// Packed-record store: the native data-pipeline runtime.
//
// TPU-native replacement for the reference's C++ data machinery --
// DataReader's one-reader-per-source thread + per-solver BlockingQueues
// (src/caffe/data_reader.cpp), BasePrefetchingDataLayer's background batch
// thread (src/caffe/layers/base_data_layer.cpp:39-124), the
// BlockingQueue itself (src/caffe/util/blocking_queue.cpp), and the
// LMDB/LevelDB cursor layer (src/caffe/util/db_lmdb.cpp) -- redesigned for
// feeding a TPU host: instead of per-datum queues and protobuf decoding,
// a memory-mapped columnar file is gathered into contiguous batch buffers
// by a thread pool, with an N-deep prefetch ring so the host->device
// transfer of batch k+1 overlaps step k.
//
// File format "MMSP" (written by native/packed_format.py):
//   magic 'MMSP' | u32 version | u32 n_fields | u64 n_rows
//   n_fields x { char name[32] | u32 dtype (0=i32,1=f32,2=i64,3=f64)
//                | u64 n_cols | u64 byte_offset }
//   ... field data, each row-major (n_rows, n_cols), 64-byte aligned ...
//
// C ABI (ctypes-friendly), no exceptions across the boundary.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x5053'4D4Du;  // 'MMSP' little-endian

struct Field {
  char name[32];
  uint32_t dtype;
  uint64_t n_cols;
  uint64_t byte_offset;
};

size_t dtype_size(uint32_t dtype) {
  switch (dtype) {
    case 0: return 4;  // i32
    case 1: return 4;  // f32
    case 2: return 8;  // i64
    case 3: return 8;  // f64
    default: return 0;
  }
}

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n_rows = 0;
  std::vector<Field> fields;
};

// splitmix64: deterministic seeding independent of libstdc++ version
// (the reproducible-shuffle requirement the reference met with a seeded
// Caffe RNG, hdf5_data_layer.cpp:62-68)
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void gather_rows(const uint8_t* src, size_t row_bytes, const int64_t* idx,
                 uint64_t n, uint8_t* dst, int n_threads) {
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + (uint64_t)idx[i] * row_bytes,
                  row_bytes);
    }
  };
  if (n_threads <= 1 || n < 1024) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  uint64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    uint64_t lo = t * chunk;
    uint64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& t : threads) t.join();
}

// ------------------------------------------------------------------ prefetch
struct Batch {
  std::vector<std::vector<uint8_t>> buffers;  // one per field
  uint64_t step = 0;
};

struct Prefetcher {
  Store* store = nullptr;
  std::vector<uint32_t> field_ids;
  uint64_t batch_size = 0;
  uint64_t seed = 0;
  bool shuffle = true;
  int gather_threads = 4;
  uint64_t shard_index = 0, shard_count = 1;

  // free/full ring, the BlockingQueue pair of the reference
  std::queue<Batch*> free_q, full_q;
  std::mutex mu;
  std::condition_variable cv_free, cv_full;
  std::vector<Batch> slots;
  std::thread worker;
  std::atomic<bool> stop{false};

  std::vector<int64_t> perm;
  uint64_t cursor = 0, epoch = 0, step = 0;
  Batch* held = nullptr;  // slot lent out via acquire, pending release

  void reshuffle() {
    uint64_t n = store->n_rows;
    perm.resize(n);
    for (uint64_t i = 0; i < n; ++i) perm[i] = (int64_t)i;
    if (shuffle && n > 1) {  // n==0 would underflow the loop index
      uint64_t s = seed * 0x9E3779B97F4A7C15ull + epoch + 1;
      for (uint64_t i = n - 1; i > 0; --i) {
        uint64_t j = splitmix64(s) % (i + 1);
        std::swap(perm[i], perm[j]);
      }
    }
    // shard striping = DataReader round-robin (data_reader.cpp:79-98)
    if (shard_count > 1) {
      std::vector<int64_t> mine;
      mine.reserve(n / shard_count + 1);
      for (uint64_t i = shard_index; i < n; i += shard_count)
        mine.push_back(perm[i]);
      perm.swap(mine);
    }
    cursor = 0;
  }

  // Returns false when the shard is empty (n_rows < shard_count can
  // leave this shard with zero rows) -- the caller stops the ring
  // instead of spinning in the epoch loop forever.
  bool fill(Batch* b) {
    std::vector<int64_t> idx(batch_size);
    for (uint64_t i = 0; i < batch_size; ++i) {
      if (cursor >= perm.size()) {
        ++epoch;
        reshuffle();
        if (perm.empty()) return false;
      }
      idx[i] = perm[cursor++];
    }
    for (size_t f = 0; f < field_ids.size(); ++f) {
      const Field& fld = store->fields[field_ids[f]];
      size_t row_bytes = fld.n_cols * dtype_size(fld.dtype);
      b->buffers[f].resize(batch_size * row_bytes);
      gather_rows(store->base + fld.byte_offset, row_bytes, idx.data(),
                  batch_size, b->buffers[f].data(), gather_threads);
    }
    b->step = step++;
    return true;
  }

  void run() {
    reshuffle();
    while (!stop.load()) {
      Batch* b = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_q.empty(); });
        if (stop.load()) return;
        b = free_q.front();
        free_q.pop();
      }
      if (!fill(b)) {
        // empty shard: return the slot, signal end-of-stream via stop
        // so consumers blocked in next/acquire wake up with -1
        std::lock_guard<std::mutex> lk(mu);
        free_q.push(b);
        stop.store(true);
        cv_full.notify_all();
        return;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        full_q.push(b);
      }
      cv_full.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* mmsp_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store;
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->size = st.st_size;
  auto fail = [&]() {
    delete s;
    ::munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  };
  // every header read is bounds-checked against the mapping: a
  // truncated or corrupted file must fail open, not fault in a later
  // gather (the reference's datum reader had protobuf doing this job)
  if (s->size < 20) return fail();
  const uint8_t* p = s->base;
  uint32_t magic, version, n_fields;
  std::memcpy(&magic, p, 4);
  std::memcpy(&version, p + 4, 4);
  std::memcpy(&n_fields, p + 8, 4);
  if (magic != kMagic || version != 1) return fail();
  std::memcpy(&s->n_rows, p + 12, 8);
  if (s->size < 20 + (uint64_t)n_fields * sizeof(Field)) return fail();
  p += 20;
  s->fields.resize(n_fields);
  for (uint32_t i = 0; i < n_fields; ++i) {
    std::memcpy(&s->fields[i], p, sizeof(Field));
    p += sizeof(Field);
    const Field& f = s->fields[i];
    size_t esize = dtype_size(f.dtype);
    if (esize == 0) return fail();  // unknown dtype
    // extent check without overflow: rows*cols*esize must fit below
    // size - offset
    if (f.byte_offset > s->size) return fail();
    uint64_t avail = s->size - f.byte_offset;
    if (f.n_cols != 0 && s->n_rows != 0) {
      if (f.n_cols > avail / esize / s->n_rows) return fail();
    }
  }
  return s;
}

void mmsp_close(void* h) {
  auto* s = static_cast<Store*>(h);
  if (!s) return;
  ::munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

uint64_t mmsp_rows(void* h) { return static_cast<Store*>(h)->n_rows; }
uint32_t mmsp_num_fields(void* h) {
  return (uint32_t) static_cast<Store*>(h)->fields.size();
}

int mmsp_field_info(void* h, uint32_t i, char* name_out, uint32_t* dtype_out,
                    uint64_t* cols_out) {
  auto* s = static_cast<Store*>(h);
  if (i >= s->fields.size()) return -1;
  std::memcpy(name_out, s->fields[i].name, 32);
  *dtype_out = s->fields[i].dtype;
  *cols_out = s->fields[i].n_cols;
  return 0;
}

int mmsp_gather(void* h, uint32_t field, const int64_t* idx, uint64_t n,
                void* out, int n_threads) {
  auto* s = static_cast<Store*>(h);
  if (field >= s->fields.size()) return -1;
  const Field& f = s->fields[field];
  size_t row_bytes = f.n_cols * dtype_size(f.dtype);
  for (uint64_t i = 0; i < n; ++i)
    if ((uint64_t)idx[i] >= s->n_rows) return -2;
  gather_rows(s->base + f.byte_offset, row_bytes, idx, n,
              static_cast<uint8_t*>(out), n_threads);
  return 0;
}

void mmsp_shuffle(uint64_t n, uint64_t seed, int64_t* out) {
  for (uint64_t i = 0; i < n; ++i) out[i] = (int64_t)i;
  if (n < 2) return;  // n==0 would underflow the loop index
  uint64_t s = seed * 0x9E3779B97F4A7C15ull + 1;
  for (uint64_t i = n - 1; i > 0; --i) {
    uint64_t j = splitmix64(s) % (i + 1);
    std::swap(out[i], out[j]);
  }
}

void* mmsp_prefetcher_create(void* store, const uint32_t* field_ids,
                             uint32_t n_fields, uint64_t batch_size,
                             uint64_t seed, int do_shuffle, int depth,
                             int gather_threads, uint64_t shard_index,
                             uint64_t shard_count) {
  auto* p = new Prefetcher;
  p->store = static_cast<Store*>(store);
  p->field_ids.assign(field_ids, field_ids + n_fields);
  p->batch_size = batch_size;
  p->seed = seed;
  p->shuffle = do_shuffle != 0;
  p->gather_threads = gather_threads;
  p->shard_index = shard_index;
  p->shard_count = shard_count;
  p->slots.resize(depth);
  for (auto& b : p->slots) {
    b.buffers.resize(n_fields);
    p->free_q.push(&b);
  }
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocks until a batch is ready; copies each field into the caller's
// buffers (sized batch*cols*dtype).  Returns the step index, or -1.
int64_t mmsp_prefetcher_next(void* h, void** out_buffers) {
  auto* p = static_cast<Prefetcher*>(h);
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_full.wait(lk, [&] { return p->stop.load() || !p->full_q.empty(); });
    if (p->stop.load()) return -1;
    b = p->full_q.front();
    p->full_q.pop();
  }
  for (size_t f = 0; f < p->field_ids.size(); ++f)
    std::memcpy(out_buffers[f], b->buffers[f].data(), b->buffers[f].size());
  int64_t step = (int64_t)b->step;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->free_q.push(b);
  }
  p->cv_free.notify_one();
  return step;
}

// Zero-copy variant: lends the ring slot's buffers to the caller instead of
// copying them out (the extra host copy TODO'd in round 1).  Returns the
// step index and writes one pointer + byte size per field; the slot stays
// checked out until mmsp_prefetcher_release, so the caller must finish the
// host->device transfer (jax.device_put + block) before releasing.  Single
// consumer; a second acquire without release returns -2.
int64_t mmsp_prefetcher_acquire(void* h, void** ptrs_out,
                                uint64_t* sizes_out) {
  auto* p = static_cast<Prefetcher*>(h);
  if (p->held) return -2;
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_full.wait(lk, [&] { return p->stop.load() || !p->full_q.empty(); });
    if (p->stop.load()) return -1;
    b = p->full_q.front();
    p->full_q.pop();
  }
  for (size_t f = 0; f < p->field_ids.size(); ++f) {
    ptrs_out[f] = b->buffers[f].data();
    sizes_out[f] = b->buffers[f].size();
  }
  p->held = b;
  return (int64_t)b->step;
}

void mmsp_prefetcher_release(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  if (!p->held) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->free_q.push(p->held);
  }
  p->held = nullptr;
  p->cv_free.notify_one();
}

void mmsp_prefetcher_destroy(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  {
    // store under the mutex: a waiter that evaluated its predicate but
    // has not yet blocked would otherwise miss the notify (the classic
    // missed-wakeup race) and deadlock the join below
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
  }
  p->cv_free.notify_all();
  p->cv_full.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
