// Gradient of the embedding table: the backward of out = w[ids].
//
// Replaces: the autograd of the table lookup (``jnp.take`` in
// mms_answer_selection_tpu/ops/embed.py; ``w[ids]`` in the port, whose
// aten backward sorts the ids and gives each distinct id to one warp,
// which walks all of that id's duplicates one after another).
//
//   dW[v, :] = sum over positions p with ids[p] == v of G[p, :]
//
// ids (T,) int64, already clamped into [0, V); G (T, D) float32; dW (V, D)
// float32, zero in every row no id touches.  Any T and D.
//
// The lookups this serves repeat a few ids very often: the recipe pads
// questions and answers to 40 tokens with one id, so about two thirds of
// a batch's ids are that one row.  A segment sum that gives each id to
// one thread walks those duplicates serially; here they are split over
// the card, in two passes, with every addition in a fixed order (no
// float atomics), so two runs, and a graph replay and an eager call,
// give the same bits:
//
// 1. embed_grad_tiles_kernel: one block a tile of TILE positions.  It
//    sorts the tile's (id, position) pairs in shared memory (each thread
//    counts the pairs below its own: the keys are distinct, so the counts
//    are a permutation) and writes the tile's distinct ids in ascending
//    order and their number.  Then, a slab of SLAB columns at a time, it
//    copies the tile's rows of G into shared memory (every thread, all
//    loads independent) and sums each distinct id's rows there in
//    position order, a thread an (id, column): the walk over a heavy id's
//    duplicates reads shared memory, not the device's.
// 2. embed_grad_merge_kernel: one warp a (tile, distinct id).  Its lanes
//    look the id up in every tile's sorted list, one tile a lane (binary
//    searches, 32 tiles a round).  The warp whose tile is the first to
//    hold the id adds the partial rows of its own and the later tiles in
//    tile order and writes the table's row; every other warp returns.
//
// So no thread walks more than a tile's duplicates of one id, and the
// merge walks at most one partial a tile.  The launch depends on T and D
// alone (blocks whose slot holds no id return), with no host sync, so it
// captures into a CUDA graph.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TILE = 256;       // positions a pass-1 block sorts, one a thread
constexpr int SLAB = 32;        // columns of G a pass-1 block stages at once
constexpr int MERGE_WARPS = 8;  // warps of a pass-2 block, one a (tile, id)
constexpr int NONE = -1;

__global__ void __launch_bounds__(TILE)
    embed_grad_tiles_kernel(const int64_t* __restrict__ ids,
                            const float* __restrict__ g,
                            float* __restrict__ part, int* __restrict__ uids,
                            int* __restrict__ ucount, int t, int d) {
  __shared__ __align__(16) int s_id[TILE];  // the tile's ids, position order
  __shared__ int s_sorted[TILE];            // ... sorted by (id, position)
  __shared__ int s_pos[TILE];               // the position of each sorted id
  __shared__ int s_start[TILE + 1];  // first sorted index of each distinct id
  __shared__ int s_heads[TILE / 32];
  __shared__ float s_g[TILE][SLAB];  // a slab of the tile's rows of G
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const long long base = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, t - base);
  // past the end: INT_MAX, which sorts last (ids are below V <= INT_MAX)
  const int mine = i < n ? (int)ids[base + i] : INT_MAX;
  s_id[i] = mine;
  __syncthreads();
  int rank = 0;
#pragma unroll 4
  for (int j = 0; j < TILE; j += 4) {
    const int4 o = *reinterpret_cast<const int4*>(&s_id[j]);
    rank += (o.x < mine || (o.x == mine && j < i)) +
            (o.y < mine || (o.y == mine && j + 1 < i)) +
            (o.z < mine || (o.z == mine && j + 2 < i)) +
            (o.w < mine || (o.w == mine && j + 3 < i));
  }
  s_sorted[rank] = mine;
  s_pos[rank] = i;
  __syncthreads();
  // sorted index i opens a distinct id: number the heads in order
  const bool head = i < n && (i == 0 || s_sorted[i] != s_sorted[i - 1]);
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  if (lane == 0) s_heads[warp] = __popc(heads);
  __syncthreads();
  int before = __popc(heads & ((1u << lane) - 1)), total = 0;
#pragma unroll
  for (int w = 0; w < TILE / 32; ++w) {
    before += w < warp ? s_heads[w] : 0;
    total += s_heads[w];
  }
  if (head) {
    s_start[before] = i;
    uids[base + before] = s_sorted[i];
  }
  if (i == 0) {
    s_start[total] = n;
    ucount[blockIdx.x] = total;
  }
  for (int c0 = 0; c0 < d; c0 += SLAB) {
    const int w = min(SLAB, d - c0);
    __syncthreads();  // s_start written; the last slab's sums read
    for (int k = i; k < n * w; k += TILE) {
      const int r = k / w, c = k - r * w;
      s_g[r][c] = g[(base + r) * d + c0 + c];
    }
    __syncthreads();
    // consecutive threads take consecutive columns of one id
    for (int item = i; item < total * w; item += TILE) {
      const int s = item / w, c = item - s * w;
      const int end = s_start[s + 1];
      float acc = 0.0f;
#pragma unroll 8
      for (int k = s_start[s]; k < end; ++k) acc += s_g[s_pos[k]][c];
      part[(base + s) * d + c0 + c] = acc;
    }
  }
}

// the index of ``id`` in the ascending list u[0, n), or NONE
__device__ __forceinline__ int find(const int* __restrict__ u, int n, int id) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (u[mid] < id)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && u[lo] == id ? lo : NONE;
}

__global__ void __launch_bounds__(MERGE_WARPS * 32)
    embed_grad_merge_kernel(const float* __restrict__ part,
                            const int* __restrict__ uids,
                            const int* __restrict__ ucount,
                            float* __restrict__ out, int tiles, int d) {
  __shared__ long long s_rows[MERGE_WARPS][32];  // partial rows to add
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * MERGE_WARPS + warp;
  const int tile = (int)(item / TILE), slot = (int)(item % TILE);
  if (tile >= tiles || slot >= ucount[tile]) return;
  const int id = uids[(long long)tile * TILE + slot];
  float* row = out + (long long)id * d;
  // rounds of 32 tiles in tile order; the row carries the sum from one
  // round to the next
  bool started = false;
  for (int u0 = 0; u0 < tiles; u0 += 32) {
    const int u = u0 + lane;
    const int at = u == tile ? slot
                   : u < tiles ? find(uids + (long long)u * TILE, ucount[u], id)
                               : NONE;
    const unsigned found = __ballot_sync(0xffffffffu, at != NONE);
    // only the first tile that holds the id writes its row
    if (found & __ballot_sync(0xffffffffu, u < tile)) return;
    if (!found) continue;
    if (at != NONE)
      s_rows[warp][__popc(found & ((1u << lane) - 1))] =
          (long long)u * TILE + at;
    __syncwarp();
    const int n = __popc(found);
    for (int c = lane; c < d; c += 32) {
      float acc = started ? row[c] : 0.0f;
      for (int k = 0; k < n; ++k) acc += part[s_rows[warp][k] * d + c];
      row[c] = acc;
    }
    __syncwarp();
    started = true;
  }
}

}  // namespace

// ids (T,) int64 clamped into [0, V), g (T, D) and out (V, D) float32;
// part: ceil(T / tile) * tile * D floats and meta: ceil(T / tile) *
// (tile + 1) ints of scratch, sized by the caller's tile, which has to be
// the TILE this file is built for.  Zeroes out, then the two passes.
extern "C" int embed_grad(const void* ids, const void* g, void* out,
                          void* part, void* meta, int t, int d, int v,
                          int tile, int device, void* stream) {
  if (tile != TILE || t < 0 || d < 0 || v <= 0 || v == INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (int err = (int)cudaSetDevice(device)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int err = (int)cudaMemsetAsync(out, 0, (size_t)v * d * sizeof(float),
                                     s))
    return err;
  if (t == 0 || d == 0) return 0;
  const int tiles = (t + TILE - 1) / TILE;
  int* uids = static_cast<int*>(meta);
  int* ucount = uids + (long long)tiles * TILE;
  embed_grad_tiles_kernel<<<tiles, TILE, 0, s>>>(
      static_cast<const int64_t*>(ids), static_cast<const float*>(g),
      static_cast<float*>(part), uids, ucount, t, d);
  if (int err = (int)cudaGetLastError()) return err;
  embed_grad_merge_kernel<<<tiles * (TILE / MERGE_WARPS), MERGE_WARPS * 32, 0,
                            s>>>(static_cast<const float*>(part), uids,
                                 ucount, static_cast<float*>(out), tiles, d);
  return (int)cudaGetLastError();
}
