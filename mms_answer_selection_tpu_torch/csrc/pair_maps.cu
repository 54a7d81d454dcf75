// Pair maps of the learned bilinear metric, forward and backward.
//
// Replaces: mms_answer_selection_tpu/ops/sim_cross_pallas.py,
// _pair_map_kernel (reached through _pair_maps_forward and
// bilinear_pair_maps), and the closed-form backward of its custom_vjp,
// _pair_maps_bwd (sim_cross_pallas.py:156; its JAX body is einsums outside
// Pallas).  Any W1, W2 and D: the launch plans tile them.
//
// Forward   out[n, i, j, m] = sum_d sum_e q[n, i, d] W[m, d, e] a[n, j, e]
// Backward, with G = dL/dout in the same NHWC (N, W1, W2, M) layout:
//   dQ[n, i, d] = sum_m sum_j G[n, i, j, m] (a_n W_m^T)[j, d]
//   dA[n, j, e] = sum_m sum_i G[n, i, j, m] (q_n W_m)[i, e]
//   dW[m, d, e] = sum_n sum_i q[n, i, d] (G_m a_n)[i, e]
// All to float32 accuracy: the reference runs these products at
// Precision.HIGHEST, which single-pass TF32 tensor cores would not match
// (about three decimal digits).  dW, the forward's second product and dQ /
// dA's contraction with G use float32 FMAs on the CUDA cores; the
// forward's main product (mma.sync) and dQ / dA's first product (wgmma)
// run on the tensor cores as 3xTF32 (each operand split into a TF32 high
// and low part, three products summed in float32), within float32's
// rounding.
//
// What bounds them on the H100.  The forward and dW each do N * M * W1 *
// D * (D + W2) FMAs; float32-accurate products run fastest as 3xTF32 on
// the tensor cores, 495 / 3 = 165 TFLOP/s (float32 FMAs: 67).  At V4
// widths (W1 = W2 = 40, M = 4) that is 0.0089 ms at N = 1024, D = 50,
// under the 0.0127 ms of its bytes (3.35 TB/s), and 0.0099 ms at N = 50,
// D = 300 (V4_WIDE), over its 0.0022 ms of bytes.  The kernels are built
// to keep the arithmetic units fed:
//
// * Register tiles.  On the CUDA cores each thread owns an 8 x 8 output
//   tile and reads two float4s of each operand per k step, loaded one step
//   ahead of their FMAs: 64 FMAs per four 16-byte shared loads, which the
//   shared-memory pipe sustains (4 x 4 tiles, 16 FMAs per two loads, were
//   held to about half the FMA rate by it).  A tile's two float4s lie half
//   a tile apart, so a quarter-warp's loads are 128 contiguous bytes.
// * Tensor cores.  The forward's P = q_n W_m is formed as P^T = W^T q^T
//   with mma.sync m16n8k8 TF32: W's tile columns fill the 16-row
//   fragments and q's rows the 8-wide ones, so V4's 40 rows need no
//   padding.  Each warp owns MFW column fragments by all row fragments;
//   padded shared-memory rows keep the fragment loads free of bank
//   conflicts.  mma.sync TF32 is slower on Hopper than wgmma, so three of
//   them cost about what the FMAs would at full rate; the gain is in the
//   instructions issued.
// * Asynchronous staging.  Operands reach shared memory by cp.async, 16 or
//   8 bytes a copy where D allows, into two buffers: the next slab or
//   sample is in flight while the current one is multiplied.
//
// pair_maps_fwd (one block per sample, part of its rows, column tile of P,
// tile of W2's columns and four measures): P = q_n W_m is a small GEMM and
// out = P a_n^T a second one.  32-row slabs of q_n and of W's tile columns stream through
// the two buffers; the P tile then stays in shared memory for the second
// product, whose tiles are two rows x the four measures x eight columns,
// so each thread writes out[n, i, j, 0..3] as float4s and a warp's stores
// are contiguous (a_n's columns are permuted to make that so).  When D
// needs several column tiles, each writes its share of out as a partial
// map, and sum_partials_kernel adds them in tile order.  Past 200 columns
// of W2 (the second product's threads), W2 is cut into tiles, each forming
// its P again.  The wrapper picks the row parts, the tile widths and the W2
// tiles from the shape alone (sim_cross_kernels.pair_maps_fwd_geometry), so
// small batches still fill the 132 SMs and D = 300 fits in dynamic shared
// memory.
//
// pair_maps_bwd_w (one block per panel dW[m0..m0+3][d-rows, e-slice] and
// chunk of the batch): for each sample, t = G_m a_n[:, e-slice] is formed
// once for the block's four measures (G copied as 16-byte rows over M, 4 x
// 4 tiles), then q_n^T t accumulates into the panel in registers (8 x 8).
// A panel spans all of D's rows unless shared memory forces a split, so t
// is formed once per (sample, e-slice).  Each block sums its chunk's
// samples in order into a partial; sum_partials_kernel adds the partials
// in chunk order.  Where G_n [W1][W2][MS] does not fit twice (W past about
// 100), a sample's W1 rows are staged in tiles, each tile's q rows and G
// rows in turn, and the panel sums them in row order.  No atomics and no
// order chosen at run time, so two runs give the same bits.  The chunk
// size and the W1 tile come from the shape alone (pair_maps_bwd_w_geometry).
//
// Neither kernel reaches a seventh of that bound yet, and at V4_WIDE's
// D = 300 the forward does not beat cuBLAS's einsum (PERF.md has the
// times).
//
// pair_maps_bwd_qa (dQ and dA, one launch): dQ[n] = sum_m G_m (a_n W_m^T)
// and dA[n] = sum_m G_m^T (q_n W_m).  88% of the operations at D = 300 are
// in the first products U = x_n V_m (V_m = W_m^T or W_m), each a GEMM of
// x's rows by D x D against one W_m shared by every sample; the bound is
// 2 N M D ((W1 + W2) D + 2 W1 W2) operations at 165 TFLOP/s (0.405 ms at N
// = 1024, D = 300) over the bytes (each input once, dQ and dA once).  The
// design, the forward's carried further: a block takes the rows of up to
// 128 / K whole samples (three of V4's 40), so one staged 32-row slab of
// W_m serves 120 rows, not 40; U's 64-column tile is formed on the tensor
// cores as wgmma m64n64k8 TF32, one warpgroup per 64 rows, both operands
// K-major from 128-byte-swizzled shared memory: the high part is the
// operand itself (the tensor cores read its top 19 bits), the low part the
// exact rest, written beside the slab once per slab, three products a k
// step.  U is kept in shared memory in the place of the spent slabs and
// contracted at once with G_m (staged, and the next measure's G copied
// while this one's U is formed) into each thread's 4 x 8 register tile of
// the output, summed over m and k in a fixed order.  U
// (196 MB at N = 1024, D = 300, which the einsums write and read) never
// reaches device memory, and no atomics are used.  Small batches split the
// measures into groups whose partial outputs are summed in order.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "maxsim_wgmma.cuh"  // wgmma, shared-memory descriptors, swizzle

namespace {

constexpr int NT = 256;           // threads of the partial sums' blocks
constexpr int MS = 4;             // measures per block: one float4 of out, g
constexpr int FK = 32;            // columns of q_n, rows of W per slab
constexpr int FKQ = FK + 4;       // floats per row of the forward's q slab
constexpr int STAGES = 2;         // slabs in the forward's ring
constexpr int MFW = 2;            // 16-column fragments of P^T per warp
constexpr int MAX_NF = 5;         // 8-row fragments of P^T, at most
constexpr int MAX_THREADS = 512;  // threads per block, at most
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory of one block
constexpr int QA_THREADS = 256;   // threads of a dQ / dA block
constexpr int QA_ROWS = 128;      // rows of x in a dQ / dA block's U, at most

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[4 r + c] += x[r] * y[c]
__device__ __forceinline__ void outer4(float* acc, float4 x, float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[4 * r + c] = fmaf(xs[r], ys[c], acc[4 * r + c]);
}

// acc[4 r + c] += x[s * xs + r] * y[s * ys + c] over s < steps, a 4 x 4
// register tile, each step's operands loaded one step ahead of its FMAs.
__device__ __forceinline__ void product4(float (&acc)[16], const float* x,
                                         int xs, const float* y, int ys,
                                         int steps) {
  if (steps <= 0) return;
  float4 a = ld4(x), b = ld4(y);
#pragma unroll 4
  for (int s = 1; s <= steps; ++s) {
    const int nx = s < steps ? s : steps - 1;
    const float4 na = ld4(x + nx * xs), nb = ld4(y + nx * ys);
    outer4(acc, a, b);
    a = na;
    b = nb;
  }
}

// Asynchronous copy of BYTES (4, 8 or 16, src aligned to them) to shared
// memory, zero-filled when !full (src is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               ::"r"(s), "l"(src), "n"(BYTES), "r"(full ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The float nearest x in TF32 (10 mantissa bits), as its bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for a 16 x 8 TF32 fragment a (rows g and g + 8, columns t and
// t + 4 of lane 4 g + t), an 8 x 8 fragment b (rows t, t + 4, column g)
// and a 16 x 8 float fragment d (rows g, g + 8, columns 2 t, 2 t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = start, start + step, ... over a grid of rows x cols, as (r, c),
// with no division per step.
struct Walk {
  int r, c;
  const int dr, dc, cols;
  __device__ Walk(int start, int step, int cols_)
      : r(start / cols_), c(start % cols_), dr(step / cols_),
        dc(step % cols_), cols(cols_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// The widest copy, in floats (4, 2 or 1), that every row of a D-wide
// float32 matrix at p allows.
__device__ __forceinline__ int copy_width(const void* p, int d) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (d % 4 == 0 && a % 16 == 0) return 4;
  if (d % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

// dst[r][c] = src[r * ld + c] for r < rows, c < cols (a multiple of V),
// zero where c >= valid; V-float copies.
template <int V>
__device__ __forceinline__ void copy_rows(float* dst, int dst_ld,
                                          const float* src, size_t ld,
                                          int rows, int cols, int valid,
                                          int tid, int nt) {
  for (Walk it(tid, nt, cols / V); it.r < rows; it.next()) {
    const int c = it.c * V;
    cp_async<4 * V>(dst + it.r * dst_ld + c,
                    c < valid ? src + it.r * ld + c : src, c < valid);
  }
}

__device__ __forceinline__ void copy_rows(int v, float* dst, int dst_ld,
                                          const float* src, size_t ld,
                                          int rows, int cols, int valid,
                                          int tid, int nt) {
  if (v == 4)
    copy_rows<4>(dst, dst_ld, src, ld, rows, cols, valid, tid, nt);
  else if (v == 2)
    copy_rows<2>(dst, dst_ld, src, ld, rows, cols, valid, tid, nt);
  else
    copy_rows<1>(dst, dst_ld, src, ld, rows, cols, valid, tid, nt);
}

// The slab rows [rows][32 floats] of a 128-byte-swizzled operand: float k
// of row r at byte swizzle(128 r + 4 k) of dst, from src[r * ld + k] for r
// < rows_valid, k < cols_valid, zero elsewhere; V-float copies.
template <int V>
__device__ __forceinline__ void copy_swizzled(uint8_t* dst, const float* src,
                                              size_t ld, int rows,
                                              int rows_valid, int cols_valid,
                                              int tid, int nt) {
  for (Walk it(tid, nt, FK / V); it.r < rows; it.next()) {
    const int k = it.c * V;
    const bool ok = it.r < rows_valid && k < cols_valid;
    cp_async<4 * V>(reinterpret_cast<float*>(
                        dst + maxsim::swizzle(it.r * FK * 4 + 4 * k, FK * 4)),
                    ok ? src + it.r * ld + k : src, ok);
  }
}

__device__ __forceinline__ void copy_swizzled(int v, uint8_t* dst,
                                              const float* src, size_t ld,
                                              int rows, int rows_valid,
                                              int cols_valid, int tid,
                                              int nt) {
  if (v == 4)
    copy_swizzled<4>(dst, src, ld, rows, rows_valid, cols_valid, tid, nt);
  else if (v == 2)
    copy_swizzled<2>(dst, src, ld, rows, rows_valid, cols_valid, tid, nt);
  else
    copy_swizzled<1>(dst, src, ld, rows, rows_valid, cols_valid, tid, nt);
}

// A forward slab of W: ws[dd * wst + ms * te_max + c] = W[m0 + ms][d0 +
// dd][e0 + c], zero past tk rows, ms_here measures and te columns; V-float
// copies.
template <int V>
__device__ __forceinline__ void stage_w(float* ws, int wst, const float* w,
                                        int d, int d0, int e0, int m0,
                                        int tk, int te, int ms_here,
                                        int te_max, int tid, int nt) {
  for (Walk it(tid, nt, te_max / V); it.r < FK * MS; it.next()) {
    const int dd = it.r / MS, ms = it.r % MS, c = it.c * V;
    const bool ok = dd < tk && ms < ms_here && c < te;
    cp_async<4 * V>(ws + dd * wst + ms * te_max + c,
                    ok ? w + ((size_t)(m0 + ms) * d + d0 + dd) * d + e0 + c
                       : w,
                    ok);
  }
}

// A forward slab of q_n's rows: qs[r * FKQ + c] = q_n[r][d0 + c], zero past
// tk columns and past the block's rows; V-float copies.
template <int V>
__device__ __forceinline__ void stage_q(float* qs, const float* qn, int d,
                                        int d0, int tk, int rows, int r8,
                                        int tid, int nt) {
  for (Walk it(tid, nt, FK / V); it.r < r8; it.next()) {
    const int c = it.c * V;
    const bool ok = it.r < rows && c < tk;
    cp_async<4 * V>(qs + it.r * FKQ + c,
                    ok ? qn + (size_t)it.r * d + d0 + c : qn, ok);
  }
}

// acc[8 r + c] += x_r * y_c summed over s < steps, an 8 x 8 register
// tile: x_0..3 = x[s * xs + 0..3], x_4..7 = x[s * xs + xh + 0..3], and y
// likewise with ys and yh.  With the halves of a tile apart (xh, yh half a
// tile), neighbouring threads' float4s are neighbours in shared memory, so
// a quarter-warp reads 128 contiguous bytes.  Each step's operands are
// loaded one step ahead of its FMAs.
__device__ __forceinline__ void product8(float (&acc)[64], const float* x,
                                         int xs, int xh, const float* y,
                                         int ys, int yh, int steps) {
  if (steps <= 0) return;
  float4 x0 = ld4(x), x1 = ld4(x + xh), y0 = ld4(y), y1 = ld4(y + yh);
#pragma unroll 4
  for (int s = 1; s <= steps; ++s) {
    const int nx = s < steps ? s : steps - 1;
    const float4 nx0 = ld4(x + nx * xs), nx1 = ld4(x + nx * xs + xh);
    const float4 ny0 = ld4(y + nx * ys), ny1 = ld4(y + nx * ys + yh);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[8 * r + c] = fmaf(xv[r], yv[c], acc[8 * r + c]);
    x0 = nx0;
    x1 = nx1;
    y0 = ny0;
    y1 = ny1;
  }
}

// The forward's shared-memory row strides, padded so that a fragment's
// loads hit 32 distinct banks: q's rows hold FKQ = FK + 4 floats (lane
// 4 g + t reads row g, column t), W's rows MS x TE + 8 (lane 4 g + t reads
// row t, column g).
__host__ __device__ inline int fwd_wst(int te) { return MS * te + 8; }

// Shared memory of the forward, in bytes: STAGES x (qs [R8][FKQ] + ws
// [FK][wst]) + ps [TE][R8][MS] + as [TE][W2P], R8 = round8(rows), W2P =
// round8(w2), w2 the block's tile of W2.
size_t fwd_smem(int rows, int w2, int te) {
  const size_t r8 = round8(rows);
  return 4 * (STAGES * (r8 * FKQ + (size_t)FK * fwd_wst(te)) +
              (size_t)te * r8 * MS + (size_t)te * round8(w2));
}

// dQ / dA's tiles: U is formed by wgmma on 64-row tiles of x's rows (one
// warpgroup each) by 64 columns; a slab is 32 floats (128 bytes, one
// swizzle span) of K.
constexpr int QA_COLS = 64;       // wgmma width; column tiles up to it
constexpr int QA_SLAB = FK * 4;   // bytes of a K slab row
constexpr int QA_UP = QA_COLS + 4;  // floats per row of U in shared memory

// Rows of x a dQ / dA block multiplies: 64 or 128.
__host__ __device__ inline int qa_rows(int samples, int k_rows) {
  return samples * k_rows <= 64 ? 64 : QA_ROWS;
}

// Shared memory of a dQ or dA block, in bytes: 1 KB to align, STAGES raw
// slabs (x's rows, then V's 64 rows) and one slab of their low TF32
// parts, each [rows][128 bytes] swizzled, U [rows][QA_UP] in the raw
// slabs' place once they are used, then 2 x gs [samples x k_rows][4
// ceil(r_rows / 4)].
size_t qa_smem(int samples, int k_rows, int r_rows) {
  const size_t slab = (size_t)(qa_rows(samples, k_rows) + QA_COLS) * QA_SLAB;
  return 1024 + (STAGES + 1) * slab +
         2 * 4 * (size_t)samples * k_rows * 4 * ((r_rows + 3) / 4);
}

// Shared memory of dW, in bytes: 2 x (qs [W1][DR8] + gs [W1][W2][MS] +
// as [W2][TE]) + ts [W1][MS][TE], DR8 = round8(d_rows), w1 the rows of a
// W1 tile.
size_t bwd_w_smem(int w1, int w2, int d_rows, int te) {
  return 4 * (2 * ((size_t)w1 * round8(d_rows) + (size_t)w1 * w2 * MS +
                   (size_t)w2 * te) +
              (size_t)w1 * MS * te);
}

// out[n, i0:i0+rows, j0:j0+w2_max, m0:m0+4], or its share from P's
// columns e0..e0+te, for blockIdx = (n, (row part x column tile) x W2
// tile, measure group).
// P = q_n W_m over the tile's columns is summed from FK-row slabs of q_n
// and W, streamed through a ring of STAGES buffers; then out += P a_n^T
// over the same columns.  With one column tile the block writes out; with
// several it writes its share to part[et] (summed in tile order).
__global__ void __launch_bounds__(MAX_THREADS)
pair_maps_fwd_kernel(const float* __restrict__ q, const float* __restrict__ a,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n_count, int w1, int w2, int d, int m_count,
                     int rows_max, int te_max, int w2_max) {
  extern __shared__ float4 smem4[];
  const int e_tiles = (d + te_max - 1) / te_max;
  const int w2_tiles = (w2 + w2_max - 1) / w2_max;
  const int n = blockIdx.x, m0 = blockIdx.z * MS;
  const int part = blockIdx.y / w2_tiles, j0 = (blockIdx.y % w2_tiles) * w2_max;
  const int i0 = (part / e_tiles) * rows_max;
  const int et = part % e_tiles, e0 = et * te_max;
  const int rows = min(rows_max, w1 - i0), ms_here = min(MS, m_count - m0);
  const int te = min(te_max, d - e0), w2h = min(w2_max, w2 - j0);
  const int r8 = round8(rows_max), w2p = round8(w2_max);
  const int tid = threadIdx.x, nt = blockDim.x;
  // per stage: qs [r8][FKQ] (q_n's rows, a slab of columns) and ws
  // [FK][wst] (W's slab rows, the tile's MS x te_max columns); then ps
  // [te_max][r8][MS] (the P tile) and as [te_max][w2p] (a_n^T, permuted)
  const int wst = fwd_wst(te_max);
  const int buf = r8 * FKQ + FK * wst;
  float* smem = reinterpret_cast<float*>(smem4);
  float* ps = smem + STAGES * buf;
  float* as = ps + te_max * r8 * MS;

  // Product 1 on the tensor cores as P^T = W^T q^T: warp w owns the
  // 16-column fragments mf = w, w + nw, .. (MFW at most) of P^T, by all nf
  // 8-row fragments; lane 4 gq + tq holds the fragment elements mma_tf32
  // names.  Product 2 tile: rows rp and r8/2 + rp x the MS measures x 8
  // columns of out, j = jg + jj * jg_n (jj < 8), which a_n's permuted
  // columns place at jg*4.. and w2p/2 + jg*4.. so that a warp's stores are
  // contiguous.
  const int lane = tid % 32, warp = tid / 32, nw = nt / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int mf_n = MS * te_max / 16, nf = r8 / 8;
  const int jg_n = w2p / 8, tiles2 = r8 / 2 * jg_n;
  const int jg = tid % jg_n, rp = tid / jg_n;

  const float* qn = q + ((size_t)n * w1 + i0) * d;
  const int qv = copy_width(q, d), wv = copy_width(w, d);
  // slab s: columns d0..d0+FK of q_n's rows and rows d0..d0+FK of W
  auto stage = [&](int s, float* qs) {
    const int d0 = s * FK, tk = min(FK, d - d0);
    if (qv == 4)
      stage_q<4>(qs, qn, d, d0, tk, rows, r8, tid, nt);
    else if (qv == 2)
      stage_q<2>(qs, qn, d, d0, tk, rows, r8, tid, nt);
    else
      stage_q<1>(qs, qn, d, d0, tk, rows, r8, tid, nt);
    float* ws = qs + r8 * FKQ;
    if (wv == 4)
      stage_w<4>(ws, wst, w, d, d0, e0, m0, tk, te, ms_here, te_max, tid,
                 nt);
    else if (wv == 2)
      stage_w<2>(ws, wst, w, d, d0, e0, m0, tk, te, ms_here, te_max, tid,
                 nt);
    else
      stage_w<1>(ws, wst, w, d, d0, e0, m0, tk, te, ms_here, te_max, tid,
                 nt);
  };

  const float* an = a + ((size_t)n * w2 + j0) * d + e0;
  for (Walk it(tid, nt, te_max); it.r < w2p; it.next()) {
    const bool ok = it.r < w2h && it.c < te;
    const int jj = it.r / jg_n;
    cp_async<4>(as + it.c * w2p + jj / 4 * (w2p / 2) + (it.r % jg_n) * 4 +
                    jj % 4,
                ok ? an + (size_t)it.r * d + it.c : a, ok);
  }
  // A ring of STAGES slabs: STAGES - 1 in flight while one is multiplied.
  // Every thread commits one group per slot, empty or not, so waiting
  // until STAGES - 1 groups are open means slab s has landed.
  const int slabs = (d + FK - 1) / FK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slabs) stage(s, smem + s * buf);
    cp_async_commit();
  }

  // 3xTF32: each operand x = hi + lo, both TF32, and d += lo hi + hi lo +
  // hi hi in float32, which keeps the product within float32's rounding
  // (the lo lo term is below it)
  auto split = [](float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  };
  float acc1[MFW][MAX_NF][4];
#pragma unroll
  for (int k = 0; k < MFW; ++k)
#pragma unroll
    for (int ni = 0; ni < MAX_NF; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc1[k][ni][x] = 0.f;
  for (int s = 0; s < slabs; ++s) {
    const int ahead = s + STAGES - 1;
    if (ahead < slabs) stage(ahead, smem + (ahead % STAGES) * buf);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const float* qs = smem + (s % STAGES) * buf;
    const float* ws = qs + r8 * FKQ;
    const int tk = min(FK, d - s * FK);
    for (int k0 = 0; k0 < tk; k0 += 8) {
      uint32_t bh[MAX_NF][2], bl[MAX_NF][2];
#pragma unroll
      for (int ni = 0; ni < MAX_NF; ++ni) {
        if (ni >= nf) continue;
        const float* b = qs + (ni * 8 + gq) * FKQ + k0 + tq;
        split(b[0], bh[ni][0], bl[ni][0]);
        split(b[4], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int k = 0; k < MFW; ++k) {
        const int mf = warp + k * nw;
        if (mf >= mf_n) continue;
        const float* x = ws + (k0 + tq) * wst + mf * 16 + gq;
        uint32_t ah[4], al[4];
        split(x[0], ah[0], al[0]);
        split(x[8], ah[1], al[1]);
        split(x[4 * wst], ah[2], al[2]);
        split(x[4 * wst + 8], ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < MAX_NF; ++ni) {
          if (ni >= nf) continue;
          mma_tf32(acc1[k][ni], al, bh[ni]);
          mma_tf32(acc1[k][ni], ah, bl[ni]);
          mma_tf32(acc1[k][ni], ah, bh[ni]);
        }
      }
    }
    __syncthreads();  // this buffer's readers are done before it refills
  }

  // P^T's fragments to ps: fragment row gq (+ 8) is P's column c, its
  // columns 2 tq, 2 tq + 1 are P's rows
#pragma unroll
  for (int k = 0; k < MFW; ++k) {
    const int mf = warp + k * nw;
    if (mf >= mf_n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = mf * 16 + gq + 8 * h, ms = c / te_max, e = c % te_max;
#pragma unroll
      for (int ni = 0; ni < MAX_NF; ++ni) {
        if (ni >= nf) continue;
        const int r = ni * 8 + 2 * tq;
        ps[(e * r8 + r) * MS + ms] = acc1[k][ni][2 * h];
        ps[(e * r8 + r + 1) * MS + ms] = acc1[k][ni][2 * h + 1];
      }
    }
  }
  __syncthreads();
  if (tid >= tiles2) return;
  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  // acc[(4 rr + ms) * 8 + jj]: x = P[rp + rr * r8/2][ms], y = a_n[j]
  product8(acc, ps + rp * MS, r8 * MS, r8 / 2 * MS, as + jg * 4, w2p, w2p / 2,
           te);
  float* dst = out + (size_t)et * n_count * w1 * w2 * m_count;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rp + rr * (r8 / 2);
    if (r >= rows) continue;
    float* o = dst + ((size_t)n * w1 + i0 + r) * w2 * m_count + m0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = jg + jj * jg_n;
      if (j >= w2h) continue;
      const float* v = acc + rr * 32 + jj;   // acc[(rr * 4 + ms) * 8 + jj]
      if (m_count % MS == 0) {
        *reinterpret_cast<float4*>(o + (size_t)(j0 + j) * m_count) =
            make_float4(v[0], v[8], v[16], v[24]);
      } else {
        for (int mm = 0; mm < ms_here; ++mm)
          o[(size_t)(j0 + j) * m_count + mm] = v[8 * mm];
      }
    }
  }
}

// d (64 x 64, f32) += A (64 x 8) B^T (64 x 8), TF32 operands read from
// 128-byte-swizzled K-major shared memory (the tensor cores use each f32's
// top 19 bits).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving reads of d across a wgmma wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The plan of one of pair_maps_bwd_qa's two products (dQ or dA).
struct QaRole {
  int samples, k_rows, r_rows;
};

// dQ (blockIdx.z even) or dA (odd) for blockIdx.x = a block of the role's
// `samples` samples, blockIdx.y = output row tile x column tile, and
// measures [m_per * (blockIdx.z / 2), +m_per).  With x =
// a, K = W2, R = W1, V_m = W_m^T for dQ and x = q, K = W1, R = W2, V_m =
// W_m for dA:
//   out[n, r, c] = sum_m sum_k Gx[n, r, k, m] U[n, k, c],  U_n = x_n V_m,
// Gx[n, r, k] = G[n, r, k] (dQ) or G[n, k, r] (dA).  For each measure and
// chunk of k_rows of x's rows (all of K when a block holds several
// samples), the block forms U on its rows (the samples' rows one after
// another, 64 or 128 of them) and 64-column tile with 3xTF32 wgmma, keeps
// it in shared memory, and contracts it with the staged G into each
// thread's 4-row x 8-column register tile of the output.  Sums run over m,
// then k, in order: no atomics, the same bits every run.  Both products
// run in one launch, so a small batch's blocks of the two fill the card
// together; where they are still too few, the measures split into groups
// whose partial outputs (part + group x part_stride) are summed in group
// order afterwards.  Output: dQ (N, W1, D) then dA (N, W2, D).  The body
// is compiled once for each product, so that its strides are constants.
template <bool FOR_Q>
__device__ __forceinline__ void qa_body(const float* __restrict__ q,
                                        const float* __restrict__ a,
                                        const float* __restrict__ w,
                                        const float* __restrict__ g,
                                        float* __restrict__ part,
                                        size_t part_stride, int n_count,
                                        int w1, int w2, int d, int m_count,
                                        int m_per, int te_max,
                                        QaRole role_q, QaRole role_a) {
  extern __shared__ float4 smem4[];
  constexpr bool for_q = FOR_Q;
  const int m_lo = (blockIdx.z / 2) * m_per;
  const int m_hi = min(m_count, m_lo + m_per);
  const QaRole role = for_q ? role_q : role_a;
  const int samples = role.samples, k_rows = role.k_rows;
  const int r_rows = role.r_rows;
  const float* x = for_q ? a : q;
  float* out = part + (blockIdx.z / 2) * part_stride +
               (for_q ? 0 : (size_t)n_count * w1 * d);
  const int kn = for_q ? w2 : w1, rn = for_q ? w1 : w2;
  const int e_tiles = (d + te_max - 1) / te_max;
  const int r_tiles = (rn + r_rows - 1) / r_rows;
  // the grid covers the larger of the two roles' plans
  if ((int)blockIdx.x * samples >= n_count ||
      (int)blockIdx.y >= r_tiles * e_tiles)
    return;
  const int n0 = blockIdx.x * samples, s_here = min(samples, n_count - n0);
  const int r0 = (blockIdx.y / e_tiles) * r_rows, rh = min(r_rows, rn - r0);
  const int c0 = (blockIdx.y % e_tiles) * te_max, te = min(te_max, d - c0);
  const int rows = samples * k_rows, rows_p = qa_rows(samples, k_rows);
  const int r4 = (r_rows + 3) / 4;
  // the raw slabs (STAGES), the low parts' slab, then gs (two buffers of
  // [samples * k_rows][4 r4]: this G's and the next one's); a slab is x's
  // rows_p rows, then V's QA_COLS rows, 128 bytes each, swizzled.  U, us
  // [rows_p][QA_UP], takes the raw slabs' place once they are used.
  const int slab = (rows_p + QA_COLS) * QA_SLAB;
  const int gcols = 4 * r4, gk = samples * k_rows;
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  smem += (1024 - (maxsim::smem_u32(smem) & 1023)) & 1023;
  uint8_t* lo_slab = smem + STAGES * slab;
  float* us = reinterpret_cast<float*>(smem);
  float* gs0 = reinterpret_cast<float*>(lo_slab + slab);
  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128;
  // the output's tiling: thread -> rows 4 rg.. of sample cs, columns 8 cg..
  const int cgn = te_max / 8, cg = tid % cgn, rest = tid / cgn;
  const int cs = rest / r4, rg = rest % r4;
  const bool owner = rest < samples * r4;
  const int xv = copy_width(x, d), wv = copy_width(w, d);

  // Gx of measure m on the block's samples, the k chunk from kc0 and the r
  // tile: gs[(s * k_rows + k) * 4 r4 + rr], zero outside; neighbouring
  // threads read neighbouring j (16 bytes apart when M = 4)
  auto stage_g = [&](int m, int kc0, float* gs) {
    const int kh = min(k_rows, kn - kc0);
    for (Walk it(tid, QA_THREADS, for_q ? gk : gcols);
         it.r < (for_q ? gcols : gk); it.next()) {
      const int rr = for_q ? it.r : it.c, sk = for_q ? it.c : it.r;
      const int sm = sk / k_rows, k = sk % k_rows;
      const bool ok = sm < s_here && k < kh && rr < rh;
      const int i = for_q ? r0 + rr : kc0 + k, j = for_q ? kc0 + k : r0 + rr;
      cp_async<4>(gs + sk * gcols + rr,
                  ok ? g + (((size_t)(n0 + sm) * w1 + i) * w2 + j) *
                               m_count + m
                     : g,
                  ok);
    }
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // iteration t = (measure, k chunk) in order; G of iteration t + 1 is
  // copied while iteration t runs
  const int slabs = (d + FK - 1) / FK, chunks = (kn + k_rows - 1) / k_rows;
  stage_g(m_lo, 0, gs0);
  cp_async_commit();
  for (int m = m_lo, t = 0; m < m_hi; ++m) {
    const float* wm = w + (size_t)m * d * d;
    for (int kc0 = 0; kc0 < kn; kc0 += k_rows, ++t) {
      const int kh = min(k_rows, kn - kc0);
      float* gs = gs0 + (t & 1) * gk * gcols;
      // x's rows of the block are contiguous: samples > 1 only with k_rows
      // = K; rows past the batch are zeros
      const float* xb = x + ((size_t)n0 * kn + kc0) * d;
      const int x_valid = min(rows, (n_count - n0) * kn - kc0);
      // slab sb: x's rows [rows_p][32] and V^T's [QA_COLS][32] (dQ: W_m's
      // rows c0.., columns d0..; dA: W_m's columns c0.., rows d0..,
      // transposed by the copies), byte (r, k) at swizzle(128 r + 4 k)
      auto stage = [&](int sb, uint8_t* dst) {
        const int d0 = sb * FK, tk = min(FK, d - d0);
        copy_swizzled(xv, dst, xb + d0, d, rows_p, x_valid, tk, tid,
                      QA_THREADS);
        uint8_t* vs = dst + rows_p * QA_SLAB;
        if (for_q) {
          copy_swizzled(wv, vs, wm + (size_t)c0 * d + d0, d, QA_COLS, te, tk,
                        tid, QA_THREADS);
        } else {
          for (Walk it(tid, QA_THREADS, QA_COLS); it.r < FK; it.next()) {
            const bool ok = it.r < tk && it.c < te;
            cp_async<4>(reinterpret_cast<float*>(
                            vs + maxsim::swizzle(it.c * QA_SLAB + 4 * it.r,
                                                 QA_SLAB)),
                        ok ? wm + (size_t)(d0 + it.r) * d + c0 + it.c : wm,
                        ok);
          }
        }
      };
      if (t + 1 < (m_hi - m_lo) * chunks)   // the next G, with slab 0
        stage_g(m + (kc0 + k_rows >= kn), kc0 + k_rows >= kn ? 0 : kc0 + k_rows,
                gs0 + ((t + 1) & 1) * gk * gcols);
#pragma unroll
      for (int sb = 0; sb < STAGES - 1; ++sb) {
        if (sb < slabs) stage(sb, smem + sb * slab);
        cp_async_commit();
      }
      float c[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) c[i] = 0.f;
      const bool busy = wg * 64 < rows_p;   // this warpgroup's rows exist
      for (int sb = 0; sb < slabs; ++sb) {
        const int ahead = sb + STAGES - 1;
        if (ahead < slabs) stage(ahead, smem + (ahead % STAGES) * slab);
        cp_async_commit();
        cp_async_wait<STAGES - 1>();
        __syncthreads();
        uint8_t* raw = smem + (sb % STAGES) * slab;
        // the low TF32 parts, v - (v's top 19 bits), exact in f32, at the
        // same offsets
        for (int i = tid; i < slab / 16; i += QA_THREADS) {
          float4 v = *reinterpret_cast<const float4*>(raw + 16 * i);
          v.x -= __uint_as_float(__float_as_uint(v.x) & 0xffffe000u);
          v.y -= __uint_as_float(__float_as_uint(v.y) & 0xffffe000u);
          v.z -= __uint_as_float(__float_as_uint(v.z) & 0xffffe000u);
          v.w -= __uint_as_float(__float_as_uint(v.w) & 0xffffe000u);
          *reinterpret_cast<float4*>(lo_slab + 16 * i) = v;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (busy) {
          // 3xTF32: lo x hi + hi x lo + hi x hi, k steps in order
          const uint32_t xr = maxsim::smem_u32(raw) + wg * 64 * QA_SLAB;
          const uint32_t xl = maxsim::smem_u32(lo_slab) + wg * 64 * QA_SLAB;
          const uint32_t vr = maxsim::smem_u32(raw) + rows_p * QA_SLAB;
          const uint32_t vl = maxsim::smem_u32(lo_slab) + rows_p * QA_SLAB;
          fence_regs(c);
          maxsim::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < QA_SLAB; ks += 32) {
            wgmma_tf32(c, maxsim::smem_desc(xl + ks, QA_SLAB),
                       maxsim::smem_desc(vr + ks, QA_SLAB));
            wgmma_tf32(c, maxsim::smem_desc(xr + ks, QA_SLAB),
                       maxsim::smem_desc(vl + ks, QA_SLAB));
            wgmma_tf32(c, maxsim::smem_desc(xr + ks, QA_SLAB),
                       maxsim::smem_desc(vr + ks, QA_SLAB));
          }
          maxsim::wgmma_commit();
          maxsim::wgmma_wait_all();
          fence_regs(c);
        }
        __syncthreads();  // this buffer's readers are done before it refills
      }
      // U to us: this thread holds rows ra and ra + 8 of its warpgroup's
      // tile, columns 8 i + 2 (lane % 4) + {0, 1}
      if (busy) {
        const int ra = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
#pragma unroll
        for (int i = 0; i < QA_COLS / 8; ++i) {
          float* u = us + ra * QA_UP + 8 * i + 2 * (lane % 4);
          *reinterpret_cast<float2*>(u) = make_float2(c[4 * i], c[4 * i + 1]);
          *reinterpret_cast<float2*>(u + 8 * QA_UP) =
              make_float2(c[4 * i + 2], c[4 * i + 3]);
        }
      }
      __syncthreads();
      if (owner) {
        // acc[8 r + c] += Gx[r][k] U[k][c], k in order
        const float* gp = gs + cs * k_rows * gcols + 4 * rg;
        const float* u = us + cs * k_rows * QA_UP + 8 * cg;
        for (int k = 0; k < kh; ++k) {
          const float4 gv = ld4(gp + k * gcols);
          const float4 u0 = ld4(u + k * QA_UP), u1 = ld4(u + k * QA_UP + 4);
          const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
          const float uc[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 8; ++cc)
              acc[8 * r + cc] = fmaf(gr[r], uc[cc], acc[8 * r + cc]);
        }
      }
      __syncthreads();  // us and gs are read before the next copies
    }
  }
  if (!owner || cs >= s_here) return;
  float* o = out + ((size_t)(n0 + cs) * rn + r0) * d + c0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (4 * rg + r >= rh) continue;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      if (8 * cg + cc < te)
        o[(size_t)(4 * rg + r) * d + 8 * cg + cc] = acc[8 * r + cc];
  }
}

__global__ void __launch_bounds__(QA_THREADS, 2)
pair_maps_bwd_qa_kernel(const float* __restrict__ q,
                        const float* __restrict__ a,
                        const float* __restrict__ w,
                        const float* __restrict__ g,
                        float* __restrict__ part, size_t part_stride,
                        int n_count, int w1, int w2, int d, int m_count,
                        int m_per, int te_max, QaRole role_q,
                        QaRole role_a) {
  if (blockIdx.z % 2 == 0)
    qa_body<true>(q, a, w, g, part, part_stride, n_count, w1, w2, d, m_count,
                  m_per, te_max, role_q, role_a);
  else
    qa_body<false>(q, a, w, g, part, part_stride, n_count, w1, w2, d,
                   m_count, m_per, te_max, role_q, role_a);
}

// The panel dW[m0..m0+3][d0..d0+d_rows, e0..e0+te] of blockIdx = (panel,
// chunk, measure group), summed over the chunk's samples [s * n_per,
// (s + 1) * n_per) in sample order, and over each sample's W1 rows in
// tiles of w1_max in row order, into out[s] (the partials, or dW itself
// when there is one chunk).  Each (sample, W1 tile)'s q_n rows, G_n rows
// and a_n columns are staged into one of two buffers while the other
// one's are multiplied.
__global__ void __launch_bounds__(MAX_THREADS)
pair_maps_bwd_w_kernel(const float* __restrict__ q,
                       const float* __restrict__ a,
                       const float* __restrict__ g, float* __restrict__ out,
                       int n_count, int n_per, int w1, int w2, int d,
                       int m_count, int d_rows, int te_max, int w1_max) {
  extern __shared__ float4 smem4[];
  const int e_slices = (d + te_max - 1) / te_max;
  const int d0 = (blockIdx.x / e_slices) * d_rows;
  const int e0 = (blockIdx.x % e_slices) * te_max;
  const int dr = min(d_rows, d - d0), te = min(te_max, d - e0);
  const int m0 = blockIdx.z * MS, ms_here = min(MS, m_count - m0);
  const int dr8 = round8(d_rows);
  const int tid = threadIdx.x, nt = blockDim.x;
  // per buffer: qs [w1_max][dr8] (q_n[i-tile, d-rows]), gs
  // [w1_max][w2][MS] (G_n's tile rows), as [w2][te_max] (a_n[:, e-slice]);
  // then ts [w1_max][MS][te_max] (G_m a_n on the tile's rows)
  const int w1_tiles = (w1 + w1_max - 1) / w1_max;
  const int n_begin = blockIdx.y * n_per;
  const int buf = w1_max * dr8 + w1_max * w2 * MS + w2 * te_max;
  float* smem = reinterpret_cast<float*>(smem4);
  float* ts = smem + 2 * buf;

  // t tiles (any number, looped over, 4 x 4): row i, the MS measures x
  // columns eg*4..; panel tile (one per thread, 8 x 8): rows dg*4.. and
  // dr8/2 + dg*4.., columns eg*4.. and te_max/2 + eg*4.. of measure ms.
  const int eg_n = te_max / 4, dg_n = dr8 / 8;
  const int tiles_w = te_max / 8 * dg_n * MS;
  const int egw = tid % (te_max / 8), dgw = (tid / (te_max / 8)) % dg_n;
  const int msw = tid / (te_max / 8 * dg_n);

  // 16-byte copies where every row and slice start is aligned
  const bool g_vec =
      m_count == MS && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const int qv = d_rows % 4 == 0 ? copy_width(q, d)
                 : d_rows % 2 == 0 ? min(2, copy_width(q, d)) : 1;
  const int av = copy_width(a, d);
  // item x: sample n_begin + x / w1_tiles, its W1 tile x % w1_tiles
  auto stage = [&](int x_item, float* qs) {
    const int n = n_begin + x_item / w1_tiles;
    const int i0 = (x_item % w1_tiles) * w1_max, w1h = min(w1_max, w1 - i0);
    float* gs = qs + w1_max * dr8;
    float* as = gs + w1_max * w2 * MS;
    copy_rows(qv, qs, dr8, q + ((size_t)n * w1 + i0) * d + d0, d, w1h, dr8,
              dr, tid, nt);
    const size_t gn = ((size_t)n * w1 + i0) * w2;
    if (g_vec) {
      for (int x = tid; x < w1h * w2; x += nt)
        cp_async<16>(gs + x * MS, g + (gn + x) * MS, true);
    } else {
      for (int x = tid; x < w1h * w2 * MS; x += nt) {
        const int ms = x % MS;
        cp_async<4>(gs + x,
                  ms < ms_here ? g + (gn + x / MS) * m_count + m0 + ms : g,
                  ms < ms_here);
      }
    }
    copy_rows(av, as, te_max, a + (size_t)n * w2 * d + e0, d, w2, te_max, te,
              tid, nt);
  };

  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;

  const int items = (min(n_count, n_begin + n_per) - n_begin) * w1_tiles;
  stage(0, smem);
  cp_async_commit();
  for (int x = 0; x < items; ++x) {
    float* qs = smem + (x & 1) * buf;
    if (x + 1 < items) {
      stage(x + 1, smem + ((x + 1) & 1) * buf);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int w1h = min(w1_max, w1 - (x % w1_tiles) * w1_max);
    const float* gs = qs + w1_max * dr8;
    const float* as = gs + w1_max * w2 * MS;
    for (int t = tid; t < w1h * eg_n; t += nt) {
      const int i = t / eg_n, eg = t % eg_n;
      float v[16];  // [ms][e]
#pragma unroll
      for (int c = 0; c < 16; ++c) v[c] = 0.f;
      product4(v, gs + i * w2 * MS, MS, as + eg * 4, te_max, w2);
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
        *reinterpret_cast<float4*>(ts + (i * MS + ms) * te_max + eg * 4) =
            make_float4(v[ms * 4], v[ms * 4 + 1], v[ms * 4 + 2],
                        v[ms * 4 + 3]);
    }
    __syncthreads();
    if (tid < tiles_w)
      product8(acc, qs + dgw * 4, dr8, dr8 / 2,
               ts + msw * te_max + egw * 4, MS * te_max, te_max / 2, w1h);
    __syncthreads();  // this buffer's and ts's readers are done
  }

  if (tid >= tiles_w || msw >= ms_here) return;
  float* dw = out + (size_t)blockIdx.y * m_count * d * d;
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int r = rr / 4 * (dr8 / 2) + dgw * 4 + rr % 4;
    if (r >= dr) continue;
    float* row = dw + ((size_t)(m0 + msw) * d + d0 + r) * d + e0;
#pragma unroll
    for (int ee = 0; ee < 8; ++ee) {
      const int c = ee / 4 * (te_max / 2) + egw * 4 + ee % 4;
      if (c < te) row[c] = acc[rr * 8 + ee];
    }
  }
}

// out = the sum of the partials (dW's chunks, the forward's column tiles),
// in order.
__global__ void __launch_bounds__(NT)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int chunks, size_t size) {
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(size_t)c * size + i];
  out[i] = s;
}

bool shape_ok(int n, int w1, int w2, int d, int m) {
  return n > 0 && w1 > 0 && w2 > 0 && d > 0 && m > 0 && m <= 65535;
}

// The launch geometry the wrapper chose: threads a multiple of 32 up to
// MAX_THREADS, column tiles a multiple of 8, one 8 x 8 tile of each
// product per thread, and the shared memory within one block's.
bool geometry_ok(int threads, int te, int tiles_a, int tiles_b, size_t smem) {
  return threads > 0 && threads <= MAX_THREADS && threads % 32 == 0 &&
         te > 0 && te % 8 == 0 && tiles_a <= threads && tiles_b <= threads &&
         smem <= SMEM_MAX;
}

// A dQ or dA plan (kn rows of x a sample, rn output rows): whole samples
// of k_rows = K, or one sample in chunks of k_rows, up to QA_ROWS rows of
// x; a 4 x 8 output tile per thread; the shared memory within a block's.
bool qa_plan_ok(int n, int kn, int rn, int d, int samples, int k_rows,
                int r_rows, int te) {
  return samples >= 1 && samples <= n && k_rows >= 1 && k_rows <= kn &&
         (samples == 1 || k_rows == kn) && samples * k_rows <= QA_ROWS &&
         r_rows >= 1 && r_rows <= rn && te >= 8 && te <= 64 && te % 8 == 0 &&
         samples * ((r_rows + 3) / 4) * (te / 8) <= QA_THREADS &&
         (long long)cdiv(rn, r_rows) * cdiv(d, te) <= 65535 &&
         qa_smem(samples, k_rows, r_rows) <= SMEM_MAX;
}

int set_device(int device) { return (int)cudaSetDevice(device); }

int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// rows: rows of q_n per block (W1 split in ceil(W1 / rows) parts); te:
// columns of P = q_n W_m per block; w2t: columns of out per block (W2
// split in ceil(W2 / w2t) tiles); with ceil(D / te) > 1 column tiles,
// part holds one partial map per tile (unused otherwise), summed by a
// second kernel; threads: block size.
extern "C" int pair_maps_fwd(const void* q, const void* a, const void* w,
                             void* out, void* part, int n, int w1, int w2,
                             int d, int m, int rows, int te, int w2t,
                             int threads, int device, void* stream) {
  if (!shape_ok(n, w1, w2, d, m) || rows <= 0 || rows > w1 || te <= 0 ||
      w2t <= 0 || w2t > w2 ||
      (long long)cdiv(w1, rows) * cdiv(d, te) * cdiv(w2, w2t) > 65535)
    return (int)cudaErrorInvalidValue;
  // MFW column fragments of P^T per warp, at most MAX_NF row fragments,
  // one product-2 tile per thread
  const size_t smem = fwd_smem(rows, w2t, te);
  const int fragments = cdiv(MS * te / 16, MFW) * 32;
  const int tiles2 = round8(rows) / 2 * (round8(w2t) / 8);
  if (round8(rows) / 8 > MAX_NF ||
      !geometry_ok(threads, te, fragments, tiles2, smem))
    return (int)cudaErrorInvalidValue;
  if (int err = set_device(device)) return err;
  if (int err = allow_smem((const void*)pair_maps_fwd_kernel, smem))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e_tiles = cdiv(d, te);
  float* dst = static_cast<float*>(e_tiles > 1 ? part : out);
  pair_maps_fwd_kernel<<<dim3(n, cdiv(w1, rows) * e_tiles * cdiv(w2, w2t),
                              cdiv(m, MS)),
                         threads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(a),
      static_cast<const float*>(w), dst, n, w1, w2, d, m, rows, te, w2t);
  if (e_tiles > 1) {
    const size_t size = (size_t)n * w1 * w2 * m;
    if (int err = (int)cudaGetLastError()) return err;
    sum_partials_kernel<<<(unsigned)((size + NT - 1) / NT), NT, 0, s>>>(
        dst, static_cast<float*>(out), e_tiles, size);
  }
  return (int)cudaGetLastError();
}

// te: output columns per block; then for dQ and for dA, samples per block,
// rows of x per chunk and output rows per block
// (sim_cross_kernels.pair_maps_bwd_qa_geometry): two launches, dQ's then
// dA's.
// out: dQ (N, W1, D) then dA (N, W2, D); te: output columns per block;
// m_per: measures per group (part holds one partial output per group,
// summed in group order into out, when there is more than one); then for
// dQ and for dA, samples per block, rows of x per chunk and output rows
// per block (sim_cross_kernels.pair_maps_bwd_qa_geometry).
extern "C" int pair_maps_bwd_qa(const void* q, const void* a, const void* w,
                                const void* g, void* out, void* part, int n,
                                int w1, int w2, int d, int m, int te,
                                int m_per, int q_samples, int q_k_rows,
                                int q_r_rows, int a_samples, int a_k_rows,
                                int a_r_rows, int device, void* stream) {
  if (!shape_ok(n, w1, w2, d, m) || m_per < 1 || m_per > m ||
      !qa_plan_ok(n, w2, w1, d, q_samples, q_k_rows, q_r_rows, te) ||
      !qa_plan_ok(n, w1, w2, d, a_samples, a_k_rows, a_r_rows, te))
    return (int)cudaErrorInvalidValue;
  if (int err = set_device(device)) return err;
  const size_t smem = std::max(qa_smem(q_samples, q_k_rows, q_r_rows),
                               qa_smem(a_samples, a_k_rows, a_r_rows));
  if (int err = allow_smem((const void*)pair_maps_bwd_qa_kernel, smem))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = cdiv(m, m_per);
  const size_t size = (size_t)n * (w1 + w2) * d;
  float* dst = static_cast<float*>(groups > 1 ? part : out);
  const dim3 grid(
      std::max(cdiv(n, q_samples), cdiv(n, a_samples)),
      std::max(cdiv(w1, q_r_rows), cdiv(w2, a_r_rows)) * cdiv(d, te),
      2 * groups);
  pair_maps_bwd_qa_kernel<<<grid, QA_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(a),
      static_cast<const float*>(w), static_cast<const float*>(g), dst, size,
      n, w1, w2, d, m, m_per, te, QaRole{q_samples, q_k_rows, q_r_rows},
      QaRole{a_samples, a_k_rows, a_r_rows});
  if (groups > 1) {
    if (int err = (int)cudaGetLastError()) return err;
    sum_partials_kernel<<<(unsigned)((size + NT - 1) / NT), NT, 0, s>>>(
        dst, static_cast<float*>(out), groups, size);
  }
  return (int)cudaGetLastError();
}

// n_per: samples per chunk; part: scratch for the ceil(n / n_per) partial
// dW when there is more than one chunk (unused otherwise), summed by a
// second kernel; d_rows x te: the panel of dW per block; w1t: rows of a
// sample's W1 tile; threads: block size.
extern "C" int pair_maps_bwd_w(const void* q, const void* a, const void* g,
                               void* dw, void* part, int n, int w1, int w2,
                               int d, int m, int n_per, int d_rows, int te,
                               int w1t, int threads, int device,
                               void* stream) {
  if (!shape_ok(n, w1, w2, d, m) || n_per <= 0 || d_rows <= 0 ||
      d_rows > d || w1t <= 0 || w1t > w1 || cdiv(n, n_per) > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_w_smem(w1t, w2, d_rows, te);
  if (!geometry_ok(threads, te, round8(d_rows) / 8 * (te / 8) * MS, 0,
                   smem))
    return (int)cudaErrorInvalidValue;
  if (int err = set_device(device)) return err;
  if (int err = allow_smem((const void*)pair_maps_bwd_w_kernel, smem))
    return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = cdiv(n, n_per);
  const int panels = cdiv(d, d_rows) * cdiv(d, te);
  float* out = static_cast<float*>(chunks > 1 ? part : dw);
  pair_maps_bwd_w_kernel<<<dim3(panels, chunks, cdiv(m, MS)), threads, smem,
                           s>>>(
      static_cast<const float*>(q), static_cast<const float*>(a),
      static_cast<const float*>(g), out, n, n_per, w1, w2, d, m, d_rows, te,
      w1t);
  if (chunks > 1) {
    const size_t size = (size_t)m * d * d;
    if (int err = (int)cudaGetLastError()) return err;
    sum_partials_kernel<<<(unsigned)((size + NT - 1) / NT), NT, 0, s>>>(
        out, static_cast<float*>(dw), chunks, size);
  }
  return (int)cudaGetLastError();
}
