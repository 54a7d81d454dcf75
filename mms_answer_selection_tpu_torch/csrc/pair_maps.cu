// Pair maps of the learned bilinear metric, forward and backward.
//
// Replaces: mms_answer_selection_tpu/ops/sim_cross_pallas.py,
// _pair_map_kernel (reached through _pair_maps_forward and
// bilinear_pair_maps), and the closed-form backward of its custom_vjp,
// _pair_maps_bwd.
//
// Forward   out[n, i, j, m] = sum_d sum_e q[n, i, d] W[m, d, e] a[n, j, e]
// Backward, with G = dL/dout in the same NHWC (N, W1, W2, M) layout:
//   dQ[n, i, d] = sum_m sum_j G[n, i, j, m] (a_n W_m^T)[j, d]
//   dA[n, j, e] = sum_m sum_i G[n, i, j, m] (q_n W_m)[i, e]
//   dW[m, d, e] = sum_n sum_i q[n, i, d] (G_m a_n)[i, e]
// All in float32 with float32 FMAs on the CUDA cores: the reference runs
// these products at Precision.HIGHEST, which TF32 tensor cores would not
// match (about three decimal digits).
//
// What bounds it on the H100: nothing here is large.  At V4 (W1 = W2 = 40,
// D = 50, M = 4) and batch 50 the forward is 36 M FMAs and writes 1.3 MB;
// at the CUDA cores' float32 rate that is microseconds of arithmetic.  So
// the chain of two small dependent products inside each block, the
// shared-memory reads feeding each FMA, launch latency, and at batch 50 the
// number of blocks (200 forward blocks on 132 SMs) bound it.
//
// What the design does about it: each product is a chain of two small
// GEMMs whose intermediate (q_n W_m, G_m a_n or G_m^T q_n) stays in shared
// memory, 32 columns of D at a time, so only the operands and the result
// cross device memory, and D = 300 (V4_WIDE) runs in the same static
// shared memory (under 38 KB) as D = 50.  Each thread owns fixed output
// elements and sums them in registers in a fixed order.  dW sums across
// samples in a fixed order, with no atomics, so two runs give the same
// bits: each block sums a chunk of the batch in sample order into a
// partial, and a second kernel adds the partials in chunk order.  Shared
// tiles carry one padding float per row against bank conflicts.  wgmma,
// TMA and a register-tiled inner loop are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TD = 32;                      // columns of D staged at a time
constexpr int MAXW = 64;                    // largest W1, W2 taken
constexpr int NT = 256;                     // threads per block
constexpr int OUT_PER_T = MAXW * MAXW / NT;  // (W1 x W2) outputs per thread
constexpr int SLICE_PER_T = MAXW * TD / NT;  // (W x TD) slice per thread
constexpr int W_PER_T = TD * TD / NT;        // (TD x TD) dW tile per thread

// out[n, :, :, m] for one (n, m) per block.
__global__ void __launch_bounds__(NT)
pair_maps_fwd_kernel(const float* __restrict__ q, const float* __restrict__ a,
                     const float* __restrict__ w, float* __restrict__ out,
                     int w1, int w2, int d, int m_count) {
  __shared__ float qs[MAXW][TD + 1];   // q_n[:, d-slice]
  __shared__ float ws[TD][TD + 1];     // W_m[d-slice, e-slice]
  __shared__ float qws[MAXW][TD + 1];  // (q_n W_m)[:, e-slice]
  __shared__ float as[MAXW][TD + 1];   // a_n[:, e-slice]
  const int n = blockIdx.x, m = blockIdx.y, tid = threadIdx.x;
  const float* qn = q + (size_t)n * w1 * d;
  const float* an = a + (size_t)n * w2 * d;
  const float* wm = w + (size_t)m * d * d;
  const int n_out = w1 * w2, n_slice = w1 * TD;

  float acc[OUT_PER_T];
#pragma unroll
  for (int k = 0; k < OUT_PER_T; ++k) acc[k] = 0.f;

  for (int e0 = 0; e0 < d; e0 += TD) {
    const int te = min(TD, d - e0);
    float qw[SLICE_PER_T];
#pragma unroll
    for (int k = 0; k < SLICE_PER_T; ++k) qw[k] = 0.f;
    for (int d0 = 0; d0 < d; d0 += TD) {
      const int td = min(TD, d - d0);
      __syncthreads();
      for (int x = tid; x < n_slice; x += NT) {
        const int i = x / TD, c = x % TD;
        qs[i][c] = c < td ? qn[(size_t)i * d + d0 + c] : 0.f;
      }
      for (int x = tid; x < TD * TD; x += NT) {
        const int r = x / TD, c = x % TD;
        ws[r][c] = (r < td && c < te) ? wm[(size_t)(d0 + r) * d + e0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SLICE_PER_T; ++k) {
        const int x = tid + k * NT;
        if (x < n_slice) {
          const int i = x / TD, e = x % TD;
          float s = qw[k];
          for (int dd = 0; dd < td; ++dd) s = fmaf(qs[i][dd], ws[dd][e], s);
          qw[k] = s;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SLICE_PER_T; ++k) {
      const int x = tid + k * NT;
      if (x < n_slice) qws[x / TD][x % TD] = qw[k];
    }
    for (int x = tid; x < w2 * TD; x += NT) {
      const int j = x / TD, c = x % TD;
      as[j][c] = c < te ? an[(size_t)j * d + e0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < OUT_PER_T; ++k) {
      const int x = tid + k * NT;
      if (x < n_out) {
        const int i = x / w2, j = x % w2;
        float s = acc[k];
        for (int ee = 0; ee < te; ++ee) s = fmaf(qws[i][ee], as[j][ee], s);
        acc[k] = s;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < OUT_PER_T; ++k) {
    const int x = tid + k * NT;
    if (x < n_out)
      out[((size_t)n * n_out + x) * m_count + m] = acc[k];
  }
}

// One 32-column slice of dQ[n] (blockIdx.z == 0) or dA[n] (== 1) per block.
// dQ[n, :, c] = sum_m (G_m a_n) W_m[c, :]^T, dA[n, :, c] = sum_m (G_m^T q_n)
// W_m[:, c]: the intermediate t = G_m x_n (x = a for dQ, q for dA) is
// formed 32 columns of the contracted D axis at a time.
__global__ void __launch_bounds__(NT)
pair_maps_bwd_qa_kernel(const float* __restrict__ q,
                        const float* __restrict__ a,
                        const float* __restrict__ w,
                        const float* __restrict__ g, float* __restrict__ dq,
                        float* __restrict__ da, int w1, int w2, int d,
                        int m_count) {
  __shared__ float gs[MAXW][MAXW + 1];  // G_m (dQ) or G_m^T (dA), rows x inner
  __shared__ float xs[MAXW][TD + 1];    // x_n[:, k-slice]
  __shared__ float ts[MAXW][TD + 1];    // t[:, k-slice]
  __shared__ float ws[TD][TD + 1];      // ws[kk][cc]: W_m at (c, k) or (k, c)
  const int n = blockIdx.x, c0 = blockIdx.y * TD, tid = threadIdx.x;
  const bool for_q = blockIdx.z == 0;
  const int tc = min(TD, d - c0);
  const int rows = for_q ? w1 : w2;   // rows of the output slice and of t
  const int inner = for_q ? w2 : w1;  // the axis G contracts with x_n
  const float* xn = for_q ? a + (size_t)n * w2 * d : q + (size_t)n * w1 * d;
  const int n_slice = rows * TD;

  float acc[SLICE_PER_T];
#pragma unroll
  for (int k = 0; k < SLICE_PER_T; ++k) acc[k] = 0.f;

  for (int m = 0; m < m_count; ++m) {
    __syncthreads();
    for (int x = tid; x < w1 * w2; x += NT) {
      const int i = x / w2, j = x % w2;
      const float v = g[((size_t)n * w1 * w2 + x) * m_count + m];
      if (for_q) gs[i][j] = v; else gs[j][i] = v;
    }
    for (int k0 = 0; k0 < d; k0 += TD) {
      const int tk = min(TD, d - k0);
      __syncthreads();
      for (int x = tid; x < inner * TD; x += NT) {
        const int r = x / TD, c = x % TD;
        xs[r][c] = c < tk ? xn[(size_t)r * d + k0 + c] : 0.f;
      }
      const float* wm = w + (size_t)m * d * d;
      for (int x = tid; x < TD * TD; x += NT) {
        // consecutive threads read consecutive addresses of W_m
        const int hi = x / TD, lo = x % TD;
        if (for_q)   // dQ: W_m[d = c0 + hi, e = k0 + lo]
          ws[lo][hi] = (hi < tc && lo < tk)
                           ? wm[(size_t)(c0 + hi) * d + k0 + lo] : 0.f;
        else         // dA: W_m[d = k0 + hi, e = c0 + lo]
          ws[hi][lo] = (hi < tk && lo < tc)
                           ? wm[(size_t)(k0 + hi) * d + c0 + lo] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SLICE_PER_T; ++k) {
        const int x = tid + k * NT;
        if (x < n_slice) {
          const int r = x / TD, kk = x % TD;
          float s = 0.f;
          for (int v = 0; v < inner; ++v) s = fmaf(gs[r][v], xs[v][kk], s);
          ts[r][kk] = s;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SLICE_PER_T; ++k) {
        const int x = tid + k * NT;
        if (x < n_slice) {
          const int r = x / TD, cc = x % TD;
          float s = acc[k];
          for (int kk = 0; kk < tk; ++kk) s = fmaf(ts[r][kk], ws[kk][cc], s);
          acc[k] = s;
        }
      }
    }
  }
  float* out = (for_q ? dq : da) + (size_t)n * rows * d;
#pragma unroll
  for (int k = 0; k < SLICE_PER_T; ++k) {
    const int x = tid + k * NT;
    if (x < n_slice) {
      const int r = x / TD, cc = x % TD;
      if (cc < tc) out[(size_t)r * d + c0 + cc] = acc[k];
    }
  }
}

// One 32 x 32 tile of dW[m] per block, summed over one chunk of the batch
// (samples [s * n_per, (s + 1) * n_per), blockIdx.y = s) in sample order,
// written to out[s] (the partials, or dW itself when there is one chunk).
__global__ void __launch_bounds__(NT)
pair_maps_bwd_w_kernel(const float* __restrict__ q,
                       const float* __restrict__ a,
                       const float* __restrict__ g, float* __restrict__ out,
                       int n_count, int n_per, int w1, int w2, int d,
                       int m_count) {
  __shared__ float gs[MAXW][MAXW + 1];  // G[n, :, :, m]
  __shared__ float as[MAXW][TD + 1];    // a_n[:, e-slice]
  __shared__ float qs[MAXW][TD + 1];    // q_n[:, d-slice]
  __shared__ float ts[MAXW][TD + 1];    // (G_m a_n)[:, e-slice]
  const int tiles = (d + TD - 1) / TD;
  const int d0 = (blockIdx.x / tiles) * TD, e0 = (blockIdx.x % tiles) * TD;
  const int m = blockIdx.z, tid = threadIdx.x;
  const int td = min(TD, d - d0), te = min(TD, d - e0);
  const int n_end = min(n_count, (int)(blockIdx.y + 1) * n_per);
  float* dw = out + (size_t)blockIdx.y * m_count * d * d;

  float acc[W_PER_T];
#pragma unroll
  for (int k = 0; k < W_PER_T; ++k) acc[k] = 0.f;

  for (int n = blockIdx.y * n_per; n < n_end; ++n) {
    __syncthreads();
    for (int x = tid; x < w1 * w2; x += NT)
      gs[x / w2][x % w2] = g[((size_t)n * w1 * w2 + x) * m_count + m];
    for (int x = tid; x < w2 * TD; x += NT) {
      const int j = x / TD, c = x % TD;
      as[j][c] = c < te ? a[((size_t)n * w2 + j) * d + e0 + c] : 0.f;
    }
    for (int x = tid; x < w1 * TD; x += NT) {
      const int i = x / TD, c = x % TD;
      qs[i][c] = c < td ? q[((size_t)n * w1 + i) * d + d0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SLICE_PER_T; ++k) {
      const int x = tid + k * NT;
      if (x < w1 * TD) {
        const int i = x / TD, e = x % TD;
        float s = 0.f;
        for (int j = 0; j < w2; ++j) s = fmaf(gs[i][j], as[j][e], s);
        ts[i][e] = s;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < W_PER_T; ++k) {
      const int x = tid + k * NT;
      const int dd = x / TD, ee = x % TD;
      float s = acc[k];
      for (int i = 0; i < w1; ++i) s = fmaf(qs[i][dd], ts[i][ee], s);
      acc[k] = s;
    }
  }
#pragma unroll
  for (int k = 0; k < W_PER_T; ++k) {
    const int x = tid + k * NT;
    const int dd = x / TD, ee = x % TD;
    if (dd < td && ee < te)
      dw[((size_t)m * d + d0 + dd) * d + e0 + ee] = acc[k];
  }
}

// dW = sum of the chunks' partials, in chunk order.
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
  return n > 0 && w1 > 0 && w2 > 0 && d > 0 && m > 0 && w1 <= MAXW &&
         w2 <= MAXW && m <= 65535 && d <= 65535 * TD;
}

int set_device(int device) { return (int)cudaSetDevice(device); }

}  // namespace

extern "C" int pair_maps_fwd(const void* q, const void* a, const void* w,
                             void* out, int n, int w1, int w2, int d, int m,
                             int device, void* stream) {
  if (!shape_ok(n, w1, w2, d, m)) return (int)cudaErrorInvalidValue;
  if (int err = set_device(device)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_maps_fwd_kernel<<<dim3(n, m), NT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(a),
      static_cast<const float*>(w), static_cast<float*>(out), w1, w2, d, m);
  return (int)cudaGetLastError();
}

extern "C" int pair_maps_bwd_qa(const void* q, const void* a, const void* w,
                                const void* g, void* dq, void* da, int n,
                                int w1, int w2, int d, int m, int device,
                                void* stream) {
  if (!shape_ok(n, w1, w2, d, m)) return (int)cudaErrorInvalidValue;
  if (int err = set_device(device)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_maps_bwd_qa_kernel<<<dim3(n, (d + TD - 1) / TD, 2), NT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(a),
      static_cast<const float*>(w), static_cast<const float*>(g),
      static_cast<float*>(dq), static_cast<float*>(da), w1, w2, d, m);
  return (int)cudaGetLastError();
}

// part: scratch for ceil(n / n_per) partial dW when there is more than one
// chunk (unused otherwise); the sum over chunks runs in a second kernel.
extern "C" int pair_maps_bwd_w(const void* q, const void* a, const void* g,
                               void* dw, void* part, int n, int w1, int w2,
                               int d, int m, int n_per, int device,
                               void* stream) {
  if (!shape_ok(n, w1, w2, d, m) || n_per <= 0)
    return (int)cudaErrorInvalidValue;
  if (int err = set_device(device)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (d + TD - 1) / TD, chunks = (n + n_per - 1) / n_per;
  float* out = static_cast<float*>(chunks > 1 ? part : dw);
  pair_maps_bwd_w_kernel<<<dim3(tiles * tiles, chunks, m), NT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(a),
      static_cast<const float*>(g), out, n, n_per, w1, w2, d, m);
  if (chunks > 1) {
    const size_t size = (size_t)m * d * d;
    if (int err = (int)cudaGetLastError()) return err;
    sum_partials_kernel<<<(unsigned)((size + NT - 1) / NT), NT, 0, s>>>(
        out, static_cast<float*>(dw), chunks, size);
  }
  return (int)cudaGetLastError();
}
