// int8 and int4 MaxSim scorers for the learned bilinear metric.
//
// Replaces: mms_answer_selection_tpu/ops/sim_cross_pallas.py,
// _maxsim_int8_tokmaj_kernel (the serving default, reached through
// bilinear_maxsim_scores_int8(layout="tokmaj")), and by its scores
// _maxsim_int8_kernel (layout="candmaj"), which computes the same numbers;
// and bilinear_maxsim_scores_int4, which runs those bodies on +-7 codes.
//
// Computes out[q, c] = sum_r ((max_j dot32(qw[q, r], pool[c, j])) * sq[q, r])
//                      * sc[c]  +  mask[c]
// where dot32 is the exact int32 dot product of two int8 rows, the max runs
// on those raw int32 values before any scale, sq is the query row's scale
// and sc the candidate's, both already rounded to bf16 (sq arrives as f32
// holding bf16 values; sc and mask are lanes 0 and 1 of the (C, 2) bf16 aux
// array).  The products are rounded in that order, as the reference does.
// Padded token rows duplicate token 0, so they never change a max, and
// masked candidates have sc = 0 and mask = -1e30.
//
// What bounds it on the H100: arithmetic, as for the bf16 kernel: 2 * R *
// W2P * Dp integer ops per pair (819 kop at R=160, W2P=40, Dp=64) against a
// 2.5 KB candidate reused by every query in the batch.
//
// What the design does about it: the products run on the tensor cores
// (mma.sync m16n8k32, s8 in, s32 accumulate), at twice the bf16 rate.  The
// layout is the bf16 kernel's: a shared-memory tile of candidates (rows
// padded by 16 bytes against bank conflicts) reused by every warp, A
// fragments of 32 query rows held in registers across the tile, the token
// max folded on int32 in registers and across the quad, the two scales
// applied once per (row, candidate) after the max, and the row sum reduced
// across the warp in a fixed order.  No similarity value leaves registers.
//
// int4 (maxsim_int4): the pool holds two 4-bit two's-complement codes per
// byte (lane 2i low nibble, lane 2i+1 high), so a candidate is Dp/2 bytes
// per token, half of int8's bytes read.  The staging loop reads 16 packed
// bytes at a time and sign-extends the 32 nibbles into the same padded int8
// tile; from there the int8 path runs unchanged, so the scores equal the
// int8 kernel's on the unpacked codes, bit for bit.  What bounds it is
// still the tensor-core work: Hopper's wgmma has no 4-bit input and the
// H100 data sheet gives no int4 tensor-core rate, so int4 buys capacity and
// bytes read, not operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 packed nibbles (lane k in bits 4k..4k+3) -> 8 sign-extended int8 lanes:
// lanes 0-3 in lo, 4-7 in hi
__device__ __forceinline__ void unpack8(uint32_t w, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t even = w & 0x0F0F0F0Fu;         // lanes 0, 2, 4, 6
  const uint32_t odd = (w >> 4) & 0x0F0F0F0Fu;   // lanes 1, 3, 5, 7
  // per byte: (n ^ 8) - 8 sign-extends a 4-bit value
  const uint32_t e = __vsub4(even ^ 0x08080808u, 0x08080808u);
  const uint32_t o = __vsub4(odd ^ 0x08080808u, 0x08080808u);
  lo = __byte_perm(e, o, 0x5140);  // e0 o0 e1 o1
  hi = __byte_perm(e, o, 0x7362);  // e2 o2 e3 o3
}

// D += A (16x32, row-major) * B (32x8, column-major), s8 -> s32
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// KS: 32-lane k-steps along Dp (Dp = 32 * KS).  Same block shape as the
// bf16 kernel: tc <= 32 candidates per tile, lane j owns candidate j.
// PACKED4: the pool holds two int4 codes per byte (Dp/2 bytes per token).
template <int KS, bool PACKED4>
__global__ void __launch_bounds__(256)
maxsim_int8_kernel(const int8_t* __restrict__ qw,
                   const float* __restrict__ qs,
                   const uint8_t* __restrict__ pool,
                   const __nv_bfloat16* __restrict__ aux,
                   float* __restrict__ out, int nq, int r, int c, int w2p,
                   int tc, int q_per_block) {
  constexpr int DP = KS * 32;
  constexpr int SROW = DP + 16;  // bytes per staged token row
  constexpr int CH = DP / 16;    // 16-byte chunks per token row
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* tile = reinterpret_cast<int8_t*>(smem);

  const int c0 = blockIdx.x * tc;
  const int n_c = min(tc, c - c0);
  if constexpr (PACKED4) {
    // 16 packed bytes -> 32 int8 lanes of the staged row
    constexpr int PCH = DP / 32;  // 16-byte packed chunks per token row
    const uint4* src =
        reinterpret_cast<const uint4*>(pool + (size_t)c0 * w2p * (DP / 2));
    for (int i = threadIdx.x; i < n_c * w2p * PCH; i += blockDim.x) {
      const int row = i / PCH;
      const uint4 v = src[i];
      uint4 a, b;
      unpack8(v.x, a.x, a.y);
      unpack8(v.y, a.z, a.w);
      unpack8(v.z, b.x, b.y);
      unpack8(v.w, b.z, b.w);
      uint4* dst =
          reinterpret_cast<uint4*>(tile + row * SROW + (i - row * PCH) * 32);
      dst[0] = a;
      dst[1] = b;
    }
  } else {
    const uint4* src =
        reinterpret_cast<const uint4*>(pool + (size_t)c0 * w2p * DP);
    for (int i = threadIdx.x; i < n_c * w2p * CH; i += blockDim.x) {
      const int row = i / CH;
      *reinterpret_cast<uint4*>(tile + row * SROW + (i - row * CH) * 16) =
          src[i];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = w2p >> 3;
  const int q_end = min(nq, (int)(blockIdx.y + 1) * q_per_block);
  for (int q = blockIdx.y * q_per_block + warp; q < q_end; q += nwarps) {
    const int8_t* qrow = qw + (size_t)q * r * DP;
    const float* qsrow = qs + (size_t)q * r;
    float acc = 0.f;
    for (int r0 = 0; r0 < r; r0 += 32) {
      // rows past R get zero codes and a zero scale: they add 0
      uint32_t a[2][KS][4];
      float sq[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int ra = r0 + mt * 16 + g, rb = ra + 8;
        sq[mt][0] = ra < r ? qsrow[ra] : 0.f;
        sq[mt][1] = rb < r ? qsrow[rb] : 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int col = ks * 32 + t * 4;
          a[mt][ks][0] = ra < r ? ld_u32(qrow + (size_t)ra * DP + col) : 0u;
          a[mt][ks][1] = rb < r ? ld_u32(qrow + (size_t)rb * DP + col) : 0u;
          a[mt][ks][2] =
              ra < r ? ld_u32(qrow + (size_t)ra * DP + col + 16) : 0u;
          a[mt][ks][3] =
              rb < r ? ld_u32(qrow + (size_t)rb * DP + col + 16) : 0u;
        }
      }
      for (int cc = 0; cc < n_c; ++cc) {
        int mx[2][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) mx[i >> 2][i & 3] = INT_MIN;
        const int8_t* cb = tile + (cc * w2p + g) * SROW + t * 4;
        for (int nt = 0; nt < ntiles; ++nt) {
          int d[2][4] = {};
          const int8_t* bp = cb + nt * 8 * SROW;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const uint32_t b0 = ld_u32(bp + ks * 32);
            const uint32_t b1 = ld_u32(bp + ks * 32 + 16);
            mma_s8_16832(d[0], a[0][ks], b0, b1);
            mma_s8_16832(d[1], a[1][ks], b0, b1);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            mx[i >> 2][i & 3] = max(mx[i >> 2][i & 3], d[i >> 2][i & 3]);
        }
        const float sc = __bfloat162float(aux[2 * (c0 + cc)]);
        float s = 0.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          int lo = max(mx[mt][0], mx[mt][1]);
          int hi = max(mx[mt][2], mx[mt][3]);
          lo = max(lo, __shfl_xor_sync(0xffffffffu, lo, 1));
          lo = max(lo, __shfl_xor_sync(0xffffffffu, lo, 2));
          hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, 1));
          hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, 2));
          // (max * sq) * sc, each product rounded (no fused multiply-add)
          s += __fmul_rn(__fmul_rn((float)lo, sq[mt][0]), sc) +
               __fmul_rn(__fmul_rn((float)hi, sq[mt][1]), sc);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane == cc) acc += s;
      }
    }
    if (lane < n_c)
      out[(size_t)q * c + c0 + lane] =
          acc + __bfloat162float(aux[2 * (c0 + lane) + 1]);
  }
}

template <int KS, bool PACKED4>
int launch(const void* qw, const void* qs, const void* pool, const void* aux,
           void* out, int nq, int r, int c, int w2p, int tc, int nwarps,
           int q_per_block, cudaStream_t stream) {
  const size_t smem = (size_t)tc * w2p * (KS * 32 + 16);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_int8_kernel<KS, PACKED4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + tc - 1) / tc, (nq + q_per_block - 1) / q_per_block);
  maxsim_int8_kernel<KS, PACKED4><<<grid, 32 * nwarps, smem, stream>>>(
      static_cast<const int8_t*>(qw), static_cast<const float*>(qs),
      static_cast<const uint8_t*>(pool),
      static_cast<const __nv_bfloat16*>(aux), static_cast<float*>(out), nq, r,
      c, w2p, tc, q_per_block);
  return (int)cudaGetLastError();
}

template <bool PACKED4>
int dispatch(const void* qw, const void* qs, const void* pool,
             const void* aux, void* out, int nq, int r, int c, int w2p,
             int dp, int tc, int nwarps, int q_per_block, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 32: return launch<1, PACKED4>(qw, qs, pool, aux, out, nq, r, c, w2p, tc, nwarps, q_per_block, s);
    case 64: return launch<2, PACKED4>(qw, qs, pool, aux, out, nq, r, c, w2p, tc, nwarps, q_per_block, s);
    case 96: return launch<3, PACKED4>(qw, qs, pool, aux, out, nq, r, c, w2p, tc, nwarps, q_per_block, s);
    case 128: return launch<4, PACKED4>(qw, qs, pool, aux, out, nq, r, c, w2p, tc, nwarps, q_per_block, s);
    case 160: return launch<5, PACKED4>(qw, qs, pool, aux, out, nq, r, c, w2p, tc, nwarps, q_per_block, s);
    case 192: return launch<6, PACKED4>(qw, qs, pool, aux, out, nq, r, c, w2p, tc, nwarps, q_per_block, s);
    case 224: return launch<7, PACKED4>(qw, qs, pool, aux, out, nq, r, c, w2p, tc, nwarps, q_per_block, s);
    case 256: return launch<8, PACKED4>(qw, qs, pool, aux, out, nq, r, c, w2p, tc, nwarps, q_per_block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// pool: (C, W2P, Dp) int8
extern "C" int maxsim_int8(const void* qw, const void* qs, const void* pool,
                           const void* aux, void* out, int nq, int r, int c,
                           int w2p, int dp, int tc, int nwarps,
                           int q_per_block, int device, void* stream) {
  return dispatch<false>(qw, qs, pool, aux, out, nq, r, c, w2p, dp, tc,
                         nwarps, q_per_block, device, stream);
}

// pool: (C, W2P, Dp/2) uint8, two int4 codes per byte; dp is the unpacked
// lane count
extern "C" int maxsim_int4(const void* qw, const void* qs, const void* pool,
                           const void* aux, void* out, int nq, int r, int c,
                           int w2p, int dp, int tc, int nwarps,
                           int q_per_block, int device, void* stream) {
  return dispatch<true>(qw, qs, pool, aux, out, nq, r, c, w2p, dp, tc,
                        nwarps, q_per_block, device, stream);
}
