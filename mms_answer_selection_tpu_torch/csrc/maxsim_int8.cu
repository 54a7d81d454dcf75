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
// masked candidates have sc = 0 and mask = -1e30, so they score the mask.
//
// What bounds it on the H100: the token max as much as the tensor cores.
// 2 * R * W2P * Dp integer ops per pair at 1,979 TOP/s is 27.8 ms for 256
// queries x 262,144 candidates at Dp=64; the R * W2P max operations per
// pair (4.3e11 there) run on the CUDA cores at the same count as bf16's.
//
// What the design does about it: the bf16 kernel's (maxsim_wgmma.cuh), with
// wgmma m64nNk32 s8 -> s32 on 64-byte-swizzled tiles at Dp=64 (K-sliced in
// 128-byte spans at V4_WIDE's Dp 320, where the int4 producer writes the
// zeros past Dp that TMA fills for int8); the token max
// on int32 takes three operands an instruction (vimax3), and the two scales
// are applied once per (row, candidate) in the row sum, after the max.
//
// int4 (maxsim_int4): the pool holds two 4-bit two's-complement codes per
// byte (lane 2i low nibble, lane 2i+1 high), Dp/2 bytes per token, half of
// int8's bytes read.  TMA cannot unpack nibbles, so the producer
// warpgroup's 128 threads read 16 packed bytes at a time, sign-extend the 32
// nibbles and store them where TMA's swizzle would have put the int8 lanes;
// from there the int8 path runs unchanged, so the scores equal the int8
// kernel's on the unpacked codes, bit for bit.  wgmma has no 4-bit input,
// so int4 buys capacity and bytes read, not operations.

#include "maxsim_wgmma.cuh"

// qw (Nq, R, Dp) int8, qs (Nq, R) float32, pool (C, W2P, Dp) int8, aux
// (C, 2) bf16, out (Nq, C) float32; the plan from maxsim_geometry
extern "C" int maxsim_int8(const void* qw, const void* qs, const void* pool,
                           const void* aux, void* out, int nq, int r, int c,
                           int w2p, int dp, int g, int n_c, int w2s, int n,
                           int stages, int tiles_per_unit, int grid,
                           int k_sliced, int device, void* stream) {
  return maxsim::dispatch<maxsim::INT8>(qw, qs, pool, aux, out, nq, r, c, w2p,
                                        dp, g, n_c, w2s, n, stages,
                                        tiles_per_unit, grid, k_sliced, device,
                                        stream);
}

// pool: (C, W2P, Dp/2) uint8, two int4 codes per byte; dp is the unpacked
// lane count
extern "C" int maxsim_int4(const void* qw, const void* qs, const void* pool,
                           const void* aux, void* out, int nq, int r, int c,
                           int w2p, int dp, int g, int n_c, int w2s, int n,
                           int stages, int tiles_per_unit, int grid,
                           int k_sliced, int device, void* stream) {
  return maxsim::dispatch<maxsim::INT4>(qw, qs, pool, aux, out, nq, r, c, w2p,
                                        dp, g, n_c, w2s, n, stages,
                                        tiles_per_unit, grid, k_sliced, device,
                                        stream);
}
