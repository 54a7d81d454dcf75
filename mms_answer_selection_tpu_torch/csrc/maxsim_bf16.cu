// bf16 MaxSim scorer for the learned bilinear metric.
//
// Replaces: mms_answer_selection_tpu/ops/sim_cross_pallas.py, _maxsim_kernel
// (the TPU kernel behind bilinear_maxsim_scores).
//
// Computes out[q, c] = sum_r max_j <qw[q, r, :], pool[c, j, :]> with bf16
// inputs and f32 accumulation.  qw is (Nq, R, Dp), the queries projected
// through the M metric matrices (R = M * W1); pool is (C, W2P, Dp).  The last
// of the Dp lanes is the token mask: 1.0 in every real query row, 0 or -1e30
// in every pool token, so a padded token's dot product carries -1e30 and
// never wins a max.  The kernel therefore needs no mask of its own.
//
// What bounds it on the H100: the tensor cores first, then the token max.
// A (query, candidate) pair costs 2 * R * W2P * Dp flops (819 kflop at
// R=160, W2P=40, Dp=64: at 989 TFLOP/s, 55.6 ms for 256 queries x 262,144
// candidates on the padded width) and R * W2P max operations on the CUDA
// cores (4.3e11 there).  The candidate's 5 KB are reused by every query, so
// bytes bound only a single query (about 160 flops per byte).
//
// What the design does about it (maxsim_wgmma.cuh): the products run as
// wgmma m64nNk16 on TMA-staged, 128-byte-swizzled shared-memory tiles (N =
// 240 or 256 token columns, whole candidates); the query group's rows stay
// resident (at V4_WIDE's Dp 304, rows of 608 bytes, the K-sliced plan
// streams 128-byte spans of pool and query rows instead and accumulates
// over them in the wgmma registers); a producer warp keeps a ring of pool
// tiles in flight; two
// consumer warpgroups take alternate tiles, so the token max of one (in
// registers, then across the quad) runs while the other's products occupy
// the tensor cores.  The R x W2P similarity tile of a pair never leaves the
// SM: one value per (row, candidate) goes to shared memory and the row sum
// is taken there in an order fixed by r and R, so scores are deterministic
// and independent of the launch shape.

#include "maxsim_wgmma.cuh"

// qw (Nq, R, Dp) and pool (C, W2P, Dp) bf16, out (Nq, C) float32; the plan
// from maxsim_geometry
extern "C" int maxsim_bf16(const void* qw, const void* pool, void* out,
                           int nq, int r, int c, int w2p, int dp, int g,
                           int n_c, int w2s, int n, int stages,
                           int tiles_per_unit, int grid, int k_sliced,
                           int device, void* stream) {
  return maxsim::dispatch<maxsim::BF16>(qw, nullptr, pool, nullptr, out, nq,
                                        r, c, w2p, dp, g, n_c, w2s, n, stages,
                                        tiles_per_unit, grid, k_sliced, device,
                                        stream);
}

extern "C" const char* maxsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
