// The MaxSim kernel body shared by maxsim_bf16.cu and maxsim_int8.cu: a
// persistent, warp-specialised Hopper kernel (TMA-staged pool tiles,
// wgmma products, the token max and the row sum fused behind them).
//
// Work.  The projected query rows qw (Nq * R, Dp) are cut into groups of G
// whole queries (G * R rows, m_tiles tiles of 64 rows); the pool, viewed as
// token rows (C * W2P, Dp), into tiles of n_c whole candidates (or, past 256
// tokens a candidate, into `slabs` parts of W2S tokens each).  A unit is one
// query group against a range of tiles; unit u is group u % n_groups and
// range u / n_groups, so the blocks running at once read the same pool
// tiles from L2.  One block per SM walks units u = blockIdx.x, +gridDim.x.
//
// Roles.  Warpgroup 2 produces: one thread loads the group's query rows
// once per unit (TMA, kept resident) and streams pool tiles through a ring
// of `stages` shared-memory buffers (TMA, mbarriers); for int4 its 128
// threads unpack the nibbles into the same swizzled layout instead.
// Warpgroups 0 and 1 consume alternate tiles, so one's token max and row
// sums run while the other's products occupy the tensor cores (a candidate
// split in slabs goes to warpgroup 0 alone).  For each 64-row tile of the
// group a consumer issues S = A * B^T as wgmma m64nNk16 (bf16) or m64nNk32
// (s8) over Dp, both operands K-major from swizzled shared memory, then
// folds the max over each candidate's tokens in registers and across the
// quad, and stores one value per (row, candidate) to shared memory.  After
// the last row tile it sums each (query, candidate)'s R row terms.
//
// K-sliced plans (STREAM).  Where a row is longer than 256 bytes (V4_WIDE:
// D = 300, Dp 304 bf16 or 320 int8) or the group's query rows do not fit
// in shared memory beside the ring (R = 800 at D = 300), nothing stays
// resident: each ring item is one 128-byte K span (the swizzle span) of a
// pool tile's N rows and of one 64-row tile of the group's query rows, and
// a consumer accumulates a row tile's product over the spans in its wgmma
// registers before the token max.  So each pool tile's spans stream once
// per row tile (L2 traffic x row tiles, HBM traffic unchanged).  The last
// span of a row may run past Dp; TMA fills the lanes past the tensor's
// edge with zeros (the int4 producer writes them), which add exact zeros
// to every dot product.  Each consumer has a ring of its own (half of the
// stages), fed by its own producer thread (int4: 64 producer threads), so
// consecutive items of one tile never alias a barrier phase of the other
// consumer's.  Rows of 256 bytes or less whose query rows fit keep the
// resident plan above, compiled as before.
//
// Canonical order.  A pair's score never depends on where the pair sat in
// the launch: each row term is the max of dot products whose K order is
// fixed (ascending 32-byte steps in either plan; a sliced plan's steps past
// Dp add zeros), and the row sum is taken by 4 lanes over r = j, j + 4, ...
// then combined by a fixed butterfly, an order set by r and R alone.  So
// the score of a pair is the same bits whatever the batch, the query's
// place in it, the candidate's offset, the chunking of the pool, or the
// plan.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace maxsim {

enum Kind { BF16 = 0, INT8 = 1, INT4 = 2 };

constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block
constexpr int kMaxCands = 32;       // candidates per tile, at most
constexpr int kMaxStages = 8;
constexpr int kRowTile = 64;        // rows of one wgmma
constexpr int kConsumers = 2;       // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
// setmaxnreg: int4's producers unpack with four loads in flight; ptxas
// holds the consumers to the launch bound (168) whatever they are given
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

template <typename T, int N>
struct Acc {
  T d[N / 2];
};

// ---------------------------------------------------------------- wgmma
// D (64 x N) (+)= A (64 x K) B^T, both operands K-major in shared memory,
// described by smem descriptors; accumulate = 0 overwrites D.

__device__ __forceinline__ void wgmma_bf16(Acc<float, 240>& acc, uint64_t da,
    uint64_t db, int accumulate) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119"
      "}, %120, %121, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(Acc<float, 256>& acc, uint64_t da,
    uint64_t db, int accumulate) {
  float* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(Acc<int, 240>& acc, uint64_t da,
    uint64_t db, int accumulate) {
  int* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119"
      "}, %120, %121, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(Acc<int, 256>& acc, uint64_t da,
    uint64_t db, int accumulate) {
  int* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
template <typename T, int N>
__device__ __forceinline__ void fence_acc(Acc<T, N>& acc) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(acc.d[i])::"memory");
    else
      asm volatile("" : "+r"(acc.d[i])::"memory");
  }
}

// Descriptor of a K-major operand whose rows are `kc` bytes (one swizzle
// span: 128, 64 or 32 bytes, TMA's swizzle of the same width), 8-row
// groups 8 * kc bytes apart.  The K step inside a row is a plain address
// offset of 32 bytes (16 bf16 or 32 int8 lanes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int kc) {
  const uint64_t layout = kc == 128 ? 1 : (kc == 64 ? 2 : 3);
  const uint64_t sbo = (uint64_t)(8 * kc) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) |
         (layout << 62);
}

// The byte TMA's swizzle puts byte offset o of a region whose rows are kc
// bytes (the region aligned to 8 * kc): the 16-byte chunk index is xored
// with the 128-byte line index, modulo the chunks of a row.
__device__ __forceinline__ uint32_t swizzle(uint32_t o, int kc) {
  return o ^ (((o >> 7) & ((kc >> 4) - 1)) << 4);
}

// ------------------------------------------------------ barriers and TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// raises the barrier's expected transaction bytes without arriving
__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar,
                                                    uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id) {  // one warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// 8 packed nibbles (lane k in bits 4k..4k+3) -> 8 sign-extended int8 lanes:
// lanes 0-3 in lo, 4-7 in hi
__device__ __forceinline__ void unpack8(uint32_t w, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t even = w & 0x0F0F0F0Fu;        // lanes 0, 2, 4, 6
  const uint32_t odd = (w >> 4) & 0x0F0F0F0Fu;  // lanes 1, 3, 5, 7
  // per byte: (n ^ 8) - 8 sign-extends a 4-bit value
  const uint32_t e = __vsub4(even ^ 0x08080808u, 0x08080808u);
  const uint32_t o = __vsub4(odd ^ 0x08080808u, 0x08080808u);
  lo = __byte_perm(e, o, 0x5140);  // e0 o0 e1 o1
  hi = __byte_perm(e, o, 0x7362);  // e2 o2 e3 o3
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  return fmaxf(a, fmaxf(b, c));
}
__device__ __forceinline__ int max3(int a, int b, int c) {
  return __vimax3_s32(a, b, c);
}
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

// A row term as the row sum takes it: a bf16 product's max as it is; an
// int8 one's int32 max times the row's scale, rounded (the reference's
// first product; for a positive scale the rounding keeps the order, so a
// max of scaled slab maxima is the scaled max).
__device__ __forceinline__ float scale_term(float v, const float*, int) {
  return v;
}
__device__ __forceinline__ float scale_term(int v, const float* sq, int row) {
  return __fmul_rn((float)v, sq[row]);
}

// The max over each candidate's tokens for a product of NC = N / (8 * KC8)
// whole candidates (KC8 chunks of 8 columns each), stored as row terms:
// this thread holds rows ra and ra + 8, columns 8i + 2(lane % 4) + {0, 1}
// of chunk i.  A transposing reduction across the quad follows (lanes l,
// l ^ 1 trade halves by row, then l, l ^ 2 by candidate), after which each
// lane holds NC / 2 maxima of one row and stores them.
template <int KC8, typename T, int N>
__device__ __forceinline__ void token_max(const Acc<T, N>& acc,
                                          float* terms, const float* sq,
                                          int stride, int ra, int lane,
                                          int n_live) {
  constexpr int NC = N / (8 * KC8), H = NC / 2;
  static_assert(NC % 2 == 0, "candidates per product must be even");
  T v[2][NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int q = 4 * c * KC8;
    T a = vmax(acc.d[q], acc.d[q + 1]);
    T b = vmax(acc.d[q + 2], acc.d[q + 3]);
#pragma unroll
    for (int i = 1; i < KC8; ++i) {
      a = max3(a, acc.d[q + 4 * i], acc.d[q + 4 * i + 1]);
      b = max3(b, acc.d[q + 4 * i + 2], acc.d[q + 4 * i + 3]);
    }
    v[0][c] = a;
    v[1][c] = b;
  }
  const bool hi_row = lane & 1, hi_cand = lane & 2;
  T h[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const T send = hi_row ? v[0][c] : v[1][c];
    const T keep = hi_row ? v[1][c] : v[0][c];
    h[c] = vmax(keep, __shfl_xor_sync(0xffffffffu, send, 1));
  }
  const int first = hi_cand ? H : 0, row = ra + (hi_row ? 8 : 0);
  float* e = terms + row * stride + first;
#pragma unroll
  for (int c = 0; c < H; ++c) {
    const T send = hi_cand ? h[c] : h[c + H];
    const T keep = hi_cand ? h[c + H] : h[c];
    const T f = vmax(keep, __shfl_xor_sync(0xffffffffu, send, 2));
    if (first + c < n_live) e[c] = scale_term(f, sq, row);
  }
}

// The token max for any W2S: this thread holds rows ra and ra + 8, columns
// 8i + 2(lane % 4) + {0, 1} of chunk i; a candidate ends every W2S / 8
// chunks (the same chunk for every lane); a slab past the first merges its
// max.
template <typename T, int N>
__device__ __forceinline__ void token_max_any(const Acc<T, N>& acc,
                                              float* terms, const float* sq,
                                              int stride, int ra, int lane,
                                              int n_live, int w2s, int slab) {
  T lowest;
  if constexpr (std::is_same<T, float>::value)
    lowest = -INFINITY;
  else
    lowest = INT_MIN;
  T m0 = lowest, m1 = lowest;
  int cand = 0, left = w2s / 8;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    m0 = max3(m0, acc.d[4 * i], acc.d[4 * i + 1]);
    m1 = max3(m1, acc.d[4 * i + 2], acc.d[4 * i + 3]);
    if (--left == 0) {
      if (cand < n_live) {
        m0 = vmax(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = vmax(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = vmax(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = vmax(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
        if ((lane & 3) == 0) {
          float* e0 = terms + ra * stride + cand;
          float* e1 = e0 + 8 * stride;
          const float f0 = scale_term(m0, sq, ra);
          const float f1 = scale_term(m1, sq, ra + 8);
          *e0 = slab ? fmaxf(*e0, f0) : f0;
          *e1 = slab ? fmaxf(*e1, f1) : f1;
        }
      }
      ++cand;
      left = w2s / 8;
      m0 = m1 = lowest;
    }
  }
}

// ------------------------------------------------------------ the plan
// The launch plan, as ops/sim_cross_kernels.py's maxsim_geometry gives it,
// and the layout derived from it (the same formulas as maxsim_smem there).
struct Plan {
  int nq, r, c, w2p, dp;
  int g;               // queries per group
  int n_c;             // candidates per tile
  int w2s, slabs;      // tokens per slab, slabs per candidate
  int stages;          // ring slots (K-sliced: half for each consumer)
  int tiles_per_unit;  // pool tiles of one unit (the last range may be short)
  int stream;          // 1: K-sliced, query rows streamed (STREAM)
  int row_bytes, kc, nkc;  // Dp in bytes, swizzle span, spans per row
  int m_tiles, stride;     // 64-row tiles per group, row-term buffer pitch
  int n_groups, n_tiles, n_units;
  int stage_bytes, a_off;  // a slot; K-sliced: its query rows' offset
  int off_a, off_terms, off_sq, off_bar, smem;
};

// Fills the layout of `p` from its plan; false if the kernel of tile width
// n cannot run it.
inline bool make_plan(Plan& p, int es, bool quant, int n, int grid) {
  if (p.nq < 1 || p.r < 1 || p.c < 1 || p.g < 1 || p.w2p < 8 ||
      p.w2p % 8 || p.w2s < 8 || p.w2s % 8 || p.w2s > n ||
      p.w2p != p.w2s * p.slabs || p.n_c < 1 || p.n_c > kMaxCands ||
      (p.slabs > 1 && p.n_c != 1) || p.n_c * p.w2s > n ||
      p.stages < 2 || p.stages > kMaxStages || p.tiles_per_unit < 1 ||
      (p.stream != 0 && p.stream != 1) ||
      (p.stream && (p.stages < 4 || p.stages % 2)))
    return false;
  p.row_bytes = p.dp * es;
  if (p.row_bytes < 32 || p.row_bytes % 32 ||
      (!p.stream && p.row_bytes > 256))
    return false;
  // past 256 bytes (K-sliced only) 128-byte spans, the last one running
  // past Dp into TMA's zero fill
  p.kc = p.row_bytes % 128 == 0 || p.row_bytes > 256
             ? 128
             : (p.row_bytes % 64 == 0 ? 64 : 32);
  p.nkc = (p.row_bytes + p.kc - 1) / p.kc;
  p.m_tiles = (p.g * p.r + kRowTile - 1) / kRowTile;
  p.stride = p.n_c | 1;
  const int rows = p.m_tiles * kRowTile;
  p.n_groups = (p.nq + p.g - 1) / p.g;
  p.n_tiles = (p.c + p.n_c - 1) / p.n_c;
  p.n_units = p.n_groups * ((p.n_tiles + p.tiles_per_unit - 1) /
                            p.tiles_per_unit);
  if (p.stream) {
    // a slot: one K span of the pool tile's N rows, then of a row tile
    p.a_off = (n * p.kc + 1023) / 1024 * 1024;
    p.stage_bytes = (p.a_off + kRowTile * p.kc + 1023) / 1024 * 1024;
    p.off_a = p.stages * p.stage_bytes;
    p.off_terms = p.off_a;
  } else {
    p.a_off = 0;
    p.stage_bytes = (n * p.row_bytes + 1023) / 1024 * 1024;
    p.off_a = p.stages * p.stage_bytes;
    p.off_terms = p.off_a + rows * p.row_bytes;
  }
  p.off_sq = p.off_terms + kConsumers * rows * p.stride * 4;
  p.off_bar = p.off_sq + (quant ? kConsumers * rows * 4 : 0);
  p.smem = 1024 + p.off_bar + (2 * p.stages + 2) * 8;
  return p.smem <= kSmemLimit && grid >= 1 && grid <= p.n_units;
}

// ---------------------------------------------------------- the kernel
// The row sum of each (query, candidate) of a tile: 4 lanes a pair, lane j
// over rows j, j + 4, ..., then a fixed butterfly.
template <bool kQuant>
__device__ __forceinline__ void row_sums(const float* terms,
                                         const __nv_bfloat16* aux,
                                         float* out, const Plan& p, int grp,
                                         int q_live, int c0, int n_live,
                                         int tid) {
  const int pairs = q_live * n_live, j = tid & 3;
  for (int p0 = 0; p0 < pairs; p0 += 32) {
    const int pr = p0 + (tid >> 2);
    const bool ok = pr < pairs;
    const int ql = ok ? pr / n_live : 0, cl = ok ? pr - ql * n_live : 0;
    float sc = 0.f;
    if (kQuant && ok) sc = __bfloat162float(aux[2 * (c0 + cl)]);
    float sum = 0.f;
    if (ok)
#pragma unroll 8
      for (int rr = j; rr < p.r; rr += 4) {
        const float v = terms[(ql * p.r + rr) * p.stride + cl];
        // int8: (max * sq) * sc, each product rounded (no fused
        // multiply-add); the first product is the term
        sum += kQuant ? __fmul_rn(v, sc) : v;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (ok && j == 0) {
      if constexpr (kQuant) sum += __bfloat162float(aux[2 * (c0 + cl) + 1]);
      out[(size_t)(grp * p.g + ql) * p.c + c0 + cl] = sum;
    }
  }
}

template <int KIND, int N, int KC8, bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
    maxsim_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_pool,
                  const uint8_t* __restrict__ packed,  // int4 pool
                  const float* __restrict__ qs,
                  const __nv_bfloat16* __restrict__ aux,
                  float* __restrict__ out, const Plan p) {
  using T = typename std::conditional<KIND == BF16, float, int>::type;
  constexpr bool kQuant = KIND != BF16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sm0 = smem_u32(sm);
  const uint32_t bar0 = sm0 + p.off_bar;
  // barriers: full[stages], empty[stages], q_full, q_empty
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (p.stages + s); };
  const uint32_t q_full = bar0 + 16 * p.stages;
  const uint32_t q_empty = q_full + 8;
  const int rows = p.m_tiles * kRowTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), KIND == INT4 ? (STREAM ? 64 : 128) : 1);
      mbar_init(empty(s), 4);  // the four warps of the consuming warpgroup
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == kConsumers) {
    // ================================================== producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if constexpr (STREAM) {
      // ring w (slots w * half..) is fed by producer threads 64w.. (int4:
      // all 64 unpack; else thread 64w alone) with the items of the tiles
      // consumer w takes (every other tile the block walks): for each
      // slab, row tile and K span, the span of the pool tile's N token
      // rows and of the row tile's 64 query rows
      const int half = p.stages / 2, ring = tid / 64, ftid = tid % 64;
      if (KIND != INT4 && ftid != 0) return;
      const long long n_tok = (long long)p.c * p.w2p;
      int item = 0, walked = 0;
      for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
        const int grp = u % p.n_groups;
        const int t0 = (u / p.n_groups) * p.tiles_per_unit;
        const int t1 = min(p.n_tiles, t0 + p.tiles_per_unit);
        const int q_live = min(p.g, p.nq - grp * p.g);
        const int m_live = (q_live * p.r + kRowTile - 1) / kRowTile;
        const int row0 = grp * p.g * p.r;
        for (int t = t0; t < t1; ++t) {
          if (walked++ % kConsumers != ring) continue;
          for (int sl = 0; sl < p.slabs; ++sl)
            for (int m = 0; m < m_live; ++m)
              for (int j = 0; j < p.nkc; ++j, ++item) {
                const int st = ring * half + item % half;
                mbar_wait(empty(st), ((item / half) & 1) ^ 1);
                const int tok0 = t * p.n_c * p.w2p + sl * p.w2s;
                const uint32_t dst = sm0 + st * p.stage_bytes;
                const int x = j * p.kc / (KIND == BF16 ? 2 : 1);
                if (ftid == 0) {
                  if (KIND == INT4) {
                    mbar_expect_tx_only(full(st), kRowTile * p.kc);
                  } else {
                    mbar_expect_tx(full(st), (N + kRowTile) * p.kc);
                    tma_load(dst, &map_pool, full(st), x, tok0);
                  }
                  tma_load(dst + p.a_off, &map_q, full(st), x,
                           row0 + m * kRowTile);
                }
                if constexpr (KIND == INT4) {
                  // span j of each token row: 16 packed bytes -> 32 int8
                  // lanes where TMA's swizzle would put them; lanes past
                  // Dp and rows past the pool are zeros
                  const int kcc = p.kc / 32;
                  uint8_t* base = sm + st * p.stage_bytes;
                  for (int i0 = ftid; i0 < N * kcc; i0 += 4 * 64) {
                    uint4 v[4];
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                      const int i = i0 + b * 64, row = i / kcc;
                      const int lane0 = j * p.kc + (i - row * kcc) * 32;
                      v[b] = make_uint4(0, 0, 0, 0);
                      if (i < N * kcc && lane0 < p.dp && tok0 + row < n_tok)
                        v[b] = __ldg(reinterpret_cast<const uint4*>(
                            packed + ((size_t)(tok0 + row) * p.dp + lane0) /
                                         2));
                    }
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                      const int i = i0 + b * 64, row = i / kcc;
                      if (i >= N * kcc) break;
                      uint4 a, c;
                      unpack8(v[b].x, a.x, a.y);
                      unpack8(v[b].y, a.z, a.w);
                      unpack8(v[b].z, c.x, c.y);
                      unpack8(v[b].w, c.z, c.w);
                      const uint32_t o = row * p.kc + (i - row * kcc) * 32;
                      *reinterpret_cast<uint4*>(base + swizzle(o, p.kc)) = a;
                      *reinterpret_cast<uint4*>(base + swizzle(o + 16, p.kc)) =
                          c;
                    }
                  }
                  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                  mbar_arrive(full(st));
                }
              }
        }
      }
      return;
    }
    const bool leader = tid == 0;
    if (KIND != INT4 && !leader) return;
    int k = 0, loads = 0, prev = -1;
    for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
      const int grp = u % p.n_groups;
      const int t0 = (u / p.n_groups) * p.tiles_per_unit;
      const int t1 = min(p.n_tiles, t0 + p.tiles_per_unit);
      if (grp != prev && leader) {
        // the group's query rows, once; boxes wholly past Nq * R are
        // skipped (their rows are never summed), partial ones zero-filled
        if (loads > 0) mbar_wait(q_empty, (loads - 1) & 1);
        const int row0 = grp * p.g * p.r;
        const int live = min(p.m_tiles, (p.nq * p.r - row0 + kRowTile - 1) /
                                            kRowTile);
        mbar_expect_tx(q_full, live * kRowTile * p.row_bytes);
        for (int m = 0; m < live; ++m)
          for (int j = 0; j < p.nkc; ++j)
            tma_load(sm0 + p.off_a + (j * rows + m * kRowTile) * p.kc, &map_q,
                     q_full, j * p.kc / (KIND == BF16 ? 2 : 1),
                     row0 + m * kRowTile);
      }
      if (grp != prev) ++loads;
      prev = grp;
      for (int t = t0; t < t1; ++t) {
        for (int s = 0; s < p.slabs; ++s, ++k) {
          const int st = k % p.stages;
          mbar_wait(empty(st), ((k / p.stages) & 1) ^ 1);
          const int tok0 = t * p.n_c * p.w2p + s * p.w2s;
          const uint32_t dst = sm0 + st * p.stage_bytes;
          if constexpr (KIND != INT4) {
            mbar_expect_tx(full(st), N * p.row_bytes);
            for (int j = 0; j < p.nkc; ++j)
              tma_load(dst + j * N * p.kc, &map_pool, full(st),
                       j * p.kc / (KIND == BF16 ? 2 : 1), tok0);
          } else {
            // 16 packed bytes -> 32 int8 lanes, stored where TMA's swizzle
            // would put them; rows past the pool are zeros
            const int chunks = p.dp / 32;  // per token row
            const long long n_tok = (long long)p.c * p.w2p;
            uint8_t* base = sm + st * p.stage_bytes;
            for (int i0 = tid; i0 < N * chunks; i0 += 4 * 128) {
              uint4 v[4];  // four loads in flight before any unpacking
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                const int i = i0 + b * 128, row = i / chunks;
                v[b] = make_uint4(0, 0, 0, 0);
                if (i < N * chunks && tok0 + row < n_tok)
                  v[b] = __ldg(reinterpret_cast<const uint4*>(
                      packed + ((size_t)(tok0 + row) * p.dp +
                                (i - row * chunks) * 32) / 2));
              }
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                const int i = i0 + b * 128, row = i / chunks;
                if (i >= N * chunks) break;
                uint4 a, c;
                unpack8(v[b].x, a.x, a.y);
                unpack8(v[b].y, a.z, a.w);
                unpack8(v[b].z, c.x, c.y);
                unpack8(v[b].w, c.z, c.w);
                const int off = (i - row * chunks) * 32, j = off / p.kc;
                const uint32_t o = row * p.kc + off - j * p.kc;
                uint8_t* region = base + j * N * p.kc;
                *reinterpret_cast<uint4*>(region + swizzle(o, p.kc)) = a;
                *reinterpret_cast<uint4*>(region + swizzle(o + 16, p.kc)) = c;
              }
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(full(st));
          }
        }
      }
    }
    return;
  }

  // ==================================================== consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = tid / 32, lane = tid % 32;
  float* terms =
      reinterpret_cast<float*>(sm + p.off_terms) + wg * rows * p.stride;
  float* sq = reinterpret_cast<float*>(sm + p.off_sq) + wg * rows;
  if constexpr (STREAM) {
    // every other tile the block walks, from this consumer's own ring: for
    // each slab and row tile the product summed over the K spans, then
    // the token max
    const int half = p.stages / 2;
    int item = 0, walked = 0, prev = -1;
    for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
      const int grp = u % p.n_groups;
      const int t0 = (u / p.n_groups) * p.tiles_per_unit;
      const int t1 = min(p.n_tiles, t0 + p.tiles_per_unit);
      if (kQuant && grp != prev) {
        // the last tile's readers of sq passed its row sums' barrier
        const int row0 = grp * p.g * p.r;
        for (int i = tid; i < p.g * p.r; i += 128)
          sq[i] = row0 + i < p.nq * p.r ? qs[row0 + i] : 0.f;
        named_sync(1 + wg);
      }
      prev = grp;
      const int q_live = min(p.g, p.nq - grp * p.g);
      const int m_live = (q_live * p.r + kRowTile - 1) / kRowTile;
      for (int t = t0; t < t1; ++t) {
        if (walked++ % kConsumers != wg) continue;
        const int c0 = t * p.n_c, n_live = min(p.n_c, p.c - c0);
        for (int sl = 0; sl < p.slabs; ++sl)
          for (int m = 0; m < m_live; ++m) {
            Acc<T, N> acc;
            for (int j = 0; j < p.nkc; ++j, ++item) {
              const int st = wg * half + item % half;
              mbar_wait(full(st), (item / half) & 1);
              const uint32_t b0 = sm0 + st * p.stage_bytes;
              fence_acc(acc);
              wgmma_fence();
              for (int ks = 0; ks < p.kc; ks += 32) {
                const uint64_t da = smem_desc(b0 + p.a_off + ks, p.kc);
                const uint64_t db = smem_desc(b0 + ks, p.kc);
                if constexpr (KIND == BF16)
                  wgmma_bf16(acc, da, db, j | ks);
                else
                  wgmma_s8(acc, da, db, j | ks);
              }
              wgmma_commit();
              wgmma_wait_all();
              fence_acc(acc);
              if (lane == 0) mbar_arrive(empty(st));
            }
            const int ra = m * kRowTile + warp * 16 + lane / 4;
            if constexpr (KC8 > 0)
              token_max<KC8>(acc, terms, sq, p.stride, ra, lane, n_live);
            else
              token_max_any(acc, terms, sq, p.stride, ra, lane, n_live,
                            p.w2s, sl);
          }
        named_sync(1 + wg);
        row_sums<kQuant>(terms, aux, out, p, grp, q_live, c0, n_live, tid);
        named_sync(1 + wg);
      }
    }
    return;
  }
  int kbase = 0, loads = 0, prev = -1;
  for (int u = blockIdx.x; u < p.n_units; u += gridDim.x) {
    const int grp = u % p.n_groups;
    const int t0 = (u / p.n_groups) * p.tiles_per_unit;
    const int t1 = min(p.n_tiles, t0 + p.tiles_per_unit);
    if (grp != prev) {
      if (loads > 0) {  // done with the previous group's rows
        named_sync(1 + wg);
        if (tid == 0) mbar_arrive(q_empty);
      }
      mbar_wait(q_full, loads & 1);
      ++loads;
      prev = grp;
      if constexpr (kQuant) {
        const int row0 = grp * p.g * p.r;
        for (int i = tid; i < p.g * p.r; i += 128)
          sq[i] = row0 + i < p.nq * p.r ? qs[row0 + i] : 0.f;
        named_sync(1 + wg);  // every row's scale is in before any max reads it
      }
    }
    const int q_live = min(p.g, p.nq - grp * p.g);
    const int m_live = (q_live * p.r + kRowTile - 1) / kRowTile;
    for (int t = t0; t < t1; ++t) {
      // tile k goes to consumer k % 2, or, when a candidate is split in
      // slabs, every tile to consumer 0: either way a consumer never waits
      // on a ring slot more than one lap ahead of the producer's loads,
      // which the barriers' phase parity could not tell apart
      const int k0 = kbase + (t - t0) * p.slabs;
      if ((p.slabs > 1 ? 0 : k0 % kConsumers) != wg) continue;
      const int c0 = t * p.n_c, n_live = min(p.n_c, p.c - c0);
      for (int s = 0; s < p.slabs; ++s) {
        const int k = k0 + s;
        const int st = k % p.stages;
        mbar_wait(full(st), (k / p.stages) & 1);
        const uint32_t b0 = sm0 + st * p.stage_bytes;
        Acc<T, N> acc;
        for (int m = 0; m < m_live; ++m) {
          const uint32_t a0 = sm0 + p.off_a + m * kRowTile * p.kc;
          fence_acc(acc);
          wgmma_fence();
          for (int j = 0; j < p.nkc; ++j)
            for (int ks = 0; ks < p.kc; ks += 32) {
              const uint64_t da = smem_desc(a0 + j * rows * p.kc + ks, p.kc);
              const uint64_t db = smem_desc(b0 + j * N * p.kc + ks, p.kc);
              if constexpr (KIND == BF16)
                wgmma_bf16(acc, da, db, j | ks);
              else
                wgmma_s8(acc, da, db, j | ks);
            }
          wgmma_commit();
          wgmma_wait_all();
          fence_acc(acc);
          const int ra = m * kRowTile + warp * 16 + lane / 4;
          if constexpr (KC8 > 0)
            token_max<KC8>(acc, terms, sq, p.stride, ra, lane, n_live);
          else
            token_max_any(acc, terms, sq, p.stride, ra, lane, n_live, p.w2s,
                          s);
        }
        if (lane == 0) mbar_arrive(empty(st));
      }
      named_sync(1 + wg);
      row_sums<kQuant>(terms, aux, out, p, grp, q_live, c0, n_live, tid);
      named_sync(1 + wg);
    }
    kbase += (t1 - t0) * p.slabs;
  }
}

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime, so nothing links
// against libcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A 2-D map over `rows` rows of dp lanes (es bytes each), boxes of one
// swizzle span (kc bytes) by box_rows rows, zeros past the last row.
inline bool encode_rows(CUtensorMap* map, bool bf16, const void* base,
                        long long rows, int dp, int kc, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int es = bf16 ? 2 : 1;
  cuuint64_t dims[2] = {(cuuint64_t)dp, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)dp * es};
  cuuint32_t box[2] = {(cuuint32_t)(kc / es), (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle sw =
      kc == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (kc == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks the plan, encodes the maps and launches maxsim_kernel<KIND, N,
// KC8, STREAM>.
// qw (Nq * R, Dp); pool (C * W2P, Dp) bf16 or int8, or the packed int4
// bytes (C * W2P, Dp / 2); qs and aux only for int8 and int4.
template <int KIND, int N, int KC8, bool STREAM>
int launch(Plan p, int grid, const void* qw, const void* qs, const void* pool,
           const void* aux, void* out, cudaStream_t stream) {
  const bool bf16 = KIND == BF16;
  if (p.stream != (STREAM ? 1 : 0) ||
      !make_plan(p, bf16 ? 2 : 1, KIND != BF16, N, grid))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_q, map_pool;
  if (!encode_rows(&map_q, bf16, qw, (long long)p.nq * p.r, p.dp, p.kc,
                   kRowTile))
    return (int)cudaErrorInvalidValue;
  if (KIND == INT4)
    map_pool = map_q;  // unused: the producers unpack the nibbles
  else if (!encode_rows(&map_pool, bf16, pool, (long long)p.c * p.w2p, p.dp,
                        p.kc, N))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_kernel<KIND, N, KC8, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  maxsim_kernel<KIND, N, KC8, STREAM><<<grid, kThreads, p.smem, stream>>>(
      map_q, map_pool, static_cast<const uint8_t*>(pool),
      static_cast<const float*>(qs), static_cast<const __nv_bfloat16*>(aux),
      static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

// The launch of the kernel of tile width n, resident or K-sliced.
template <int KIND, bool STREAM>
int launch_width(Plan p, int n, int grid, const void* qw, const void* qs,
                 const void* pool, const void* aux, void* out,
                 cudaStream_t s) {
  // V4's answers (W2P = 40): six whole candidates a 240-column tile, the
  // candidate width known to the compiler; any other width: any W2S
  if (n == 240 && p.w2s == 40 && p.w2p == 40 && p.n_c == 6)
    return launch<KIND, 240, 5, STREAM>(p, grid, qw, qs, pool, aux, out, s);
  if (n == 240)
    return launch<KIND, 240, 0, STREAM>(p, grid, qw, qs, pool, aux, out, s);
  if (n == 256)
    return launch<KIND, 256, 0, STREAM>(p, grid, qw, qs, pool, aux, out, s);
  return (int)cudaErrorInvalidValue;
}

// The C entry points' common part: (nq, r, c, w2p, dp, g, n_c, w2s, tile n,
// stages, tiles per unit, grid, stream) -> the launch of the kernel of
// width n, K-sliced when `k_sliced` is 1.
template <int KIND>
int dispatch(const void* qw, const void* qs, const void* pool,
             const void* aux, void* out, int nq, int r, int c, int w2p,
             int dp, int g, int n_c, int w2s, int n, int stages,
             int tiles_per_unit, int grid, int k_sliced, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan p = {};
  p.nq = nq, p.r = r, p.c = c, p.w2p = w2p, p.dp = dp, p.g = g, p.n_c = n_c;
  p.w2s = w2s, p.slabs = w2s > 0 ? w2p / w2s : 0, p.stages = stages;
  p.tiles_per_unit = tiles_per_unit, p.stream = k_sliced;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_sliced)
    return launch_width<KIND, true>(p, n, grid, qw, qs, pool, aux, out, s);
  return launch_width<KIND, false>(p, n, grid, qw, qs, pool, aux, out, s);
}

}  // namespace maxsim
