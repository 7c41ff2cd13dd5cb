// Shared helpers of the port's stencil kernels (evisc.cu, tend_rk.cu,
// tend_rk_fold.cu, tend_generic.cu).
//
// Fields are (kcells, jtot, itot) row-major, i fastest, periodic in i and j.
// A block of TI x TJ threads owns a (TJ, TI) tile of the horizontal plane and
// marches in k.  Each field keeps a ring of three (TJ+2) x (TI+2) planes in
// shared memory: the tile plus a one-cell periodic halo, which is the widest
// horizontal reach of the 2nd-order stencils.  Per k-step a block loads one
// new plane per field, so every field is read from device memory once, plus
// the halo ((TJ+2)(TI+2) / (TJ TI) = 1.33x).
#pragma once

#include <cuda_runtime.h>

namespace mhh {

constexpr int TI = 32;
constexpr int TJ = 8;
constexpr int HI = TI + 2;
constexpr int HJ = TJ + 2;

__device__ __forceinline__ int wrap(int x, int n) {
    x %= n;
    return x < 0 ? x + n : x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// Load plane `level` of field `a` for the tile at (j0, i0) with its halo.
template <typename T>
__device__ __forceinline__ void load_tile(T (*sh)[HI], const T* __restrict__ a,
                                          long long level, int j0, int i0,
                                          int jtot, int itot) {
    const long long base = level * (long long)jtot * itot;
    for (int idx = threadIdx.y * TI + threadIdx.x; idx < HJ * HI;
         idx += TI * TJ) {
        const int r = idx / HI;
        const int c = idx - r * HI;
        const int jg = wrap(j0 + r - 1, jtot);
        const int ig = wrap(i0 + c - 1, itot);
        sh[r][c] = __ldg(a + base + (long long)jg * itot + ig);
    }
}

// Ring slot of logical plane p (p >= -1).
__device__ __forceinline__ int slot(int p) { return (p + 3) % 3; }

}  // namespace mhh
