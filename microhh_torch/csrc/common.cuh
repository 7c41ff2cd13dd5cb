// Shared helpers of the port's stencil kernels (evisc.cu, tend_rk_fold.cu,
// tend_generic.cu and the k-march of kmarch.cuh): the tile width of a warp
// and the periodic wrap and clamp of an index.
//
// Fields are (kcells, jtot, itot) row-major, i fastest, periodic in i and j.
#pragma once

#include <cuda_runtime.h>

namespace mhh {

constexpr int TI = 32;

__device__ __forceinline__ int wrap(int x, int n) {
    x %= n;
    return x < 0 ? x + n : x;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace mhh
