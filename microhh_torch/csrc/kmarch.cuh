// The k-march machinery of the redesigned ring kernels (K13 in
// advec_interp.cu, K16 in o4.cu, the scalar sweep K10/K19 in
// tend_generic.cu): a (TJ, 32) tile of the plane per block, a
// chunk of the levels per block, planes copied asynchronously into rings in
// shared memory, the thread's own vertical column held in registers.
//
// * Chunks.  Block z of the grid marches the levels [k0, k1) of
//   chunk_bounds(z, chunks, ktot), so that the grid has tiles x chunks blocks
//   and fills the card in whole waves; ops/kmarch.py picks the chunk count
//   from the resident slots (blocks per SM x SMs) and repeats this formula.
//   Each chunk warms its window up on its own (at most six planes read again).
// * Planes.  A ring slot holds one (TJ + 2H, 32 + 2H) haloed plane of a field,
//   periodic in i and j, with rows of RS values and the tile's interior at
//   column C0, so that it starts on a 16-byte boundary.  H is the halo of
//   the widest horizontal reach (3) unless a kernel gives its own (HALO,
//   1 for the 2nd-order sweep); C0 and RS serve any halo up to 3.  PlaneLoader works out
//   once per block which copies each thread makes (the periodic wrap taken
//   once); a copy is 16 bytes of a row's interior where the tile's whole
//   interior lies inside the plane, itot is a multiple of 16 bytes and every
//   field is 16-byte aligned, else one value; the halo columns go one value
//   at a time.  The copies are cp.async; the caller commits one group a level
//   and waits for the group it needs with one barrier.
// * Table rows.  The per-level weight rows (NC values) follow the planes into
//   a small ring in shared memory, once per block instead of once per thread.
#pragma once

#include "common.cuh"

namespace mhh {
namespace km {

constexpr int TI = 32;       // tile width in i (one warp)
constexpr int H = 3;         // halo of the widest horizontal reach
constexpr int C0 = 4;        // column of the tile's first interior value
constexpr int RS = 40;       // values a row of a ring slot (C0 + TI + H, padded)
constexpr int NCP = 28;      // values a staged table row (27 columns, padded)
constexpr int VEC = 1 << 16; // flag of a 16-byte copy in PlaneLoader::dst

template <int TJ, int HALO = H>
struct Slot {
    static_assert(HALO >= 1 && HALO <= C0 && C0 + TI + HALO <= RS, "halo");
    static constexpr int ROWS = TJ + 2 * HALO;
    static constexpr int SIZE = ROWS * RS;
};

// chunk z of `chunks` over [0, ktot): [k0, k1)
__device__ __forceinline__ void chunk_bounds(int z, int chunks, int ktot,
                                             int& k0, int& k1) {
    k0 = (int)((long long)z * ktot / chunks);
    k1 = (int)((long long)(z + 1) * ktot / chunks);
}

// asynchronous copies of N bytes, global to shared (s a shared-window
// address)
template <int N>
__device__ __forceinline__ void cp_async(unsigned s, const void* gmem) {
    if (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                     "l"(gmem)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                     "l"(gmem), "n"(N)
                     : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    cp_async<N>((unsigned)__cvta_generic_to_shared(smem), gmem);
}

__device__ __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wait_pending() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Which values of a haloed plane this thread copies, and where to.
template <typename T, int TJ, int NT, int HALO = H>
struct PlaneLoader {
    static constexpr int ROWS = Slot<TJ, HALO>::ROWS;
    static constexpr int VPR = TI * (int)sizeof(T) / 16;  // pieces a row
    static constexpr int VW = 16 / (int)sizeof(T);        // values a piece
    static constexpr int VOPS = ROWS * (VPR + 2 * HALO);
    static constexpr int SOPS = ROWS * (TI + 2 * HALO);
    static constexpr int NOP = (SOPS + NT - 1) / NT;
    int src[NOP];  // offset in the plane, or -1
    int dst[NOP];  // offset in the slot | VEC

    __device__ __forceinline__ PlaneLoader(int tid, int i0, int j0, int itot,
                                           int jtot, bool vec) {
        const int nops = vec ? VOPS : SOPS;
#pragma unroll
        for (int n = 0; n < NOP; ++n) {
            const int op = tid + n * NT;
            src[n] = -1;
            dst[n] = 0;
            if (op >= nops) continue;
            int r, c, flag = 0;
            if (vec) {
                r = op / (VPR + 2 * HALO);
                const int e = op - r * (VPR + 2 * HALO);
                if (e < VPR) {
                    c = C0 + e * VW;
                    flag = VEC;
                } else {
                    c = e - VPR < HALO ? C0 - HALO + (e - VPR)
                                       : C0 + TI + (e - VPR - HALO);
                }
            } else {
                r = op / (TI + 2 * HALO);
                c = C0 - HALO + (op - r * (TI + 2 * HALO));
            }
            src[n] = wrap(j0 + r - HALO, jtot) * itot + wrap(i0 + c - C0, itot);
            dst[n] = (r * RS + c) | flag;
        }
    }

    // start the copies of one plane (a points at its first value) into slot
    __device__ __forceinline__ void issue(T* slot, const T* a) const {
#pragma unroll
        for (int n = 0; n < NOP; ++n) {
            if (src[n] < 0) continue;
            T* d = slot + (dst[n] & (VEC - 1));
            if (dst[n] & VEC)
                cp_async<16>(d, a + src[n]);
            else
                cp_async<sizeof(T)>(d, a + src[n]);
        }
    }
};

// true for a field whose planes a block may copy 16 bytes at a time
inline bool aligned16(const void* p) {
    return ((unsigned long long)p & 15ull) == 0;
}

// start the copy of table row r (nc values) into a staged row
template <typename T>
__device__ __forceinline__ void issue_row(T* dst, const T* cc, int r, int nc,
                                          int tid) {
    if (tid < nc) cp_async<sizeof(T)>(dst + tid, cc + (long long)r * nc + tid);
}

// six consecutive taps of a staged row (p 8-byte aligned for float, 16 for
// double), three vector loads
template <typename T>
__device__ __forceinline__ void load6(const T* p, T (&w)[6]);

template <>
__device__ __forceinline__ void load6<float>(const float* p, float (&w)[6]) {
    const float2 a = reinterpret_cast<const float2*>(p)[0];
    const float2 b = reinterpret_cast<const float2*>(p)[1];
    const float2 c = reinterpret_cast<const float2*>(p)[2];
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y; w[4] = c.x; w[5] = c.y;
}

template <>
__device__ __forceinline__ void load6<double>(const double* p,
                                              double (&w)[6]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    const double2 c = reinterpret_cast<const double2*>(p)[2];
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y; w[4] = c.x; w[5] = c.y;
}

// What a launch reports of a kernel: registers, bytes of local memory a
// thread (spills, stack), dynamic shared memory a block, resident blocks an
// SM, SMs.
template <typename K>
int kernel_info(K kernel, int threads, size_t smem, int* out) {
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    cudaFuncAttributes a;
    if ((rc = (int)cudaFuncGetAttributes(&a, kernel))) return rc;
    int blocks = 0, dev = 0, sms = 0;
    if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, kernel, threads, smem)))
        return rc;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)))
        return rc;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)smem;
    out[3] = blocks;
    out[4] = sms;
    return 0;
}

}  // namespace km
}  // namespace mhh
