// K1: strain rate squared and the stability-corrected Smagorinsky eddy
// viscosity on the interior levels (diff_smag2.cxx calc_strain2 +
// calc_evisc).
//
// Replaces the TPU kernel FusedLES2.evisc / _evisc_body
// (microhh_tpu/ops/pallas_fused.py:1417, pallas_call :1441), full-plane
// variant, in its two modes.  ghosts = 0 (the dry path, fold_ghosts): the
// fields are read raw and the k index of each neighbour plane is clamped
// (u, v, th to [ks, ke-1], w to [ks, ke]), which equals the ghost value for
// the zero-gradient top BCs.  ghosts = 1 (the generic path): the fields
// are ghost-filled and read at k-1 and k+1 as they are; the stratified
// term is then the moist N2 of thl against thvref (model.py:964-970).  The
// MOST wall row is patched afterwards in torch (ops/fused.py
// surface_evisc_row).
//
// K14: the same eddy viscosity with the buoyancy frequency N2 read from an
// interior (ktot, jtot, itot) field that the thermodynamics computed
// (thermo buoy's background N2, thermo dry on the generic path) instead of
// taken from a scalar's gradient: stratified = 2, the th argument is then
// that field, read at the point with no ring.  Replaces FusedLES2.evisc_n2 /
// _evisc_n2_body (pallas_fused.py:1480, pallas_call :1496); it runs on
// ghost-filled fields.  Its entry is mhh_evisc_n2.
//
// K7: the adaptive-dt limits pass, the per-level maxima of the CFL rate
// (advec_2.cxx:50-78 pointwise expression) and of the same eddy viscosity,
// in one read of u, v, w, th and with no field-sized write.  Replaces
// FusedLES2.limits_pass / _limits_body (pallas_fused.py:1502, pallas_call
// :1524); the per-level dt factors and the MOST row are applied by the
// caller on the (ktot,) maxima, as the JAX package does.
//
// Bound: device-memory bytes.  Per output point K1 does ~100 flops on 4
// field reads and 1 write (~20 B in f32), far below the H100's ~20 flop/B
// balance.  Design: the k-marching tile with a shared-memory ring
// (common.cuh) reads each field once (plus a 1/3 halo) and writes the
// output once; the per-level coefficients come from a small table that
// every thread of a block reads at the same address.  K7 reduces each
// level's tile to one maximum per block (warp shuffles, then one slot per
// warp) and writes it to a (2, ktot, blocks) partial array; a second small
// kernel takes the maximum over the blocks, so the result does not depend
// on the order in which blocks finish.
#include "les_math.cuh"

namespace mhh {

// the four fields' ring: u, v, w, th
template <typename T>
using Ring = T[4][3][HJ][HI];

// plane ks+p of each field; cell-centred planes clamped to [lo, hic] and
// w to [lo, ke] (lo = ks, hic = ke-1 clamp; lo = ks-1, hic = ke read the
// ghost planes)
template <typename T>
__device__ __forceinline__ void load_ring(Ring<T>& sh, const T* __restrict__ u,
                                          const T* __restrict__ v,
                                          const T* __restrict__ w,
                                          const T* __restrict__ th, int p,
                                          int ks, int ke, int lo, int hic,
                                          int j0, int i0, int jtot, int itot) {
    const int s = slot(p);
    load_tile(sh[0][s], u, clampi(ks + p, lo, hic), j0, i0, jtot, itot);
    load_tile(sh[1][s], v, clampi(ks + p, lo, hic), j0, i0, jtot, itot);
    load_tile(sh[2][s], w, clampi(ks + p, lo, ke), j0, i0, jtot, itot);
    if (th)
        load_tile(sh[3][s], th, clampi(ks + p, lo, hic), j0, i0, jtot, itot);
}

// eddy viscosity at interior level k of the thread's tile point
// (les_math.cuh evisc_math on the ring's views)
template <typename T>
__device__ __forceinline__ T evisc_point(const Ring<T>& sh, int k,
                                         const T* __restrict__ ce, T dxi,
                                         T dyi, T tPr, int stratified,
                                         T n2ext) {
    return evisc_math(view<T>(sh[0]), view<T>(sh[1]), view<T>(sh[2]),
                      view<T>(sh[3]), slots(k), ce + (long long)k * NE, dxi,
                      dyi, tPr, stratified, n2ext);
}

#define U(s, dj, di) sh[0][s][r + (dj)][c + (di)]
#define V(s, dj, di) sh[1][s][r + (dj)][c + (di)]
#define W(s, dj, di) sh[2][s][r + (dj)][c + (di)]

// CFL rate at interior level k (advec_2 cfl_max pointwise expression)
template <typename T>
__device__ __forceinline__ T cfl_point(const Ring<T>& sh, int k,
                                       const T* __restrict__ ce, T dxi,
                                       T dyi) {
    const int kc = slot(k), kp = slot(k + 1);
    const int r = threadIdx.y + 1, c = threadIdx.x + 1;
    const T half = T(0.5);
    return fabs(half * (U(kc, 0, 0) + U(kc, 0, 1))) * dxi
           + fabs(half * (V(kc, 0, 0) + V(kc, 1, 0))) * dyi
           + fabs(half * (W(kc, 0, 0) + W(kp, 0, 0))) * ce[(long long)k * NE + E_DZI];
}

#undef U
#undef V
#undef W

template <typename T>
__global__ void __launch_bounds__(TI * TJ)
evisc_kernel(const T* __restrict__ u, const T* __restrict__ v,
             const T* __restrict__ w, const T* __restrict__ th,
             T* __restrict__ out, const T* __restrict__ ce,
             int itot, int jtot, int ktot, int ks,
             T dxi, T dyi, T tPr, int stratified, int ghosts) {
    __shared__ Ring<T> sh;
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const int ke = ks + ktot;
    const int lo = ghosts ? ks - 1 : ks, hic = ghosts ? ke : ke - 1;
    const long long plane = (long long)itot * jtot;

    // stratified = 2: th is the interior N2 field, read at the point
    const T* ring_th = stratified == 2 ? nullptr : th;

    load_ring(sh, u, v, w, ring_th, -1, ks, ke, lo, hic, j0, i0, jtot, itot);
    load_ring(sh, u, v, w, ring_th, 0, ks, ke, lo, hic, j0, i0, jtot, itot);
    for (int k = 0; k < ktot; ++k) {
        load_ring(sh, u, v, w, ring_th, k + 1, ks, ke, lo, hic, j0, i0, jtot,
                  itot);
        __syncthreads();
        if (inside) {
            const long long o = (long long)k * plane + (long long)j * itot + i;
            const T n2 = stratified == 2 ? __ldg(th + o) : T(0);
            out[o] = evisc_point(sh, k, ce, dxi, dyi, tPr, stratified, n2);
        }
        __syncthreads();
    }
}

// max that keeps a NaN, as jnp.max does
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
    return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
    for (int off = 16; off > 0; off >>= 1)
        x = nanmax(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

template <typename T>
__global__ void __launch_bounds__(TI * TJ)
limits_kernel(const T* __restrict__ u, const T* __restrict__ v,
              const T* __restrict__ w, const T* __restrict__ th,
              T* __restrict__ part, const T* __restrict__ ce,
              int itot, int jtot, int ktot, int ks,
              T dxi, T dyi, T tPr, int stratified, int ghosts) {
    constexpr int NW = TI * TJ / 32;
    __shared__ Ring<T> sh;
    __shared__ T red[2][NW];
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const int ke = ks + ktot;
    const int lo = ghosts ? ks - 1 : ks, hic = ghosts ? ke : ke - 1;
    const int tid = threadIdx.y * TI + threadIdx.x;
    const long long plane = (long long)itot * jtot;
    const T* ring_th = stratified == 2 ? nullptr : th;
    const long long nblk = (long long)gridDim.x * gridDim.y;
    const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;

    load_ring(sh, u, v, w, ring_th, -1, ks, ke, lo, hic, j0, i0, jtot, itot);
    load_ring(sh, u, v, w, ring_th, 0, ks, ke, lo, hic, j0, i0, jtot, itot);
    for (int k = 0; k < ktot; ++k) {
        load_ring(sh, u, v, w, ring_th, k + 1, ks, ke, lo, hic, j0, i0, jtot,
                  itot);
        __syncthreads();
        // both rates are >= 0: a point outside the grid contributes 0
        T cfl = T(0), ev = T(0);
        if (inside) {
            cfl = cfl_point(sh, k, ce, dxi, dyi);
            const T n2 = stratified == 2
                ? __ldg(th + (long long)k * plane + (long long)j * itot + i)
                : T(0);
            ev = evisc_point(sh, k, ce, dxi, dyi, tPr, stratified, n2);
        }
        cfl = warp_max(cfl);
        ev = warp_max(ev);
        if ((tid & 31) == 0) {
            red[0][tid >> 5] = cfl;
            red[1][tid >> 5] = ev;
        }
        __syncthreads();
        if (tid == 0) {
            for (int q = 1; q < NW; ++q) {
                cfl = nanmax(cfl, red[0][q]);
                ev = nanmax(ev, red[1][q]);
            }
            part[(long long)k * nblk + blk] = cfl;
            part[((long long)ktot + k) * nblk + blk] = ev;
        }
        __syncthreads();
    }
}

// out[row] = max over the nblk partial maxima of row (2*ktot rows)
template <typename T>
__global__ void __launch_bounds__(256)
limits_reduce(const T* __restrict__ part, T* __restrict__ out, long long nblk) {
    __shared__ T red[256 / 32];
    const T* row = part + (long long)blockIdx.x * nblk;
    T m = T(0);
    for (long long q = threadIdx.x; q < nblk; q += blockDim.x)
        m = nanmax(m, row[q]);
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int q = 1; q < 256 / 32; ++q) m = nanmax(m, red[q]);
        out[blockIdx.x] = m;
    }
}

template <typename T>
int launch_evisc(const T* u, const T* v, const T* w, const T* th, T* out,
                 const T* ce, int itot, int jtot, int ktot, int ks, double dxi,
                 double dyi, double tPr, int stratified, int ghosts,
                 cudaStream_t stream) {
    const dim3 block(TI, TJ);
    const dim3 grid((itot + TI - 1) / TI, (jtot + TJ - 1) / TJ);
    evisc_kernel<T><<<grid, block, 0, stream>>>(
        u, v, w, th, out, ce, itot, jtot, ktot, ks, T(dxi), T(dyi), T(tPr),
        stratified, ghosts);
    return (int)cudaGetLastError();
}

// part: (2, ktot, tiles) scratch, tiles = ceil(itot/TI) * ceil(jtot/TJ);
// out: (2, ktot) per-level maxima of the CFL rate and the eddy viscosity
template <typename T>
int launch_limits(const T* u, const T* v, const T* w, const T* th, T* part,
                  T* out, const T* ce, int itot, int jtot, int ktot, int ks,
                  double dxi, double dyi, double tPr, int stratified,
                  int ghosts, cudaStream_t stream) {
    const dim3 block(TI, TJ);
    const dim3 grid((itot + TI - 1) / TI, (jtot + TJ - 1) / TJ);
    limits_kernel<T><<<grid, block, 0, stream>>>(
        u, v, w, th, part, ce, itot, jtot, ktot, ks, T(dxi), T(dyi), T(tPr),
        stratified, ghosts);
    if (int rc = (int)cudaGetLastError()) return rc;
    limits_reduce<T><<<2 * ktot, 256, 0, stream>>>(
        part, out, (long long)grid.x * grid.y);
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_EVISC(SUF, T)                                                     \
    extern "C" int mhh_evisc_##SUF(                                           \
        const void* u, const void* v, const void* w, const void* th,          \
        void* out, const void* ce, int itot, int jtot, int ktot, int ks,      \
        double dxi, double dyi, double tPr, int stratified, int ghosts,       \
        void* stream) {                                                       \
        return mhh::launch_evisc<T>((const T*)u, (const T*)v, (const T*)w,    \
                                    (const T*)th, (T*)out, (const T*)ce,      \
                                    itot, jtot, ktot, ks, dxi, dyi, tPr,      \
                                    stratified, ghosts, (cudaStream_t)stream);\
    }                                                                         \
    extern "C" int mhh_evisc_n2_##SUF(                                        \
        const void* u, const void* v, const void* w, const void* n2,          \
        void* out, const void* ce, int itot, int jtot, int ktot, int ks,      \
        double dxi, double dyi, double tPr, void* stream) {                   \
        return mhh::launch_evisc<T>((const T*)u, (const T*)v, (const T*)w,    \
                                    (const T*)n2, (T*)out, (const T*)ce,      \
                                    itot, jtot, ktot, ks, dxi, dyi, tPr, 2,   \
                                    1, (cudaStream_t)stream);                 \
    }                                                                         \
    extern "C" int mhh_limits_##SUF(                                          \
        const void* u, const void* v, const void* w, const void* th,          \
        void* part, void* out, const void* ce, int itot, int jtot, int ktot,  \
        int ks, double dxi, double dyi, double tPr, int stratified,           \
        int ghosts, void* stream) {                                           \
        return mhh::launch_limits<T>((const T*)u, (const T*)v, (const T*)w,   \
                                     (const T*)th, (T*)part, (T*)out,         \
                                     (const T*)ce, itot, jtot, ktot, ks, dxi, \
                                     dyi, tPr, stratified, ghosts,            \
                                     (cudaStream_t)stream);                   \
    }

MHH_EVISC(f32, float)
MHH_EVISC(f64, double)
