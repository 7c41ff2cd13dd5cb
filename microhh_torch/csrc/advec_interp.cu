// K12 and K13: the interpolated advection schemes 2i4 / 2i5 / 2i53 / 2i62
// (advec_2i4.cxx, advec_2i5.cxx, advec_2i53.cxx, advec_2i62.cxx) added into
// the RK carry in one pass per field group.
//
// K12 advec_mom: tu, tv, tw += advection of u, v, w.  Replaces the momentum
// call of AdvecInterpPallas._core (microhh_tpu/ops/advec_interp_pallas.py
// :362, pallas_call :379; body _mom_body :248).
// K13 advec_scalars: each of S scalars' carry += its advection, with u, v, w
// read once for all of them.  Replaces the scalar call (:403; body
// _scalar_body :294).
//
// Horizontal: the advecting velocity is interpolated 2nd-order to the flux
// face, the transported quantity by a 6-tap centred (4-tap for 2i4) value
// plus, for 2i5 and 2i53, a 5-tap upwind part weighted with |velocity|;
// taps reach i +- 3 and j +- 3, periodic.  Vertical: row k of the table cc
// (ops/advec_interp_fused.py build_interp_tables) holds six density-
// prescaled tap weights per face and centre, applied to planes k-3..k+3
// whose index is CLAMPED to the interior ([ks, ke-1] for u, v and the
// scalars, [ks, ke] for w): the zero weights near a wall, not the ghost
// planes, make the wall fluxes right, so one body serves every rung of the
// ladder and the four schemes differ only in the table and in two
// compile-time flags (C4: 4th-order centred horizontal; UP: upwind parts).
//
// Bound: device-memory bytes.  K12 reads u, v, w and reads and writes the
// three carries: 9 x 4 B per point in f32 (2.05 GB at 384^3), ~400 flops
// per point.  K13 with S scalars reads 3 + 2S fields and writes S: 15 x 4 B
// for S = 4 (3.41 GB).  Design: a block of AI x AJ threads owns an (AJ, AI)
// tile and marches in k; each field keeps a ring of seven (AJ+6) x (AI+6)
// planes (tile + 3-cell periodic halo) in dynamic shared memory, so a field
// is read from device memory once plus the halo (1.63x, mostly served by
// L2).  K13 keeps S such rings and reads u, v, w, which it needs only at
// the point and its +1 neighbours, straight from global memory; the
// wrapper splits the scalars over launches when their rings exceed a
// block's shared memory.  The carries are updated in place.
#include "common.cuh"

namespace mhh {

// table columns (ops/advec_interp_fused.py)
enum { WXF = 0, WUF = 6, WXC = 12, WUC = 18, RCDZI = 24, RHDZHI = 25,
       WMASK = 26, NC = 27 };

constexpr int AI = 32;
constexpr int AJ = 16;
constexpr int AH = 3;
constexpr int WI = AI + 2 * AH;
constexpr int WJ = AJ + 2 * AH;
constexpr int NR = 7;
constexpr int MAXA = 8;

extern __shared__ __align__(16) unsigned char adv_smem[];

__device__ __forceinline__ int slot7(int p) { return (p + NR) % NR; }

template <typename T>
__device__ __forceinline__ void load_tile7(T (*sh)[WI], const T* __restrict__ a,
                                           long long level, int j0, int i0,
                                           int jtot, int itot) {
    const long long base = level * (long long)jtot * itot;
    for (int idx = threadIdx.y * AI + threadIdx.x; idx < WJ * WI;
         idx += AI * AJ) {
        const int r = idx / WI;
        const int c = idx - r * WI;
        const int jg = wrap(j0 + r - AH, jtot);
        const int ig = wrap(i0 + c - AH, itot);
        sh[r][c] = __ldg(a + base + (long long)jg * itot + ig);
    }
}

// one field's seven-plane ring seen from the thread's point
template <typename T>
struct View7 {
    const T (*ring)[WJ][WI];
    int r, c;
    __device__ __forceinline__ T operator()(int s, int dj, int di) const {
        return ring[s][r + dj][c + di];
    }
};

template <typename T>
__device__ __forceinline__ View7<T> view7(const T (*ring)[WJ][WI]) {
    return View7<T>{ring, (int)threadIdx.y + AH, (int)threadIdx.x + AH};
}

// Flux divergence along one axis (before the 1/dx factor): q(d) is the
// transported quantity at offset d along the axis, vR and vL the advecting
// velocities at the right and the left face of the point.
template <bool C4, bool UP, typename T, typename F>
__device__ __forceinline__ T hdiv(F q, T vR, T vL) {
    const T qm3 = q(-3), qm2 = q(-2), qm1 = q(-1), q0 = q(0), qp1 = q(1),
            qp2 = q(2), qp3 = q(3);
    T cR, cL;
    if (C4) {
        const T ci0 = T(-1. / 16.), ci1 = T(9. / 16.);
        cR = ci0 * qm1 + ci1 * q0 + ci1 * qp1 + ci0 * qp2;
        cL = ci0 * qm2 + ci1 * qm1 + ci1 * q0 + ci0 * qp1;
    } else {
        const T a = T(37. / 60.), b = T(8. / 60.), c = T(1. / 60.);
        cR = a * (q0 + qp1) - b * (qm1 + qp2) + c * (qm2 + qp3);
        cL = a * (qm1 + q0) - b * (qm2 + qp1) + c * (qm3 + qp2);
    }
    T out = -(vR * cR - vL * cL);
    if (UP) {
        const T a = T(10. / 60.), b = T(5. / 60.), c = T(1. / 60.);
        const T uR = a * (qp1 - q0) - b * (qp2 - qm1) + c * (qp3 - qm2);
        const T uL = a * (q0 - qm1) - b * (qp1 - qm2) + c * (qp2 - qm3);
        out = out + (fabs(vR) * uR - fabs(vL) * uL);
    }
    return out;
}

// sum over the six taps of row[base + j] * Q(plane p0 + j) at the point
template <typename T>
__device__ __forceinline__ T wsum(const T* __restrict__ row, int base,
                                  const View7<T>& Q, int p0) {
    T acc = row[base] * Q(slot7(p0), 0, 0);
#pragma unroll
    for (int j = 1; j < 6; ++j)
        acc = acc + row[base + j] * Q(slot7(p0 + j), 0, 0);
    return acc;
}

// Vertical flux divergence of a cell-centred quantity at level k: faces k
// (advecting wf0, table row r0) and k+1 (wf1, row r1).
template <bool UP, typename T>
__device__ __forceinline__ T vterm(const T* __restrict__ r0,
                                   const T* __restrict__ r1,
                                   const View7<T>& Q, int k, T wf0, T wf1) {
    T adv = -(wf1 * wsum(r1, WXF, Q, k - 2) - wf0 * wsum(r0, WXF, Q, k - 3));
    if (UP)
        adv = adv + (fabs(wf1) * wsum(r1, WUF, Q, k - 2)
                     - fabs(wf0) * wsum(r0, WUF, Q, k - 3));
    return adv * r0[RCDZI];
}

template <typename T, bool C4, bool UP>
__global__ void __launch_bounds__(AI * AJ)
advec_mom_kernel(const T* __restrict__ u, const T* __restrict__ v,
                 const T* __restrict__ w, T* tu, T* tv, T* tw,
                 const T* __restrict__ cc, int itot, int jtot, int ktot,
                 int ks, T dxi, T dyi) {
    // rings: u, v, w
    T (*sh)[NR][WJ][WI] = reinterpret_cast<T (*)[NR][WJ][WI]>(adv_smem);
    const int i0 = blockIdx.x * AI, j0 = blockIdx.y * AJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const int ke = ks + ktot;
    const long long plane = (long long)itot * jtot;
    const View7<T> U = view7<T>(sh[0]), V = view7<T>(sh[1]), W = view7<T>(sh[2]);
    const T half = T(0.5);

    auto load = [&](int p) {
        const int s = slot7(p);
        load_tile7(sh[0][s], u, clampi(ks + p, ks, ke - 1), j0, i0, jtot, itot);
        load_tile7(sh[1][s], v, clampi(ks + p, ks, ke - 1), j0, i0, jtot, itot);
        load_tile7(sh[2][s], w, clampi(ks + p, ks, ke), j0, i0, jtot, itot);
    };

    for (int p = -3; p < 3; ++p) load(p);
    for (int k = 0; k < ktot; ++k) {
        load(k + 3);
        __syncthreads();
        if (inside) {
            const int s0 = slot7(k), sm = slot7(k - 1), sp = slot7(k + 1);
            const T* r0 = cc + (long long)k * NC;
            const T* r1 = r0 + NC;
            const T* rm = cc + (long long)(k > 0 ? k - 1 : 0) * NC;
            const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;

            // ---- u ----
            {
                T t = hdiv<C4, UP, T>([&](int d) { return U(s0, 0, d); },
                                      half * (U(s0, 0, 0) + U(s0, 0, 1)),
                                      half * (U(s0, 0, -1) + U(s0, 0, 0))) * dxi;
                t = t + hdiv<C4, UP, T>([&](int d) { return U(s0, d, 0); },
                                        half * (V(s0, 1, -1) + V(s0, 1, 0)),
                                        half * (V(s0, 0, -1) + V(s0, 0, 0))) * dyi;
                const T wf0 = half * (W(s0, 0, -1) + W(s0, 0, 0));
                const T wf1 = half * (W(sp, 0, -1) + W(sp, 0, 0));
                tu[o] = tu[o] + t + vterm<UP, T>(r0, r1, U, k, wf0, wf1);
            }
            // ---- v ----
            {
                T t = hdiv<C4, UP, T>([&](int d) { return V(s0, 0, d); },
                                      half * (U(s0, -1, 1) + U(s0, 0, 1)),
                                      half * (U(s0, -1, 0) + U(s0, 0, 0))) * dxi;
                t = t + hdiv<C4, UP, T>([&](int d) { return V(s0, d, 0); },
                                        half * (V(s0, 0, 0) + V(s0, 1, 0)),
                                        half * (V(s0, -1, 0) + V(s0, 0, 0))) * dyi;
                const T wf0 = half * (W(s0, -1, 0) + W(s0, 0, 0));
                const T wf1 = half * (W(sp, -1, 0) + W(sp, 0, 0));
                tv[o] = tv[o] + t + vterm<UP, T>(r0, r1, V, k, wf0, wf1);
            }
            // ---- w at half level k; k = 0 is the wall ----
            if (k > 0) {
                T t = hdiv<C4, UP, T>([&](int d) { return W(s0, 0, d); },
                                      half * (U(sm, 0, 1) + U(s0, 0, 1)),
                                      half * (U(sm, 0, 0) + U(s0, 0, 0))) * dxi;
                t = t + hdiv<C4, UP, T>([&](int d) { return W(s0, d, 0); },
                                        half * (V(sm, 1, 0) + V(s0, 1, 0)),
                                        half * (V(sm, 0, 0) + V(s0, 0, 0))) * dyi;
                const T velw0 = half * (W(sm, 0, 0) + W(s0, 0, 0));   // centre k-1
                const T velw1 = half * (W(s0, 0, 0) + W(sp, 0, 0));   // centre k
                T adv = -(velw1 * wsum(r0, WXC, W, k - 2)
                          - velw0 * wsum(rm, WXC, W, k - 3));
                if (UP)
                    adv = adv + (fabs(velw1) * wsum(r0, WUC, W, k - 2)
                                 - fabs(velw0) * wsum(rm, WUC, W, k - 3));
                tw[o] = tw[o] + t + adv * r0[RHDZHI];
            }
        }
        __syncthreads();
    }
}

// the scalars' and their carries' pointers, passed by value
template <typename T>
struct AdvScalars {
    const T* a[MAXA];
    T* ta[MAXA];
};

template <typename T, bool C4, bool UP>
__global__ void __launch_bounds__(AI * AJ)
advec_scalars_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ w, const AdvScalars<T> sc, int S,
                     const T* __restrict__ cc, int itot, int jtot, int ktot,
                     int ks, T dxi, T dyi) {
    // one ring per scalar
    T (*sh)[NR][WJ][WI] = reinterpret_cast<T (*)[NR][WJ][WI]>(adv_smem);
    const int i0 = blockIdx.x * AI, j0 = blockIdx.y * AJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const int ke = ks + ktot;
    const long long plane = (long long)itot * jtot;
    // the point and its +1 neighbours in the plane
    const long long o2 = (long long)j * itot + i;
    const long long o2_ip = (long long)j * itot + wrap(i + 1, itot);
    const long long o2_jp = (long long)wrap(j + 1, jtot) * itot + i;

    auto load = [&](int p) {
        const int s = slot7(p);
        for (int n = 0; n < S; ++n)
            load_tile7(sh[n][s], sc.a[n], clampi(ks + p, ks, ke - 1), j0, i0,
                       jtot, itot);
    };

    for (int p = -3; p < 3; ++p) load(p);
    for (int k = 0; k < ktot; ++k) {
        load(k + 3);
        __syncthreads();
        if (inside) {
            const int s0 = slot7(k);
            const T* r0 = cc + (long long)k * NC;
            const T* r1 = r0 + NC;
            const long long lev = (long long)(ks + k) * plane;
            const T uL = __ldg(u + lev + o2), uR = __ldg(u + lev + o2_ip);
            const T vL = __ldg(v + lev + o2), vR = __ldg(v + lev + o2_jp);
            const T w0 = __ldg(w + lev + o2), w1 = __ldg(w + lev + plane + o2);
            for (int n = 0; n < S; ++n) {
                const View7<T> A = view7<T>(sh[n]);
                T t = hdiv<C4, UP, T>([&](int d) { return A(s0, 0, d); }, uR, uL) * dxi;
                t = t + hdiv<C4, UP, T>([&](int d) { return A(s0, d, 0); }, vR, vL) * dyi;
                t = t + vterm<UP, T>(r0, r1, A, k, w0, w1);
                sc.ta[n][lev + o2] = sc.ta[n][lev + o2] + t;
            }
        }
        __syncthreads();
    }
}

template <typename K>
static int raise_smem(K kernel, size_t smem) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool C4, bool UP>
int launch_mom(const T* u, const T* v, const T* w, T* tu, T* tv, T* tw,
               const T* cc, int itot, int jtot, int ktot, int ks, double dxi,
               double dyi, cudaStream_t stream) {
    const size_t smem = (size_t)3 * NR * WJ * WI * sizeof(T);
    if (int rc = raise_smem(advec_mom_kernel<T, C4, UP>, smem)) return rc;
    const dim3 block(AI, AJ);
    const dim3 grid((itot + AI - 1) / AI, (jtot + AJ - 1) / AJ);
    advec_mom_kernel<T, C4, UP><<<grid, block, smem, stream>>>(
        u, v, w, tu, tv, tw, cc, itot, jtot, ktot, ks, T(dxi), T(dyi));
    return (int)cudaGetLastError();
}

template <typename T, bool C4, bool UP>
int launch_scalars(const T* u, const T* v, const T* w, const AdvScalars<T>& sc,
                   int S, const T* cc, int itot, int jtot, int ktot, int ks,
                   double dxi, double dyi, cudaStream_t stream) {
    const size_t smem = (size_t)S * NR * WJ * WI * sizeof(T);
    if (int rc = raise_smem(advec_scalars_kernel<T, C4, UP>, smem)) return rc;
    const dim3 block(AI, AJ);
    const dim3 grid((itot + AI - 1) / AI, (jtot + AJ - 1) / AJ);
    advec_scalars_kernel<T, C4, UP><<<grid, block, smem, stream>>>(
        u, v, w, sc, S, cc, itot, jtot, ktot, ks, T(dxi), T(dyi));
    return (int)cudaGetLastError();
}

// scheme: 0 = 2i4, 1 = 2i5, 2 = 2i53, 3 = 2i62 (ops/advec_interp_fused.py
// SCHEME_ID); 2i5 and 2i53 differ only in the table
template <typename T>
int advec_mom(const T* u, const T* v, const T* w, T* tu, T* tv, T* tw,
              const T* cc, int itot, int jtot, int ktot, int ks, int scheme,
              double dxi, double dyi, cudaStream_t stream) {
    switch (scheme) {
    case 0:
        return launch_mom<T, true, false>(u, v, w, tu, tv, tw, cc, itot, jtot,
                                          ktot, ks, dxi, dyi, stream);
    case 1:
    case 2:
        return launch_mom<T, false, true>(u, v, w, tu, tv, tw, cc, itot, jtot,
                                          ktot, ks, dxi, dyi, stream);
    case 3:
        return launch_mom<T, false, false>(u, v, w, tu, tv, tw, cc, itot, jtot,
                                           ktot, ks, dxi, dyi, stream);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int advec_scalars(const T* u, const T* v, const T* w, const void* const* a,
                  void* const* ta, int S, const T* cc, int itot, int jtot,
                  int ktot, int ks, int scheme, double dxi, double dyi,
                  cudaStream_t stream) {
    if (S < 1 || S > MAXA) return (int)cudaErrorInvalidValue;
    AdvScalars<T> sc;
    for (int n = 0; n < MAXA; ++n) {
        sc.a[n] = n < S ? (const T*)a[n] : nullptr;
        sc.ta[n] = n < S ? (T*)ta[n] : nullptr;
    }
    switch (scheme) {
    case 0:
        return launch_scalars<T, true, false>(u, v, w, sc, S, cc, itot, jtot,
                                              ktot, ks, dxi, dyi, stream);
    case 1:
    case 2:
        return launch_scalars<T, false, true>(u, v, w, sc, S, cc, itot, jtot,
                                              ktot, ks, dxi, dyi, stream);
    case 3:
        return launch_scalars<T, false, false>(u, v, w, sc, S, cc, itot, jtot,
                                               ktot, ks, dxi, dyi, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace mhh

#define MHH_ADVEC_INTERP(SUF, T)                                              \
    extern "C" int mhh_advec_mom_##SUF(                                       \
        const void* u, const void* v, const void* w, void* tu, void* tv,      \
        void* tw, const void* cc, int itot, int jtot, int ktot, int ks,       \
        int scheme, double dxi, double dyi, void* stream) {                   \
        return mhh::advec_mom<T>((const T*)u, (const T*)v, (const T*)w,       \
                                 (T*)tu, (T*)tv, (T*)tw, (const T*)cc, itot,  \
                                 jtot, ktot, ks, scheme, dxi, dyi,            \
                                 (cudaStream_t)stream);                       \
    }                                                                         \
    extern "C" int mhh_advec_scalars_##SUF(                                   \
        const void* u, const void* v, const void* w, const void* const* a,    \
        void* const* ta, int S, const void* cc, int itot, int jtot, int ktot, \
        int ks, int scheme, double dxi, double dyi, void* stream) {           \
        return mhh::advec_scalars<T>((const T*)u, (const T*)v, (const T*)w,   \
                                     a, ta, S, (const T*)cc, itot, jtot,      \
                                     ktot, ks, scheme, dxi, dyi,              \
                                     (cudaStream_t)stream);                   \
    }

MHH_ADVEC_INTERP(f32, float)
MHH_ADVEC_INTERP(f64, double)
