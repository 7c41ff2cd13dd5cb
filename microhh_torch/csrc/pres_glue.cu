// K4: the projection glue around the spectral Poisson solve
// (pres_2.cxx:156-196 and :364-387).
//
// Replaces the TPU kernel family PresGlue (microhh_tpu/ops/pallas_fused.py):
//  * pres_rhs  <- PresGlue.rhs (:2591, pallas_call :2604, _pres_rhs_body):
//    rhs = dti * div(rho s*) on the interior levels, in one pass over s*;
//  * pres_apply <- PresGlue.apply (:2613, pallas_call :2634,
//    _pres_apply_uvw_body): s* -= dt grad p and, unless it is the last
//    substep, t -= cA_next grad p, for u, v and w, updated IN PLACE.
// dti and dt are read from device scalars (the step's, taken on the card),
// so that a launch captured in a CUDA graph reads each step's value.
//
// Bound: device-memory bytes (a few flops per value).
//
// pres_rhs: one thread per (j, i) column marching all of k, w at the upper
// half level carried to the next level in a register; the i/j neighbours
// are read from device memory by the adjacent threads of the same warp and
// hit in L1.
//
// pres_apply (pres_apply_kernel<T, CARRY>): p (ktot, jtot, itot) read, the
// six arrays su, sv, sw and, with the carry, tu, tv, tw read and written in
// place: 13 x 4 B a point in f32 (6.98 GB at 512^3), 7 without the carry
// (the last substep), a few operations a value.  Design: a k-split march
// without shared memory.  A block of 32 x PA_TJ threads owns a tile of
// PA_TJ rows of 32 x VW values (VW = 16 / sizeof(T): one 16-byte access a
// thread and array where the row is aligned, else VW single values, those
// past itot neither read nor written) and marches one chunk [k0, k1) of the
// levels (the chunk count chosen by the wrapper, ops/kmarch.py plan, so
// that the grid fills the card in whole waves).  A thread reads p's values
// at its own points and at the row j-1 below them (periodic; the row of
// the warp below, an L1 or L2 hit), gets p at i-1 from the lane to its left
// (__shfl_up_sync; lane 0 reads it, periodic), and carries p of the level
// below in registers for the vertical gradient: the chunk reads p at k0-1
// first (none below k = 0, where the gradient is zero: the wall).  Every
// value of a level (p's and the six arrays') is loaded one level ahead,
// before the stores of the level in hand, so that a level's loads are in
// flight while the one before computes and stores.  The six arrays are not
// __restrict__: each value is read and written by its own thread, its
// loads issued before any store to it.
#include <cuda_runtime.h>

#include "kmarch.cuh"

namespace mhh {

// per-level table columns (ops/fused.py P_*)
enum { P_RHO, P_RHOH, P_RHOH1, P_DZI, P_DZHI, NP };

template <typename T>
__global__ void pres_rhs_kernel(const T* __restrict__ u,
                                const T* __restrict__ v,
                                const T* __restrict__ w, T* __restrict__ out,
                                const T* __restrict__ pc, int itot, int jtot,
                                int ktot, int ks, T dxi, T dyi,
                                const T* __restrict__ dti_dev) {
    const long long plane = (long long)itot * jtot;
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= plane) return;
    const T dti = __ldg(dti_dev);
    const int j = (int)(n / itot), i = (int)(n - (long long)j * itot);
    const long long nip = (long long)j * itot + (i + 1 == itot ? 0 : i + 1);
    const long long njp = (long long)(j + 1 == jtot ? 0 : j + 1) * itot + i;
    T wk = w[(long long)ks * plane + n];
    for (int k = 0; k < ktot; ++k) {
        const T* c = pc + k * NP;
        const long long b = (long long)(ks + k) * plane;
        const T w1 = w[b + plane + n];
        const T uc = u[b + n], vc = v[b + n];
        out[(long long)k * plane + n] =
            dti * (c[P_RHO] * ((u[b + nip] - uc) * dxi + (v[b + njp] - vc) * dyi)
                   + (c[P_RHOH1] * w1 - c[P_RHOH] * wk) * c[P_DZI]);
        wk = w1;
    }
}

constexpr int PA_TJ = 8;                 // tile rows (32 x PA_TJ threads)
constexpr int PA_NT = km::TI * PA_TJ;

// 16 bytes of a row: VW values
template <typename T>
struct alignas(16) Vals {
    static constexpr int VW = 16 / (int)sizeof(T);
    T v[VW];
};

template <typename T> struct Vec16;
template <> struct Vec16<float> { typedef float4 type; };
template <> struct Vec16<double> { typedef double2 type; };

// the values a of the row at q: n of them (the rest 0), or all VW at once
// (vec); p read only (ro) goes through the read-only path
template <typename T, bool RO>
__device__ __forceinline__ void load_vals(Vals<T>& a, const T* q, bool vec,
                                          int n) {
    typedef typename Vec16<T>::type V;
    if (vec) {
        if (RO)
            *reinterpret_cast<V*>(a.v) = __ldg(reinterpret_cast<const V*>(q));
        else
            *reinterpret_cast<V*>(a.v) = *reinterpret_cast<const V*>(q);
        return;
    }
#pragma unroll
    for (int e = 0; e < Vals<T>::VW; ++e)
        a.v[e] = e < n ? (RO ? __ldg(q + e) : q[e]) : T(0);
}

template <typename T>
__device__ __forceinline__ void store_vals(T* q, const Vals<T>& a, bool vec,
                                           int n) {
    typedef typename Vec16<T>::type V;
    if (vec) {
        *reinterpret_cast<V*>(q) = *reinterpret_cast<const V*>(a.v);
        return;
    }
#pragma unroll
    for (int e = 0; e < Vals<T>::VW; ++e)
        if (e < n) q[e] = a.v[e];
}

// everything a launch takes but its template arguments
template <typename T>
struct ApplyArgs {
    const T* p;
    T *su, *sv, *sw;      // s*, in place
    T *tu, *tv, *tw;      // the carries, in place (null without CARRY)
    const T* pc;          // (ktot, NP)
    const T* dt;          // the step's dt, a device scalar
    int itot, jtot, ktot, ks;
    T dxi, dyi, can;
    int chunks, vec_ok;
};

// what a thread reads of one level: p at its points, at the row below and
// (lane 0) left of its first point, the six arrays and dzhi
template <typename T, bool CARRY>
struct ApplyLevel {
    Vals<T> p, pj, s[3], t[CARRY ? 3 : 1];
    T pl, dzhi;
};

// two blocks an SM (at most 128 registers): at three (80) the level read
// ahead spilled 196 B and ran 3.57 against 2.52 ms at 512^3 f32 on an
// H100 at 700 W; streaming cache hints on the six arrays changed nothing
template <typename T, bool CARRY>
__global__ void __launch_bounds__(PA_NT, 2)
pres_apply_kernel(const ApplyArgs<T> a) {
    constexpr int VW = Vals<T>::VW;
    const int tx = threadIdx.x, j = blockIdx.y * PA_TJ + threadIdx.y;
    // a warp is one row of the tile: a row past the plane has nothing to do
    if (j >= a.jtot) return;
    const int i = (blockIdx.x * km::TI + tx) * VW;
    const int n = min(VW, a.itot - i);   // values inside the row; <= 0: none
    const bool vec = a.vec_ok;
    int k0, k1;
    km::chunk_bounds(blockIdx.z, a.chunks, a.ktot, k0, k1);
    const long long plane = (long long)a.itot * a.jtot;
    const long long me = (long long)j * a.itot + i;
    const long long below =
        (long long)(j == 0 ? a.jtot - 1 : j - 1) * a.itot + i;
    const long long left =
        (long long)j * a.itot + (i == 0 ? a.itot - 1 : i - 1);
    T* const s[3] = {a.su, a.sv, a.sw};
    T* const t[3] = {a.tu, a.tv, a.tw};
    const T dt = __ldg(a.dt);

    auto fetch = [&](int k, ApplyLevel<T, CARRY>& L) {
        const T* const pk = a.p + k * plane;
        const long long o = (a.ks + k) * plane + me;
        if (n > 0) {
            load_vals<T, true>(L.p, pk + me, vec, n);
            load_vals<T, true>(L.pj, pk + below, vec, n);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                load_vals<T, false>(L.s[c], s[c] + o, vec, n);
                if constexpr (CARRY)
                    load_vals<T, false>(L.t[c], t[c] + o, vec, n);
            }
        }
        if (tx == 0) L.pl = __ldg(pk + left);
        L.dzhi = __ldg(a.pc + k * NP + P_DZHI);
    };

    ApplyLevel<T, CARRY> cur, nxt;
    fetch(k0, cur);
    // p at the level below the chunk's first, for its vertical gradient
    Vals<T> pdn;
    if (k0 > 0 && n > 0) load_vals<T, true>(pdn, a.p + (k0 - 1) * plane + me,
                                            vec, n);
    for (int k = k0; k < k1; ++k) {
        if (k + 1 < k1) fetch(k + 1, nxt);
        // p at i-1 of the thread's first point: the last of the lane to the
        // left, or (lane 0) its own read
        const T up = __shfl_up_sync(0xffffffffu, cur.p.v[VW - 1], 1);
        if (n > 0) {
            const T pl = tx == 0 ? cur.pl : up;
            const long long o = (a.ks + k) * plane + me;
            Vals<T> g[3];
#pragma unroll
            for (int e = 0; e < VW; ++e) {
                const T pc_ = cur.p.v[e];
                g[0].v[e] = (pc_ - (e == 0 ? pl : cur.p.v[e - 1])) * a.dxi;
                g[1].v[e] = (pc_ - cur.pj.v[e]) * a.dyi;
                // k == 0 is the bottom wall w level, held at its value
                g[2].v[e] = k == 0 ? T(0) : (pc_ - pdn.v[e]) * cur.dzhi;
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                Vals<T> r;
#pragma unroll
                for (int e = 0; e < VW; ++e)
                    r.v[e] = cur.s[c].v[e] - dt * g[c].v[e];
                store_vals(s[c] + o, r, vec, n);
                if constexpr (CARRY) {
#pragma unroll
                    for (int e = 0; e < VW; ++e)
                        r.v[e] = cur.t[c].v[e] - a.can * g[c].v[e];
                    store_vals(t[c] + o, r, vec, n);
                }
            }
        }
        pdn = cur.p;
        cur = nxt;
    }
}

template <typename T>
int launch_pres_rhs(const T* u, const T* v, const T* w, T* out, const T* pc,
                    int itot, int jtot, int ktot, int ks, double dxi,
                    double dyi, const T* dti, cudaStream_t stream) {
    const long long plane = (long long)itot * jtot;
    const int threads = 256;
    pres_rhs_kernel<T><<<(unsigned int)((plane + threads - 1) / threads),
                         threads, 0, stream>>>(
        u, v, w, out, pc, itot, jtot, ktot, ks, T(dxi), T(dyi), dti);
    return (int)cudaGetLastError();
}

template <typename T>
ApplyArgs<T> apply_args(const void* p, void* su, void* sv, void* sw, void* tu,
                        void* tv, void* tw, const void* pc, int itot,
                        int jtot, int ktot, int ks, double dxi, double dyi,
                        const void* dt, double can, int chunks) {
    ApplyArgs<T> a;
    a.p = (const T*)p;
    a.su = (T*)su; a.sv = (T*)sv; a.sw = (T*)sw;
    a.tu = (T*)tu; a.tv = (T*)tv; a.tw = (T*)tw;
    a.pc = (const T*)pc;
    a.itot = itot; a.jtot = jtot; a.ktot = ktot; a.ks = ks;
    a.dt = (const T*)dt;
    a.dxi = T(dxi); a.dyi = T(dyi); a.can = T(can);
    a.chunks = chunks;
    a.vec_ok = itot % (16 / (int)sizeof(T)) == 0;
    a.vec_ok = a.vec_ok && km::aligned16(p) && km::aligned16(su)
               && km::aligned16(sv) && km::aligned16(sw) && km::aligned16(tu)
               && km::aligned16(tv) && km::aligned16(tw);
    return a;
}

// the carries all given (CARRY) or all null
template <typename T>
int launch_pres_apply(const ApplyArgs<T>& a, int carry, cudaStream_t stream) {
    if (a.chunks < 1 || a.chunks > a.ktot) return (int)cudaErrorInvalidValue;
    if (!carry != !a.tu || !carry != !a.tv || !carry != !a.tw)
        return (int)cudaErrorInvalidValue;
    constexpr int VW = Vals<T>::VW;
    const dim3 block(km::TI, PA_TJ);
    const dim3 grid((a.itot + km::TI * VW - 1) / (km::TI * VW),
                    (a.jtot + PA_TJ - 1) / PA_TJ, a.chunks);
    if (carry)
        pres_apply_kernel<T, true><<<grid, block, 0, stream>>>(a);
    else
        pres_apply_kernel<T, false><<<grid, block, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T>
int pres_apply_info(int carry, int* out) {
    return carry ? km::kernel_info(pres_apply_kernel<T, true>, PA_NT, 0, out)
                 : km::kernel_info(pres_apply_kernel<T, false>, PA_NT, 0, out);
}

}  // namespace mhh

#define MHH_PRES(SUF, T)                                                      \
    extern "C" int mhh_pres_rhs_##SUF(                                        \
        const void* u, const void* v, const void* w, void* out,               \
        const void* pc, int itot, int jtot, int ktot, int ks, double dxi,     \
        double dyi, const void* dti, void* stream) {                          \
        return mhh::launch_pres_rhs<T>((const T*)u, (const T*)v, (const T*)w, \
                                       (T*)out, (const T*)pc, itot, jtot,     \
                                       ktot, ks, dxi, dyi, (const T*)dti,     \
                                       (cudaStream_t)stream);                 \
    }                                                                         \
    extern "C" int mhh_pres_apply_##SUF(                                      \
        const void* p, void* su, void* sv, void* sw, void* tu, void* tv,      \
        void* tw, const void* pc, int itot, int jtot, int ktot, int ks,       \
        double dxi, double dyi, const void* dt, double can, int carry,        \
        int chunks,                                                           \
        void* stream) {                                                       \
        return mhh::launch_pres_apply<T>(                                     \
            mhh::apply_args<T>(p, su, sv, sw, tu, tv, tw, pc, itot, jtot,     \
                               ktot, ks, dxi, dyi, dt, can, chunks),          \
            carry, (cudaStream_t)stream);                                     \
    }                                                                         \
    extern "C" int mhh_pres_apply_info_##SUF(int scheme, int S, int* out) {   \
        return mhh::pres_apply_info<T>(scheme, out);                          \
    }

MHH_PRES(f32, float)
MHH_PRES(f64, double)
