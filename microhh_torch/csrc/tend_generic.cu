// K8/K9 and K10: the RK tendency sweeps of the generic path (any thermo,
// any scalar list; the moist bomex/rico class), with the low-storage RK
// update folded in: s* = s + cB*dt*t_total and the carry t = cA_next*t_total.
//
// K8/K9 tend_uvw: u, v and w advec_2 + Smagorinsky diffusion, the column
// fold of the per-substep table (ADDU/V, FACZ, FACZH and the WLSDN/UP
// local-subsidence stencil: sponge, dpdx and large-scale sources, mean
// subsidence) and the geostrophic Coriolis term (force.cxx coriolis_2nd,
// ug/vg from the table).  One kernel for two TPU kernels:
// FusedLES2.tend_uv_rk (microhh_tpu/ops/pallas_fused.py:1617, pallas_call
// :1641; body _tend_uv_rk_body :536) and FusedLES2.tend_w_rk (:1649 /
// :1667; _w_rk_body :401).
//
// K10 tend_scalars: every scalar's advec_2 + diffusion + column fold
// (ADDS - FACZ a + WLSDN (a - a_dn) + WLSUP (a_up - a)) in one pass that
// reads u, v, w and evisc once for all S scalars.  Replaces
// FusedLES2.tend_scalars_rk (:1702 / :1733; _scalars_rk_body :474).
//
// K15 tend_scalar: the same sweep for one scalar, the form a case with a
// single scalar (SBL_Smag's b) takes.  Replaces FusedLES2.tend_scalar_rk
// (:1674 / :1694; _scalar_rk_body :417), with its carry, fold (column terms
// on or off) and advec flags.
//
// advec = 0 on any of them leaves the advec_2 terms out: an interpolated
// scheme (K12/K13, advec_interp.cu) has then added the advection into the
// carry before the sweep (pallas_fused.py advec=not self.no_advec); the
// diffusion, the column fold and the Coriolis term stay.
//
// K18 tend_uvw_acc and K19 tend_scalar_acc: the same sweeps WITHOUT the RK
// fold (the RK template flag off), for the substep in which another producer
// changes the tendency after them (open boundaries, sources, the limiter in
// its tendency form): the carry is read, the tendency added, the carry
// written back in place; no s* is written, no ghost level of the carry is
// touched, the column terms of the table are left out (buffer, sources and
// forcing run as ops afterwards) and the Coriolis term stays a flag.  K18
// replaces FusedLES2.tend_uv (:1540 / :1560; _tend_uv_body :505) and tend_w
// (:1568 / :1582; _w_body :373), K19 FusedLES2.tend_scalar (:1589 / :1607;
// _scalar_body :389), launched once per scalar.
//
// The fields are ghost-filled and read at k-1 and k+1 as they are (no
// clamping, fold_ghosts off as on the TPU's generic path); evisc is the
// kcells array whose ghost planes repeat the edge levels.  The per-level
// tables are built every substep from plane means (ops/fused.py
// generic_col_tables) and read from device memory on every launch.  The
// carry t always enters: the thermo, microphysics and forcing producers
// have already added to it.  It is updated IN PLACE (carry = 0 on the last
// substep skips the write); s* goes to fresh tensors, because neighbouring
// tiles still read s.  The MOST wall rows are patched afterwards in torch.
//
// Bound: device-memory bytes.  K8/K9 read u, v, w, evisc and the three
// carries and write three s* and three carries: 13 x 4 B per point in f32
// (~3.0 GB per call at 384^3), ~450 flops per point.  K10 with S scalars
// reads 4 + 2S fields and writes 2S: 20 x 4 B per point for S = 4 (~4.6
// GB).  Design: the k-marching tile of K2 with a three-plane shared-memory
// ring per field, so each field is read once plus a 1/3 halo; K10 keeps
// 4 + S rings in dynamic shared memory and passes the scalars' pointers
// and viscosities by value, so one launch serves any S <= MAXS.
#include "les_math.cuh"

namespace mhh {

constexpr int MAXS = 8;

template <typename T, bool RK>
__global__ void __launch_bounds__(TI * TJ)
tend_uvw_kernel(const T* __restrict__ u, const T* __restrict__ v,
                const T* __restrict__ w, const T* __restrict__ e,
                T* __restrict__ us, T* __restrict__ vs, T* __restrict__ ws,
                T* tu, T* tv, T* tw, const T* __restrict__ ct, int itot,
                int jtot, int ktot, int ks, T dxi, T dyi, T visc, T fc,
                T utrans, T vtrans, T cbdt, T can, int coriolis, int carry,
                int advec) {
    __shared__ T sh[4][3][HJ][HI];
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const long long plane = (long long)itot * jtot;
    const View<T> U = view<T>(sh[0]), V = view<T>(sh[1]), W = view<T>(sh[2]);
    const View<T> E = view<T>(sh[3]);

    auto load = [&](int p) {
        const int s = slot(p);
        load_tile(sh[0][s], u, ks + p, j0, i0, jtot, itot);
        load_tile(sh[1][s], v, ks + p, j0, i0, jtot, itot);
        load_tile(sh[2][s], w, ks + p, j0, i0, jtot, itot);
        load_tile(sh[3][s], e, ks + p, j0, i0, jtot, itot);
    };

    load(-1);
    load(0);
    for (int k = 0; k < ktot; ++k) {
        load(k + 1);
        __syncthreads();
        if (inside) {
            const Slots q = slots(k);
            const T* cc = ct + (long long)k * NTG;
            T ut, vt;
            uv_tend(U, V, W, E, q, cc, dxi, dyi, visc, ut, vt, advec);
            T wt = w_tend(U, V, W, E, q, cc, dxi, dyi, visc, advec);
            const T u_ = U(q.kc, 0, 0), v_ = V(q.kc, 0, 0), w_ = W(q.kc, 0, 0);

            // ---- column fold and Coriolis (pallas_fused.py _extra_uv) ----
            if (RK) {
                const T facz = cc[T_FACZ];
                ut = ut + cc[T_ADDU] - facz * u_;
                vt = vt + cc[T_ADDV] - facz * v_;
                const T wdn = cc[T_WLSDN], wup = cc[T_WLSUP];
                ut = ut + wdn * (u_ - U(q.km, 0, 0)) + wup * (U(q.kp, 0, 0) - u_);
                vt = vt + wdn * (v_ - V(q.km, 0, 0)) + wup * (V(q.kp, 0, 0) - v_);
                wt = wt - cc[T_FACZH] * w_;
            }
            if (coriolis) {
                // the JAX package's stencil (ROADMAP Queue 3 on its offset)
                const T v_at_u = T(0.25) * (v_ + V(q.kc, 0, 1) + V(q.kc, -1, 0)
                                            + V(q.kc, -1, 1));
                const T u_at_v = T(0.25) * (u_ + U(q.kc, 0, -1) + U(q.kc, 1, 0)
                                            + U(q.kc, 1, -1));
                ut = ut + fc * (v_at_u + vtrans - cc[T_VG]);
                vt = vt - fc * (u_at_v + utrans - cc[T_UG]);
            }
            if (k == 0) wt = T(0);   // half level ks is the wall

            // ---- RK fold, or the plain accumulation onto the carry ----
            const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;
            ut = tu[o] + ut;
            vt = tv[o] + vt;
            wt = tw[o] + wt;
            if (RK) {
                us[o] = u_ + cbdt * ut;
                vs[o] = v_ + cbdt * vt;
                ws[o] = w_ + cbdt * wt;
                if (carry) {
                    tu[o] = can * ut;
                    tv[o] = can * vt;
                    tw[o] = can * wt;
                }
            } else {
                tu[o] = ut;
                tv[o] = vt;
                tw[o] = wt;
            }
        }
        __syncthreads();
    }
}

// the scalars' pointers and viscosities, passed by value
template <typename T>
struct Scalars {
    const T* a[MAXS];
    T* as[MAXS];
    T* ta[MAXS];
    T svisc[MAXS];
};

extern __shared__ __align__(16) unsigned char dyn_smem[];

template <typename T>
__global__ void __launch_bounds__(TI * TJ)
tend_scalars_kernel(const T* __restrict__ u, const T* __restrict__ v,
                    const T* __restrict__ w, const T* __restrict__ e,
                    const Scalars<T> sc, int S, const T* __restrict__ ccs,
                    int itot, int jtot, int ktot, int ks, T dxi, T dyi, T tPr,
                    T cbdt, T can, int carry, int advec) {
    // rings: u, v, w, evisc, then the S scalars
    T (*sh)[3][HJ][HI] = reinterpret_cast<T (*)[3][HJ][HI]>(dyn_smem);
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const long long plane = (long long)itot * jtot;
    const T tPri = T(1) / tPr;
    const View<T> U = view<T>(sh[0]), V = view<T>(sh[1]), W = view<T>(sh[2]);
    const View<T> E = view<T>(sh[3]);

    auto load = [&](int p) {
        const int s = slot(p);
        load_tile(sh[0][s], u, ks + p, j0, i0, jtot, itot);
        load_tile(sh[1][s], v, ks + p, j0, i0, jtot, itot);
        load_tile(sh[2][s], w, ks + p, j0, i0, jtot, itot);
        load_tile(sh[3][s], e, ks + p, j0, i0, jtot, itot);
        for (int n = 0; n < S; ++n)
            load_tile(sh[4 + n][s], sc.a[n], ks + p, j0, i0, jtot, itot);
    };

    load(-1);
    load(0);
    for (int k = 0; k < ktot; ++k) {
        load(k + 1);
        __syncthreads();
        if (inside) {
            const Slots q = slots(k);
            const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;
            for (int n = 0; n < S; ++n) {
                const View<T> A = view<T>(sh[4 + n]);
                const T* cc = ccs + ((long long)n * ktot + k) * NTG;
                const T a_ = A(q.kc, 0, 0);
                T tt = sc.ta[n][o]
                       + s_tend(U, V, W, A, E, q, cc, dxi, dyi, sc.svisc[n], tPri,
                                advec);
                tt = tt + (cc[T_ADDS] - cc[T_FACZ] * a_
                           + cc[T_WLSDN] * (a_ - A(q.km, 0, 0))
                           + cc[T_WLSUP] * (A(q.kp, 0, 0) - a_));
                sc.as[n][o] = a_ + cbdt * tt;
                if (carry) sc.ta[n][o] = can * tt;
            }
        }
        __syncthreads();
    }
}

// K15: one scalar's sweep (tend_scalar_rk), the form a case with a single
// scalar takes: the same point math as K10 with static shared memory for its
// five rings.  fold = 0 leaves the column terms of the table out.
template <typename T, bool RK>
__global__ void __launch_bounds__(TI * TJ)
tend_scalar_kernel(const T* __restrict__ u, const T* __restrict__ v,
                   const T* __restrict__ w, const T* __restrict__ e,
                   const T* __restrict__ a, T* __restrict__ as, T* ta,
                   const T* __restrict__ ct, int itot, int jtot, int ktot,
                   int ks, T dxi, T dyi, T svisc, T tPr, T cbdt, T can,
                   int carry, int fold, int advec) {
    __shared__ T sh[5][3][HJ][HI];
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const long long plane = (long long)itot * jtot;
    const T tPri = T(1) / tPr;
    const View<T> U = view<T>(sh[0]), V = view<T>(sh[1]), W = view<T>(sh[2]);
    const View<T> E = view<T>(sh[3]), A = view<T>(sh[4]);

    auto load = [&](int p) {
        const int s = slot(p);
        load_tile(sh[0][s], u, ks + p, j0, i0, jtot, itot);
        load_tile(sh[1][s], v, ks + p, j0, i0, jtot, itot);
        load_tile(sh[2][s], w, ks + p, j0, i0, jtot, itot);
        load_tile(sh[3][s], e, ks + p, j0, i0, jtot, itot);
        load_tile(sh[4][s], a, ks + p, j0, i0, jtot, itot);
    };

    load(-1);
    load(0);
    for (int k = 0; k < ktot; ++k) {
        load(k + 1);
        __syncthreads();
        if (inside) {
            const Slots q = slots(k);
            const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;
            const T* cc = ct + (long long)k * NTG;
            const T a_ = A(q.kc, 0, 0);
            T tt = ta[o] + s_tend(U, V, W, A, E, q, cc, dxi, dyi, svisc, tPri,
                                  advec);
            if (fold)
                tt = tt + (cc[T_ADDS] - cc[T_FACZ] * a_
                           + cc[T_WLSDN] * (a_ - A(q.km, 0, 0))
                           + cc[T_WLSUP] * (A(q.kp, 0, 0) - a_));
            if (RK) {
                as[o] = a_ + cbdt * tt;
                if (carry) ta[o] = can * tt;
            } else {
                ta[o] = tt;
            }
        }
        __syncthreads();
    }
}

template <typename T, bool RK>
int launch_tend_scalar(const T* u, const T* v, const T* w, const T* e,
                       const T* a, T* as, T* ta, const T* ct, int itot,
                       int jtot, int ktot, int ks, double dxi, double dyi,
                       double svisc, double tPr, double cbdt, double can,
                       int carry, int fold, int advec, cudaStream_t stream) {
    const dim3 block(TI, TJ);
    const dim3 grid((itot + TI - 1) / TI, (jtot + TJ - 1) / TJ);
    tend_scalar_kernel<T, RK><<<grid, block, 0, stream>>>(
        u, v, w, e, a, as, ta, ct, itot, jtot, ktot, ks, T(dxi), T(dyi),
        T(svisc), T(tPr), T(cbdt), T(can), carry, fold, advec);
    return (int)cudaGetLastError();
}

template <typename T, bool RK>
int launch_tend_uvw(const T* u, const T* v, const T* w, const T* e, T* us,
                    T* vs, T* ws, T* tu, T* tv, T* tw, const T* ct, int itot,
                    int jtot, int ktot, int ks, double dxi, double dyi,
                    double visc, double fc, double utrans, double vtrans,
                    double cbdt, double can, int coriolis, int carry,
                    int advec, cudaStream_t stream) {
    const dim3 block(TI, TJ);
    const dim3 grid((itot + TI - 1) / TI, (jtot + TJ - 1) / TJ);
    tend_uvw_kernel<T, RK><<<grid, block, 0, stream>>>(
        u, v, w, e, us, vs, ws, tu, tv, tw, ct, itot, jtot, ktot, ks, T(dxi),
        T(dyi), T(visc), T(fc), T(utrans), T(vtrans), T(cbdt), T(can),
        coriolis, carry, advec);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_tend_scalars(const T* u, const T* v, const T* w, const T* e,
                        const void* const* a, void* const* as,
                        void* const* ta, const double* svisc, int S,
                        const T* ccs, int itot, int jtot, int ktot, int ks,
                        double dxi, double dyi, double tPr, double cbdt,
                        double can, int carry, int advec,
                        cudaStream_t stream) {
    if (S < 1 || S > MAXS) return (int)cudaErrorInvalidValue;
    Scalars<T> sc;
    for (int n = 0; n < MAXS; ++n) {
        const bool used = n < S;
        sc.a[n] = used ? (const T*)a[n] : nullptr;
        sc.as[n] = used ? (T*)as[n] : nullptr;
        sc.ta[n] = used ? (T*)ta[n] : nullptr;
        sc.svisc[n] = used ? T(svisc[n]) : T(0);
    }
    const size_t smem = (size_t)(4 + S) * 3 * HJ * HI * sizeof(T);
    cudaError_t rc = cudaFuncSetAttribute(
        tend_scalars_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 block(TI, TJ);
    const dim3 grid((itot + TI - 1) / TI, (jtot + TJ - 1) / TJ);
    tend_scalars_kernel<T><<<grid, block, smem, stream>>>(
        u, v, w, e, sc, S, ccs, itot, jtot, ktot, ks, T(dxi), T(dyi), T(tPr),
        T(cbdt), T(can), carry, advec);
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_TEND_GENERIC(SUF, T)                                              \
    extern "C" int mhh_tend_uvw_##SUF(                                        \
        const void* u, const void* v, const void* w, const void* e,           \
        void* us, void* vs, void* ws, void* tu, void* tv, void* tw,           \
        const void* ct, int itot, int jtot, int ktot, int ks, double dxi,     \
        double dyi, double visc, double fc, double utrans, double vtrans,      \
        double cbdt, double can, int coriolis, int carry, int advec,          \
        void* stream) {                                                       \
        return mhh::launch_tend_uvw<T, true>(                                       \
            (const T*)u, (const T*)v, (const T*)w, (const T*)e, (T*)us,       \
            (T*)vs, (T*)ws, (T*)tu, (T*)tv, (T*)tw, (const T*)ct, itot, jtot, \
            ktot, ks, dxi, dyi, visc, fc, utrans, vtrans, cbdt, can,          \
            coriolis, carry, advec, (cudaStream_t)stream);                    \
    }                                                                         \
    extern "C" int mhh_tend_scalars_##SUF(                                    \
        const void* u, const void* v, const void* w, const void* e,           \
        const void* const* a, void* const* as, void* const* ta,               \
        const double* svisc, int S, const void* ccs, int itot, int jtot,      \
        int ktot, int ks, double dxi, double dyi, double tPr, double cbdt,    \
        double can, int carry, int advec, void* stream) {                     \
        return mhh::launch_tend_scalars<T>(                                   \
            (const T*)u, (const T*)v, (const T*)w, (const T*)e, a, as, ta,    \
            svisc, S, (const T*)ccs, itot, jtot, ktot, ks, dxi, dyi, tPr,     \
            cbdt, can, carry, advec, (cudaStream_t)stream);                   \
    }                                                                         \
    extern "C" int mhh_tend_scalar_rk_##SUF(                                  \
        const void* u, const void* v, const void* w, const void* e,           \
        const void* a, void* as, void* ta, const void* cc, int itot,          \
        int jtot, int ktot, int ks, double dxi, double dyi, double svisc,     \
        double tPr, double cbdt, double can, int carry, int fold, int advec,  \
        void* stream) {                                                       \
        return mhh::launch_tend_scalar<T, true>(                                    \
            (const T*)u, (const T*)v, (const T*)w, (const T*)e, (const T*)a,  \
            (T*)as, (T*)ta, (const T*)cc, itot, jtot, ktot, ks, dxi, dyi,     \
            svisc, tPr, cbdt, can, carry, fold, advec, (cudaStream_t)stream); \
    }                                                                         \
    extern "C" int mhh_tend_uvw_acc_##SUF(                                    \
        const void* u, const void* v, const void* w, const void* e,           \
        void* tu, void* tv, void* tw, const void* ct, int itot, int jtot,     \
        int ktot, int ks, double dxi, double dyi, double visc, double fc,     \
        double utrans, double vtrans, int coriolis, int advec,                \
        void* stream) {                                                       \
        return mhh::launch_tend_uvw<T, false>(                                \
            (const T*)u, (const T*)v, (const T*)w, (const T*)e, nullptr,      \
            nullptr, nullptr, (T*)tu, (T*)tv, (T*)tw, (const T*)ct, itot,     \
            jtot, ktot, ks, dxi, dyi, visc, fc, utrans, vtrans, 0., 0.,       \
            coriolis, 0, advec, (cudaStream_t)stream);                        \
    }                                                                         \
    extern "C" int mhh_tend_scalar_acc_##SUF(                                 \
        const void* u, const void* v, const void* w, const void* e,           \
        const void* a, void* ta, const void* cc, int itot, int jtot,          \
        int ktot, int ks, double dxi, double dyi, double svisc, double tPr,   \
        int advec, void* stream) {                                            \
        return mhh::launch_tend_scalar<T, false>(                             \
            (const T*)u, (const T*)v, (const T*)w, (const T*)e, (const T*)a,  \
            nullptr, (T*)ta, (const T*)cc, itot, jtot, ktot, ks, dxi, dyi,    \
            svisc, tPr, 0., 0., 0, 0, advec, (cudaStream_t)stream);           \
    }

MHH_TEND_GENERIC(f32, float)
MHH_TEND_GENERIC(f64, double)
