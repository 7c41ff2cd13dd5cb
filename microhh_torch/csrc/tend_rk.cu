// K2: the RK tendency sweep of the dry LES: advec_2 (advec_2.cxx) +
// Smagorinsky diffusion (diff_smag2.cxx diff_u/v/w/c) + dry buoyancy
// (thermo_dry.cxx) + the static-profile Rayleigh sponge (buffer.cxx), with
// the low-storage RK update folded in: s* = s + cB*dt*t_total and the carry
// t = cA_next*t_total.
//
// Replaces the TPU kernel FusedLES2.tendencies_rk
// (microhh_tpu/ops/pallas_fused.py:1875; full-plane bodies _tend_uv_rk_body
// :1930 and _tend_wth_rk_body :1951) with fold_ghosts semantics: clamped k
// neighbours (u, v, th to [ks, ke-1], w to [ks, ke], evisc to the interior).
// The MOST wall rows stay in torch (ops/fused.py tendencies_rk), as they
// stay in XLA on the TPU.  The carry is updated IN PLACE: `first` (cA = 0,
// the carry is zero) skips reading it and `carry` = 0 (last substep,
// cA_next = 0) skips writing it.  As flags it carries the geostrophic
// Coriolis term of the TPU kernel (_extra_uv :432 under fold_coriolis, ug and
// vg in the table) and its has_thermo=False form (th null: no th sweep, no
// buoyancy).  The evisc fold and the Poisson-rhs fold of the TPU kernel (the
// tiled bodies, :2073 and :2108) are K22, tend_rk_fold.cu; this kernel is
// the form with both off (Model.build_step(fold=False)).
//
// Bound: device-memory bytes.  Per point ~350 flops on 5 field reads, 4
// carry reads and 8 writes (~68 B in f32): below the card's flop/B balance.
// Design: one k-marching tile per block with a three-plane shared-memory
// ring per field (common.cuh), so each of u, v, w, th, evisc is read once
// (plus a 1/3 halo) and u/v/w/th share one pass, like the TPU kernel pair;
// the pointwise math is les_math.cuh's, shared with K8-K10.
//
// K20 tendencies: the same dry set WITHOUT the RK fold, on ghost-filled
// fields: the planes k-1 and k+1 are read as they are (evisc is the kcells
// array whose ghost planes repeat the edge levels), the tendencies are added
// onto the carries in place, no s* is written and no ghost level of a carry
// is touched.  It carries the static-buffer fold and, as a flag, the
// geostrophic Coriolis term with ug and vg in its (ktot, NTG) table.
// A null th gives the has_thermo=False form.
// Replaces FusedLES2.tendencies (:1743; pallas_calls :1807, :1827, :1861;
// bodies _tend_uv_body :505, _tend_wth_body :521, _all_tiled_body :1100) and
// the k-streaming form of the same sweep (_stream_call :1383 / :1399 with
// _uv_stream_math :639 and _wth_stream_math :648): a k-marching ring of
// three planes per field in shared memory is that dataflow, each plane
// fetched once.  Used when a forcing, a limiter or a top boundary condition
// rules the RK fold or the clamped reads out.
#include "les_math.cuh"

namespace mhh {

template <typename T>
__global__ void __launch_bounds__(TI * TJ)
tend_rk_kernel(const T* __restrict__ u, const T* __restrict__ v,
               const T* __restrict__ w, const T* __restrict__ th,
               const T* __restrict__ e,
               T* __restrict__ us, T* __restrict__ vs, T* __restrict__ ws,
               T* __restrict__ ths,
               T* tu, T* tv, T* tw, T* tth,
               const T* __restrict__ ct, int itot, int jtot, int ktot, int ks,
               T dxi, T dyi, T visc, T svisc, T tPr, T cbdt, T can, T fc,
               T utrans, T vtrans, int first, int carry, int coriolis) {
    __shared__ T sh[5][3][HJ][HI];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + tx, j = j0 + ty;
    const bool inside = i < itot && j < jtot;
    const bool thermo = th != nullptr;
    const int ke = ks + ktot;
    const long long plane = (long long)itot * jtot;
    const T grav = T(9.81);
    const View<T> U = view<T>(sh[0]), V = view<T>(sh[1]), W = view<T>(sh[2]);
    const View<T> A = view<T>(sh[3]), E = view<T>(sh[4]);

    auto load = [&](int p) {
        const int s = slot(p);
        load_tile(sh[0][s], u, clampi(ks + p, ks, ke - 1), j0, i0, jtot, itot);
        load_tile(sh[1][s], v, clampi(ks + p, ks, ke - 1), j0, i0, jtot, itot);
        load_tile(sh[2][s], w, clampi(ks + p, ks, ke), j0, i0, jtot, itot);
        if (thermo)
            load_tile(sh[3][s], th, clampi(ks + p, ks, ke - 1), j0, i0, jtot,
                      itot);
        load_tile(sh[4][s], e, clampi(p, 0, ktot - 1), j0, i0, jtot, itot);
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
            uv_tend(U, V, W, E, q, cc, dxi, dyi, visc, ut, vt);
            T wt = w_tend(U, V, W, E, q, cc, dxi, dyi, visc);

            // ---- folded sponge (buffer.cxx), Coriolis, the wall half level
            const T u_ = U(q.kc, 0, 0), v_ = V(q.kc, 0, 0), w_ = W(q.kc, 0, 0);
            ut = ut + u_folds(U, V, q.kc, cc, fc, vtrans, coriolis);
            vt = vt + v_folds(U, V, q.kc, cc, fc, utrans, coriolis);
            wt = wt - cc[T_FACZH] * w_;
            T a_ = T(0), tht = T(0);
            if (thermo) {
                const T threfh = cc[T_THREFH];
                a_ = A(q.kc, 0, 0);
                wt = wt + grav / threfh * (i2(A(q.km, 0, 0), a_) - threfh);
                tht = s_tend(U, V, W, A, E, q, cc, dxi, dyi, svisc, T(1) / tPr)
                      - cc[T_FACZ] * (a_ - cc[T_SREF]);
            }
            if (k == 0) wt = T(0);

            // ---- RK fold ----
            const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;
            if (!first) {
                ut = tu[o] + ut;
                vt = tv[o] + vt;
                wt = tw[o] + wt;
                if (thermo) tht = tth[o] + tht;
            }
            us[o] = u_ + cbdt * ut;
            vs[o] = v_ + cbdt * vt;
            ws[o] = w_ + cbdt * wt;
            if (thermo) ths[o] = a_ + cbdt * tht;
            if (carry) {
                tu[o] = can * ut;
                tv[o] = can * vt;
                tw[o] = can * wt;
                if (thermo) tth[o] = can * tht;
            }
        }
        __syncthreads();
    }
}

template <typename T>
int launch_tend_rk(const T* u, const T* v, const T* w, const T* th,
                   const T* e, T* us, T* vs, T* ws, T* ths, T* tu, T* tv,
                   T* tw, T* tth, const T* ct, int itot, int jtot, int ktot,
                   int ks, double dxi, double dyi, double visc, double svisc,
                   double tPr, double cbdt, double can, double fc,
                   double utrans, double vtrans, int first, int carry,
                   int coriolis, cudaStream_t stream) {
    const dim3 block(TI, TJ);
    const dim3 grid((itot + TI - 1) / TI, (jtot + TJ - 1) / TJ);
    tend_rk_kernel<T><<<grid, block, 0, stream>>>(
        u, v, w, th, e, us, vs, ws, ths, tu, tv, tw, tth, ct, itot, jtot,
        ktot, ks, T(dxi), T(dyi), T(visc), T(svisc), T(tPr), T(cbdt), T(can),
        T(fc), T(utrans), T(vtrans), first, carry, coriolis);
    return (int)cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(TI * TJ)
tendencies_kernel(const T* __restrict__ u, const T* __restrict__ v,
                  const T* __restrict__ w, const T* __restrict__ th,
                  const T* __restrict__ e, T* tu, T* tv, T* tw, T* tth,
                  const T* __restrict__ ct, int itot, int jtot, int ktot,
                  int ks, T dxi, T dyi, T visc, T svisc, T tPr, T fc, T utrans,
                  T vtrans, int coriolis) {
    __shared__ T sh[5][3][HJ][HI];
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + threadIdx.x, j = j0 + threadIdx.y;
    const bool inside = i < itot && j < jtot;
    const bool thermo = th != nullptr;
    const long long plane = (long long)itot * jtot;
    const T grav = T(9.81);
    const View<T> U = view<T>(sh[0]), V = view<T>(sh[1]), W = view<T>(sh[2]);
    const View<T> A = view<T>(sh[3]), E = view<T>(sh[4]);

    auto load = [&](int p) {
        const int s = slot(p);
        load_tile(sh[0][s], u, ks + p, j0, i0, jtot, itot);
        load_tile(sh[1][s], v, ks + p, j0, i0, jtot, itot);
        load_tile(sh[2][s], w, ks + p, j0, i0, jtot, itot);
        if (thermo) load_tile(sh[3][s], th, ks + p, j0, i0, jtot, itot);
        load_tile(sh[4][s], e, ks + p, j0, i0, jtot, itot);
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
            uv_tend(U, V, W, E, q, cc, dxi, dyi, visc, ut, vt);
            T wt = w_tend(U, V, W, E, q, cc, dxi, dyi, visc);

            // ---- folded sponge and Coriolis (_extra_uv, _extra_wth) ----
            ut = ut + u_folds(U, V, q.kc, cc, fc, vtrans, coriolis);
            vt = vt + v_folds(U, V, q.kc, cc, fc, utrans, coriolis);
            wt = wt - cc[T_FACZH] * W(q.kc, 0, 0);
            const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;
            if (thermo) {
                const T threfh = cc[T_THREFH], a_ = A(q.kc, 0, 0);
                wt = wt + grav / threfh * (i2(A(q.km, 0, 0), a_) - threfh);
                const T tht =
                    s_tend(U, V, W, A, E, q, cc, dxi, dyi, svisc, T(1) / tPr)
                    - cc[T_FACZ] * (a_ - cc[T_SREF]);
                tth[o] = tth[o] + tht;
            }
            if (k == 0) wt = T(0);   // half level ks is the wall

            tu[o] = tu[o] + ut;
            tv[o] = tv[o] + vt;
            tw[o] = tw[o] + wt;
        }
        __syncthreads();
    }
}

template <typename T>
int launch_tendencies(const T* u, const T* v, const T* w, const T* th,
                      const T* e, T* tu, T* tv, T* tw, T* tth, const T* ct,
                      int itot, int jtot, int ktot, int ks, double dxi,
                      double dyi, double visc, double svisc, double tPr,
                      double fc, double utrans, double vtrans, int coriolis,
                      cudaStream_t stream) {
    const dim3 block(TI, TJ);
    const dim3 grid((itot + TI - 1) / TI, (jtot + TJ - 1) / TJ);
    tendencies_kernel<T><<<grid, block, 0, stream>>>(
        u, v, w, th, e, tu, tv, tw, tth, ct, itot, jtot, ktot, ks, T(dxi),
        T(dyi), T(visc), T(svisc), T(tPr), T(fc), T(utrans), T(vtrans),
        coriolis);
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_TEND_RK(SUF, T)                                                   \
    extern "C" int mhh_tend_rk_##SUF(                                         \
        const void* u, const void* v, const void* w, const void* th,          \
        const void* e, void* us, void* vs, void* ws, void* ths, void* tu,     \
        void* tv, void* tw, void* tth, const void* ct, int itot, int jtot,    \
        int ktot, int ks, double dxi, double dyi, double visc, double svisc,  \
        double tPr, double cbdt, double can, double fc, double utrans,        \
        double vtrans, int first, int carry, int coriolis, void* stream) {    \
        return mhh::launch_tend_rk<T>(                                        \
            (const T*)u, (const T*)v, (const T*)w, (const T*)th,              \
            (const T*)e, (T*)us, (T*)vs, (T*)ws, (T*)ths, (T*)tu, (T*)tv,     \
            (T*)tw, (T*)tth, (const T*)ct, itot, jtot, ktot, ks, dxi, dyi,    \
            visc, svisc, tPr, cbdt, can, fc, utrans, vtrans, first, carry,    \
            coriolis, (cudaStream_t)stream);                                  \
    }                                                                         \
    extern "C" int mhh_tendencies_##SUF(                                      \
        const void* u, const void* v, const void* w, const void* th,          \
        const void* e, void* tu, void* tv, void* tw, void* tth,               \
        const void* ct, int itot, int jtot, int ktot, int ks, double dxi,     \
        double dyi, double visc, double svisc, double tPr, double fc,         \
        double utrans, double vtrans, int coriolis, void* stream) {           \
        return mhh::launch_tendencies<T>(                                     \
            (const T*)u, (const T*)v, (const T*)w, (const T*)th,              \
            (const T*)e, (T*)tu, (T*)tv, (T*)tw, (T*)tth, (const T*)ct, itot, \
            jtot, ktot, ks, dxi, dyi, visc, svisc, tPr, fc, utrans, vtrans,   \
            coriolis, (cudaStream_t)stream);                                  \
    }

MHH_TEND_RK(f32, float)
MHH_TEND_RK(f64, double)
