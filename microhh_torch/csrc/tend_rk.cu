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
// cA_next = 0) skips writing it.  The evisc fold, the Poisson-rhs fold and
// the Coriolis fold of the TPU kernel are not ported (ROADMAP Queue 2).
//
// Bound: device-memory bytes.  Per point ~350 flops on 5 field reads, 4
// carry reads and 8 writes (~68 B in f32): below the card's flop/B balance.
// Design: one k-marching tile per block with a three-plane shared-memory
// ring per field (common.cuh), so each of u, v, w, th, evisc is read once
// (plus a 1/3 halo) and u/v/w/th share one pass, like the TPU kernel pair.
#include "common.cuh"

namespace mhh {

// per-level table columns (ops/fused.py T_*)
enum {
    T_DZI, T_DZHI, T_DZHI1, T_DZI_M1, T_RHO, T_RHOH, T_RHOH1, T_RHO_M1,
    T_THREFH, T_FACZ, T_FACZH, T_UREF, T_VREF, T_SREF, NT
};

template <typename T>
__device__ __forceinline__ T i2(T a, T b) { return T(0.5) * (a + b); }

template <typename T>
__global__ void __launch_bounds__(TI * TJ)
tend_rk_kernel(const T* __restrict__ u, const T* __restrict__ v,
               const T* __restrict__ w, const T* __restrict__ th,
               const T* __restrict__ e,
               T* __restrict__ us, T* __restrict__ vs, T* __restrict__ ws,
               T* __restrict__ ths,
               T* tu, T* tv, T* tw, T* tth,
               const T* __restrict__ ct, int itot, int jtot, int ktot, int ks,
               T dxi, T dyi, T visc, T svisc, T tPr, T cbdt, T can,
               int first, int carry) {
    __shared__ T sh[5][3][HJ][HI];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
    const int i = i0 + tx, j = j0 + ty;
    const bool inside = i < itot && j < jtot;
    const int ke = ks + ktot;
    const long long plane = (long long)itot * jtot;
    const T grav = T(9.81);

    auto load = [&](int p) {
        const int s = slot(p);
        load_tile(sh[0][s], u, clampi(ks + p, ks, ke - 1), j0, i0, jtot, itot);
        load_tile(sh[1][s], v, clampi(ks + p, ks, ke - 1), j0, i0, jtot, itot);
        load_tile(sh[2][s], w, clampi(ks + p, ks, ke), j0, i0, jtot, itot);
        load_tile(sh[3][s], th, clampi(ks + p, ks, ke - 1), j0, i0, jtot, itot);
        load_tile(sh[4][s], e, clampi(p, 0, ktot - 1), j0, i0, jtot, itot);
    };

    load(-1);
    load(0);
    for (int k = 0; k < ktot; ++k) {
        load(k + 1);
        __syncthreads();
        if (inside) {
            const int km = slot(k - 1), kc = slot(k), kp = slot(k + 1);
            const int r = ty + 1, c = tx + 1;
#define U(s, dj, di) sh[0][s][r + (dj)][c + (di)]
#define V(s, dj, di) sh[1][s][r + (dj)][c + (di)]
#define W(s, dj, di) sh[2][s][r + (dj)][c + (di)]
#define A(s, dj, di) sh[3][s][r + (dj)][c + (di)]
#define E(s, dj, di) sh[4][s][r + (dj)][c + (di)]
            const T* cc = ct + (long long)k * NT;
            const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzhi1 = cc[T_DZHI1];
            const T dzi_m1 = cc[T_DZI_M1];
            const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rhoh1 = cc[T_RHOH1];
            const T rho_m1 = cc[T_RHO_M1], threfh = cc[T_THREFH];
            const T facz = cc[T_FACZ], faczh = cc[T_FACZH];
            const T rdzi = dzi / rho;
            const T rdzhi = dzhi / rhoh;
            const T tPri = T(1) / tPr;

            // ---- u (advec_2.cxx advec_u + diff_smag2.cxx diff_u) ----
            const T u_ = U(kc, 0, 0), v_ = V(kc, 0, 0), w_ = W(kc, 0, 0);
            const T adv_u = -((i2(u_, U(kc, 0, 1)) * i2(u_, U(kc, 0, 1))
                               - i2(U(kc, 0, -1), u_) * i2(U(kc, 0, -1), u_)) * dxi
                              + (i2(V(kc, 1, -1), V(kc, 1, 0)) * i2(u_, U(kc, 1, 0))
                                 - i2(V(kc, 0, -1), v_) * i2(U(kc, -1, 0), u_)) * dyi
                              + (rhoh1 * i2(W(kp, 0, -1), W(kp, 0, 0)) * i2(u_, U(kp, 0, 0))
                                 - rhoh * i2(W(kc, 0, -1), w_) * i2(U(km, 0, 0), u_)) * rdzi);
            const T e_ = E(kc, 0, 0);
            const T ev_e = e_ + visc;
            const T ev_w = E(kc, 0, -1) + visc;
            const T ev_n = T(0.25) * (E(kc, 0, -1) + e_ + E(kc, 1, -1) + E(kc, 1, 0)) + visc;
            const T ev_s = T(0.25) * (E(kc, -1, -1) + E(kc, -1, 0) + E(kc, 0, -1) + e_) + visc;
            const T ev_t = T(0.25) * (E(kc, 0, -1) + e_ + E(kp, 0, -1) + E(kp, 0, 0)) + visc;
            const T ev_b = T(0.25) * (E(km, 0, -1) + E(km, 0, 0) + E(kc, 0, -1) + e_) + visc;
            const T dif_u =
                (ev_e * (U(kc, 0, 1) - u_) - ev_w * (u_ - U(kc, 0, -1))) * T(2) * dxi * dxi
                + (ev_n * ((U(kc, 1, 0) - u_) * dyi + (V(kc, 1, 0) - V(kc, 1, -1)) * dxi)
                   - ev_s * ((u_ - U(kc, -1, 0)) * dyi + (v_ - V(kc, 0, -1)) * dxi)) * dyi
                + (rhoh1 * ev_t * ((U(kp, 0, 0) - u_) * dzhi1 + (W(kp, 0, 0) - W(kp, 0, -1)) * dxi)
                   - rhoh * ev_b * ((u_ - U(km, 0, 0)) * dzhi + (w_ - W(kc, 0, -1)) * dxi)) * rdzi;

            // ---- v ----
            const T adv_v = -((i2(U(kc, -1, 1), U(kc, 0, 1)) * i2(v_, V(kc, 0, 1))
                               - i2(U(kc, -1, 0), u_) * i2(V(kc, 0, -1), v_)) * dxi
                              + (i2(v_, V(kc, 1, 0)) * i2(v_, V(kc, 1, 0))
                                 - i2(V(kc, -1, 0), v_) * i2(V(kc, -1, 0), v_)) * dyi
                              + (rhoh1 * i2(W(kp, -1, 0), W(kp, 0, 0)) * i2(v_, V(kp, 0, 0))
                                 - rhoh * i2(W(kc, -1, 0), w_) * i2(V(km, 0, 0), v_)) * rdzi);
            const T ev_e2 = T(0.25) * (E(kc, -1, 0) + e_ + E(kc, -1, 1) + E(kc, 0, 1)) + visc;
            const T ev_w2 = T(0.25) * (E(kc, -1, -1) + E(kc, 0, -1) + E(kc, -1, 0) + e_) + visc;
            const T ev_n2 = e_ + visc;
            const T ev_s2 = E(kc, -1, 0) + visc;
            const T ev_t2 = T(0.25) * (E(kc, -1, 0) + e_ + E(kp, -1, 0) + E(kp, 0, 0)) + visc;
            const T ev_b2 = T(0.25) * (E(km, -1, 0) + E(km, 0, 0) + E(kc, -1, 0) + e_) + visc;
            const T dif_v =
                (ev_e2 * ((V(kc, 0, 1) - v_) * dxi + (U(kc, 0, 1) - U(kc, -1, 1)) * dyi)
                 - ev_w2 * ((v_ - V(kc, 0, -1)) * dxi + (u_ - U(kc, -1, 0)) * dyi)) * dxi
                + (ev_n2 * (V(kc, 1, 0) - v_) - ev_s2 * (v_ - V(kc, -1, 0))) * T(2) * dyi * dyi
                + (rhoh1 * ev_t2 * ((V(kp, 0, 0) - v_) * dzhi1 + (W(kp, 0, 0) - W(kp, -1, 0)) * dyi)
                   - rhoh * ev_b2 * ((v_ - V(km, 0, 0)) * dzhi + (w_ - W(kc, -1, 0)) * dyi)) * rdzi;

            // ---- w (half level ks+k) ----
            const T w_dn = W(km, 0, 0), w_up = W(kp, 0, 0);
            const T adv_w = -((i2(U(km, 0, 1), U(kc, 0, 1)) * i2(w_, W(kc, 0, 1))
                               - i2(U(km, 0, 0), u_) * i2(W(kc, 0, -1), w_)) * dxi
                              + (i2(V(km, 1, 0), V(kc, 1, 0)) * i2(w_, W(kc, 1, 0))
                                 - i2(V(km, 0, 0), v_) * i2(W(kc, -1, 0), w_)) * dyi
                              + (rho * i2(w_, w_up) * i2(w_, w_up)
                                 - rho_m1 * i2(w_dn, w_) * i2(w_dn, w_)) * rdzhi);
            const T e_dn = E(km, 0, 0);
            const T ev_xw = T(0.25) * (E(km, 0, -1) + E(kc, 0, -1) + e_dn + e_) + visc;
            const T ev_xw_p = T(0.25) * (e_dn + e_ + E(km, 0, 1) + E(kc, 0, 1)) + visc;
            const T ev_yw = T(0.25) * (E(km, -1, 0) + E(kc, -1, 0) + e_dn + e_) + visc;
            const T ev_yw_p = T(0.25) * (e_dn + e_ + E(km, 1, 0) + E(kc, 1, 0)) + visc;
            const T dif_w =
                (ev_xw_p * ((W(kc, 0, 1) - w_) * dxi + (U(kc, 0, 1) - U(km, 0, 1)) * dzhi)
                 - ev_xw * ((w_ - W(kc, 0, -1)) * dxi + (u_ - U(km, 0, 0)) * dzhi)) * dxi
                + (ev_yw_p * ((W(kc, 1, 0) - w_) * dyi + (V(kc, 1, 0) - V(km, 1, 0)) * dzhi)
                   - ev_yw * ((w_ - W(kc, -1, 0)) * dyi + (v_ - V(km, 0, 0)) * dzhi)) * dyi
                + (rho * (e_ + visc) * (w_up - w_) * dzi
                   - rho_m1 * (e_dn + visc) * (w_ - w_dn) * dzi_m1) * (T(2) * rdzhi);
            const T a_ = A(kc, 0, 0), a_dn = A(km, 0, 0), a_up = A(kp, 0, 0);
            T wt = adv_w + dif_w + grav / threfh * (i2(a_dn, a_) - threfh);

            // ---- th (advec_2.cxx advec_s + diff_smag2.cxx diff_c) ----
            const T adv_s = -((U(kc, 0, 1) * i2(a_, A(kc, 0, 1)) - u_ * i2(A(kc, 0, -1), a_)) * dxi
                              + (V(kc, 1, 0) * i2(a_, A(kc, 1, 0)) - v_ * i2(A(kc, -1, 0), a_)) * dyi
                              + (rhoh1 * w_up * i2(a_, a_up) - rhoh * w_ * i2(a_dn, a_)) * rdzi);
            const T se = T(0.5) * (e_ + E(kc, 0, 1)) * tPri + svisc;
            const T sw = T(0.5) * (E(kc, 0, -1) + e_) * tPri + svisc;
            const T sn = T(0.5) * (e_ + E(kc, 1, 0)) * tPri + svisc;
            const T ss = T(0.5) * (E(kc, -1, 0) + e_) * tPri + svisc;
            const T st = T(0.5) * (e_ + E(kp, 0, 0)) * tPri + svisc;
            const T sb = T(0.5) * (e_dn + e_) * tPri + svisc;
            const T dif_s =
                (se * (A(kc, 0, 1) - a_) - sw * (a_ - A(kc, 0, -1))) * dxi * dxi
                + (sn * (A(kc, 1, 0) - a_) - ss * (a_ - A(kc, -1, 0))) * dyi * dyi
                + (rhoh1 * st * (a_up - a_) * dzhi1 - rhoh * sb * (a_ - a_dn) * dzhi) * rdzi;

            // ---- folded sponge (buffer.cxx) and the wall half level ----
            T ut = adv_u + dif_u - facz * (u_ - cc[T_UREF]);
            T vt = adv_v + dif_v - facz * (v_ - cc[T_VREF]);
            wt = wt - faczh * w_;
            T tht = adv_s + dif_s - facz * (a_ - cc[T_SREF]);
            if (k == 0) wt = T(0);

            // ---- RK fold ----
            const long long o = (long long)(ks + k) * plane + (long long)j * itot + i;
            if (!first) {
                ut = tu[o] + ut;
                vt = tv[o] + vt;
                wt = tw[o] + wt;
                tht = tth[o] + tht;
            }
            us[o] = u_ + cbdt * ut;
            vs[o] = v_ + cbdt * vt;
            ws[o] = w_ + cbdt * wt;
            ths[o] = a_ + cbdt * tht;
            if (carry) {
                tu[o] = can * ut;
                tv[o] = can * vt;
                tw[o] = can * wt;
                tth[o] = can * tht;
            }
#undef U
#undef V
#undef W
#undef A
#undef E
        }
        __syncthreads();
    }
}

template <typename T>
int launch_tend_rk(const T* u, const T* v, const T* w, const T* th,
                   const T* e, T* us, T* vs, T* ws, T* ths, T* tu, T* tv,
                   T* tw, T* tth, const T* ct, int itot, int jtot, int ktot,
                   int ks, double dxi, double dyi, double visc, double svisc,
                   double tPr, double cbdt, double can, int first, int carry,
                   cudaStream_t stream) {
    const dim3 block(TI, TJ);
    const dim3 grid((itot + TI - 1) / TI, (jtot + TJ - 1) / TJ);
    tend_rk_kernel<T><<<grid, block, 0, stream>>>(
        u, v, w, th, e, us, vs, ws, ths, tu, tv, tw, tth, ct, itot, jtot,
        ktot, ks, T(dxi), T(dyi), T(visc), T(svisc), T(tPr), T(cbdt), T(can),
        first, carry);
    return (int)cudaGetLastError();
}

}  // namespace mhh

#define MHH_TEND_RK(SUF, T)                                                   \
    extern "C" int mhh_tend_rk_##SUF(                                         \
        const void* u, const void* v, const void* w, const void* th,          \
        const void* e, void* us, void* vs, void* ws, void* ths, void* tu,     \
        void* tv, void* tw, void* tth, const void* ct, int itot, int jtot,    \
        int ktot, int ks, double dxi, double dyi, double visc, double svisc,  \
        double tPr, double cbdt, double can, int first, int carry,            \
        void* stream) {                                                       \
        return mhh::launch_tend_rk<T>(                                        \
            (const T*)u, (const T*)v, (const T*)w, (const T*)th,              \
            (const T*)e, (T*)us, (T*)vs, (T*)ws, (T*)ths, (T*)tu, (T*)tv,     \
            (T*)tw, (T*)tth, (const T*)ct, itot, jtot, ktot, ks, dxi, dyi,    \
            visc, svisc, tPr, cbdt, can, first, carry, (cudaStream_t)stream); \
    }

MHH_TEND_RK(f32, float)
MHH_TEND_RK(f64, double)
