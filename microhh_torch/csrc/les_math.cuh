// Pointwise math of the 2nd-order LES tendencies, shared by the RK
// tendency sweeps K2 (tend_rk.cu) and K8-K10 (tend_generic.cu):
// advec_2 (advec_2.cxx) + Smagorinsky diffusion (diff_smag2.cxx
// diff_u/v/w/c) of u, v, w and a scalar at one point of a k-marching tile.
//
// Each field is seen through its three-plane shared-memory ring
// (common.cuh): F(s, dj, di) is the value in ring slot s at row and column
// offsets (dj, di) from the thread's point; km, kc, kp are the slots of
// the planes below, at and above the level computed.
#pragma once

#include "common.cuh"

namespace mhh {

// per-level table columns (ops/fused.py T_*): the dry K2 table holds the
// first NT, the generic K8-K10 tables all NTG
enum {
    T_DZI, T_DZHI, T_DZHI1, T_DZI_M1, T_RHO, T_RHOH, T_RHOH1, T_RHO_M1,
    T_THREFH, T_FACZ, T_FACZH, T_UREF, T_VREF, T_SREF, NT,
    T_UG = NT, T_VG, T_ADDU, T_ADDV, T_ADDS, T_WLSDN, T_WLSUP, NTG
};

template <typename T>
__device__ __forceinline__ T i2(T a, T b) { return T(0.5) * (a + b); }

// one field's ring seen from the thread's point
template <typename T>
struct View {
    const T (*ring)[HJ][HI];
    int r, c;
    __device__ __forceinline__ T operator()(int s, int dj, int di) const {
        return ring[s][r + dj][c + di];
    }
};

template <typename T>
__device__ __forceinline__ View<T> view(const T (*ring)[HJ][HI]) {
    return View<T>{ring, (int)threadIdx.y + 1, (int)threadIdx.x + 1};
}

struct Slots {
    int km, kc, kp;
};

__device__ __forceinline__ Slots slots(int k) {
    return Slots{slot(k - 1), slot(k), slot(k + 1)};
}

// u and v tendencies (advection + diffusion) at full level k
template <typename T>
__device__ __forceinline__ void uv_tend(const View<T>& U, const View<T>& V,
                                        const View<T>& W, const View<T>& E,
                                        Slots q, const T* __restrict__ cc,
                                        T dxi, T dyi, T visc, T& ut, T& vt,
                                        int advec = 1) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzhi1 = cc[T_DZHI1];
    const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rhoh1 = cc[T_RHOH1];
    const T rdzi = dzi / rho;

    // ---- u (advec_2.cxx advec_u + diff_smag2.cxx diff_u) ----
    const T u_ = U(kc, 0, 0), v_ = V(kc, 0, 0), w_ = W(kc, 0, 0);
    // advec = 0: an interpolated scheme (K12/K13) has already added the
    // advection into the carry; the sweep does diffusion and the folds only
    const T adv_u = !advec ? T(0) : -((i2(u_, U(kc, 0, 1)) * i2(u_, U(kc, 0, 1))
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
    const T adv_v = !advec ? T(0) : -((i2(U(kc, -1, 1), U(kc, 0, 1)) * i2(v_, V(kc, 0, 1))
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
    ut = adv_u + dif_u;
    vt = adv_v + dif_v;
}

// w tendency (advection + diffusion) at half level k
template <typename T>
__device__ __forceinline__ T w_tend(const View<T>& U, const View<T>& V,
                                    const View<T>& W, const View<T>& E,
                                    Slots q, const T* __restrict__ cc,
                                    T dxi, T dyi, T visc, int advec = 1) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzi_m1 = cc[T_DZI_M1];
    const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rho_m1 = cc[T_RHO_M1];
    const T rdzhi = dzhi / rhoh;
    const T u_ = U(kc, 0, 0), v_ = V(kc, 0, 0), w_ = W(kc, 0, 0);
    const T w_dn = W(km, 0, 0), w_up = W(kp, 0, 0);
    const T adv_w = !advec ? T(0) : -((i2(U(km, 0, 1), U(kc, 0, 1)) * i2(w_, W(kc, 0, 1))
                       - i2(U(km, 0, 0), u_) * i2(W(kc, 0, -1), w_)) * dxi
                      + (i2(V(km, 1, 0), V(kc, 1, 0)) * i2(w_, W(kc, 1, 0))
                         - i2(V(km, 0, 0), v_) * i2(W(kc, -1, 0), w_)) * dyi
                      + (rho * i2(w_, w_up) * i2(w_, w_up)
                         - rho_m1 * i2(w_dn, w_) * i2(w_dn, w_)) * rdzhi);
    const T e_ = E(kc, 0, 0), e_dn = E(km, 0, 0);
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
    return adv_w + dif_w;
}

// scalar tendency (advec_2.cxx advec_s + diff_smag2.cxx diff_c) at full
// level k
template <typename T>
__device__ __forceinline__ T s_tend(const View<T>& U, const View<T>& V,
                                    const View<T>& W, const View<T>& A,
                                    const View<T>& E, Slots q,
                                    const T* __restrict__ cc, T dxi, T dyi,
                                    T svisc, T tPri, int advec = 1) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzhi1 = cc[T_DZHI1];
    const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rhoh1 = cc[T_RHOH1];
    const T rdzi = dzi / rho;
    const T u_ = U(kc, 0, 0), v_ = V(kc, 0, 0), w_ = W(kc, 0, 0);
    const T w_up = W(kp, 0, 0);
    const T a_ = A(kc, 0, 0), a_dn = A(km, 0, 0), a_up = A(kp, 0, 0);
    const T e_ = E(kc, 0, 0), e_dn = E(km, 0, 0);
    const T adv_s = !advec ? T(0) : -((U(kc, 0, 1) * i2(a_, A(kc, 0, 1)) - u_ * i2(A(kc, 0, -1), a_)) * dxi
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
    return adv_s + dif_s;
}

}  // namespace mhh
