// Pointwise math of the 2nd-order LES kernels, shared by the eddy-viscosity
// kernels K1, K7, K14 (evisc.cu), the RK tendency sweeps K2, K20
// (tend_rk.cu), K22 (tend_rk_fold.cu) and K8-K10 (tend_generic.cu): the
// strain rate and the Smagorinsky viscosity (diff_smag2.cxx calc_strain2 +
// calc_evisc), advec_2 (advec_2.cxx) + Smagorinsky diffusion
// (diff_smag2.cxx diff_u/v/w/c) of u, v, w and a scalar, and the folded
// sponge and geostrophic Coriolis terms, at one point of a k-marching tile.
//
// Each field is seen through a view of its shared-memory ring: F(s, dj, di)
// is the value in ring slot s at row and column offsets (dj, di) from the
// view's point; km, kc, kp are the slots of the planes below, at and above
// the level computed.  The functions take any view type, so a kernel may
// keep rings of another depth or halo width (K22) than common.cuh's.
#pragma once

#include "common.cuh"

namespace mhh {

// per-level table columns of the eddy-viscosity kernels (ops/fused.py E_*)
enum { E_DZI, E_DZHI, E_DZHI1, E_MLEN2, E_THREF, E_TOPS, NE };

// per-level table columns of the tendency sweeps (ops/fused.py T_*); every
// table is NTG wide
enum {
    T_DZI, T_DZHI, T_DZHI1, T_DZI_M1, T_RHO, T_RHOH, T_RHOH1, T_RHO_M1,
    T_THREFH, T_FACZ, T_FACZH, T_UREF, T_VREF, T_SREF, NT,
    T_UG = NT, T_VG, T_ADDU, T_ADDV, T_ADDS, T_WLSDN, T_WLSUP, NTG
};

template <typename T>
__device__ __forceinline__ T i2(T a, T b) { return T(0.5) * (a + b); }

// one field's ring of (NJ, NI) planes seen from the point (r, c)
template <typename T, int NJ, int NI>
struct ViewT {
    const T (*ring)[NJ][NI];
    int r, c;
    __device__ __forceinline__ T operator()(int s, int dj, int di) const {
        return ring[s][r + dj][c + di];
    }
};

// common.cuh's ring: the tile with a one-cell halo
template <typename T>
using View = ViewT<T, HJ, HI>;

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

// strain rate squared and the stability-corrected Smagorinsky viscosity at
// the views' point of the plane in slot q.kc; cc is that level's row of the
// E_* table.  stratified: 0 none, 1 N2 from A's vertical gradient (E_TOPS
// patches a clamped top plane with the scalar's top-gradient ghost offset,
// zero elsewhere), 2 N2 = n2ext.  A is read only when stratified is 1.
template <typename T, typename VF>
__device__ __forceinline__ T evisc_math(const VF& U, const VF& V, const VF& W,
                                        const VF& A, Slots q,
                                        const T* __restrict__ cc, T dxi, T dyi,
                                        T tPr, int stratified, T n2ext) {
    const T dsmall = T(1.e-9), grav = T(9.81);
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[E_DZI], dzhi = cc[E_DZHI], dzhi1 = cc[E_DZHI1];
    const T mlen2 = cc[E_MLEN2];

    const T dudx = (U(kc, 0, 1) - U(kc, 0, 0)) * dxi;
    const T dvdy = (V(kc, 1, 0) - V(kc, 0, 0)) * dyi;
    const T dwdz = (W(kp, 0, 0) - W(kc, 0, 0)) * dzi;

    // (du/dy + dv/dx) at the four corners of the cell
    auto cor = [&](int dj, int di) {
        return (U(kc, dj, di) - U(kc, dj - 1, di)) * dyi
               + (V(kc, dj, di) - V(kc, dj, di - 1)) * dxi;
    };
    const T c00 = cor(0, 0), c01 = cor(0, 1), c10 = cor(1, 0), c11 = cor(1, 1);
    const T horiz = T(0.125) * (c00 * c00 + c01 * c01 + c10 * c10 + c11 * c11);

    auto duz_lo = [&](int di) {
        return (U(kc, 0, di) - U(km, 0, di)) * dzhi
               + (W(kc, 0, di) - W(kc, 0, di - 1)) * dxi;
    };
    auto duz_hi = [&](int di) {
        return (U(kp, 0, di) - U(kc, 0, di)) * dzhi1
               + (W(kp, 0, di) - W(kp, 0, di - 1)) * dxi;
    };
    const T xl0 = duz_lo(0), xl1 = duz_lo(1), xh0 = duz_hi(0), xh1 = duz_hi(1);
    const T vert_x = T(0.125) * (xl0 * xl0 + xl1 * xl1 + xh0 * xh0 + xh1 * xh1);

    auto dvz_lo = [&](int dj) {
        return (V(kc, dj, 0) - V(km, dj, 0)) * dzhi
               + (W(kc, dj, 0) - W(kc, dj - 1, 0)) * dyi;
    };
    auto dvz_hi = [&](int dj) {
        return (V(kp, dj, 0) - V(kc, dj, 0)) * dzhi1
               + (W(kp, dj, 0) - W(kp, dj - 1, 0)) * dyi;
    };
    const T yl0 = dvz_lo(0), yl1 = dvz_lo(1), yh0 = dvz_hi(0), yh1 = dvz_hi(1);
    const T vert_y = T(0.125) * (yl0 * yl0 + yl1 * yl1 + yh0 * yh0 + yh1 * yh1);

    const T strain2 = T(2) * (dudx * dudx + dvdy * dvdy + dwdz * dwdz + horiz
                              + vert_x + vert_y) + dsmall;
    if (!stratified) return mlen2 * sqrt(strain2);
    const T n2 = stratified == 2 ? n2ext
                 : grav / cc[E_THREF] * T(0.5)
                       * (A(kp, 0, 0) + cc[E_TOPS] - A(km, 0, 0)) * dzi;
    const T a = n2 * (T(-1) / tPr) + strain2;
    const T b = strain2 * dsmall;
    return mlen2 * sqrt(a > b ? a : b);
}

// u tendency (advec_2.cxx advec_u + diff_smag2.cxx diff_u) at full level k.
// advec = 0: an interpolated scheme (K12/K13) has already added the
// advection into the carry; the sweep does diffusion and the folds only
template <typename T, typename VF, typename VE>
__device__ __forceinline__ T u_tend(const VF& U, const VF& V, const VF& W,
                                    const VE& E, Slots q,
                                    const T* __restrict__ cc, T dxi, T dyi,
                                    T visc, int advec = 1) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzhi1 = cc[T_DZHI1];
    const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rhoh1 = cc[T_RHOH1];
    const T rdzi = dzi / rho;
    const T u_ = U(kc, 0, 0), v_ = V(kc, 0, 0), w_ = W(kc, 0, 0);
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
    return adv_u + dif_u;
}

// v tendency (advec_v + diff_v) at full level k
template <typename T, typename VF, typename VE>
__device__ __forceinline__ T v_tend(const VF& U, const VF& V, const VF& W,
                                    const VE& E, Slots q,
                                    const T* __restrict__ cc, T dxi, T dyi,
                                    T visc, int advec = 1) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzhi1 = cc[T_DZHI1];
    const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rhoh1 = cc[T_RHOH1];
    const T rdzi = dzi / rho;
    const T u_ = U(kc, 0, 0), v_ = V(kc, 0, 0), w_ = W(kc, 0, 0);
    const T e_ = E(kc, 0, 0);
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
    return adv_v + dif_v;
}

// u and v tendencies (advection + diffusion) at full level k
template <typename T, typename VF, typename VE>
__device__ __forceinline__ void uv_tend(const VF& U, const VF& V, const VF& W,
                                        const VE& E, Slots q,
                                        const T* __restrict__ cc, T dxi, T dyi,
                                        T visc, T& ut, T& vt, int advec = 1) {
    ut = u_tend(U, V, W, E, q, cc, dxi, dyi, visc, advec);
    vt = v_tend(U, V, W, E, q, cc, dxi, dyi, visc, advec);
}

// The folds of the dry sweeps K2, K20 and K22 onto u's tendency: the static
// sponge of the table (buffer.cxx) and, when coriolis, the geostrophic term
// fc (v - vg) of the JAX package's stencil (force.py:149, pallas_fused.py
// _extra_uv: v is averaged around (i+1/2, j-1), ROADMAP "followed
// behaviour" 1), with vg in the table
template <typename T, typename VF>
__device__ __forceinline__ T u_folds(const VF& U, const VF& V, int kc,
                                     const T* __restrict__ cc, T fc, T vtrans,
                                     int coriolis) {
    T ut = -cc[T_FACZ] * (U(kc, 0, 0) - cc[T_UREF]);
    if (coriolis) {
        const T v_at_u = T(0.25) * (V(kc, 0, 0) + V(kc, 0, 1) + V(kc, -1, 0)
                                    + V(kc, -1, 1));
        ut = ut + fc * (v_at_u + vtrans - cc[T_VG]);
    }
    return ut;
}

// the same for v: the sponge and -fc (u - ug)
template <typename T, typename VF>
__device__ __forceinline__ T v_folds(const VF& U, const VF& V, int kc,
                                     const T* __restrict__ cc, T fc, T utrans,
                                     int coriolis) {
    T vt = -cc[T_FACZ] * (V(kc, 0, 0) - cc[T_VREF]);
    if (coriolis) {
        const T u_at_v = T(0.25) * (U(kc, 0, 0) + U(kc, 0, -1) + U(kc, 1, 0)
                                    + U(kc, 1, -1));
        vt = vt - fc * (u_at_v + utrans - cc[T_UG]);
    }
    return vt;
}

// w tendency (advection + diffusion) at half level k
template <typename T, typename VF, typename VE>
__device__ __forceinline__ T w_tend(const VF& U, const VF& V, const VF& W,
                                    const VE& E, Slots q,
                                    const T* __restrict__ cc,
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
template <typename T, typename VF, typename VE>
__device__ __forceinline__ T s_tend(const VF& U, const VF& V, const VF& W,
                                    const VF& A, const VE& E, Slots q,
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
