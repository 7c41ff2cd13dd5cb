// Pointwise math of the 2nd-order LES kernels, shared by the eddy-viscosity
// kernels K1, K7, K14 (evisc.cu), the tendency sweeps K22 (tend_rk_fold.cu)
// and K2, K8-K10, K15, K18, K19, K20 (tend_generic.cu): the strain rate and the Smagorinsky viscosity (diff_smag2.cxx calc_strain2 +
// calc_evisc), advec_2 (advec_2.cxx) + Smagorinsky diffusion
// (diff_smag2.cxx diff_u/v/w/c) of u, v, w and a scalar, and the folded
// sponge and geostrophic Coriolis terms, at one point of a k-marching tile.
//
// Each field is seen through a view of its planes: F(s, dj, di) is the value
// in plane s at row and column offsets (dj, di) from the view's point; km,
// kc, kp name the planes below, at and above the level computed (Slots).
// The functions take any view type (KV below, K22's and the scalar sweep's
// own), so a kernel keeps its planes as its march needs them.
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

// columns that a kernel's staged row may hold after NTG (and after NE in an
// E_* row): quotients of the row's own columns, divided once a level by the
// kernel instead of once a point (K22's QRow)
enum { TQ_RDZI = NTG, TQ_RDZHI, TQ_GTHREFH, NTQ };
enum { EQ_GTHREF = NE, NEQ };

// a per-level row whose quotients are already divided (columns TQ_*, EQ_*)
template <typename T>
struct QRow {
    const T* p;
    __device__ __forceinline__ T operator[](int c) const { return p[c]; }
};

// The row a function below takes as cc, chosen by its first template
// argument R: a table row through a restrict-qualified pointer (R void, the
// default, as every kernel but K22 passes it), or a QRow<T>.
template <typename R, typename T>
struct RowArg {
    typedef const QRow<T>& type;
};
template <typename T>
struct RowArg<void, T> {
    typedef const T* __restrict__ type;
};

// a / b of two columns of the row cc: divided here for a plain row, read
// from column col of a QRow (which holds the same quotient)
template <typename T>
__device__ __forceinline__ T quot(const T* __restrict__ cc, T a, T b,
                                  int col) {
    return a / b;
}

template <typename T>
__device__ __forceinline__ T quot(const QRow<T>& cc, T a, T b, int col) {
    return cc.p[col];
}

template <typename T>
__device__ __forceinline__ T i2(T a, T b) { return T(0.5) * (a + b); }

// a field seen from a point of a k-march's tile (K22, K8/K9/K18, K1/K14):
// P0, P1, P2 point at it in the planes k-1, k, k+1 (rows W apart) and c0,
// c1, c2 are its own column
template <typename T, int W>
struct KV {
    const T *P0, *P1, *P2;
    T c0, c1, c2;
    __device__ __forceinline__ T operator()(int s, int dj, int di) const {
        if (dj == 0 && di == 0) return s == 0 ? c0 : (s == 1 ? c1 : c2);
        return (s == 0 ? P0 : (s == 1 ? P1 : P2))[dj * W + di];
    }
};

struct Slots {
    int km, kc, kp;
};

// strain rate squared and the stability-corrected Smagorinsky viscosity at
// the views' point of the plane in slot q.kc; cc is that level's row of the
// E_* table (RowArg).  stratified: 0 none, 1 N2 from A's vertical gradient (E_TOPS
// patches a clamped top plane with the scalar's top-gradient ghost offset,
// zero elsewhere), 2 N2 = n2ext.  A is read only when stratified is 1.
template <typename R = void, typename T, typename VF>
__device__ __forceinline__ T evisc_math(const VF& U, const VF& V, const VF& W,
                                        const VF& A, Slots q,
                                        typename RowArg<R, T>::type cc, T dxi,
                                        T dyi, T tPr, int stratified, T n2ext) {
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
                 : quot(cc, grav, cc[E_THREF], EQ_GTHREF) * T(0.5)
                       * (A(kp, 0, 0) + cc[E_TOPS] - A(km, 0, 0)) * dzi;
    const T a = n2 * (T(-1) / tPr) + strain2;
    const T b = strain2 * dsmall;
    return mlen2 * sqrt(a > b ? a : b);
}

// u tendency (advec_2.cxx advec_u + diff_smag2.cxx diff_u) at full level k.
// advec = 0: an interpolated scheme (K12/K13) has already added the
// advection into the carry; the sweep does diffusion and the folds only
template <typename R = void, typename T, typename VF, typename VE>
__device__ __forceinline__ T u_tend(const VF& U, const VF& V, const VF& W,
                                    const VE& E, Slots q,
                                    typename RowArg<R, T>::type cc, T dxi,
                                    T dyi, T visc, int advec = 1) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzhi1 = cc[T_DZHI1];
    const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rhoh1 = cc[T_RHOH1];
    const T rdzi = quot(cc, dzi, rho, TQ_RDZI);
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
template <typename R = void, typename T, typename VF, typename VE>
__device__ __forceinline__ T v_tend(const VF& U, const VF& V, const VF& W,
                                    const VE& E, Slots q,
                                    typename RowArg<R, T>::type cc, T dxi,
                                    T dyi, T visc, int advec = 1) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzhi1 = cc[T_DZHI1];
    const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rhoh1 = cc[T_RHOH1];
    const T rdzi = quot(cc, dzi, rho, TQ_RDZI);
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

// The folds of the folded dry sweep K22 onto u's tendency: the static
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
template <typename R = void, typename T, typename VF, typename VE>
__device__ __forceinline__ T w_tend(const VF& U, const VF& V, const VF& W,
                                    const VE& E, Slots q,
                                    typename RowArg<R, T>::type cc,
                                    T dxi, T dyi, T visc, int advec = 1) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T dzi = cc[T_DZI], dzhi = cc[T_DZHI], dzi_m1 = cc[T_DZI_M1];
    const T rho = cc[T_RHO], rhoh = cc[T_RHOH], rho_m1 = cc[T_RHO_M1];
    const T rdzhi = quot(cc, dzhi, rhoh, TQ_RDZHI);
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

// The scalar tendency (advec_2.cxx advec_s + diff_smag2.cxx diff_c) at
// full level k in three parts, so that a kernel that sweeps several
// scalars at once (the scalar sweep K10/K19) forms the second once a point:
// the advection of a scalar A by U, V, W
template <typename R = void, typename T, typename VF>
__device__ __forceinline__ T s_adv(const VF& U, const VF& V, const VF& W,
                                   const VF& A, Slots q,
                                   typename RowArg<R, T>::type cc, T dxi,
                                   T dyi) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T rdzi = quot(cc, cc[T_DZI], cc[T_RHO], TQ_RDZI);
    const T u_ = U(kc, 0, 0), v_ = V(kc, 0, 0), w_ = W(kc, 0, 0);
    const T w_up = W(kp, 0, 0);
    const T a_ = A(kc, 0, 0), a_dn = A(km, 0, 0), a_up = A(kp, 0, 0);
    return -((U(kc, 0, 1) * i2(a_, A(kc, 0, 1)) - u_ * i2(A(kc, 0, -1), a_)) * dxi
             + (V(kc, 1, 0) * i2(a_, A(kc, 1, 0)) - v_ * i2(A(kc, -1, 0), a_)) * dyi
             + (cc[T_RHOH1] * w_up * i2(a_, a_up) - cc[T_RHOH] * w_ * i2(a_dn, a_)) * rdzi);
}

// the eddy viscosity at the six faces (east, west, north, south, top,
// bottom), the same for every scalar
template <typename T, typename VE>
__device__ __forceinline__ void s_faces(const VE& E, Slots q, T (&f)[6]) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T e_ = E(kc, 0, 0);
    f[0] = T(0.5) * (e_ + E(kc, 0, 1));
    f[1] = T(0.5) * (E(kc, 0, -1) + e_);
    f[2] = T(0.5) * (e_ + E(kc, 1, 0));
    f[3] = T(0.5) * (E(kc, -1, 0) + e_);
    f[4] = T(0.5) * (e_ + E(kp, 0, 0));
    f[5] = T(0.5) * (E(km, 0, 0) + e_);
}

// and the diffusion of A, its diffusivity at each face f tPri + svisc
template <typename R = void, typename T, typename VF>
__device__ __forceinline__ T s_dif(const VF& A, Slots q,
                                   typename RowArg<R, T>::type cc, T dxi,
                                   T dyi, const T (&f)[6], T tPri, T svisc) {
    const int km = q.km, kc = q.kc, kp = q.kp;
    const T rhoh = cc[T_RHOH], rhoh1 = cc[T_RHOH1];
    const T rdzi = quot(cc, cc[T_DZI], cc[T_RHO], TQ_RDZI);
    const T a_ = A(kc, 0, 0), a_dn = A(km, 0, 0), a_up = A(kp, 0, 0);
    const T se = f[0] * tPri + svisc, sw = f[1] * tPri + svisc;
    const T sn = f[2] * tPri + svisc, ss = f[3] * tPri + svisc;
    const T st = f[4] * tPri + svisc, sb = f[5] * tPri + svisc;
    return (se * (A(kc, 0, 1) - a_) - sw * (a_ - A(kc, 0, -1))) * dxi * dxi
           + (sn * (A(kc, 1, 0) - a_) - ss * (a_ - A(kc, -1, 0))) * dyi * dyi
           + (rhoh1 * st * (a_up - a_) * cc[T_DZHI1]
              - rhoh * sb * (a_ - a_dn) * cc[T_DZHI]) * rdzi;
}

// the scalar tendency in one call (K2, K15, K20, K22), the parts in this
// order: with e's faces read first the latency-bound ring of K15 ran 2.4%
// slower on an H100
template <typename R = void, typename T, typename VF, typename VE>
__device__ __forceinline__ T s_tend(const VF& U, const VF& V, const VF& W,
                                    const VF& A, const VE& E, Slots q,
                                    typename RowArg<R, T>::type cc, T dxi,
                                    T dyi, T svisc, T tPri, int advec = 1) {
    const T adv_s = advec ? s_adv<R>(U, V, W, A, q, cc, dxi, dyi) : T(0);
    T f[6];
    s_faces(E, q, f);
    return adv_s + s_dif<R>(A, q, cc, dxi, dyi, f, tPri, svisc);
}

}  // namespace mhh
