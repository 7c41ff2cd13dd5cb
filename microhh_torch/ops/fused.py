"""Hand-kernel wrappers of the LES step (counterpart of
``microhh_tpu/ops/pallas_fused.py``): the dry path of the drycblles slice and
the generic path of the moist (bomex/rico) slice.

Each wrapper takes the ghost-padded (kcells, jtot, itot) fields.  On a CUDA
tensor it launches its hand-written kernel (``csrc/*.cu``, bound in
kernels.py); on a CPU tensor it runs the plain-torch version beside it in
this module, which is also what the card's kernel is held against.  There is
no fallback from the card to the plain version.

* K1 ``Fused.evisc``      - strain^2 + stability-corrected Smagorinsky eddy
                            viscosity (``csrc/evisc.cu``, a k-march chunked
                            by ``ops/kmarch.py``, one body with K14);
* K2 ``Fused.tend_rk``    - advec_2 + smag2 diffusion + dry buoyancy +
                            folded sponge and Coriolis term + RK fold
                            (``csrc/tend_generic.cu``: K20's k-march with
                            its RK flag and clamped reads, chunked by
                            ``ops/kmarch.py``);
* K22 ``Fused.tend_rk_fold`` - K2's sweep with the eddy viscosity (K1) and
                            the Poisson right-hand side (K4 rhs) computed in
                            the same k-march (``csrc/tend_rk_fold.cu``,
                            chunked by ``ops/kmarch.py``): the dry step's
                            default form;
* K4 ``PresGlue.rhs`` / ``PresGlue.apply`` - the projection glue
                            (``csrc/pres_glue.cu``; apply a k-split march,
                            chunked by ``ops/kmarch.py``);
* K7 ``Fused.limits``     - per-level maxima of the CFL rate and of K1's
                            eddy viscosity, the adaptive-dt limits
                            (``csrc/evisc.cu``, K1's k-march with the
                            maxima as its epilogue);
* K8/K9 ``FusedGeneric.tend_uvw`` - the generic path's u, v, w advec_2 +
                            smag2 + column fold + Coriolis + RK fold in
                            one k-march (``csrc/tend_generic.cu``, chunked
                            by ``ops/kmarch.py``);
* K10 ``FusedGeneric.tend_scalars`` - every scalar's advec_2 + smag2 +
                            column fold + RK fold in one k-march, four
                            scalars a launch (the scalar sweep of
                            ``csrc/tend_generic.cu``, ``ops/kmarch.py``);
* K14 ``FusedGeneric.evisc_n2`` - K1's eddy viscosity with N2 read from a
                            field the thermo computed (``csrc/evisc.cu``);
* K15 ``FusedGeneric.tend_scalars`` in a case of one scalar (SBL_Smag's
                            b) - K10's launch at one scalar, counted under
                            its own name, its column fold a flag
                            (``csrc/tend_generic.cu``, ``ops/kmarch.py``).

* K18 ``FusedGeneric.tend_uvw_acc`` and K19 ``FusedGeneric.tend_scalars_acc``
                          - K8/K9's sweep and the scalar sweep without the RK
                            fold: the tendency is added onto the carry in
                            place, K19 for every scalar in one launch of up
                            to four (``tend_scalar_acc``: one scalar)
                            (``csrc/tend_generic.cu``);
* K20 ``Fused.tendencies`` - K2's dry set without the RK fold on ghost-filled
                            fields, with the sponge and Coriolis folds: K18's
                            k-march with the sponge and th
                            (``csrc/tend_generic.cu``, chunked by
                            ``ops/kmarch.py``).

K8-K10, K15, K18 and K19 leave the advec_2 terms out when an interpolated
scheme (K12/K13, ops/advec_interp_fused.py) has added the advection into the
carry; the scalar sweep then reads no u, v or w.  K18-K20 serve the
substep without the RK fold (model.py ``_substep_unfolded``): another
producer changes the tendency after them there (open boundaries, sources, a
forcing op, the limiter in its tendency form), so the RK update cannot ride
the sweep.

On the dry path the kernels read the raw fields with CLAMPED k neighbours
(the JAX package's ``fold_ghosts`` variant: no ghost fill inside the
substep).  The generic path fills the ghost planes first, as the JAX
package's does, and K1, K7 and K8-K10 read k-1 and k+1 as they are.  The
MOST wall rows are patched afterwards in plain torch (``tendencies_rk``,
``generic_tendencies_rk``, ``surface_evisc_row``), as the JAX package
patches them in XLA.
"""

import ctypes

import numpy as np
import torch

from .. import constants as cst
from ..kernels import Kernel, check, device_scalar, on_cpu
from . import kmarch
from .stencil import im, ip, jm, jp, i2

# per-level table columns, shared with csrc/les_math.cuh and pres_glue.cu
(E_DZI, E_DZHI, E_DZHI1, E_MLEN2, E_THREF, E_TOPS, NE) = range(7)
# every table is NTG wide; the dry kernels (K2, K20, K22) read the first NT
# columns and ug, vg, the generic K8-K10 tables (built every substep by
# generic_col_tables) all of them
(T_DZI, T_DZHI, T_DZHI1, T_DZI_M1, T_RHO, T_RHOH, T_RHOH1, T_RHO_M1,
 T_THREFH, T_FACZ, T_FACZH, T_UREF, T_VREF, T_SREF, NT) = range(15)
(T_UG, T_VG, T_ADDU, T_ADDV, T_ADDS, T_WLSDN, T_WLSUP, NTG) = range(NT, NT + 8)
(P_RHO, P_RHOH, P_RHOH1, P_DZI, P_DZHI, NP) = range(6)

PROGNOSTIC = ("u", "v", "w", "th")


def _planes(a, first, n, off, lo, hi):
    """Planes first+off .. first+off+n-1 of a, each index clamped to [lo, hi]."""
    idx = torch.clamp(torch.arange(n, device=a.device) + first + off, lo, hi)
    return a.index_select(0, idx)


def _columns(tab):
    """slot -> (nk, 1, 1) column of a per-level table."""
    return lambda slot: tab[:, slot][:, None, None]


# ==========================================================================
#  plain-torch versions of the kernels
# ==========================================================================

def evisc_plain(u, v, w, th, ce, ks, dxi, dyi, tPr, stratified,
                ghosts=False, n2=None):
    """K1 in plain torch: eddy viscosity on the interior (ktot, jtot, itot).
    ghosts: read the ghost planes of filled fields instead of clamping.
    n2: an interior N2 field that replaces the one from th (K14)."""
    kt = ce.shape[0]
    ke = ks + kt
    lo, hic = (ks - 1, ke) if ghosts else (ks, ke - 1)
    c = _columns(ce)
    u_dn, uc, u_up = (_planes(u, ks, kt, o, lo, hic) for o in (-1, 0, 1))
    v_dn, vc, v_up = (_planes(v, ks, kt, o, lo, hic) for o in (-1, 0, 1))
    wc, w1 = (_planes(w, ks, kt, o, lo, ke) for o in (0, 1))
    dzi, dzhi, dzhi1 = c(E_DZI), c(E_DZHI), c(E_DZHI1)

    dudx = (ip(uc) - uc) * dxi
    dvdy = (jp(vc) - vc) * dyi
    dwdz = (w1 - wc) * dzi
    cor = (uc - jm(uc)) * dyi + (vc - im(vc)) * dxi
    horiz = 0.125 * (cor * cor + ip(cor) ** 2 + jp(cor) ** 2 + ip(jp(cor)) ** 2)
    duz_lo = (uc - u_dn) * dzhi + (wc - im(wc)) * dxi
    duz_hi = (u_up - uc) * dzhi1 + (w1 - im(w1)) * dxi
    vert_x = 0.125 * (duz_lo ** 2 + ip(duz_lo) ** 2 + duz_hi ** 2 + ip(duz_hi) ** 2)
    dvz_lo = (vc - v_dn) * dzhi + (wc - jm(wc)) * dyi
    dvz_hi = (v_up - vc) * dzhi1 + (w1 - jm(w1)) * dyi
    vert_y = 0.125 * (dvz_lo ** 2 + jp(dvz_lo) ** 2 + dvz_hi ** 2 + jp(dvz_hi) ** 2)
    strain2 = 2. * (dudx ** 2 + dvdy ** 2 + dwdz ** 2 + horiz + vert_x + vert_y) + cst.dsmall
    if not stratified:
        return c(E_MLEN2) * torch.sqrt(strain2)
    if n2 is None:
        th_dn, th_up = (_planes(th, ks, kt, o, lo, hic) for o in (-1, 1))
        n2 = cst.grav / c(E_THREF) * 0.5 * (th_up + c(E_TOPS) - th_dn) * dzi
    return c(E_MLEN2) * torch.sqrt(torch.maximum(
        n2 * (-1. / tPr) + strain2, strain2 * cst.dsmall))


def limits_plain(u, v, w, th, ce, ks, dxi, dyi, tPr, stratified,
                 ghosts=False, n2=None):
    """K7 in plain torch: per-level maxima (ktot,) of the CFL rate and of
    the eddy viscosity of evisc_plain."""
    kt = ce.shape[0]
    ke = ks + kt
    ev = evisc_plain(u, v, w, th, ce, ks, dxi, dyi, tPr, stratified, ghosts,
                     n2)
    uc, vc = u[ks:ke], v[ks:ke]
    wc, w1 = (_planes(w, ks, kt, o, ks, ke) for o in (0, 1))
    cfl = (torch.abs(i2(uc, ip(uc))) * dxi + torch.abs(i2(vc, jp(vc))) * dyi
           + torch.abs(i2(wc, w1)) * ce[:, E_DZI][:, None, None])
    return cfl.amax(dim=(1, 2)), ev.amax(dim=(1, 2))


def _uv_tend(c, dxi, dyi, visc, u_dn, u, u_up, v_dn, v, v_up, w, w_up,
             e_dn, e, e_up, advec=True):
    """advec False: an interpolated scheme has added the advection into the
    carry already; diffusion only."""
    dzi, dzhi, dzhi1 = c(T_DZI), c(T_DZHI), c(T_DZHI1)
    rhoh, rhoh1 = c(T_RHOH), c(T_RHOH1)
    rdzi = dzi / c(T_RHO)

    adv_u = 0. if not advec else -((i2(u, ip(u)) ** 2 - i2(im(u), u) ** 2) * dxi
              + (i2(im(jp(v)), jp(v)) * i2(u, jp(u))
                 - i2(im(v), v) * i2(jm(u), u)) * dyi
              + (rhoh1 * i2(im(w_up), w_up) * i2(u, u_up)
                 - rhoh * i2(im(w), w) * i2(u_dn, u)) * rdzi)
    ev_e = e + visc
    ev_w = im(e) + visc
    ev_n = 0.25 * (im(e) + e + im(jp(e)) + jp(e)) + visc
    ev_s = jm(ev_n)
    ev_t = 0.25 * (im(e) + e + im(e_up) + e_up) + visc
    ev_b = 0.25 * (im(e_dn) + e_dn + im(e) + e) + visc
    dif_u = ((ev_e * (ip(u) - u) - ev_w * (u - im(u))) * 2. * dxi * dxi
             + (ev_n * ((jp(u) - u) * dyi + (jp(v) - im(jp(v))) * dxi)
                - ev_s * ((u - jm(u)) * dyi + (v - im(v)) * dxi)) * dyi
             + (rhoh1 * ev_t * ((u_up - u) * dzhi1 + (w_up - im(w_up)) * dxi)
                - rhoh * ev_b * ((u - u_dn) * dzhi + (w - im(w)) * dxi)) * rdzi)

    adv_v = 0. if not advec else -((i2(jm(ip(u)), ip(u)) * i2(v, ip(v))
               - i2(jm(u), u) * i2(im(v), v)) * dxi
              + (i2(v, jp(v)) ** 2 - i2(jm(v), v) ** 2) * dyi
              + (rhoh1 * i2(jm(w_up), w_up) * i2(v, v_up)
                 - rhoh * i2(jm(w), w) * i2(v_dn, v)) * rdzi)
    ev_e2 = 0.25 * (jm(e) + e + ip(jm(e)) + ip(e)) + visc
    ev_w2 = im(ev_e2)
    ev_n2 = e + visc
    ev_s2 = jm(e) + visc
    ev_t2 = 0.25 * (jm(e) + e + jm(e_up) + e_up) + visc
    ev_b2 = 0.25 * (jm(e_dn) + e_dn + jm(e) + e) + visc
    dif_v = ((ev_e2 * ((ip(v) - v) * dxi + (ip(u) - jm(ip(u))) * dyi)
              - ev_w2 * ((v - im(v)) * dxi + (u - jm(u)) * dyi)) * dxi
             + (ev_n2 * (jp(v) - v) - ev_s2 * (v - jm(v))) * 2. * dyi * dyi
             + (rhoh1 * ev_t2 * ((v_up - v) * dzhi1 + (w_up - jm(w_up)) * dyi)
                - rhoh * ev_b2 * ((v - v_dn) * dzhi + (w - jm(w)) * dyi)) * rdzi)
    return adv_u + dif_u, adv_v + dif_v


def _w_tend(c, dxi, dyi, visc, u_dn, u, v_dn, v, w_dn, w, w_up, e_dn, e,
            advec=True):
    """advec_2 + smag2 of w at the half levels (without buoyancy)."""
    dzi, dzhi = c(T_DZI), c(T_DZHI)
    rho, rhoh, rho_m1 = c(T_RHO), c(T_RHOH), c(T_RHO_M1)
    rdzhi = dzhi / rhoh

    adv_w = 0. if not advec else -((i2(ip(u_dn), ip(u)) * i2(w, ip(w))
               - i2(u_dn, u) * i2(im(w), w)) * dxi
              + (i2(jp(v_dn), jp(v)) * i2(w, jp(w))
                 - i2(v_dn, v) * i2(jm(w), w)) * dyi
              + (rho * i2(w, w_up) ** 2 - rho_m1 * i2(w_dn, w) ** 2) * rdzhi)
    ev_xw = 0.25 * (im(e_dn) + im(e) + e_dn + e) + visc
    ev_yw = 0.25 * (jm(e_dn) + jm(e) + e_dn + e) + visc
    dif_w = ((ip(ev_xw) * ((ip(w) - w) * dxi + (ip(u) - ip(u_dn)) * dzhi)
              - ev_xw * ((w - im(w)) * dxi + (u - u_dn) * dzhi)) * dxi
             + (jp(ev_yw) * ((jp(w) - w) * dyi + (jp(v) - jp(v_dn)) * dzhi)
                - ev_yw * ((w - jm(w)) * dyi + (v - v_dn) * dzhi)) * dyi
             + (rho * (e + visc) * (w_up - w) * dzi
                - rho_m1 * (e_dn + visc) * (w - w_dn) * c(T_DZI_M1)) * (2. * rdzhi))
    return adv_w + dif_w


def _s_tend(c, dxi, dyi, svisc, tPr, u, v, w, w_up, a_dn, a, a_up,
            e_dn, e, e_up, advec=True):
    """advec_2 + smag2 (diff_c) of one scalar at the full levels."""
    dzi, dzhi, dzhi1 = c(T_DZI), c(T_DZHI), c(T_DZHI1)
    rhoh, rhoh1 = c(T_RHOH), c(T_RHOH1)
    rdzi = dzi / c(T_RHO)
    tPri = 1. / tPr

    adv_s = 0. if not advec else -((ip(u) * i2(a, ip(a)) - u * i2(im(a), a)) * dxi
              + (jp(v) * i2(a, jp(a)) - v * i2(jm(a), a)) * dyi
              + (rhoh1 * w_up * i2(a, a_up) - rhoh * w * i2(a_dn, a)) * rdzi)
    se = 0.5 * (e + ip(e)) * tPri + svisc
    sw_ = 0.5 * (im(e) + e) * tPri + svisc
    sn = 0.5 * (e + jp(e)) * tPri + svisc
    ss = 0.5 * (jm(e) + e) * tPri + svisc
    st_ = 0.5 * (e + e_up) * tPri + svisc
    sb = 0.5 * (e_dn + e) * tPri + svisc
    dif_s = ((se * (ip(a) - a) - sw_ * (a - im(a))) * dxi * dxi
             + (sn * (jp(a) - a) - ss * (a - jm(a))) * dyi * dyi
             + (rhoh1 * st_ * (a_up - a) * dzhi1
                - rhoh * sb * (a - a_dn) * dzhi) * rdzi)
    return adv_s + dif_s


def _dry_tend(s, e, ct, ks, dxi, dyi, visc, svisc, tPr, fc, utrans, vtrans,
              coriolis, thermo, planes):
    """The dry set's tendencies on the interior: advec_2 + smag2 of u, v, w
    and, when thermo, th with the dry buoyancy; the static sponge of the
    table ct and, when coriolis, the geostrophic term.  planes(a, half)
    gives the planes k-1, k, k+1 of a field (clamped or ghost-filled) and
    of e.  Returns the tendencies in the order u, v, w(, th) and the planes
    at k."""
    c = _columns(ct)
    u_dn, uc, u_up = planes(s["u"], False)
    v_dn, vc, v_up = planes(s["v"], False)
    w_dn, wc, w_up = planes(s["w"], True)
    e_dn, ec, e_up = planes(e, None)
    ut, vt = _uv_tend(c, dxi, dyi, visc, u_dn, uc, u_up, v_dn, vc, v_up,
                      wc, w_up, e_dn, ec, e_up)
    wt = _w_tend(c, dxi, dyi, visc, u_dn, uc, v_dn, vc, w_dn, wc, w_up,
                 e_dn, ec)
    facz = c(T_FACZ)
    ut = ut - facz * (uc - c(T_UREF))
    vt = vt - facz * (vc - c(T_VREF))
    if coriolis:
        cu, cv = _coriolis(uc, vc, c, fc, utrans, vtrans)
        ut, vt = ut + cu, vt + cv
    wt = wt - c(T_FACZH) * wc
    tends, cur = [ut, vt, wt], [uc, vc, wc]
    if thermo:
        a_dn, ac, a_up = planes(s["th"], False)
        threfh = c(T_THREFH)
        wt += cst.grav / threfh * (i2(a_dn, ac) - threfh)
        tht = _s_tend(c, dxi, dyi, svisc, tPr, uc, vc, wc, w_up, a_dn, ac,
                      a_up, e_dn, ec, e_up)
        tends.append(tht - facz * (ac - c(T_SREF)))
        cur.append(ac)
    wt[0] = 0.          # half level ks is the wall
    return tends, cur


def tend_rk_plain(s, e, t, ct, ks, dxi, dyi, visc, svisc, tPr, cbdt, can,
                  first, carry, fc=0., utrans=0., vtrans=0., coriolis=False,
                  thermo=True):
    """K2 in plain torch.  s, t: dicts of (kcells, jtot, itot) u, v, w and,
    when thermo, th; e: interior evisc (ktot, jtot, itot).  Returns s* (zero
    ghost planes); updates the carry t in place unless carry is False, and
    reads it only when first is False."""
    kt = ct.shape[0]
    ke = ks + kt

    def planes(a, half):
        if half is None:
            return (_planes(a, 0, kt, o, 0, kt - 1) for o in (-1, 0, 1))
        return (_planes(a, ks, kt, o, ks, ke if half else ke - 1)
                for o in (-1, 0, 1))

    tends, cur = _dry_tend(s, e, ct, ks, dxi, dyi, visc, svisc, tPr, fc,
                           utrans, vtrans, coriolis, thermo, planes)
    s_star = {}
    for n, tend, sc in zip(PROGNOSTIC, tends, cur):
        tt = tend if first else t[n][ks:ke] + tend
        out = torch.zeros_like(s[n])
        out[ks:ke] = sc + cbdt * tt
        s_star[n] = out
        if carry:
            t[n][ks:ke] = can * tt
    return s_star


def tend_rk_fold_plain(s, t, ct, ce, ks, dxi, dyi, visc, svisc, tPr, cbdt,
                       can, dti, first, carry, se_row=None, e=None, fc=0.,
                       utrans=0., vtrans=0., coriolis=False, thermo=True):
    """K22 in plain torch: the eddy viscosity of evisc_plain on clamped
    planes with its bottom row replaced by se_row when given (or the
    interior array e as it is, when the evisc fold is off), K2's sweep with
    it, and dti * div(rho s*) of the s* that sweep gives, w*(ke) = 0.
    Returns (s*, e, rhs); the carry as in tend_rk_plain."""
    kt = ct.shape[0]
    ke = ks + kt
    if e is None:
        e = evisc_plain(s["u"], s["v"], s["w"], s.get("th"), ce, ks, dxi, dyi,
                        tPr, thermo)
        if se_row is not None:
            e[0] = se_row
    s_star = tend_rk_plain(s, e, t, ct, ks, dxi, dyi, visc, svisc, tPr, cbdt,
                           can, first, carry, fc, utrans, vtrans, coriolis,
                           thermo)
    c = _columns(ct)
    us, vs, ws = (s_star[n][ks:ke] for n in ("u", "v", "w"))
    w_up = s_star["w"][ks + 1:ke + 1]
    rhs = dti * (c(T_RHO) * ((ip(us) - us) * dxi + (jp(vs) - vs) * dyi)
                 + (c(T_RHOH1) * w_up - c(T_RHOH) * ws) * c(T_DZI))
    return s_star, e, rhs


def pres_rhs_plain(u, v, w, pc, ks, dxi, dyi, dti):
    """K4 rhs in plain torch: dti * div(rho s*) on the interior."""
    kt = pc.shape[0]
    ke = ks + kt
    c = _columns(pc)
    uc, vc, wc, w1 = u[ks:ke], v[ks:ke], w[ks:ke], w[ks + 1:ke + 1]
    return dti * (c(P_RHO) * ((ip(uc) - uc) * dxi + (jp(vc) - vc) * dyi)
                  + (c(P_RHOH1) * w1 - c(P_RHOH) * wc) * c(P_DZI))


def pres_apply_plain(p, s, t, pc, ks, dxi, dyi, dt, can, carry):
    """K4 apply in plain torch: s -= dt grad p (and t -= can grad p when
    carry) for u, v, w in place; p is the interior pressure."""
    kt = pc.shape[0]
    ke = ks + kt
    gu = (p - im(p)) * dxi
    gv = (p - jm(p)) * dyi
    gw = torch.zeros_like(p)
    gw[1:] = (p[1:] - p[:-1]) * pc[1:, P_DZHI][:, None, None]
    for n, g in (("u", gu), ("v", gv), ("w", gw)):
        s[n][ks:ke] = s[n][ks:ke] - dt * g
        if carry:
            t[n][ks:ke] = t[n][ks:ke] - can * g


def _ghost_planes(a, ks, ke):
    """Planes k-1, k, k+1 of a ghost-filled array for the interior k."""
    return a[ks - 1:ke - 1], a[ks:ke], a[ks + 1:ke + 1]


def _fresh(s, ks, ke, values):
    """A new array like s holding values on the interior, zero ghosts."""
    out = torch.zeros_like(s)
    out[ks:ke] = values
    return out


def tend_uvw_plain(s, e, t, ct, ks, dxi, dyi, visc, fc, utrans, vtrans,
                   cbdt, can, coriolis, carry, advec=True):
    """K8/K9 in plain torch.  s, t: dicts of ghost-filled (kcells, jtot,
    itot) u, v, w; e: the eddy viscosity with edge ghost planes (kcells);
    ct: this substep's (ktot, NTG) table.  Returns s* for u, v, w (zero
    ghost planes); the carry t always enters and is overwritten in place
    when carry.  advec False leaves the advec_2 terms out."""
    kt = ct.shape[0]
    ke = ks + kt
    c = _columns(ct)
    u_dn, uc, u_up = _ghost_planes(s["u"], ks, ke)
    v_dn, vc, v_up = _ghost_planes(s["v"], ks, ke)
    w_dn, wc, w_up = _ghost_planes(s["w"], ks, ke)
    e_dn, ec, e_up = _ghost_planes(e, ks, ke)

    ut, vt = _uv_tend(c, dxi, dyi, visc, u_dn, uc, u_up, v_dn, vc, v_up,
                      wc, w_up, e_dn, ec, e_up, advec)
    # the column fold and the geostrophic Coriolis term
    # (pallas_fused.py _extra_uv with fold_add)
    facz = c(T_FACZ)
    ut = ut + c(T_ADDU) - facz * uc
    vt = vt + c(T_ADDV) - facz * vc
    wdn, wup = c(T_WLSDN), c(T_WLSUP)
    ut = ut + wdn * (uc - u_dn) + wup * (u_up - uc)
    vt = vt + wdn * (vc - v_dn) + wup * (v_up - vc)
    if coriolis:
        cu, cv = _coriolis(uc, vc, c, fc, utrans, vtrans)
        ut, vt = ut + cu, vt + cv
    wt = (_w_tend(c, dxi, dyi, visc, u_dn, uc, v_dn, vc, w_dn, wc, w_up,
                  e_dn, ec, advec) - c(T_FACZH) * wc)
    wt[0] = 0.          # half level ks is the wall

    s_star = {}
    for n, tend, cur in (("u", ut, uc), ("v", vt, vc), ("w", wt, wc)):
        tt = t[n][ks:ke] + tend
        s_star[n] = _fresh(s[n], ks, ke, cur + cbdt * tt)
        if carry:
            t[n][ks:ke] = can * tt
    return s_star


def tend_scalars_plain(s, names, e, t, cts, sviscs, ks, dxi, dyi, tPr,
                       cbdt, can, carry, advec=True, fold=True):
    """K10 (and, for one scalar, K15) in plain torch: the scalars ``names``
    with their tables cts (S, ktot, NTG) and viscosities; returns their s*,
    updates the carry in place when carry.  advec False leaves the advec_2
    terms out, fold False the column terms of the tables."""
    kt = cts.shape[1]
    ke = ks + kt
    uc, vc, wc = s["u"][ks:ke], s["v"][ks:ke], s["w"][ks:ke]
    w_up = s["w"][ks + 1:ke + 1]
    e_dn, ec, e_up = _ghost_planes(e, ks, ke)
    s_star = {}
    for n, ct, svisc in zip(names, cts, sviscs):
        c = _columns(ct)
        a_dn, ac, a_up = _ghost_planes(s[n], ks, ke)
        tt = t[n][ks:ke] + _s_tend(c, dxi, dyi, svisc, tPr, uc, vc, wc, w_up,
                                   a_dn, ac, a_up, e_dn, ec, e_up, advec)
        if fold:
            tt = tt + (c(T_ADDS) - c(T_FACZ) * ac + c(T_WLSDN) * (ac - a_dn)
                       + c(T_WLSUP) * (a_up - ac))
        s_star[n] = _fresh(s[n], ks, ke, ac + cbdt * tt)
        if carry:
            t[n][ks:ke] = can * tt
    return s_star


def _coriolis(uc, vc, c, fc, utrans, vtrans):
    """The geostrophic Coriolis terms of u and v (pallas_fused.py _extra_uv;
    ROADMAP Queue 3 on the stencil's offset)."""
    v_at_u = 0.25 * (vc + ip(vc) + jm(vc) + jm(ip(vc)))
    u_at_v = 0.25 * (uc + im(uc) + jp(uc) + im(jp(uc)))
    return (fc * (v_at_u + vtrans - c(T_VG)),
            -fc * (u_at_v + utrans - c(T_UG)))


def tend_uvw_acc_plain(s, e, t, ct, ks, dxi, dyi, visc, fc, utrans, vtrans,
                       coriolis, advec=True):
    """K18 in plain torch: advec_2 (unless advec is False) + smag2 of u, v
    and w and, when coriolis, the geostrophic term with ug, vg of the (ktot,
    NTG) table ct, added onto the interior of the carries t in place.  s:
    ghost-filled fields, e: the kcells eddy viscosity.  The table's column
    terms are left out; half level ks of w keeps its carry."""
    kt = ct.shape[0]
    ke = ks + kt
    c = _columns(ct)
    u_dn, uc, u_up = _ghost_planes(s["u"], ks, ke)
    v_dn, vc, v_up = _ghost_planes(s["v"], ks, ke)
    w_dn, wc, w_up = _ghost_planes(s["w"], ks, ke)
    e_dn, ec, e_up = _ghost_planes(e, ks, ke)
    ut, vt = _uv_tend(c, dxi, dyi, visc, u_dn, uc, u_up, v_dn, vc, v_up,
                      wc, w_up, e_dn, ec, e_up, advec)
    if coriolis:
        cu, cv = _coriolis(uc, vc, c, fc, utrans, vtrans)
        ut, vt = ut + cu, vt + cv
    wt = _w_tend(c, dxi, dyi, visc, u_dn, uc, v_dn, vc, w_dn, wc, w_up,
                 e_dn, ec, advec)
    wt[0] = 0.          # half level ks is the wall
    for n, tend in (("u", ut), ("v", vt), ("w", wt)):
        t[n][ks:ke] += tend


def tend_scalar_acc_plain(s, name, e, t, ct, svisc, ks, dxi, dyi, tPr,
                          advec=True):
    """K19 in plain torch: one scalar's advec_2 (unless advec is False) +
    smag2, added onto the interior of its carry in place."""
    kt = ct.shape[0]
    ke = ks + kt
    a_dn, ac, a_up = _ghost_planes(s[name], ks, ke)
    e_dn, ec, e_up = _ghost_planes(e, ks, ke)
    t[name][ks:ke] += _s_tend(
        _columns(ct), dxi, dyi, svisc, tPr, s["u"][ks:ke], s["v"][ks:ke],
        s["w"][ks:ke], s["w"][ks + 1:ke + 1], a_dn, ac, a_up, e_dn, ec, e_up,
        advec)


def tend_scalars_acc_plain(s, names, e, t, ct, sviscs, ks, dxi, dyi, tPr,
                           advec=True):
    """K19 for the scalars ``names`` in plain torch: tend_scalar_acc_plain
    for each in turn, with its viscosity of sviscs."""
    for name, svisc in zip(names, sviscs):
        tend_scalar_acc_plain(s, name, e, t, ct, svisc, ks, dxi, dyi, tPr,
                              advec)


def tendencies_plain(s, e, t, ct, ks, dxi, dyi, visc, svisc, tPr, fc, utrans,
                     vtrans, coriolis, thermo=True):
    """K20 in plain torch: K2's dry set (advec_2 + smag2 of u, v, w and,
    when thermo, th with the dry buoyancy, the static sponge of the (ktot,
    NTG) table ct and, when coriolis, the geostrophic term) on ghost-filled
    fields s and the kcells eddy viscosity e, added onto the interior of
    the carries t in place; no RK update."""
    ke = ks + ct.shape[0]
    tends, _ = _dry_tend(s, e, ct, ks, dxi, dyi, visc, svisc, tPr, fc, utrans,
                         vtrans, coriolis, thermo,
                         lambda a, half: _ghost_planes(a, ks, ke))
    for n, tend in zip(PROGNOSTIC, tends):
        t[n][ks:ke] += tend


def _empty_ghosts_zero(like, ctx, out=None):
    """An uninitialised array like ``like`` whose ghost planes are zero
    (the kernels write the interior planes only): ``out`` when given (an
    array of the next state, which the chunked loop's graphs alternate
    between), else a new one."""
    if out is None:
        out = torch.empty_like(like)
    out[:ctx.ks].zero_()
    out[ctx.ke:].zero_()
    return out


# ==========================================================================
#  kernel wrappers
# ==========================================================================

class Fused:
    """K1, K2 or K22 (or K20) and K7 with their per-level tables, for one
    grid, base state and sponge.  ``buffer`` is the static-profile sponge
    folded into the sweep (None: no sponge); ``force`` the static
    geostrophic forcing folded into it as a Coriolis term with ug, vg in the
    table (None: no such term); ``top_grad_th`` is th's top ghost gradient
    (Neumann value, or -flux/visc) that the clamped top plane of the eddy
    viscosity needs.  ``has_thermo`` False is the neutral set
    (FusedLES2(has_thermo=False)): no th, no buoyancy, no N2.  ``ghosts``:
    the kernels read the ghost planes of filled fields (the dry substep
    without the RK fold: K1 and K7 in their ghost mode and K20); else they
    clamp (K2, K22)."""

    ghosts = False    # K1/K7 read ghost planes (generic path) or clamp
    # K1/K7's stability term: 0 none, 1 N2 from the th argument's gradient,
    # 2 the th argument is an interior N2 field (K14's mode)
    stratified = 1
    n2_scalar = "th"  # the scalar whose gradient gives N2 (generic_viscosity)
    names = ("th",)

    def __init__(self, ctx, smag, thermo, buffer, top_grad_th, ghosts=False,
                 force=None, has_thermo=True):
        self.ctx = ctx
        self.smag = smag
        self.ghosts = bool(ghosts)
        self.has_thermo = bool(has_thermo)
        self.stratified = int(self.has_thermo)
        self.names = ("th",) if self.has_thermo else ()
        self.prognostic = ("u", "v", "w") + self.names
        self.coriolis = force is not None
        self.fc = float(force.fc) if self.coriolis else 0.
        self.tPr = smag.tPr
        self.visc = smag.visc
        self.svisc = (smag.viscs.get("th", smag.visc) if self.has_thermo
                      else smag.visc)
        ks, ke, kt = ctx.ks, ctx.ke, ctx.ktot
        ka = np.arange(ks, ke)
        ce = np.zeros((kt, NE))
        ce[:, E_DZI] = ctx.np_dzi[ka]
        ce[:, E_DZHI] = ctx.np_dzhi[ka]
        ce[:, E_DZHI1] = ctx.np_dzhi[ka + 1]
        ce[:, E_MLEN2] = smag.mlen2
        ct = np.zeros((kt, NTG))
        ct[:, T_DZI] = ctx.np_dzi[ka]
        ct[:, T_DZHI] = ctx.np_dzhi[ka]
        ct[:, T_DZHI1] = ctx.np_dzhi[ka + 1]
        ct[:, T_DZI_M1] = ctx.np_dzi[ka - 1]
        ct[:, T_RHO] = ctx.np_rhoref[ka]
        ct[:, T_RHOH] = ctx.np_rhorefh[ka]
        ct[:, T_RHOH1] = ctx.np_rhorefh[ka + 1]
        ct[:, T_RHO_M1] = ctx.np_rhoref[ka - 1]
        # a thermo without a reference profile (the disabled one) leaves the
        # columns zero (pallas_fused.py:1300-1317); no kernel reads them then
        if self.has_thermo and getattr(thermo, "thref", None) is not None:
            ce[:, E_THREF] = thermo.thref[ka]
            ct[:, T_THREFH] = thermo.threfh[ka]
            if not self.ghosts:
                ce[kt - 1, E_TOPS] = top_grad_th / ctx.np_dzhi[ke]
        if buffer is not None:
            ct[:, T_FACZ] = buffer.fac_z[:, 0, 0]
            ct[:, T_FACZH] = buffer.fac_zh[:, 0, 0]
            ct[:, T_UREF] = buffer.profs["u"][:, 0, 0]
            ct[:, T_VREF] = buffer.profs["v"][:, 0, 0]
            if self.has_thermo:
                ct[:, T_SREF] = buffer.profs["th"][:, 0, 0]
        if self.coriolis:
            ct[:, T_UG] = force.ug[:, 0, 0]
            ct[:, T_VG] = force.vg[:, 0, 0]
        self.ce = ctx.tensor(ce)
        self.ct = ctx.tensor(ct)
        self.k_evisc = Kernel("evisc", "microhh_torch/csrc/evisc.cu",
                              "microhh_tpu/ops/pallas_fused.py:1441")
        self.k_tend = Kernel("tend_rk",
                             "microhh_torch/csrc/tend_generic.cu",
                             "microhh_tpu/ops/pallas_fused.py:1930, "
                             "microhh_tpu/ops/pallas_fused.py:1951")
        self.k_tend_fold = Kernel("tend_rk_fold",
                                  "microhh_torch/csrc/tend_rk_fold.cu",
                                  "microhh_tpu/ops/pallas_fused.py:2073, "
                                  "microhh_tpu/ops/pallas_fused.py:2108")
        self.k_limits = Kernel("limits", "microhh_torch/csrc/evisc.cu",
                               "microhh_tpu/ops/pallas_fused.py:1524")
        self.k_tendencies = Kernel(
            "tendencies", "microhh_torch/csrc/tend_generic.cu",
            "microhh_tpu/ops/pallas_fused.py:1807, "
            "microhh_tpu/ops/pallas_fused.py:1827, "
            "microhh_tpu/ops/pallas_fused.py:1399")

    def _th(self, d):
        """The th entry of a state or carry dict; None without thermo (a
        null pointer to the kernels)."""
        return d["th"] if self.has_thermo else None

    def evisc_plan(self, dtype, stratified, chunks=None):
        """K1's or K14's k-march (ops/kmarch.py) in the stratified mode
        (0, 1, or 2 for K14), the chunk count chosen from the card's
        resident blocks unless given."""
        ctx = self.ctx
        info = self.k_evisc.info(dtype, stratified)
        return kmarch.plan("evisc", ctx.itot, ctx.jtot, ctx.ktot, 0, dtype,
                           info["blocks_per_sm"] * info["sms"], chunks)

    def evisc(self, u, v, w, th, out=None, chunks=None):
        """K1: interior eddy viscosity (ktot, jtot, itot), into ``out`` when
        given (a contiguous interior view).  Unstratified, th is not read
        (pass any field).  chunks: force the k-split (checks and timings
        only)."""
        ctx = self.ctx
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.tPr)
        stratified = min(self.stratified, 1)
        if on_cpu(u):
            ev = evisc_plain(u, v, w, th, self.ce, *args, bool(stratified),
                             self.ghosts)
            return ev if out is None else out.copy_(ev)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        interior = (ctx.ktot, ctx.jtot, ctx.itot)
        if out is None:
            out = torch.empty(interior, dtype=u.dtype, device=u.device)
        check((u, v, w, th, self.ce, out), u.dtype, u.device,
              [shape] * 4 + [(ctx.ktot, NE), interior])
        self.k_evisc(u.dtype, u, v, w, th, out, self.ce, ctx.itot, ctx.jtot,
                     ctx.ktot, *args, stratified, int(self.ghosts),
                     self.evisc_plan(u.dtype, stratified, chunks).chunks)
        return out

    def limits_plan(self, dtype, stratified, chunks=None):
        """K7's k-march (ops/kmarch.py) in the stratified mode (0, 1, or 2
        with an N2 field), the chunk count chosen from the card's resident
        blocks unless given."""
        ctx = self.ctx
        info = self.k_limits.info(dtype, stratified)
        return kmarch.plan("limits", ctx.itot, ctx.jtot, ctx.ktot, 0, dtype,
                           info["blocks_per_sm"] * info["sms"], chunks)

    def limits(self, u, v, w, th, chunks=None):
        """K7: per-level maxima (ktot,) of the CFL rate and the eddy
        viscosity (before the MOST row patch).  th is the scalar whose
        gradient gives N2 or, when ``stratified`` is 2, the interior N2
        field itself (K14's mode; K7 takes it as a mode of its one kernel);
        unstratified, it is not read (pass any field).  chunks: force the
        k-split (checks and timings only)."""
        ctx = self.ctx
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.tPr)
        external = self.stratified == 2
        if on_cpu(u):
            return limits_plain(u, v, w, th, self.ce, *args,
                                bool(self.stratified), self.ghosts,
                                th if external else None)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        th_shape = (ctx.ktot, ctx.jtot, ctx.itot) if external else shape
        check((u, v, w, th, self.ce), u.dtype, u.device,
              [shape] * 3 + [th_shape, (ctx.ktot, NE)])
        plan = self.limits_plan(u.dtype, self.stratified, chunks)
        part = torch.empty((2, ctx.ktot, plan.tiles_i * plan.tiles_j),
                           dtype=u.dtype, device=u.device)
        out = torch.empty((2, ctx.ktot), dtype=u.dtype, device=u.device)
        self.k_limits(u.dtype, u, v, w, th, part, out, self.ce, ctx.itot,
                      ctx.jtot, ctx.ktot, *args, self.stratified,
                      int(self.ghosts), plan.chunks)
        return out[0], out[1]

    def _sweep_args(self):
        """What K2's, K20's and K22's plain versions take after the RK
        numbers: the Coriolis fold and the thermo flag."""
        ctx = self.ctx
        return (self.fc, ctx.utrans, ctx.vtrans, self.coriolis,
                self.has_thermo)

    def tend_rk_plan(self, dtype, chunks=None):
        """K2's k-march (ops/kmarch.py) in this case's thermo form (S its
        one scalar th, counted), the chunk count chosen from the card's
        resident blocks unless given."""
        ctx, S = self.ctx, int(self.has_thermo)
        info = self.k_tend.info(dtype, 0, S)
        return kmarch.plan("tend_rk", ctx.itot, ctx.jtot, ctx.ktot, S, dtype,
                           info["blocks_per_sm"] * info["sms"], chunks)

    def tend_rk(self, s, t, e, cbdt, can, first, carry, chunks=None,
                out=None):
        """K2: returns s* = s + cbdt*t_total (zero ghost planes) and, when
        carry, overwrites the interior of t with can*t_total in place; with
        first the carry is not read.  e: the interior eddy viscosity;
        cbdt: a 0-dim tensor (the kernel reads it on the card) or a number.
        out: the arrays to write s* into (on the card), else new ones.
        chunks: force the k-split (checks and timings only)."""
        ctx = self.ctx
        u = s["u"]
        if not on_cpu(u):
            cbdt = device_scalar(cbdt, u)
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.visc, self.svisc, self.tPr,
                cbdt, can)
        if on_cpu(u):
            return tend_rk_plain(s, e, t, self.ct, *args, first, carry,
                                 *self._sweep_args())
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        names = self.prognostic
        check([s[n] for n in names] + [t[n] for n in names] + [e, self.ct],
              u.dtype, u.device, [shape] * (2 * len(names))
              + [(ctx.ktot, ctx.jtot, ctx.itot), (ctx.ktot, NTG)])
        s_star = {n: _empty_ghosts_zero(s[n], ctx, out[n] if out else None)
                  for n in names}
        self.k_tend(u.dtype, s["u"], s["v"], s["w"], self._th(s), e,
                    s_star["u"], s_star["v"], s_star["w"], self._th(s_star),
                    t["u"], t["v"], t["w"], self._th(t), self.ct, ctx.itot,
                    ctx.jtot, ctx.ktot, *args, self.fc, ctx.utrans,
                    ctx.vtrans, int(first), int(carry), int(self.coriolis),
                    self.tend_rk_plan(u.dtype, chunks).chunks)
        return s_star

    def fold_plan(self, dtype, chunks=None):
        """K22's k-march (ops/kmarch.py), the chunk count chosen from the
        card's resident blocks unless given."""
        ctx = self.ctx
        info = self.k_tend_fold.info(dtype, int(self.has_thermo))
        return kmarch.plan("tend_rk_fold", ctx.itot, ctx.jtot, ctx.ktot, 0,
                           dtype, info["blocks_per_sm"] * info["sms"], chunks)

    def tend_rk_fold(self, s, t, se_row, cbdt, can, dti, first, carry,
                     e=None, chunks=None, out=None):
        """K22: returns (s*, e, rhs): s* as tend_rk, the interior eddy
        viscosity it computed (its bottom row se_row, the MOST surface row,
        when given) and the Poisson right-hand side dti * div(rho s*), both
        (ktot, jtot, itot).  With ``e`` given the eddy viscosity is read, not
        computed, and returned as it is.  The carry: t["th"] is overwritten
        in place when carry; t["u"], t["v"] and t["w"] are then REPLACED in
        the dict by new tensors when they were also read (not first),
        because a block reads u's and v's one cell inside its neighbours'
        tiles and w's one level above its chunk.  cbdt, dti: 0-dim tensors
        (the kernel reads them on the card) or numbers.  out: the arrays to
        write s* into (on the card), else new ones.  chunks: force the
        k-split (checks and timings only)."""
        ctx = self.ctx
        u = s["u"]
        if not on_cpu(u):
            cbdt, dti = device_scalar(cbdt, u), device_scalar(dti, u)
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.visc, self.svisc, self.tPr,
                cbdt, can, dti)
        old = {n: t[n] for n in ("u", "v", "w")}
        if carry and not first:
            for n in ("u", "v", "w"):
                t[n] = (t[n].clone() if on_cpu(u)
                        else _empty_ghosts_zero(t[n], ctx))
        if on_cpu(u):
            return tend_rk_fold_plain(s, t, self.ct, self.ce, *args, first,
                                      carry, se_row, e, *self._sweep_args())
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        interior = (ctx.ktot, ctx.jtot, ctx.itot)
        names = self.prognostic
        extra = [a for a in (se_row, e) if a is not None]
        check([s[n] for n in names] + [t[n] for n in names] + list(old.values())
              + [self.ct, self.ce] + extra, u.dtype, u.device,
              [shape] * (2 * len(names) + 3) + [(ctx.ktot, NTG), (ctx.ktot, NE)]
              + ([(ctx.jtot, ctx.itot)] if se_row is not None else [])
              + ([interior] if e is not None else []))
        s_star = {n: _empty_ghosts_zero(s[n], ctx, out[n] if out else None)
                  for n in names}
        e_out = None
        if e is None:
            e_out = torch.empty(interior, dtype=u.dtype, device=u.device)
        rhs = torch.empty(interior, dtype=u.dtype, device=u.device)
        self.k_tend_fold(
            u.dtype, s["u"], s["v"], s["w"], self._th(s), e, se_row,
            s_star["u"], s_star["v"], s_star["w"], self._th(s_star),
            *[None if first else old[n] for n in ("u", "v", "w")],
            *[t[n] if carry else None for n in ("u", "v", "w")],
            self._th(t), e_out, rhs, self.ct, self.ce, ctx.itot, ctx.jtot,
            ctx.ktot, *args, self.fc, ctx.utrans, ctx.vtrans, int(first),
            int(carry), int(self.coriolis),
            self.fold_plan(u.dtype, chunks).chunks)
        return s_star, (e_out if e is None else e), rhs

    def tendencies_plan(self, dtype, chunks=None):
        """K20's k-march (ops/kmarch.py) in this case's thermo form (S its
        one scalar th, counted), the chunk count chosen from the card's
        resident blocks unless given."""
        ctx, S = self.ctx, int(self.has_thermo)
        info = self.k_tendencies.info(dtype, 0, S)
        return kmarch.plan("tendencies", ctx.itot, ctx.jtot, ctx.ktot, S,
                           dtype, info["blocks_per_sm"] * info["sms"], chunks)

    def tendencies(self, s, t, e, chunks=None):
        """K20: the dry tendencies of ghost-filled u, v, w, th with the
        kcells eddy viscosity e, added onto the carries t in place.
        chunks: force the k-split (checks and timings only)."""
        ctx = self.ctx
        if not self.ghosts:
            raise ValueError("K20 reads ghost planes: build Fused with "
                             "ghosts=True")
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.visc, self.svisc, self.tPr,
                self.fc, ctx.utrans, ctx.vtrans)
        if on_cpu(e):
            return tendencies_plain(s, e, t, self.ct, *args, self.coriolis,
                                    self.has_thermo)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        names = self.prognostic
        check([s[n] for n in names] + [e] + [t[n] for n in names] + [self.ct],
              e.dtype, e.device,
              [shape] * (2 * len(names) + 1) + [(ctx.ktot, NTG)])
        self.k_tendencies(e.dtype, s["u"], s["v"], s["w"], self._th(s), e,
                          t["u"], t["v"], t["w"], self._th(t), self.ct,
                          ctx.itot, ctx.jtot, ctx.ktot, *args,
                          int(self.coriolis),
                          self.tendencies_plan(e.dtype, chunks).chunks)


class FusedGeneric(Fused):
    """The generic path's kernels for one grid, base state and scalar list:
    K1 and K7 on ghost-filled fields, K8/K9 and K10 (K15 for a single
    scalar) with the per-substep tables of generic_col_tables, and K18/K19
    without the RK fold.

    The stability term of the eddy viscosity takes one of three forms
    (fused_generic_viscosity): the moist N2 of thl against thvref inside K1
    (microhh_tpu/model.py:964-970; ``n2_scalar``), the thermo's own
    ``get_n2`` field through K14 (buoy's background N2, dry), or none when
    the thermo carries no scalar.  ``advec`` False leaves the advec_2 terms
    out of K8-K10/K15/K18/K19: an interpolated scheme then adds the
    advection into the carry before them."""

    ghosts = True

    def __init__(self, ctx, smag, thermo, force, advec=True):
        from .force import Force, foldable_geo
        from .thermo_moist import ThermoMoist
        self.ctx = ctx
        self.smag = smag
        self.thermo = thermo
        self.advec = bool(advec)
        moist = isinstance(thermo, ThermoMoist)
        self.n2_scalar = "thl" if moist else None
        self.stratified = 1 if moist else (2 if thermo.scalars else 0)
        self.tPr = smag.tPr
        self.visc = smag.visc
        self.names = tuple(ctx.scalar_names)
        self.sviscs = [smag.viscs.get(n, smag.visc) for n in self.names]
        self.coriolis = isinstance(force, Force) and force.swlspres == "geo"
        self.fc = float(force.fc) if self.coriolis else 0.
        ks, ke, kt = ctx.ks, ctx.ke, ctx.ktot
        ka = np.arange(ks, ke)
        ce = np.zeros((kt, NE))
        ce[:, E_DZI] = ctx.np_dzi[ka]
        ce[:, E_DZHI] = ctx.np_dzhi[ka]
        ce[:, E_DZHI1] = ctx.np_dzhi[ka + 1]
        ce[:, E_MLEN2] = smag.mlen2
        ce[:, E_THREF] = thermo.thvref[ka] if moist else 1.
        ct = np.zeros((kt, NTG))
        ct[:, T_DZI] = ctx.np_dzi[ka]
        ct[:, T_DZHI] = ctx.np_dzhi[ka]
        ct[:, T_DZHI1] = ctx.np_dzhi[ka + 1]
        ct[:, T_DZI_M1] = ctx.np_dzi[ka - 1]
        ct[:, T_RHO] = ctx.np_rhoref[ka]
        ct[:, T_RHOH] = ctx.np_rhorefh[ka]
        ct[:, T_RHOH1] = ctx.np_rhorefh[ka + 1]
        ct[:, T_RHO_M1] = ctx.np_rhoref[ka - 1]
        self.ce = ctx.tensor(ce)
        self.base = ctx.tensor(ct)
        # the table of K18/K19, which take no column terms: the base
        # columns and, when the forcing is nothing but a static geostrophic
        # wind (fold_force; any other forcing runs as an op after them),
        # its ug and vg for K18's Coriolis term
        self.fold_force = foldable_geo(force)
        ct = ct.copy()      # self.base may share the first array's memory
        if self.fold_force:
            ct[:, T_UG] = force.ug[:, 0, 0]
            ct[:, T_VG] = force.vg[:, 0, 0]
        self.ct_static = ctx.tensor(ct)
        self.k_evisc = Kernel("evisc", "microhh_torch/csrc/evisc.cu",
                              "microhh_tpu/ops/pallas_fused.py:1441")
        self.k_limits = Kernel("limits", "microhh_torch/csrc/evisc.cu",
                               "microhh_tpu/ops/pallas_fused.py:1524")
        self.k_uvw = Kernel("tend_uvw", "microhh_torch/csrc/tend_generic.cu",
                            "microhh_tpu/ops/pallas_fused.py:1641, "
                            "microhh_tpu/ops/pallas_fused.py:1667")
        # K10 and K19: two forms of the one scalar sweep, each counted
        self.k_scalars = Kernel("tend_scalars",
                                "microhh_torch/csrc/tend_generic.cu",
                                "microhh_tpu/ops/pallas_fused.py:1733")
        self.k_evisc_n2 = Kernel("evisc_n2", "microhh_torch/csrc/evisc.cu",
                                 "microhh_tpu/ops/pallas_fused.py:1496")
        # K15: K10's launch in a case of one scalar, counted as the
        # counterpart of the TPU's kernel for that case
        self.k_scalar = Kernel("tend_scalar_rk",
                               "microhh_torch/csrc/tend_generic.cu",
                               "microhh_tpu/ops/pallas_fused.py:1694",
                               entry="tend_scalars")
        self.k_uvw_acc = Kernel("tend_uvw_acc",
                                "microhh_torch/csrc/tend_generic.cu",
                                "microhh_tpu/ops/pallas_fused.py:1560, "
                                "microhh_tpu/ops/pallas_fused.py:1582")
        self.k_scalar_acc = Kernel("tend_scalar_acc",
                                   "microhh_torch/csrc/tend_generic.cu",
                                   "microhh_tpu/ops/pallas_fused.py:1607")

    def evisc_n2(self, u, v, w, n2, out=None, chunks=None):
        """K14: interior eddy viscosity from ghost-filled u, v, w and an
        interior N2 field (ktot, jtot, itot), into ``out`` when given.
        chunks: force the k-split (checks and timings only)."""
        ctx = self.ctx
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.tPr)
        if on_cpu(u):
            ev = evisc_plain(u, v, w, None, self.ce, *args, True, True, n2)
            return ev if out is None else out.copy_(ev)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        interior = (ctx.ktot, ctx.jtot, ctx.itot)
        if out is None:
            out = torch.empty(interior, dtype=u.dtype, device=u.device)
        check((u, v, w, n2, self.ce, out), u.dtype, u.device,
              [shape] * 3 + [interior, (ctx.ktot, NE), interior])
        self.k_evisc_n2(u.dtype, u, v, w, n2, out, self.ce, ctx.itot,
                        ctx.jtot, ctx.ktot, *args,
                        self.evisc_plan(u.dtype, 2, chunks).chunks)
        return out

    def uvw_plan(self, dtype, acc=False, chunks=None):
        """The k-march of one launch of the momentum sweep (K8/K9, or K18
        when acc; ops/kmarch.py), the chunk count chosen from the card's
        resident blocks unless given."""
        ctx = self.ctx
        kern = self.k_uvw_acc if acc else self.k_uvw
        info = kern.info(dtype, 0)
        return kmarch.plan(kern.name, ctx.itot, ctx.jtot, ctx.ktot, 0, dtype,
                           info["blocks_per_sm"] * info["sms"], chunks)

    def tend_uvw(self, s, t, e, ct, cbdt, can, carry, chunks=None):
        """K8/K9: s* of u, v, w (zero ghost planes); the carry t["u"],
        t["v"], t["w"] is read and, when carry, overwritten in place.
        chunks: force the k-split (checks and timings only)."""
        ctx = self.ctx
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.visc, self.fc, ctx.utrans,
                ctx.vtrans, cbdt, can, self.coriolis, carry)
        if on_cpu(e):
            return tend_uvw_plain(s, e, t, ct, *args, self.advec)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        fields = [s[n] for n in ("u", "v", "w")]
        carry_t = [t[n] for n in ("u", "v", "w")]
        check(fields + [e] + carry_t + [ct], e.dtype, e.device,
              [shape] * 7 + [(ctx.ktot, NTG)])
        s_star = {n: _empty_ghosts_zero(s[n], ctx) for n in ("u", "v", "w")}
        self.k_uvw(e.dtype, *fields, e, *s_star.values(), *carry_t, ct,
                   ctx.itot, ctx.jtot, ctx.ktot, *args[:-2],
                   int(self.coriolis), int(carry), int(self.advec),
                   self.uvw_plan(e.dtype, False, chunks).chunks)
        return s_star

    def plan(self, kernel, S, dtype, chunks=None, fold=True):
        """The k-march of one launch of the scalar sweep ("tend_scalars":
        K10 and K15, fold off in K15's form only; "tend_scalar_acc": K19)
        of S scalars in this case's advec form (ops/kmarch.py), the chunk
        count chosen from the card's resident blocks unless given."""
        ctx = self.ctx
        kern = {"tend_scalars": self.k_scalars,
                "tend_scalar_acc": self.k_scalar_acc}[kernel]
        info = kern.info(dtype, int(self.advec) + 2 * (not fold), S)
        return kmarch.plan(kernel, ctx.itot, ctx.jtot, ctx.ktot, S, dtype,
                           info["blocks_per_sm"] * info["sms"], chunks,
                           self.advec)

    def _sweep(self, kern, s, t, e, names, table, tail, chunks, s_star=None,
               fold=True):
        """Launch the scalar sweep kern (K10 and K15 with s_star, K19
        without) over names, SW_MAXS scalars a launch; table(i0, S) is the
        table of the launch of names[i0:i0 + S], tail the form's own
        arguments, fold the RK form's flag."""
        ctx = self.ctx
        uvw = ([s[n] for n in ("u", "v", "w")] if self.advec
               else [None] * 3)
        for i0 in range(0, len(names), kmarch.SW_MAXS):
            grp = names[i0:i0 + kmarch.SW_MAXS]
            S = len(grp)

            def ptrs(arrays):
                return (ctypes.c_void_p * S)(*[arrays[n].data_ptr()
                                               for n in grp])

            sviscs = [self.sviscs[self.names.index(n)] for n in grp]
            heads = [ptrs(s)] + ([ptrs(s_star)] if s_star is not None else [])
            kern(e.dtype, *uvw, e, *heads, ptrs(t),
                 (ctypes.c_double * S)(*sviscs), S, table(i0, S), ctx.itot,
                 ctx.jtot, ctx.ktot, ctx.ks, ctx.dxi, ctx.dyi, self.tPr,
                 *tail, int(self.advec),
                 self.plan(kern.entry, S, e.dtype, chunks, fold).chunks)

    def _check_sweep(self, s, t, e, names, table, table_shape):
        """Raise unless every array a sweep over names reads or writes has
        the kernel's type, device, layout and shape."""
        ctx = self.ctx
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        uvw = [s[n] for n in ("u", "v", "w")] if self.advec else []
        arrays = uvw + [e] + [s[n] for n in names] + [t[n] for n in names]
        check(arrays + [table], e.dtype, e.device,
              [shape] * len(arrays) + [table_shape])

    def tend_scalars(self, s, t, e, cts, cbdt, can, carry, fold=True,
                     chunks=None):
        """K10: s* of every scalar, four scalars a launch; in a case of one
        scalar the launch is K15 (pallas_fused.py:3075-3092), counted under
        its own name.  The carry as in tend_uvw.  fold False leaves the
        tables' column terms out, K15's form only.  chunks: force the
        k-split (checks and timings only)."""
        ctx = self.ctx
        names = self.names
        if not fold and len(names) != 1:
            raise ValueError("the column fold is off only in K15's form, "
                             "one scalar; this case has %d" % len(names))
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.tPr, cbdt, can, carry)
        if on_cpu(e):
            return tend_scalars_plain(s, names, e, t, cts, self.sviscs, *args,
                                      self.advec, fold)
        self._check_sweep(s, t, e, names, cts, (len(names), ctx.ktot, NTG))
        s_star = {n: _empty_ghosts_zero(s[n], ctx) for n in names}
        kern = self.k_scalar if len(names) == 1 else self.k_scalars
        self._sweep(kern, s, t, e, names, lambda i0, S: cts[i0:i0 + S],
                    (cbdt, can, int(carry), int(fold)), chunks, s_star, fold)
        return s_star

    def tend_uvw_acc(self, s, t, e, chunks=None):
        """K18: the tendencies of u, v, w added onto the carries t["u"],
        t["v"], t["w"] in place (no RK update, no column terms; the
        Coriolis term when the forcing is a foldable geostrophic wind).
        chunks: force the k-split (checks and timings only)."""
        ctx = self.ctx
        ct = self.ct_static
        args = (ctx.ks, ctx.dxi, ctx.dyi, self.visc, self.fc, ctx.utrans,
                ctx.vtrans, self.fold_force)
        if on_cpu(e):
            return tend_uvw_acc_plain(s, e, t, ct, *args, self.advec)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        fields = [s[n] for n in ("u", "v", "w")] + [e]
        carry_t = [t[n] for n in ("u", "v", "w")]
        check(fields + carry_t + [ct], e.dtype, e.device,
              [shape] * 7 + [(ctx.ktot, NTG)])
        self.k_uvw_acc(e.dtype, *fields, *carry_t, ct, ctx.itot, ctx.jtot,
                       ctx.ktot, *args[:-1], int(self.fold_force),
                       int(self.advec),
                       self.uvw_plan(e.dtype, True, chunks).chunks)

    def tend_scalars_acc(self, s, t, e, names=None, chunks=None):
        """K19: the tendencies of the scalars ``names`` (every scalar of the
        case unless given) added onto their carries in place, four scalars
        a launch.  chunks: force the k-split (checks and timings only)."""
        ctx = self.ctx
        ct = self.ct_static
        names = self.names if names is None else tuple(names)
        if on_cpu(e):
            sviscs = [self.sviscs[self.names.index(n)] for n in names]
            return tend_scalars_acc_plain(s, names, e, t, ct, sviscs, ctx.ks,
                                          ctx.dxi, ctx.dyi, self.tPr,
                                          self.advec)
        self._check_sweep(s, t, e, names, ct, (ctx.ktot, NTG))
        self._sweep(self.k_scalar_acc, s, t, e, names, lambda i0, S: ct, (),
                    chunks)

    def tend_scalar_acc(self, s, t, e, name):
        """K19 for the one scalar ``name``."""
        self.tend_scalars_acc(s, t, e, (name,))


class PresGlue:
    """K4: the projection glue kernels with their per-level table."""

    def __init__(self, ctx):
        self.ctx = ctx
        ks, ke, kt = ctx.ks, ctx.ke, ctx.ktot
        ka = np.arange(ks, ke)
        pc = np.zeros((kt, NP))
        pc[:, P_RHO] = ctx.np_rhoref[ka]
        pc[:, P_RHOH] = ctx.np_rhorefh[ka]
        pc[:, P_RHOH1] = ctx.np_rhorefh[ka + 1]
        pc[:, P_DZI] = ctx.np_dzi[ka]
        pc[:, P_DZHI] = ctx.np_dzhi[ka]
        self.pc = ctx.tensor(pc)
        self.k_rhs = Kernel("pres_rhs", "microhh_torch/csrc/pres_glue.cu",
                            "microhh_tpu/ops/pallas_fused.py:2604")
        self.k_apply = Kernel("pres_apply", "microhh_torch/csrc/pres_glue.cu",
                              "microhh_tpu/ops/pallas_fused.py:2634")

    def rhs(self, su, sv, sw, dti):
        """dti * div(rho s*) on the interior (ktot, jtot, itot); dti a
        0-dim tensor (the kernel reads it on the card) or a number."""
        ctx = self.ctx
        if not on_cpu(su):
            dti = device_scalar(dti, su)
        args = (ctx.ks, ctx.dxi, ctx.dyi, dti)
        if on_cpu(su):
            return pres_rhs_plain(su, sv, sw, self.pc, *args)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        check((su, sv, sw, self.pc), su.dtype, su.device,
              [shape] * 3 + [(ctx.ktot, NP)])
        out = torch.empty((ctx.ktot, ctx.jtot, ctx.itot), dtype=su.dtype,
                          device=su.device)
        self.k_rhs(su.dtype, su, sv, sw, out, self.pc, ctx.itot, ctx.jtot,
                   ctx.ktot, *args)
        return out

    def apply_plan(self, dtype, carry, chunks=None):
        """K4 apply's k-march (ops/kmarch.py) in its carry form, the chunk
        count chosen from the card's resident blocks unless given."""
        ctx = self.ctx
        info = self.k_apply.info(dtype, int(carry))
        return kmarch.plan("pres_apply", ctx.itot, ctx.jtot, ctx.ktot, 0,
                           dtype, info["blocks_per_sm"] * info["sms"], chunks)

    def apply(self, p, s, t, dt, can, carry, chunks=None):
        """s -= dt grad p and, when carry, t -= can grad p for u, v, w, in
        place on the interior planes.  The six arrays must be six tensors
        (each value is read and written once, by one thread).  dt: a 0-dim
        tensor (the kernel reads it on the card) or a number.  chunks:
        force the k-split (checks and timings only)."""
        ctx = self.ctx
        if not on_cpu(p):
            dt = device_scalar(dt, p)
        args = (ctx.ks, ctx.dxi, ctx.dyi, dt, can, carry)
        if on_cpu(p):
            return pres_apply_plain(p, s, t, self.pc, *args)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        fields = [s[n] for n in ("u", "v", "w")]
        carry_t = [t[n] for n in ("u", "v", "w")] if carry else []
        check([p, self.pc] + fields + carry_t, p.dtype, p.device,
              [(ctx.ktot, ctx.jtot, ctx.itot), (ctx.ktot, NP)]
              + [shape] * (3 + len(carry_t)))
        arrays = fields + carry_t
        if len({a.data_ptr() for a in arrays}) < len(arrays):
            raise ValueError("K4 apply updates different arrays in place")
        tptr = carry_t if carry else [None] * 3
        self.k_apply(p.dtype, p, *fields, *tptr, self.pc, ctx.itot, ctx.jtot,
                     ctx.ktot, *args[:-1], int(carry),
                     self.apply_plan(p.dtype, carry, chunks).chunks)


# ==========================================================================
#  the step's use of the kernels, with the MOST wall-row patches
# ==========================================================================

def surface_evisc_row(smag, ctx, s, sfc, stratified):
    """MO surface-layer evisc bottom row (diff_smag2.cxx calc_strain2
    surface rows + calc_evisc bottom), replacing K1's interior-formula row."""
    u, v, w = s["u"], s["v"], s["w"]
    ks = ctx.ks
    dxi, dyi = ctx.dxi, ctx.dyi
    u0, v0 = u[ks], v[ks]
    dudx = (ip(u0) - u0) * dxi
    dvdy = (jp(v0) - v0) * dyi
    dwdz = (w[ks + 1] - w[ks]) * ctx.dzi[ks]
    c = (u0 - jm(u0)) * dyi + (v0 - im(v0)) * dxi
    horiz = 0.125 * (c ** 2 + ip(c) ** 2 + jp(c) ** 2 + ip(jp(c)) ** 2)
    wsl = w[ks:ks + 2]
    dwdx = (wsl - im(wsl)) * dxi
    dwdy = (wsl - jm(wsl)) * dyi
    s2b = 2. * (dudx ** 2 + dvdy ** 2 + dwdz ** 2 + horiz
                + 0.5 * sfc["dudz_mo"] ** 2
                + 0.125 * (dwdx[0] ** 2 + ip(dwdx)[0] ** 2 + dwdx[1] ** 2 + ip(dwdx)[1] ** 2)
                + 0.5 * sfc["dvdz_mo"] ** 2
                + 0.125 * (dwdy[0] ** 2 + jp(dwdy)[0] ** 2 + dwdy[1] ** 2 + jp(dwdy)[1] ** 2)
                ) + cst.dsmall
    if stratified:
        rit = torch.clamp(sfc["dbdz_mo"] / s2b / smag.tPr, max=1. - cst.dsmall)
        return smag.mlen2[0] * torch.sqrt(s2b) * torch.sqrt(1. - rit)
    return smag.mlen2[0] * torch.sqrt(s2b)


def exec_viscosity(fused, ctx, s, sfc, aux):
    """K1 + the MOST bottom-row patch -> aux['evisc_int'] (interior)."""
    ev = fused.evisc(s["u"], s["v"], s["w"], s.get("th", s["u"]))
    if fused.smag.surface:
        ev[0] = surface_evisc_row(fused.smag, ctx, s, sfc, fused.has_thermo)
    aux = dict(aux)
    aux["evisc_int"] = ev
    return aux


def _patch_wall_rows(fused, ctx, s, t, evisc, sfc, s_star, cbdt, can):
    """The MOST wall rows of the diffusion (diff_smag2.cxx wall forms)
    patched into s* and, when can is not 0, the carry.  The sweep computed
    those rows with the clamped vertical term; the patch recomputes that
    term with the same clamped neighbours and replaces it with the
    wall-flux form.  Returns the tendency corrections of u and v at the
    bottom and top rows, {(name, row): plane}, which the rhs fold needs."""
    smag = fused.smag
    u, v, w = s["u"], s["v"], s["w"]
    ks, ke = ctx.ks, ctx.ke
    dxi, dyi = ctx.dxi, ctx.dyi
    visc = smag.visc
    carry = can != 0.
    rho, rhoh, dzi, dzhi = ctx.rhoref, ctx.rhorefh, ctx.dzi, ctx.dzhi
    deltas = {}

    def F(arr, kabs):
        return arr[min(max(kabs, ks), ke - 1)]

    def E(kabs):
        return evisc[min(max(kabs - ks, 0), ctx.ktot - 1)]

    def patch(name, ka, delta):
        s_star[name][ka] += cbdt * delta
        if carry:
            t[name][ka] += can * delta

    # ---- u rows ----
    for row, ka in (("bot", ks), ("top", ke - 1)):
        ev_t = 0.25 * (im(E(ka)) + E(ka) + im(E(ka + 1)) + E(ka + 1)) + visc
        ev_b = 0.25 * (im(E(ka - 1)) + E(ka - 1) + im(E(ka)) + E(ka)) + visc
        if row == "bot":
            fz_top = ev_t * ((u[ka + 1] - u[ka]) * dzhi[ka + 1] + (w[ka + 1] - im(w[ka + 1])) * dxi)
            corr = (rhoh[ka + 1] * fz_top + rhoh[ka] * sfc["u_fluxbot"]) / rho[ka] * dzi[ka]
        else:
            fz_bot = ev_b * ((u[ka] - u[ka - 1]) * dzhi[ka] + (w[ka] - im(w[ka])) * dxi)
            corr = (-rhoh[ka] * fz_bot) / rho[ka] * dzi[ka]
        old_vert = ((rhoh[ka + 1] * ev_t * ((F(u, ka + 1) - u[ka]) * dzhi[ka + 1] + (w[ka + 1] - im(w[ka + 1])) * dxi)
                     - rhoh[ka] * ev_b * ((u[ka] - F(u, ka - 1)) * dzhi[ka] + (w[ka] - im(w[ka])) * dxi))
                    / rho[ka] * dzi[ka])
        deltas["u", row] = corr - old_vert
        patch("u", ka, corr - old_vert)

    # ---- v rows ----
    for row, ka in (("bot", ks), ("top", ke - 1)):
        ev_t = 0.25 * (jm(E(ka)) + E(ka) + jm(E(ka + 1)) + E(ka + 1)) + visc
        ev_b = 0.25 * (jm(E(ka - 1)) + E(ka - 1) + jm(E(ka)) + E(ka)) + visc
        if row == "bot":
            fz_top = ev_t * ((v[ka + 1] - v[ka]) * dzhi[ka + 1] + (w[ka + 1] - jm(w[ka + 1])) * dyi)
            corr = (rhoh[ka + 1] * fz_top + rhoh[ka] * sfc["v_fluxbot"]) / rho[ka] * dzi[ka]
        else:
            fz_bot = ev_b * ((v[ka] - v[ka - 1]) * dzhi[ka] + (w[ka] - jm(w[ka])) * dyi)
            corr = (-rhoh[ka] * fz_bot) / rho[ka] * dzi[ka]
        old_vert = ((rhoh[ka + 1] * ev_t * ((F(v, ka + 1) - v[ka]) * dzhi[ka + 1] + (w[ka + 1] - jm(w[ka + 1])) * dyi)
                     - rhoh[ka] * ev_b * ((v[ka] - F(v, ka - 1)) * dzhi[ka] + (w[ka] - jm(w[ka])) * dyi))
                    / rho[ka] * dzi[ka])
        deltas["v", row] = corr - old_vert
        patch("v", ka, corr - old_vert)

    # ---- th rows (none without thermo, pallas_fused.py:2460) ----
    if not fused.has_thermo:
        return deltas
    svisc = fused.svisc
    a = s["th"]
    for row, ka in (("bot", ks), ("top", ke - 1)):
        st_ = 0.5 * (E(ka) + E(ka + 1)) / smag.tPr + svisc
        sb = 0.5 * (E(ka - 1) + E(ka)) / smag.tPr + svisc
        if row == "bot":
            fz_top = st_ * (a[ka + 1] - a[ka]) * dzhi[ka + 1]
            corr = (rhoh[ka + 1] * fz_top + rhoh[ka] * sfc["th_fluxbot"]) / rho[ka] * dzi[ka]
        else:
            fz_bot = sb * (a[ka] - a[ka - 1]) * dzhi[ka]
            fz_top = -smag.fluxtop("th")
            corr = ((rhoh[ka + 1] * fz_top - rhoh[ka] * fz_bot)
                    / rho[ka] * dzi[ka])
        old_vert = ((rhoh[ka + 1] * st_ * (F(a, ka + 1) - a[ka]) * dzhi[ka + 1]
                     - rhoh[ka] * sb * (a[ka] - F(a, ka - 1)) * dzhi[ka])
                    / rho[ka] * dzi[ka])
        patch("th", ka, corr - old_vert)
    return deltas


def tendencies_rk(fused, ctx, s, t, aux, sfc, cbdt, can, first, out=None):
    """K2 with the eddy viscosity aux['evisc_int'], then the MOST wall rows
    patched into s* and the carry.  cbdt: a 0-dim tensor or a number; out:
    the arrays of s* (Fused.tend_rk)."""
    s_star = fused.tend_rk(s, t, aux["evisc_int"], cbdt, can, first,
                           can != 0., out=out)
    if fused.smag.surface:
        _patch_wall_rows(fused, ctx, s, t, aux["evisc_int"], sfc, s_star,
                         cbdt, can)
    return s_star


def tendencies_rk_fold(fused, ctx, s, t, aux, sfc, cbdt, can, first,
                       se_row=None, evisc_fold=True, out=None):
    """K22, then the MOST wall rows patched into s*, the carry and, as
    rho div_h of the u* and v* corrections, into the bottom and top rows of
    the Poisson right-hand side (fused_tendencies_rk with rhs_dti = 1/cbdt,
    pallas_fused.py:2479-2489).  se_row: the MOST surface row of the eddy
    viscosity, computed BEFORE the surface model ran (it must see the last
    substep's MO gradients, microhh_tpu/model.py:383-394); by default
    computed here from sfc, for a caller that has not run it since.
    evisc_fold False: K22 reads aux['evisc_int'] instead of computing it.
    cbdt: a 0-dim tensor (1/cbdt is taken on its device) or a number; out:
    the arrays of s* (Fused.tend_rk_fold).  Returns (s*, aux with
    'evisc_int', rhs)."""
    smag = fused.smag
    e_in = None if evisc_fold else aux["evisc_int"]
    if smag.surface and se_row is None and evisc_fold:
        se_row = surface_evisc_row(smag, ctx, s, sfc, fused.has_thermo)
    s_star, evisc, rhs = fused.tend_rk_fold(
        s, t, se_row if evisc_fold else None, cbdt, can, 1. / cbdt, first,
        can != 0., e=e_in, out=out)
    aux = dict(aux)
    aux["evisc_int"] = evisc
    if smag.surface:
        deltas = _patch_wall_rows(fused, ctx, s, t, evisc, sfc, s_star, cbdt,
                                  can)
        for row, ka, kr in (("bot", ctx.ks, 0),
                            ("top", ctx.ke - 1, ctx.ktot - 1)):
            du, dv = deltas["u", row], deltas["v", row]
            rhs[kr] += ctx.rhoref[ka] * ((ip(du) - du) * ctx.dxi
                                         + (jp(dv) - dv) * ctx.dyi)
    return s_star, aux, rhs


def pressure_rk(glue, ctx, pres, s_star, t, aux, subdt, can, rhs=None):
    """The projection of the RK-folded step: K4 rhs (unless the sweep has
    emitted ``rhs`` already, fused_pressure_rk's rhs=) -> spectral solve (K3)
    -> K4 apply, in place on s* and the carry.  subdt: a 0-dim tensor (1/subdt
    is taken on its device) or a number.  aux['p'] is the interior pressure
    (ktot, jtot, itot)."""
    if rhs is None:
        rhs = glue.rhs(s_star["u"], s_star["v"], s_star["w"], 1. / subdt)
    p = pres.solve(rhs)
    glue.apply(p, s_star, t, subdt, can, can != 0.)
    aux = dict(aux)
    aux["p"] = p
    return s_star, aux


# ==========================================================================
#  the generic path's use of the kernels (pallas_fused.py :2712-3109)
# ==========================================================================

def generic_viscosity(fz, ctx, s, sfc, aux):
    """The eddy viscosity on the ghost-filled fields and the MOST bottom
    row -> aux['evisc'] (kcells, its ghost planes repeating the edge
    levels), as fused_generic_viscosity: K1 with the moist N2 of thl
    against thvref, or K14 with the thermo's get_n2 field, or K1
    unstratified when the thermo carries no scalar."""
    ks, ke = ctx.ks, ctx.ke
    u, v, w = s["u"], s["v"], s["w"]
    evisc = torch.empty_like(u)
    if fz.stratified == 2:
        ev = fz.evisc_n2(u, v, w, fz.thermo.get_n2(ctx, s).contiguous(),
                         out=evisc[ks:ke])
    else:
        th = s[fz.n2_scalar] if fz.stratified else u
        ev = fz.evisc(u, v, w, th, out=evisc[ks:ke])
    if fz.smag.surface:
        ev[0] = surface_evisc_row(fz.smag, ctx, s, sfc, bool(fz.stratified))
    evisc[ks - 1] = ev[0]
    evisc[ke] = ev[-1]
    aux = dict(aux)
    aux["evisc"] = evisc
    return aux


def generic_wall_deltas(fz, ctx, s, aux, sfc):
    """The MOST wall rows of the diffusion (diff_smag2.cxx flux forms) as
    tendency corrections {field: [(k, plane), ...]} for the generic
    kernels' interior formula (_generic_wall_deltas)."""
    smag = fz.smag
    u, v, w = s["u"], s["v"], s["w"]
    e = aux["evisc"]
    ks, ke = ctx.ks, ctx.ke
    dxi, dyi = ctx.dxi, ctx.dyi
    visc = smag.visc
    rho, rhoh, dzi, dzhi = ctx.rhoref, ctx.rhorefh, ctx.dzi, ctx.dzhi
    out = {}
    for name, a, sh, d in (("u", u, im, dxi), ("v", v, jm, dyi)):
        rows = []
        for ka in (ks, ke - 1):
            ev_t = 0.25 * (sh(e[ka]) + e[ka] + sh(e[ka + 1]) + e[ka + 1]) + visc
            ev_b = 0.25 * (sh(e[ka - 1]) + e[ka - 1] + sh(e[ka]) + e[ka]) + visc
            g_top = (a[ka + 1] - a[ka]) * dzhi[ka + 1] + (w[ka + 1] - sh(w[ka + 1])) * d
            g_bot = (a[ka] - a[ka - 1]) * dzhi[ka] + (w[ka] - sh(w[ka])) * d
            if ka == ks:
                corr = (rhoh[ka + 1] * (ev_t * g_top) + rhoh[ka] * sfc[name + "_fluxbot"]) / rho[ka] * dzi[ka]
            else:
                corr = (-rhoh[ka] * (ev_b * g_bot)) / rho[ka] * dzi[ka]
            old_vert = ((rhoh[ka + 1] * ev_t * g_top - rhoh[ka] * ev_b * g_bot)
                        / rho[ka] * dzi[ka])
            rows.append((ka, corr - old_vert))
        out[name] = rows
    for name in ctx.scalar_names:
        a = s[name]
        svisc = smag.viscs.get(name, visc)
        rows = []
        for ka in (ks, ke - 1):
            st_ = 0.5 * (e[ka] + e[ka + 1]) / smag.tPr + svisc
            sb = 0.5 * (e[ka - 1] + e[ka]) / smag.tPr + svisc
            if ka == ks:
                fz_top = st_ * (a[ka + 1] - a[ka]) * dzhi[ka + 1]
                corr = (rhoh[ka + 1] * fz_top + rhoh[ka] * sfc[name + "_fluxbot"]) / rho[ka] * dzi[ka]
            else:
                fz_bot = sb * (a[ka] - a[ka - 1]) * dzhi[ka]
                fz_top = -smag.fluxtop(name)
                corr = ((rhoh[ka + 1] * fz_top - rhoh[ka] * fz_bot)
                        / rho[ka] * dzi[ka])
            old_vert = ((rhoh[ka + 1] * st_ * (a[ka + 1] - a[ka]) * dzhi[ka + 1]
                         - rhoh[ka] * sb * (a[ka] - a[ka - 1]) * dzhi[ka])
                        / rho[ka] * dzi[ka])
            rows.append((ka, corr - old_vert))
        out[name] = rows
    return out


def generic_col_tables(fz, ctx, s, force, buffer):
    """This substep's tables of K8/K9 (ktot, NTG) and K10 (S, ktot, NTG):
    the sponge, the dpdx and geostrophic forcing, the large-scale sources
    and the mean or local subsidence as per-level coefficients,

        t_a += ADDS - FACZ * a + WLSDN * (a - a_dn) + WLSUP * (a_up - a)

    (generic_col_tables of the JAX package).  Mean subsidence reads this
    substep's plane means, so the tables are built on the device every
    substep and passed to every launch."""
    from .force import Force
    ks, ke, kt = ctx.ks, ctx.ke, ctx.ktot
    names = list(fz.names)
    zero = torch.zeros(kt, dtype=ctx.dtype, device=ctx.device)
    facz = faczh = add_u = add_v = zero
    faczs = {n: zero for n in names}
    adds = {n: zero for n in names}
    wls_dn = wls_up = None
    wls_mom = False
    ug = vg = None
    means = {}

    def mean_prof(n):
        # plane means over kcells: the ghost planes are filled here
        if n not in means:
            means[n] = torch.mean(s[n], dim=(1, 2))
        return means[n]

    def col(a):
        return ctx.tensor(np.asarray(a).reshape(-1)[:kt])

    if buffer is not None:
        fzc = col(buffer.fac_z)
        facz = facz + fzc
        faczh = faczh + col(buffer.fac_zh)
        add_u = add_u + fzc * col(buffer.profs["u"])
        add_v = add_v + fzc * col(buffer.profs["v"])
        for n in names:
            faczs[n] = faczs[n] + fzc
            adds[n] = adds[n] + fzc * col(buffer.profs[n])

    if isinstance(force, Force):
        if force.swlspres == "geo":
            ug, vg = col(force.ug), col(force.vg)
        elif force.swlspres == "dpdx":
            add_u = add_u - force.dpdx
        for n in force.lslist:
            prof = col(force.ls_profs[n])
            if n == "u":
                add_u = add_u + prof
            elif n == "v":
                add_v = add_v + prof
            else:
                adds[n] = adds[n] + prof
        if force.swwls in ("mean", "local"):
            wls = col(force.wls)
            wls_mom = force.swwls_mom
            dzhi = ctx.dzhi
            if force.swwls == "mean":
                for n in names + (["u", "v"] if wls_mom else []):
                    am = mean_prof(n)
                    ddn = (am[ks:ke] - am[ks - 1:ke - 1]) * dzhi[ks:ke]
                    dup = (am[ks + 1:ke + 1] - am[ks:ke]) * dzhi[ks + 1:ke + 1]
                    tp = torch.where(wls > 0., -wls * ddn, -wls * dup)
                    if n == "u":
                        add_u = add_u + tp
                    elif n == "v":
                        add_v = add_v + tp
                    else:
                        adds[n] = adds[n] + tp
            else:
                wls_dn = torch.where(wls > 0., -wls * dzhi[ks:ke], 0.)
                wls_up = torch.where(wls > 0., 0., -wls * dzhi[ks + 1:ke + 1])

    ct = fz.base.clone()
    ct[:, T_FACZ] = facz
    ct[:, T_FACZH] = faczh
    ct[:, T_ADDU] = add_u
    ct[:, T_ADDV] = add_v
    if ug is not None:
        ct[:, T_UG] = ug
        ct[:, T_VG] = vg
    if wls_dn is not None and wls_mom:
        ct[:, T_WLSDN] = wls_dn
        ct[:, T_WLSUP] = wls_up
    cts = fz.base.repeat(len(names), 1, 1)
    for i, n in enumerate(names):
        cts[i, :, T_FACZ] = faczs[n]
        cts[i, :, T_ADDS] = adds[n]
        if wls_dn is not None:
            cts[i, :, T_WLSDN] = wls_dn
            cts[i, :, T_WLSUP] = wls_up
    return ct, cts


def generic_tendencies_rk(fz, ctx, s, t, aux, sfc, cbdt, can, cols):
    """K8/K9 and K10 (K15 when the case has one scalar, as
    pallas_fused.py:3075-3092) with the RK update folded in, then the MOST
    wall rows patched into s* and the carry (fused_generic_tendencies_rk).
    Every additive producer (thermo, microphysics, an interpolated
    advection scheme) has already added into the carry t; returns s* and
    updates t in place."""
    carry = can != 0.
    ct, cts = cols
    s_star = fz.tend_uvw(s, t, aux["evisc"], ct, cbdt, can, carry)
    if fz.names:
        s_star.update(fz.tend_scalars(s, t, aux["evisc"], cts, cbdt, can,
                                      carry))
    if fz.smag.surface:
        for name, rows in generic_wall_deltas(fz, ctx, s, aux, sfc).items():
            for ka, delta in rows:
                s_star[name][ka] += cbdt * delta
                if carry:
                    t[name][ka] += can * delta
    return s_star


# ==========================================================================
#  the substep without the RK fold (pallas_fused.py :2201-2314, :3112-3168)
# ==========================================================================

def _add_wall_deltas(fz, ctx, s, t, aux, sfc):
    """The MOST wall rows of the diffusion added onto the carry, in place."""
    if fz.smag.surface:
        for name, rows in generic_wall_deltas(fz, ctx, s, aux, sfc).items():
            for ka, delta in rows:
                t[name][ka] += delta


def generic_tendencies(fz, ctx, s, t, aux, sfc):
    """K18 and K19 (every scalar in one launch of up to four) onto the
    carry t in place, then the MOST wall rows (fused_generic_tendencies).
    No RK update: the caller runs the outflow correction, buffer, source,
    forcing, projection and limiter on t afterwards."""
    e = aux["evisc"]
    fz.tend_uvw_acc(s, t, e)
    if fz.names:
        fz.tend_scalars_acc(s, t, e)
    _add_wall_deltas(fz, ctx, s, t, aux, sfc)


def tendencies(fz, ctx, s, t, aux, sfc):
    """K20 onto the carry t in place, then the MOST wall rows of the
    diffusion: the patches of fused_tendencies for ghost-filled fields
    (unclamped neighbours), which are generic_wall_deltas' rows."""
    fz.tendencies(s, t, aux["evisc"])
    _add_wall_deltas(fz, ctx, s, t, aux, sfc)
