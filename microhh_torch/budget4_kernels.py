"""The 4th-order budget terms in plain torch (``microhh_tpu/budget4_kernels.py``;
reference ``src/budget_4.cxx``).

The reference evaluates every budget term as a nested vertical "ladder":
a 4-tap divergence/gradient whose taps are themselves 4-tap
interpolations or gradients, with one-sided (biased) tap sets on the
rows next to the walls.  Each term here is a composition of five column
primitives (slices on the k axis, horizontals as periodic rolls):

  _to_faces   cell -> face 4th-order interpolation, bi/ti ghost-face rows
  _to_cells   face -> cell interpolation, bi/ti rows at the extremes
  _dz_faces   cell -> face gradient (*dzhi4), optional bg/tg ghost rows
  _dz_cells   face -> cell gradient (*dzi4),  optional bg/tg wall rows
  _div_cells / _div_faces / _div_faces_wall
              outer 4-tap flux divergences; the ``_wall`` variant carries
              the reference's bg/cg/tg row structure and the special
              dzhi4bot/dzhi4top spacings of the w2/uw/bw ladders.

The reference's asymmetries are mirrored as the JAX package mirrors them,
each marked ``quirk:`` with its budget_4.cxx line:

  * u2_shear's top row biases d<u>/dz with the ti window shifted one
    row up relative to v2_shear's (budget_4.cxx:186 vs :192).
  * u2/v2_turb's top flux row multiplies by wx at kend, not kend+1
    (:282); uw_turb's top flux row is not squared (:342-345).
  * w2_pres zeroes its wall rows ("-0.*", :418,:444).
  * uw_diss's x- and y-parts are dead stores (:1073,:1105,:1153); only
    the z-part survives.
  * w2_buoy interpolates the raw buoyancy, not b' (:1762).
  * uz interpolates raw u (no umean), wz gets extrapolated ghost rows
    (:503-552).

Each function writes rows of a fresh zero column (``_col``) in place.
"""

import torch

from . import fd

CI = (fd.ci0, fd.ci1, fd.ci2, fd.ci3)
CG = (fd.cg0, fd.cg1, fd.cg2, fd.cg3)
BI = (fd.bi0, fd.bi1, fd.bi2, fd.bi3)
TI = (fd.ti0, fd.ti1, fd.ti2, fd.ti3)
BG = (fd.bg0, fd.bg1, fd.bg2, fd.bg3)
TG = (fd.tg0, fd.tg1, fd.tg2, fd.tg3)


# --- tap primitives ---------------------------------------------------------

def _kz(c, f, o, a, b):
    """4-tap vertical ladder: sum_m c[m]*f[k+o+m] for output rows k in
    [a, b).  Works on 3-D fields and broadcast (k,1,1) profiles alike."""
    return (c[0] * f[a + o:b + o] + c[1] * f[a + o + 1:b + o + 1]
            + c[2] * f[a + o + 2:b + o + 2] + c[3] * f[a + o + 3:b + o + 3])


def _sx(f, n):
    return torch.roll(f, -n, dims=-1) if n else f


def _sy(f, n):
    return torch.roll(f, -n, dims=-2) if n else f


def _hx(c, f, o):
    """4-tap periodic ladder in x: sum_m c[m]*f[..., i+o+m]."""
    return (c[0] * _sx(f, o) + c[1] * _sx(f, o + 1)
            + c[2] * _sx(f, o + 2) + c[3] * _sx(f, o + 3))


def _hy(c, f, o):
    return (c[0] * _sy(f, o) + c[1] * _sy(f, o + 1)
            + c[2] * _sy(f, o + 2) + c[3] * _sy(f, o + 3))


# --- column builders --------------------------------------------------------

def _col(tmpl):
    return torch.zeros_like(tmpl)


def _rows(tmpl, a, b, val):
    """A zero column like tmpl with rows [a, b) set to val."""
    out = _col(tmpl)
    out[a:b] = val
    return out


def _to_faces(f, ks, ke, top_wide=False):
    """Cell -> face interpolation on rows ks-1 .. ke+1.

    Interior rows use the centred ci window f[r-2..r+1]; the ghost faces
    just outside the walls use the one-sided sets: bi over f[r-1..r+2]
    at ks-1 and ti over f[r-3..r] at ke+1.  ``top_wide`` selects the ti
    window f[r-2..r+1] instead (quirk: budget_4.cxx:186 does this for
    the umean ladder only)."""
    out = _col(f)
    out[ks - 1:ks] = _kz(BI, f, -1, ks - 1, ks)
    out[ks:ke + 1] = _kz(CI, f, -2, ks, ke + 1)
    o_top = -2 if top_wide else -3
    out[ke + 1:ke + 2] = _kz(TI, f, o_top, ke + 1, ke + 2)
    return out


def _to_cells(g, ks, ke, lo, hi):
    """Face -> cell interpolation on rows lo..hi (lo in {ks-2, ks-1},
    hi in {ke, ke+1}).  Centred ci window g[r-1..r+2] inside, one-sided
    bi over g[r..r+3] at lo and ti over g[r-2..r+1] at hi."""
    out = _col(g)
    out[lo:lo + 1] = _kz(BI, g, 0, lo, lo + 1)
    out[lo + 1:hi] = _kz(CI, g, -1, lo + 1, hi)
    out[hi:hi + 1] = _kz(TI, g, -2, hi, hi + 1)
    return out


def _dz_faces(f, dzhi4, ks, ke, biased=False):
    """Cell -> face gradient (* dzhi4) on rows ks..ke; with ``biased``
    also the ghost-face rows: bg over f[r-1..r+2] at ks-1 and tg over
    f[r-3..r] at ke+1 (the inner ladders of u2_visc, budget_4.cxx:562,:615)."""
    out = _col(f)
    out[ks:ke + 1] = _kz(CG, f, -2, ks, ke + 1) * dzhi4[ks:ke + 1]
    if biased:
        out[ks - 1:ks] = _kz(BG, f, -1, ks - 1, ks) * dzhi4[ks - 1:ks]
        out[ke + 1:ke + 2] = _kz(TG, f, -3, ke + 1, ke + 2) * dzhi4[ke + 1:ke + 2]
    return out


def _dz_cells(g, dzi4, ks, ke, biased=False):
    """Face -> cell gradient (* dzi4) on rows ks..ke-1; with ``biased``
    also the wall rows: bg over g[r..r+3] at ks-1 and tg over g[r-2..r+1]
    at ke (the inner ladders of w2_visc, budget_4.cxx:640,:835)."""
    out = _col(g)
    out[ks:ke] = _kz(CG, g, -1, ks, ke) * dzi4[ks:ke]
    if biased:
        out[ks - 1:ks] = _kz(BG, g, 0, ks - 1, ks) * dzi4[ks - 1:ks]
        out[ke:ke + 1] = _kz(TG, g, -2, ke, ke + 1) * dzi4[ke:ke + 1]
    return out


def _div_cells(F, dzi4, ks, ke):
    """Flux divergence at cells (rows ks..ke-1) of a face flux F."""
    return _kz(CG, F, -1, ks, ke) * dzi4[ks:ke]


def _div_faces(P, dzhi4, ks, ke):
    """Flux divergence at faces (rows ks..ke) of a cell flux P."""
    return _kz(CG, P, -2, ks, ke + 1) * dzhi4[ks:ke + 1]


def _div_faces_wall(P, dzhi4, ks, ke, bot, top):
    """Face divergence with the wall-row structure of the w2/uw/bw
    ladders: bg over P[ks-1..ks+2] * dzhi4bot at ks, centred cg * dzhi4
    inside, tg over P[ke-3..ke] * dzhi4top at ke (budget_4.cxx:640-643,
    :832-835).  Returns rows ks..ke; other rows zero."""
    out = _col(P)
    out[ks:ks + 1] = bot * _kz(BG, P, -1, ks, ks + 1)
    out[ks + 1:ke] = _kz(CG, P, -2, ks + 1, ke) * dzhi4[ks + 1:ke]
    out[ke:ke + 1] = top * _kz(TG, P, -3, ke, ke + 1)
    return out


def _ddx2(f, dxi):
    """4th-order x second-stage gradient of the x-interpolated field:
    the d/dx ladder the diss/rdstr kernels apply at a velocity point."""
    return _hx(CG, _hx(CI, f, -2), -1) * dxi


def _ddy2(f, dyi):
    return _hy(CG, _hy(CI, f, -2), -1) * dyi


def _b3(A, name):
    """Profile -> broadcastable (k,1,1) column, trimmed to the field's
    kcells (callers may hand in profiles with trailing slack)."""
    n = A["_tmpl"].shape[0]
    return A[name][:n, None, None]


# --- kernels ----------------------------------------------------------------

def calc_ke(A):
    """Resolved and turbulent kinetic energy at cells (budget_4.cxx:47-93)."""
    ks, ke = A["kstart"], A["kend"]
    u, v, w = A["u"], A["v"], A["w"]
    ut, vt = A["utrans"], A["vtrans"]
    um, vm, wm = _b3(A, "umodel"), _b3(A, "vmodel"), _b3(A, "wmodel")

    def cells(uu, vv, ww):
        return 0.5 * (_hx(CI, uu * uu, -1)[ks:ke] + _hy(CI, vv * vv, -1)[ks:ke]
                      + _kz(CI, ww * ww, -1, ks, ke))

    ke_o = _rows(A["_tmpl"], ks, ke, cells(u + ut, v + vt, w))
    tke_o = _rows(A["_tmpl"], ks, ke, cells(u - um, v - vm, w - wm))
    return {"ke": ke_o, "tke": tke_o}


def calc_tke_budget_shear(A):
    """Shear production -2 u'w' d<u>/dz at cells; uw counterpart at faces
    (budget_4.cxx:114-207)."""
    ks, ke = A["kstart"], A["kend"]
    dzi4, dzhi4 = _b3(A, "dzi4"), _b3(A, "dzhi4")
    u, v, wx, wy = A["u"], A["v"], A["wx"], A["wy"]
    um, vm = _b3(A, "umean"), _b3(A, "vmean")

    def shear(vel, mean, wvel, top_wide):
        dmdz = _kz(CG, _to_faces(mean, ks, ke, top_wide=top_wide),
                   -1, ks, ke) * dzi4[ks:ke]
        return -2. * (vel - mean)[ks:ke] * _kz(CI, wvel, -1, ks, ke) * dmdz

    # quirk: the u ladder's top bias uses the wide ti window (:186).
    u2 = _rows(u, ks, ke, shear(u, um, wx, True))
    v2 = _rows(u, ks, ke, shear(v, vm, wy, False))
    uw = _rows(u, ks, ke + 1, -(wx * wx)[ks:ke + 1]
               * _kz(CG, um, -2, ks, ke + 1) * dzhi4[ks:ke + 1])
    return {"u2_shear": u2, "v2_shear": v2,
            "tke_shear": 0.5 * (u2 + v2), "uw_shear": uw}


def calc_tke_budget_turb(A):
    """Turbulent (triple-moment) transport (budget_4.cxx:210-348)."""
    ks, ke = A["kstart"], A["kend"]
    dzi4, dzhi4 = _b3(A, "dzi4"), _b3(A, "dzhi4")
    u, v, w, wx, wy = A["u"], A["v"], A["w"], A["wx"], A["wy"]
    up = u - _b3(A, "umean")
    vp = v - _b3(A, "vmean")

    def var_flux(sp, wvel):
        # face flux <s'^2 w>; quirk: the top bias multiplies by the wall
        # value wvel[ke], not the ghost face (:282).
        F = _to_faces(sp * sp, ks, ke) * wvel
        F[ke + 1:ke + 2] = _kz(TI, sp * sp, -3, ke + 1, ke + 2) * wvel[ke:ke + 1]
        return F

    u2 = _rows(u, ks, ke, -_div_cells(var_flux(up, wx), dzi4, ks, ke))
    v2 = _rows(u, ks, ke, -_div_cells(var_flux(vp, wy), dzi4, ks, ke))
    tke = _rows(u, ks, ke, -0.5 * _kz(CG, w ** 3, -1, ks, ke)
                * dzi4[ks:ke]) + 0.5 * (u2 + v2)

    w2 = _rows(u, ks, ke + 1, -_div_faces(
        _to_cells(w ** 3, ks, ke, ks - 2, ke + 1), dzhi4, ks, ke))

    wxc = _to_cells(wx, ks, ke, ks - 2, ke + 1)
    # quirk: the whole top-row ladder uses the unsquared flux wx*u'
    # instead of wx^2*u' (:342-345).
    uw = _rows(u, ks, ke, -_kz(CG, wxc * wxc * up, -2, ks, ke) * dzhi4[ks:ke])
    uw[ke:ke + 1] = -_kz(CG, wxc * up, -2, ke, ke + 1) * dzhi4[ke:ke + 1]
    return {"u2_turb": u2, "v2_turb": v2, "w2_turb": w2,
            "tke_turb": tke, "uw_turb": uw}


def calc_tke_budget_pres(A):
    """Pressure transport (budget_4.cxx:351-471)."""
    ks, ke = A["kstart"], A["kend"]
    dzi4, dzhi4 = _b3(A, "dzi4"), _b3(A, "dzhi4")
    u, w, p = A["u"], A["w"], A["p"]
    up = u - _b3(A, "umean")

    tke = _rows(u, ks, ke, -_div_cells(_to_faces(p, ks, ke) * w, dzi4, ks, ke))

    # quirk: the wall rows are multiplied by 0 upstream (:418,:444), so
    # only the interior is written.
    Q = _rows(w, ks - 1, ke + 1, _kz(CI, w, -1, ks - 1, ke + 1)) * p
    w2 = _rows(u, ks + 1, ke, -2. * _kz(CG, Q, -2, ks + 1, ke)
               * dzhi4[ks + 1:ke])

    px = _hx(CI, p, -2)
    pz = _rows(p, ks, ke + 1, _kz(CI, p, -2, ks, ke + 1))
    uw = _rows(u, ks, ke + 1, -(_kz(CG, up * px, -2, ks, ke + 1) * dzhi4[ks:ke + 1]
                               + _hx(CG, w * pz, -2)[ks:ke + 1] * A["dxi"]))
    return {"w2_pres": w2, "tke_pres": tke, "uw_pres": uw}


def calc_tke_budget_visc(A):
    """Viscous transport nu d2/dz2 of the (co)variances (budget_4.cxx:474-873)."""
    ks, ke = A["kstart"], A["kend"]
    dzi4, dzhi4 = _b3(A, "dzi4"), _b3(A, "dzhi4")
    u, v, w = A["u"], A["v"], A["w"]
    visc = A["visc"]
    bot, top = A["dzhi4bot"], A["dzhi4top"]
    up = u - _b3(A, "umean")
    vp = v - _b3(A, "vmean")

    # w at cells, with the reference's extrapolated ghost rows (:503-524).
    wz = _rows(w, ks, ke, _kz(CI, w, -1, ks, ke))
    wz[ks - 1] = -2. * wz[ks] + (1. / 3.) * wz[ks + 1]
    wz[ks - 2] = -9. * wz[ks] + 2. * wz[ks + 1]
    wz[ke] = -2. * wz[ke - 1] + (1. / 3.) * wz[ke - 2]
    wz[ke + 1] = -9. * wz[ke - 1] + 2. * wz[ke - 2]

    # raw u at faces, one-sided at the ghost/wall faces (:527-552).
    uz = _col(u)
    uz[ks - 1:ks] = _kz(BI, u, -1, ks - 1, ks)
    uz[ks:ke] = _kz(CI, u, -2, ks, ke)
    uz[ke:ke + 1] = _kz(TI, u, -2, ke, ke + 1)

    def trans_cells(sp):
        H = _dz_faces(sp * sp, dzhi4, ks, ke, biased=True)
        return visc * _div_cells(H, dzi4, ks, ke)

    u2 = _rows(u, ks, ke, trans_cells(up))
    v2 = _rows(u, ks, ke, trans_cells(vp))
    tke = _rows(u, ks, ke, 0.5 * trans_cells(wz)) + 0.5 * (u2 + v2)

    w2 = visc * _div_faces_wall(
        _dz_cells(w * w, dzi4, ks, ke, biased=True), dzhi4, ks, ke, bot, top)
    uw = visc * _div_faces_wall(
        _dz_cells(uz * _hx(CI, w, -2), dzi4, ks, ke, biased=True),
        dzhi4, ks, ke, bot, top)
    return {"u2_visc": u2, "v2_visc": v2, "w2_visc": w2,
            "tke_visc": tke, "uw_visc": uw, "wz": wz, "uz": uz}


def calc_tke_budget_diss(A):
    """Dissipation -2 nu <(grad s')^2> (budget_4.cxx:876-1658)."""
    ks, ke = A["kstart"], A["kend"]
    dzi4, dzhi4 = _b3(A, "dzi4"), _b3(A, "dzhi4")
    u, v, w = A["u"], A["v"], A["w"]
    visc, dxi, dyi = A["visc"], A["dxi"], A["dyi"]
    bot, top = A["dzhi4bot"], A["dzhi4top"]
    up = u - _b3(A, "umean")
    vp = v - _b3(A, "vmean")

    def diss_cells(sp):
        gz = _kz(CG, _to_faces(sp, ks, ke), -1, ks, ke) * dzi4[ks:ke]
        return -2. * visc * (_ddx2(sp, dxi)[ks:ke] ** 2
                             + _ddy2(sp, dyi)[ks:ke] ** 2 + gz ** 2)

    u2 = _rows(u, ks, ke, diss_cells(up))
    v2 = _rows(u, ks, ke, diss_cells(vp))
    tke = _rows(u, ks, ke, -visc * (
        (_hx(CG, w, -1)[ks:ke] * dxi) ** 2
        + (_hy(CG, w, -1)[ks:ke] * dyi) ** 2
        + (_kz(CG, w, -1, ks, ke) * dzi4[ks:ke]) ** 2)) + 0.5 * (u2 + v2)

    # w2 rows next to the walls stay zero (loop :1043 covers ks+1..ke-1).
    wc = _rows(w, ks - 1, ke + 1, _kz(CI, w, -1, ks - 1, ke + 1))
    w2 = _rows(u, ks + 1, ke, -2. * visc * (
        _ddx2(w, dxi)[ks + 1:ke] ** 2 + _ddy2(w, dyi)[ks + 1:ke] ** 2
        + (_kz(CG, wc, -2, ks + 1, ke) * dzhi4[ks + 1:ke]) ** 2))

    # quirk: the x- and y-parts are dead stores upstream (:1073,:1105 use
    # plain '=' before the z-part), so only du'/dz * dwx/dz survives.
    dudz = _kz(CG, up, -2, ks, ke + 1) * dzhi4[ks:ke + 1]
    wxf = _to_cells(_hx(CI, w, -2), ks, ke, ks - 1, ke)
    uw = _rows(u, ks, ke + 1, -2. * visc * dudz
               * _div_faces_wall(wxf, dzhi4, ks, ke, bot, top)[ks:ke + 1])
    return {"u2_diss": u2, "v2_diss": v2, "w2_diss": w2,
            "tke_diss": tke, "uw_diss": uw}


def calc_tke_budget_rdstr(A):
    """Pressure redistribution 2 p' ds'/dx_s (budget_4.cxx:1662-1727)."""
    ks, ke = A["kstart"], A["kend"]
    dzhi4 = _b3(A, "dzhi4")
    u, v, w, p = A["u"], A["v"], A["w"], A["p"]
    up = u - _b3(A, "umean")
    vp = v - _b3(A, "vmean")

    u2 = _rows(u, ks, ke,
               2. * _hx(CI, p, -2)[ks:ke] * _ddx2(up, A["dxi"])[ks:ke])
    v2 = _rows(u, ks, ke,
               2. * _hy(CI, p, -2)[ks:ke] * _ddy2(vp, A["dyi"])[ks:ke])

    wc = _rows(w, ks - 1, ke + 1, _kz(CI, w, -1, ks - 1, ke + 1))
    w2 = _rows(u, ks + 1, ke, 2. * _kz(CI, p, -2, ks + 1, ke)
               * _kz(CG, wc, -2, ks + 1, ke) * dzhi4[ks + 1:ke])

    px = _hx(CI, p, -2)
    uw = _rows(u, ks, ke + 1, _kz(CI, px, -2, ks, ke + 1)
               * (_kz(CG, up, -2, ks, ke + 1) * dzhi4[ks:ke + 1]
                  + _hx(CG, w, -2)[ks:ke + 1] * A["dxi"]))
    return {"u2_rdstr": u2, "v2_rdstr": v2, "w2_rdstr": w2, "uw_rdstr": uw}


def calc_tke_budget_buoy(A):
    """Buoyancy production (budget_4.cxx:1731-1770)."""
    ks, ke = A["kstart"], A["kend"]
    u, w, b = A["u"], A["w"], A["b"]
    bp = b - _b3(A, "bmean")
    up = u - _b3(A, "umean")

    tke = _rows(u, ks, ke, _kz(CI, w, -1, ks, ke) * bp[ks:ke])
    # quirk: w2_buoy interpolates the raw buoyancy (:1762).
    w2 = _rows(u, ks, ke + 1, 2. * _kz(CI, b, -2, ks, ke + 1) * w[ks:ke + 1])
    uw = _rows(u, ks, ke + 1, _kz(CI, up, -2, ks, ke + 1)
               * _kz(CI, _hx(CI, bp, -2), -2, ks, ke + 1))
    return {"w2_buoy": w2, "tke_buoy": tke, "uw_buoy": uw}


def calc_b2_budget(A):
    """Buoyancy-variance budget (budget_4.cxx:1774-2050)."""
    ks, ke = A["kstart"], A["kend"]
    dzi4, dzhi4 = _b3(A, "dzi4"), _b3(A, "dzhi4")
    w, b = A["w"], A["b"]
    bm = _b3(A, "bmean")
    bp = b - bm
    visc, dxi, dyi = A["visc"], A["dxi"], A["dyi"]

    dbdz = _kz(CG, _to_faces(bm, ks, ke), -1, ks, ke) * dzi4[ks:ke]
    shear = _rows(w, ks, ke, -2. * bp[ks:ke] * _kz(CI, w, -1, ks, ke) * dbdz)

    turb = _rows(w, ks, ke, -_div_cells(_to_faces(bp, ks, ke) ** 2 * w,
                                        dzi4, ks, ke))

    visct = _rows(w, ks, ke, visc * _div_cells(
        _dz_faces(bp * bp, dzhi4, ks, ke, biased=True), dzi4, ks, ke))

    gz = _kz(CG, _to_faces(bp, ks, ke), -1, ks, ke) * dzi4[ks:ke]
    diss = _rows(w, ks, ke, -2. * visc * (
        _ddx2(bp, dxi)[ks:ke] ** 2 + _ddy2(bp, dyi)[ks:ke] ** 2 + gz ** 2))
    return {"b2_shear": shear, "b2_turb": turb,
            "b2_visc": visct, "b2_diss": diss}


def calc_bw_budget_shear_turb_visc(A):
    """<b'w'> budget, part 1, plus the shared face buoyancy bz
    (budget_4.cxx:2053-2263)."""
    ks, ke = A["kstart"], A["kend"]
    dzi4, dzhi4 = _b3(A, "dzi4"), _b3(A, "dzhi4")
    w, b = A["w"], A["b"]
    bm = _b3(A, "bmean")
    bp = b - bm
    visc = A["visc"]
    bot, top = A["dzhi4bot"], A["dzhi4top"]

    bz = _to_faces(bp, ks, ke)

    shear = _rows(w, ks, ke + 1, -(w * w)[ks:ke + 1]
                  * _kz(CG, bm, -2, ks, ke + 1) * dzhi4[ks:ke + 1])

    wc = _to_cells(w, ks, ke, ks - 1, ke)
    turb = -_div_faces_wall(wc * wc * bp, dzhi4, ks, ke, bot, top)

    visct = visc * _div_faces_wall(
        _dz_cells(w * bz, dzi4, ks, ke, biased=True), dzhi4, ks, ke, bot, top)
    return {"bw_shear": shear, "bw_turb": turb, "bw_visc": visct, "bz": bz}


def calc_bw_budget_buoy_rdstr_diss_pres(A):
    """<b'w'> budget, part 2, consuming the bz of part 1
    (budget_4.cxx:2266-2561)."""
    ks, ke = A["kstart"], A["kend"]
    dzhi4 = _b3(A, "dzhi4")
    w, b, p, bz = A["w"], A["b"], A["p"], A["bz"]
    bp = b - _b3(A, "bmean")
    pp = p - _b3(A, "pmean")
    visc, dxi, dyi = A["visc"], A["dxi"], A["dyi"]
    bot, top = A["dzhi4bot"], A["dzhi4top"]

    buoy = _rows(w, ks, ke + 1, (bz * bz)[ks:ke + 1])

    dbdz = _kz(CG, bp, -2, ks, ke + 1) * dzhi4[ks:ke + 1]
    rdstr = _rows(w, ks, ke + 1, _kz(CI, pp, -2, ks, ke + 1) * dbdz)

    # z-part: both the dw/dz ladder and the db'/dz ladder carry the wall
    # spacings dzhi4bot/dzhi4top at the wall rows (:2352-2356,:2546-2550).
    dzw = dzhi4.clone()
    dzw[ks] = bot
    dzw[ke] = top
    wc = _to_cells(w, ks, ke, ks - 1, ke)
    dwdz = _div_faces_wall(wc, dzhi4, ks, ke, bot, top)
    zpart = dwdz[ks:ke + 1] * _kz(CG, bp, -2, ks, ke + 1) * dzw[ks:ke + 1]
    diss = _rows(w, ks, ke + 1, -2. * visc * (
        _ddx2(w, dxi)[ks:ke + 1] * _ddx2(bz, dxi)[ks:ke + 1]
        + _ddy2(w, dyi)[ks:ke + 1] * _ddy2(bz, dyi)[ks:ke + 1] + zpart))

    pres = _rows(w, ks, ke + 1, -_kz(CG, pp * bp, -2, ks, ke + 1)
                 * dzhi4[ks:ke + 1])
    return {"bw_buoy": buoy, "bw_rdstr": rdstr,
            "bw_diss": diss, "bw_pres": pres}
