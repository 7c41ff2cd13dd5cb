"""Second-order TKE / variance / flux budget statistics and the ``Budget``
class the statistics attach (``microhh_tpu/budget.py``; reference
``src/budget_2.cxx``, kernels :51-1278).

Every term of the <u'2>, <v'2>, <w'2>, tke, <u'w'>, <v'w'>, <b'2> and
<b'w'> budgets in the reference's 2nd-order staggered discretization:

  *_shear  — production against the mean gradient
  *_turb   — turbulent (triple-moment) transport
  *_cor    — coriolis redistribution (when f != 0)
  *_pres   — pressure transport
  *_rdstr  — pressure redistribution
  *_visc   — viscous transport        (DNS / constant viscosity)
  *_diss   — viscous dissipation      (DNS / constant viscosity)
  *_buoy   — buoyancy production

Full-level (z) profiles have ktot rows, half-level (zh) profiles ktot+1
(kstart..kend); rows the reference kernels leave untouched are zero.  Two
reference quirks are mirrored as the JAX package mirrors them: the fork's
``uw_diss`` keeps only the vertical (du/dz*dw/dz) part (the x/y parts at
budget_2.cxx:601-609 are overwritten by the z-part assignments at
:629,:649,:668), and the interior ``w2_turb`` misses ``-wmean[k-1]`` on
one stencil point (:225).

``swbudget=4`` takes ``budget4.budget4_profiles``.  Plain torch on the
model's device.
"""

import torch

from .ops.stencil import im, ip, jm, jp


def _hm(a):
    """Horizontal mean -> 1-D profile."""
    return torch.mean(a, dim=(1, 2))


def _i2(a, b):
    return 0.5 * (a + b)


def _i22(a, b, c, d):
    return 0.25 * (a + b + c + d)


def budget2_profiles(ctx, s, aux, thermo, visc, svisc=None, fc=None,
                     utrans=0., vtrans=0.):
    """All budget_2 profiles as a dict (order-2 DNS forms).  ``aux["p"]``
    is the pressure on every level (kcells) or on the interior, which is
    then extended by its edge rows, as the JAX package stores it."""
    ks, ke = ctx.ks, ctx.ke
    kt = ke - ks
    u, v, w = s["u"], s["v"], s["w"]
    dxi, dyi = ctx.dxi, ctx.dyi
    dzi, dzhi = ctx.dzi, ctx.dzhi
    dzi_c = dzi[:, None, None]
    dzhi_c = dzhi[:, None, None]
    out = {}

    umean = _hm(u)          # (kcells,)
    vmean = _hm(v)
    wmean = _hm(w)
    up = u - umean[:, None, None]
    vp = v - vmean[:, None, None]
    wp = w - wmean[:, None, None]

    # w at the u/v locations (grid.interpolate_2nd with wxloc/wyloc)
    wx = _i2(im(w), w)
    wy = _i2(jm(w), w)
    wxp = wx - wmean[:, None, None]
    wyp = wy - wmean[:, None, None]

    full = _hm

    def half(rows):
        """Assemble a (ktot+1,) zh profile from {k-offset: plane-mean}."""
        prof = torch.zeros(kt + 1, dtype=ctx.dtype, device=ctx.device)
        for h, val in rows.items():
            prof[h] = val
        return prof

    # --- kinetic energy (budget_2.cxx:51-94) ---
    ke_f = 0.5 * (_i2(u + utrans, ip(u) + utrans)[ks:ke] ** 2
                  + _i2(v + vtrans, jp(v) + vtrans)[ks:ke] ** 2
                  + _i2(w[ks:ke], w[ks + 1:ke + 1]) ** 2)
    tke_f = 0.5 * (_i2(up, ip(up))[ks:ke] ** 2
                   + _i2(vp, jp(vp))[ks:ke] ** 2
                   + _i2(wp[ks:ke], wp[ks + 1:ke + 1]) ** 2)
    out["ke"] = full(ke_f)
    out["tke"] = full(tke_f)

    # --- shear production (:100-135) ---
    dudz = (_i2(umean[ks:ke], umean[ks + 1:ke + 1])
            - _i2(umean[ks - 1:ke - 1], umean[ks:ke])) * dzi[ks:ke]
    dvdz = (_i2(vmean[ks:ke], vmean[ks + 1:ke + 1])
            - _i2(vmean[ks - 1:ke - 1], vmean[ks:ke])) * dzi[ks:ke]
    u2_sh = -2. * full(up[ks:ke] * _i2(wxp[ks:ke], wxp[ks + 1:ke + 1])) * dudz
    v2_sh = -2. * full(vp[ks:ke] * _i2(wyp[ks:ke], wyp[ks + 1:ke + 1])) * dvdz
    out["u2_shear"] = u2_sh
    out["v2_shear"] = v2_sh
    out["tke_shear"] = 0.5 * (u2_sh + v2_sh)
    dumdzh = (umean[ks:ke] - umean[ks - 1:ke - 1]) * dzhi[ks:ke]
    dvmdzh = (vmean[ks:ke] - vmean[ks - 1:ke - 1]) * dzhi[ks:ke]
    out["uw_shear"] = half({slice(0, kt): -full(wx[ks:ke] ** 2) * dumdzh})
    out["vw_shear"] = half({slice(0, kt): -full(wy[ks:ke] ** 2) * dvmdzh})

    # --- turbulent transport (:141-233) ---
    u2_tb = -((_i2(up[ks:ke], up[ks + 1:ke + 1]) ** 2 * wxp[ks + 1:ke + 1]
               - _i2(up[ks:ke], up[ks - 1:ke - 1]) ** 2 * wxp[ks:ke])
              * dzi_c[ks:ke])
    v2_tb = -((_i2(vp[ks:ke], vp[ks + 1:ke + 1]) ** 2 * wyp[ks + 1:ke + 1]
               - _i2(vp[ks:ke], vp[ks - 1:ke - 1]) ** 2 * wyp[ks:ke])
              * dzi_c[ks:ke])
    tke_tb = (-0.5 * (wp[ks + 1:ke + 1] ** 3 - wp[ks:ke] ** 3) * dzi_c[ks:ke]
              + 0.5 * (u2_tb + v2_tb))
    out["u2_turb"] = full(u2_tb)
    out["v2_turb"] = full(v2_tb)
    out["tke_turb"] = full(tke_tb)

    # w2/uw/vw turb at half levels: interior + wall rows (:176-232)
    w2_tb_i = -((_i2(wp[ks + 1:ke], wp[ks + 2:ke + 1]) ** 3
                 # reference quirk: second stencil point is NOT demeaned
                 - _i2(wp[ks + 1:ke], w[ks:ke - 1]) ** 3) * dzhi_c[ks + 1:ke])
    uw_tb_i = -((up[ks + 1:ke] * _i2(wxp[ks + 1:ke], wxp[ks + 2:ke + 1]) ** 2
                 - up[ks:ke - 1] * _i2(wxp[ks + 1:ke], wxp[ks:ke - 1]) ** 2)
                * dzhi_c[ks + 1:ke])
    vw_tb_i = -((vp[ks + 1:ke] * _i2(wyp[ks + 1:ke], wyp[ks + 2:ke + 1]) ** 2
                 - vp[ks:ke - 1] * _i2(wyp[ks + 1:ke], wyp[ks:ke - 1]) ** 2)
                * dzhi_c[ks + 1:ke])
    w2_tb_bot = -2. * _i2(w[ks], w[ks + 1]) ** 3 * dzhi[ks]
    w2_tb_top = -2. * _i2(wp[ke], wp[ke - 1]) ** 3 * dzhi[ke]
    # NOTE budget_2.cxx:189: the bottom row reads the wx GHOST row with
    # wmean[k+1] subtracted ("w^2 below sfc == w^2 above sfc")
    uw_tb_bot = -((up[ks] * _i2(wxp[ks], wxp[ks + 1]) ** 2
                   - up[ks - 1] * _i2(wxp[ks],
                                      wx[ks - 1] - wmean[ks + 1]) ** 2)
                  * dzhi[ks])
    uw_tb_top = -((up[ke] * _i2(wxp[ke], wxp[ke - 1]) ** 2
                   - up[ke - 1] * _i2(wxp[ke], wxp[ke - 1]) ** 2) * dzhi[ke])
    vw_tb_bot = -((vp[ks] * _i2(wyp[ks], wyp[ks + 1]) ** 2
                   - vp[ks - 1] * _i2(wyp[ks],
                                      (wy[ks - 1] - wmean[ks + 1])) ** 2)
                  * dzhi[ks])
    vw_tb_top = -((vp[ke] * _i2(wyp[ke], wyp[ke - 1]) ** 2
                   - vp[ke - 1] * _i2(wyp[ke], wyp[ke - 1]) ** 2) * dzhi[ke])
    out["w2_turb"] = half({slice(1, kt): full(w2_tb_i),
                           0: torch.mean(w2_tb_bot), kt: torch.mean(w2_tb_top)})
    out["uw_turb"] = half({slice(1, kt): full(uw_tb_i),
                           0: torch.mean(uw_tb_bot), kt: torch.mean(uw_tb_top)})
    out["vw_turb"] = half({slice(1, kt): full(vw_tb_i),
                           0: torch.mean(vw_tb_bot), kt: torch.mean(vw_tb_top)})

    # --- coriolis (:239-279) ---
    if fc is not None and fc != 0.:
        v_at_u = _i22(im(v), v, im(jp(v)), jp(v)) - vmean[:, None, None]
        u_at_v = _i22(jm(u), u, ip(jm(u)), ip(u)) - umean[:, None, None]
        out["u2_cor"] = full((2. * up * v_at_u * fc)[ks:ke])
        out["v2_cor"] = full((-2. * vp * u_at_v * fc)[ks:ke])
        # uw_cor (interior half rows): w'(at u) * v' interpolated to (xh, zh)
        v_u_zh = _i2(
            _i22(vp[ks + 1:ke], im(vp)[ks + 1:ke],
                 im(vp)[ks:ke - 1], vp[ks:ke - 1]),
            _i22(jp(vp)[ks + 1:ke], im(jp(vp))[ks + 1:ke],
                 im(jp(vp))[ks:ke - 1], jp(vp)[ks:ke - 1]))
        uw_cor_i = _i2(wp[ks + 1:ke], im(wp)[ks + 1:ke]) * v_u_zh * fc
        u_v_zh = _i2(
            _i22(up[ks + 1:ke], jm(up)[ks + 1:ke],
                 jm(up)[ks:ke - 1], up[ks:ke - 1]),
            _i22(ip(up)[ks + 1:ke], ip(jm(up))[ks + 1:ke],
                 ip(jm(up))[ks:ke - 1], ip(up)[ks:ke - 1]))
        vw_cor_i = _i2(wp[ks + 1:ke], jm(wp)[ks + 1:ke]) * u_v_zh * fc
        out["uw_cor"] = half({slice(1, kt): full(uw_cor_i)})
        out["vw_cor"] = half({slice(1, kt): full(vw_cor_i)})

    p = aux.get("p") if aux is not None else None
    if p is not None and p.shape[0] == kt:
        # the interior pressure of the port's solvers, extended by its edge
        # rows (the JAX package's p_full, pres_2.cxx:350-358)
        p = torch.cat([p[:1].expand(ks, -1, -1), p,
                       p[-1:].expand(u.shape[0] - ke, -1, -1)])

    # --- pressure transport (:285-352) ---
    if p is not None:
        tke_pr = -((_i2(p[ks:ke], p[ks + 1:ke + 1]) * wp[ks + 1:ke + 1]
                    - _i2(p[ks:ke], p[ks - 1:ke - 1]) * wp[ks:ke])
                   * dzi_c[ks:ke])
        out["tke_pres"] = full(tke_pr)

        uw_pr = (-((_i2(p[ks:ke], p[ks - 1:ke - 1]) * wp[ks:ke]
                    - _i2(im(p)[ks:ke], im(p)[ks - 1:ke - 1]) * im(wp)[ks:ke])
                   * dxi)
                 + ((_i2(p[ks:ke], im(p)[ks:ke]) * up[ks:ke]
                     - _i2(p[ks - 1:ke - 1], im(p)[ks - 1:ke - 1])
                     * up[ks - 1:ke - 1]) * dzhi_c[ks:ke]))
        vw_pr = (-((_i2(p[ks - 1:ke - 1], p[ks:ke]) * wp[ks:ke]
                    - _i2(jm(p)[ks - 1:ke - 1], jm(p)[ks:ke]) * jm(wp)[ks:ke])
                   * dyi)
                 + ((_i2(jm(p)[ks:ke], p[ks:ke]) * vp[ks:ke]
                     - _i2(jm(p)[ks - 1:ke - 1], p[ks - 1:ke - 1])
                     * vp[ks - 1:ke - 1]) * dzhi_c[ks:ke]))
        out["uw_pres"] = half({slice(0, kt): full(uw_pr)})
        out["vw_pres"] = half({slice(0, kt): full(vw_pr)})

        w2_pr_bot = (-2. * (_i2(wp[ks], wp[ks + 1]) * p[ks]
                            - (-_i2(wp[ks], wp[ks + 1])) * p[ks - 1])
                     * dzhi[ks])
        w2_pr_i = (-2. * (_i2(wp[ks + 1:ke], wp[ks + 2:ke + 1]) * p[ks + 1:ke]
                          - _i2(wp[ks + 1:ke], wp[ks:ke - 1]) * p[ks:ke - 1])
                   * dzhi_c[ks + 1:ke])
        out["w2_pres"] = half({slice(1, kt): full(w2_pr_i),
                               0: torch.mean(w2_pr_bot)})

        # --- pressure redistribution (:358-418) ---
        u2_rd = (2. * _i2(p, im(p))
                 * (_i2(up, ip(up)) - _i2(up, im(up))) * dxi)[ks:ke]
        v2_rd = (2. * _i2(p, jm(p))
                 * (_i2(vp, jp(vp)) - _i2(vp, jm(vp))) * dyi)[ks:ke]
        out["u2_rdstr"] = full(u2_rd)
        out["v2_rdstr"] = full(v2_rd)
        uw_rd = (_i22(p[ks:ke], p[ks - 1:ke - 1],
                      im(p)[ks - 1:ke - 1], im(p)[ks:ke])
                 * ((up[ks:ke] - up[ks - 1:ke - 1]) * dzhi_c[ks:ke]
                    + (w[ks:ke] - im(w)[ks:ke]) * dxi))
        vw_rd = (_i22(p[ks:ke], p[ks - 1:ke - 1],
                      jm(p)[ks - 1:ke - 1], jm(p)[ks:ke])
                 * ((vp[ks:ke] - vp[ks - 1:ke - 1]) * dzhi_c[ks:ke]
                    + (w[ks:ke] - jm(w)[ks:ke]) * dyi))
        out["uw_rdstr"] = half({slice(0, kt): full(uw_rd)})
        out["vw_rdstr"] = half({slice(0, kt): full(vw_rd)})
        w2_rd_bot = (2. * _i2(p[ks], p[ks - 1])
                     * (wp[ks + 1] - wp[ks]) * dzi[ks])
        w2_rd_i = (2. * _i2(p[ks + 1:ke], p[ks:ke - 1])
                   * (_i2(wp[ks + 1:ke], wp[ks + 2:ke + 1])
                      - _i2(wp[ks + 1:ke], wp[ks:ke - 1])) * dzhi_c[ks + 1:ke])
        out["w2_rdstr"] = half({slice(1, kt): full(w2_rd_i),
                                0: torch.mean(w2_rd_bot)})

    # --- viscous transport, DNS (:426-554) ---
    # wz: w at full levels, mirrored across the walls
    wz = torch.zeros_like(u)
    wz[ks:ke] = _i2(wp[ks:ke], wp[ks + 1:ke + 1])
    wz[ks - 1] = -wz[ks]
    wz[ke] = -wz[ke - 1]

    u2_vs = (visc * ((up[ks + 1:ke + 1] ** 2 - up[ks:ke] ** 2)
                     * dzhi_c[ks + 1:ke + 1]
                     - (up[ks:ke] ** 2 - up[ks - 1:ke - 1] ** 2)
                     * dzhi_c[ks:ke]) * dzi_c[ks:ke])
    v2_vs = (visc * ((vp[ks + 1:ke + 1] ** 2 - vp[ks:ke] ** 2)
                     * dzhi_c[ks + 1:ke + 1]
                     - (vp[ks:ke] ** 2 - vp[ks - 1:ke - 1] ** 2)
                     * dzhi_c[ks:ke]) * dzi_c[ks:ke])
    tke_vs = (0.5 * visc * ((wz[ks + 1:ke + 1] ** 2 - wz[ks:ke] ** 2)
                            * dzhi_c[ks + 1:ke + 1]
                            - (wz[ks:ke] ** 2 - wz[ks - 1:ke - 1] ** 2)
                            * dzhi_c[ks:ke]) * dzi_c[ks:ke]
              + 0.5 * (u2_vs + v2_vs))
    out["u2_visc"] = full(u2_vs)
    out["v2_visc"] = full(v2_vs)
    out["tke_visc"] = full(tke_vs)

    w2_vs_bot = (visc * ((wp[ks + 1] ** 2 - wp[ks] ** 2) * dzi[ks]
                         - (wp[ks] ** 2 - wp[ks + 1] ** 2) * dzi[ks - 1])
                 * dzhi[ks])
    w2_vs_top = (visc * ((wp[ke - 1] ** 2 - wp[ke] ** 2) * dzi[ke]
                         - (wp[ke] ** 2 - wp[ke - 1] ** 2) * dzi[ke - 1])
                 * dzhi[ke])
    w2_vs_i = (visc * ((wp[ks + 2:ke + 1] ** 2 - wp[ks + 1:ke] ** 2)
                       * dzi_c[ks + 1:ke]
                       - (wp[ks + 1:ke] ** 2 - wp[ks:ke - 1] ** 2)
                       * dzi_c[ks:ke - 1]) * dzhi_c[ks + 1:ke])
    utmp_b = 1.5 * up[ks - 1] - 0.5 * up[ks]
    uw_vs_bot = (visc * ((_i2(up[ks], up[ks + 1]) * wxp[ks + 1]
                          - _i2(up[ks], up[ks - 1]) * wxp[ks]) * dzi[ks]
                         - (_i2(up[ks], up[ks - 1]) * wxp[ks]
                            - utmp_b * (-wxp[ks + 1])) * dzi[ks - 1])
                 * dzhi[ks])
    utmp_t = 1.5 * up[ke] - 0.5 * up[ke - 1]
    uw_vs_top = (visc * ((utmp_t * (-wxp[ke - 1])
                          - _i2(up[ke], up[ke - 1]) * wxp[ke]) * dzi[ke]
                         - (_i2(up[ke], up[ke - 1]) * wxp[ke]
                            - _i2(up[ke - 1], up[ke - 2]) * wxp[ke - 1])
                         * dzi[ke - 1]) * dzhi[ke])
    uw_vs_i = (visc * ((_i2(up[ks + 1:ke], up[ks + 2:ke + 1])
                        * wxp[ks + 2:ke + 1]
                        - _i2(up[ks + 1:ke], up[ks:ke - 1]) * wxp[ks + 1:ke])
                       * dzi_c[ks + 1:ke]
                       - (_i2(up[ks + 1:ke], up[ks:ke - 1]) * wxp[ks + 1:ke]
                          - _i2(up[ks:ke - 1], up[ks - 1:ke - 2])
                          * wxp[ks:ke - 1]) * dzi_c[ks:ke - 1])
               * dzhi_c[ks + 1:ke])
    out["w2_visc"] = half({slice(1, kt): full(w2_vs_i),
                           0: torch.mean(w2_vs_bot), kt: torch.mean(w2_vs_top)})
    out["uw_visc"] = half({slice(1, kt): full(uw_vs_i),
                           0: torch.mean(uw_vs_bot), kt: torch.mean(uw_vs_top)})

    # --- dissipation, DNS (:560-672) ---
    u2_ds = (-2. * visc * (
        ((_i2(up, ip(up)) - _i2(up, im(up))) * dxi)[ks:ke] ** 2
        + ((_i2(up, jp(up)) - _i2(up, jm(up))) * dyi)[ks:ke] ** 2
        + ((_i2(up[ks:ke], up[ks + 1:ke + 1])
            - _i2(up[ks:ke], up[ks - 1:ke - 1])) * dzi_c[ks:ke]) ** 2))
    v2_ds = (-2. * visc * (
        ((_i2(vp, ip(vp)) - _i2(vp, im(vp))) * dxi)[ks:ke] ** 2
        + ((_i2(vp, jp(vp)) - _i2(vp, jm(vp))) * dyi)[ks:ke] ** 2
        + ((_i2(vp[ks:ke], vp[ks + 1:ke + 1])
            - _i2(vp[ks:ke], vp[ks - 1:ke - 1])) * dzi_c[ks:ke]) ** 2))
    tke_ds = (-visc * (((ip(w) - w) * dxi)[ks:ke] ** 2
                       + ((jp(w) - w) * dyi)[ks:ke] ** 2
                       + ((wp[ks + 1:ke + 1] - wp[ks:ke]) * dzi_c[ks:ke]) ** 2)
              + 0.5 * (u2_ds + v2_ds))
    out["u2_diss"] = full(u2_ds)
    out["v2_diss"] = full(v2_ds)
    out["tke_diss"] = full(tke_ds)

    w2_ds_bot = (-2. * visc * (
        ((_i2(w[ks], ip(w)[ks]) - _i2(w[ks], im(w)[ks])) * dxi) ** 2
        + ((_i2(w[ks], jp(w)[ks]) - _i2(w[ks], jm(w)[ks])) * dyi) ** 2
        + (2. * _i2(w[ks], w[ks + 1]) * dzhi[ks]) ** 2))
    w2_ds_top = (-2. * visc * (
        ((_i2(w[ke], ip(w)[ke]) - _i2(w[ke], im(w)[ke])) * dxi) ** 2
        + ((_i2(w[ke], jp(w)[ke]) - _i2(w[ke], jm(w)[ke])) * dyi) ** 2
        + (-2. * _i2(wp[ke], wp[ke - 1]) * dzhi[ke]) ** 2))
    w2_ds_i = (-2. * visc * (
        ((_i2(w, ip(w)) - _i2(w, im(w))) * dxi)[ks + 1:ke] ** 2
        + ((_i2(w, jp(w)) - _i2(w, jm(w))) * dyi)[ks + 1:ke] ** 2
        + ((_i2(wp[ks + 1:ke], wp[ks + 2:ke + 1])
            - _i2(wp[ks + 1:ke], wp[ks:ke - 1])) * dzhi_c[ks + 1:ke]) ** 2))
    # uw_diss: vertical part only (fork quirk, see module docstring)
    uw_ds_bot = (-2. * visc * (up[ks] - up[ks - 1]) * dzhi[ks]
                 * 2. * _i22(wp[ks], wp[ks + 1], im(wp)[ks + 1],
                             im(wp)[ks]) * dzhi[ks])
    uw_ds_top = (-2. * visc * (up[ke] - up[ke - 1]) * dzhi[ke]
                 * (-2.) * _i22(wp[ke], wp[ke - 1], im(wp)[ke - 1],
                                im(wp)[ke]) * dzhi[ke])
    uw_ds_i = (-2. * visc * (up[ks + 1:ke] - up[ks:ke - 1])
               * dzhi_c[ks + 1:ke]
               * (_i22(wp[ks + 1:ke], wp[ks + 2:ke + 1],
                       im(wp)[ks + 2:ke + 1], im(wp)[ks + 1:ke])
                  - _i22(wp[ks + 1:ke], wp[ks:ke - 1],
                         im(wp)[ks:ke - 1], im(wp)[ks + 1:ke]))
               * dzhi_c[ks + 1:ke])
    out["w2_diss"] = half({slice(1, kt): full(w2_ds_i),
                           0: torch.mean(w2_ds_bot), kt: torch.mean(w2_ds_top)})
    out["uw_diss"] = half({slice(1, kt): full(uw_ds_i),
                           0: torch.mean(uw_ds_bot), kt: torch.mean(uw_ds_top)})

    # --- buoyancy (:1044-1115) + b2/bw budgets (:1121-1278) ---
    if thermo is not None and getattr(thermo, "scalars", ()):
        b = thermo.get_buoyancy(ctx, s)     # (kcells,...) with ghosts
        bmean = _hm(b)
        bp = b - bmean[:, None, None]

        out["tke_buoy"] = full((_i2(wp[ks:ke], wp[ks + 1:ke + 1]) * bp[ks:ke]))
        w2_by_i = 2. * _i2(bp[ks + 1:ke], bp[ks:ke - 1]) * wp[ks + 1:ke]
        uw_by_i = (_i2(up[ks + 1:ke], up[ks:ke - 1])
                   * _i22(bp[ks + 1:ke], im(bp)[ks + 1:ke],
                          im(bp)[ks:ke - 1], bp[ks:ke - 1]))
        vw_by_i = (_i2(vp[ks + 1:ke], vp[ks:ke - 1])
                   * _i22(bp[ks + 1:ke], jm(bp)[ks + 1:ke],
                          jm(bp)[ks:ke - 1], bp[ks:ke - 1]))
        out["w2_buoy"] = half({slice(1, kt): full(w2_by_i)})
        out["uw_buoy"] = half({slice(1, kt): full(uw_by_i)})
        out["vw_buoy"] = half({slice(1, kt): full(vw_by_i)})

        # advection terms of the scalar (b) budget (:1121-1155)
        dbdz = (_i2(bmean[ks:ke], bmean[ks + 1:ke + 1])
                - _i2(bmean[ks:ke], bmean[ks - 1:ke - 1])) * dzi[ks:ke]
        dbdzh = (bmean[ks:ke] - bmean[ks - 1:ke - 1]) * dzhi[ks:ke]
        out["b2_shear"] = (-2. * full(bp[ks:ke] * _i2(w[ks:ke],
                                                      w[ks + 1:ke + 1]))
                           * dbdz)
        out["b2_turb"] = full(
            -((_i2(bp[ks:ke], bp[ks + 1:ke + 1]) ** 2 * w[ks + 1:ke + 1])
              - (_i2(bp[ks:ke], bp[ks - 1:ke - 1]) ** 2 * w[ks:ke]))
            * dzi_c[ks:ke])
        out["bw_shear"] = half({slice(0, kt): -full(w[ks:ke] ** 2) * dbdzh})
        out["bw_turb"] = half({slice(0, kt): full(
            -((_i2(w[ks:ke], w[ks + 1:ke + 1]) ** 2 * bp[ks:ke])
              - (_i2(w[ks:ke], w[ks - 1:ke - 1]) ** 2 * bp[ks - 1:ke - 1]))
            * dzhi_c[ks:ke])})

        # bw buoyancy: <b'^2> interpolated to half levels (:1096-1115)
        out["bw_buoy"] = half({slice(0, kt): full(
            _i2(bp[ks:ke], bp[ks - 1:ke - 1])
            * _i2(bp[ks:ke], bp[ks - 1:ke - 1]))})

        # diffusion terms of b2/bw (:1163-1251); diff = svisc
        diffb = svisc if svisc is not None else visc
        out["b2_visc"] = full(
            diffb * ((bp[ks + 1:ke + 1] ** 2 - bp[ks:ke] ** 2)
                     * dzhi_c[ks + 1:ke + 1]
                     - (bp[ks:ke] ** 2 - bp[ks - 1:ke - 1] ** 2)
                     * dzhi_c[ks:ke]) * dzi_c[ks:ke])
        out["b2_diss"] = full(-2. * diffb * (
            ((_i2(bp[ks:ke], bp[ks + 1:ke + 1])
              - _i2(bp[ks:ke], bp[ks - 1:ke - 1])) * dzi_c[ks:ke]) ** 2
            + ((_i2(bp, ip(bp)) - _i2(bp, im(bp))) * dxi)[ks:ke] ** 2
            + ((_i2(bp, jp(bp)) - _i2(bp, jm(bp))) * dyi)[ks:ke] ** 2))

        # interior rows ks+1..ke-2 only (budget_2.cxx:1214 loops k<kend-1),
        # the wall rows are copies of their neighbors (:1241-1250), which
        # leaves rows ke-1 and ke zero
        bw_vs_i = (visc * ((w[ks + 2:ke]
                            * _i2(bp[ks + 1:ke - 1], bp[ks + 2:ke])
                            - w[ks + 1:ke - 1]
                            * _i2(bp[ks:ke - 2], bp[ks + 1:ke - 1]))
                           * dzi_c[ks + 1:ke - 1]
                           - (w[ks + 1:ke - 1]
                              * _i2(bp[ks:ke - 2], bp[ks + 1:ke - 1])
                              - w[ks:ke - 2]
                              * _i2(bp[ks - 1:ke - 3], bp[ks:ke - 2]))
                           * dzi_c[ks:ke - 2]) * dzhi_c[ks + 1:ke - 1])
        bw_vs_prof = full(bw_vs_i)
        bw_ds_bot = (-2. * visc * (w[ks + 1] - w[ks]) * dzi[ks]
                     * (bp[ks] - bp[ks - 1]) * dzhi[ks])
        bw_ds_top = (-2. * visc * (w[ke] - w[ke - 1]) * dzi[ke - 1]
                     * (bp[ke] - bp[ke - 1]) * dzhi[ke])
        bw_ds_i = (-2. * visc * (
            (_i2(ip(w), w) - _i2(w, im(w)))[ks + 1:ke - 1] * dxi
            * (_i22(bp[ks + 1:ke - 1], ip(bp)[ks + 1:ke - 1],
                    ip(bp)[ks:ke - 2], bp[ks:ke - 2])
               - _i22(bp[ks + 1:ke - 1], im(bp)[ks + 1:ke - 1],
                      im(bp)[ks:ke - 2], bp[ks:ke - 2])) * dxi
            + (_i2(jp(w), w) - _i2(w, jm(w)))[ks + 1:ke - 1] * dyi
            * (_i22(bp[ks + 1:ke - 1], jp(bp)[ks + 1:ke - 1],
                    jp(bp)[ks:ke - 2], bp[ks:ke - 2])
               - _i22(bp[ks + 1:ke - 1], jm(bp)[ks + 1:ke - 1],
                      jm(bp)[ks:ke - 2], bp[ks:ke - 2])) * dyi
            + (_i2(w[ks + 2:ke], w[ks + 1:ke - 1])
               - _i2(w[ks + 1:ke - 1], w[ks:ke - 2])) * dzhi_c[ks + 1:ke - 1]
            * (bp[ks + 1:ke - 1] - bp[ks:ke - 2]) * dzhi_c[ks + 1:ke - 1]))
        out["bw_visc"] = half({slice(1, kt - 1): bw_vs_prof,
                               0: bw_vs_prof[0]})
        out["bw_diss"] = half({slice(1, kt - 1): full(bw_ds_i),
                               0: torch.mean(bw_ds_bot),
                               kt: torch.mean(bw_ds_top)})

        # pressure terms of the bw budget (:1257-1278)
        if p is not None:
            ppf = p - _hm(p)[:, None, None]
            out["bw_pres"] = half({slice(0, kt): full(
                -(ppf[ks:ke] * bp[ks:ke] - ppf[ks - 1:ke - 1]
                  * bp[ks - 1:ke - 1]) * dzhi_c[ks:ke])})
            out["bw_rdstr"] = half({slice(0, kt): full(
                _i2(ppf[ks:ke], ppf[ks - 1:ke - 1])
                * (bp[ks:ke] - bp[ks - 1:ke - 1]) * dzhi_c[ks:ke])})
    return out


class Budget:
    """Attachable to Stats: registers and fills the 'budget' group."""

    FULL = ["ke", "tke",
            "u2_shear", "v2_shear", "tke_shear",
            "u2_turb", "v2_turb", "tke_turb",
            "u2_cor", "v2_cor",
            "tke_pres", "u2_rdstr", "v2_rdstr",
            "u2_visc", "v2_visc", "tke_visc",
            "u2_diss", "v2_diss", "tke_diss",
            "tke_buoy", "b2_shear", "b2_turb", "b2_visc", "b2_diss"]
    HALF = ["uw_shear", "vw_shear",
            "w2_turb", "uw_turb", "vw_turb",
            "uw_cor", "vw_cor",
            "w2_pres", "uw_pres", "vw_pres",
            "w2_rdstr", "uw_rdstr", "vw_rdstr",
            "w2_visc", "uw_visc",
            "w2_diss", "uw_diss",
            "w2_buoy", "uw_buoy", "vw_buoy",
            "bw_shear", "bw_turb", "bw_buoy", "bw_visc", "bw_diss",
            "bw_pres", "bw_rdstr"]

    def __init__(self, model):
        sw = model.ini.get_str("budget", "swbudget", default="0")
        self.sw = sw not in ("0", "false")
        if not self.sw:
            return
        if sw == "4" and model.grid.spatial_order != 4:
            raise ValueError("swbudget=4 requires swspatialorder=4")
        if sw == "2" and model.grid.spatial_order != 2:
            raise ValueError("swbudget=2 requires swspatialorder=2")
        self.order = 4 if sw == "4" else 2
        self.model = model

    def register(self, stats):
        if not self.sw:
            return
        if self.order == 4:
            from .budget4 import FULL_TERMS, HALF_TERMS
            has_thermo = hasattr(self.model.thermo, "get_buoyancy")
            for name in FULL_TERMS:
                if (name.startswith("b") or name.endswith("buoy")) \
                        and not has_thermo:
                    continue
                stats.add_prof(name, name.replace("_", " "), "m2 s-3", "z",
                               group="budget")
            for name in HALF_TERMS:
                if (name.endswith("buoy") or name.startswith("bw")) \
                        and not has_thermo:
                    continue
                stats.add_prof(name, name.replace("_", " "), "m2 s-3", "zh",
                               group="budget")
            if has_thermo:
                stats.add_prof("b_sort", "Sorted buoyancy", "m s-2", "z",
                               group="budget")
            return
        for name in self.FULL:
            stats.add_prof(name, name.replace("_", " "), "m2 s-3", "z",
                           group="budget")
        for name in self.HALF:
            stats.add_prof(name, name.replace("_", " "), "m2 s-3", "zh",
                           group="budget")

    def profiles(self, ctx, s, aux):
        m = self.model
        if self.order == 4:
            from .budget4 import budget4_profiles
            return budget4_profiles(ctx, s, aux, m.thermo, m.fields.visc)
        fc = getattr(m.force, "fc", None) if m.force is not None else None
        svisc = None
        if getattr(m.thermo, "scalars", ()):
            svisc = m.fields.sp[m.thermo.scalars[0]].visc
        return budget2_profiles(ctx, s, aux, m.thermo, m.fields.visc,
                                svisc=svisc, fc=fc,
                                utrans=ctx.utrans, vtrans=ctx.vtrans)
