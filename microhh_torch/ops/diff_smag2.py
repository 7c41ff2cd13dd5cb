"""Smagorinsky-Lilly LES diffusion (``microhh_tpu/ops/diff_smag2.py``;
reference ``src/diff_smag2.cxx``).

Strain rate (calc_strain2, diff_smag2.cxx:48-253), stability-corrected eddy
viscosity with Mason wall damping (calc_evisc, :255-369), the
variable-viscosity flux-divergence stencils diff_u/v/w/c (:370-700) and the
diffusion-number limit, as plain torch.  On the model's main path the
viscosity and the diffusion run inside the hand-written kernels of
ops/fused.py; this op path is their independent reference and serves
``get_dn``.
"""

import torch

from .. import constants as cst
from .advec_2 import add_rows
from .stencil import im, ip, jm, jp


def _col(arr, sl):
    return arr[sl][:, None, None]


def _set_rows(shape_like, lo, hi, val):
    out = torch.zeros_like(shape_like)
    out[lo:hi] = val
    return out


class DiffSmag2:
    def __init__(self, ini, grid, fields, boundary):
        self.dnmax = ini.get_float("diff", "dnmax", default=0.4)
        self.cs = ini.get_float("diff", "cs", default=0.23)
        self.tPr = ini.get_float("diff", "tPr", default=1. / 3.)
        self.grid = grid
        self.fields = fields
        self.boundary = boundary
        self.visc = fields.visc
        self.viscs = {name: f.visc for name, f in fields.sp.items()}
        self.thermo = None  # set by Model
        self.surface = getattr(boundary, "is_surface", False)
        self.z0m = getattr(boundary, "z0m", 0.)

        # Mason mixing length per level (constant z0): mlen^2 precomputed.
        g = grid
        ks, ke = g.kstart, g.kend
        mlen0 = self.cs * (g.dx * g.dy * g.dz[ks:ke]) ** (1. / 3.)
        if self.surface:
            n = 2.
            mason = (1. / (1. / mlen0 ** n + 1. / (cst.kappa * (g.z[ks:ke] + self.z0m)) ** n)) ** (1. / n)
            self.mlen2 = mason ** 2
        else:
            self.mlen2 = mlen0 ** 2

    # ------------------------------------------------------------------
    def calc_strain2(self, ctx, s, sfc):
        """S^2*2 on interior levels (kmax, jtot, itot)."""
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"], s["v"], s["w"]
        dxi, dyi = ctx.dxi, ctx.dyi
        dzi = _col(ctx.dzi, slice(ks, ke))
        dzhi = ctx.dzhi

        dudx = (ip(u) - u)[ks:ke] * dxi
        dvdy = (jp(v) - v)[ks:ke] * dyi
        dwdz = (w[ks + 1:ke + 1] - w[ks:ke]) * dzi

        c = (u - jm(u)) * dyi + (v - im(v)) * dxi
        horiz = 0.125 * (c ** 2 + ip(c) ** 2 + jp(c) ** 2 + ip(jp(c)) ** 2)[ks:ke]

        duz = _set_rows(u, ks, ke + 1,
                        (u[ks:ke + 1] - u[ks - 1:ke]) * _col(dzhi, slice(ks, ke + 1))
                        + (w - im(w))[ks:ke + 1] * dxi)
        vert_x = 0.125 * ((duz ** 2 + ip(duz) ** 2)[ks:ke]
                          + (duz ** 2 + ip(duz) ** 2)[ks + 1:ke + 1])

        dvz = _set_rows(v, ks, ke + 1,
                        (v[ks:ke + 1] - v[ks - 1:ke]) * _col(dzhi, slice(ks, ke + 1))
                        + (w - jm(w))[ks:ke + 1] * dyi)
        vert_y = 0.125 * ((dvz ** 2 + jp(dvz) ** 2)[ks:ke]
                          + (dvz ** 2 + jp(dvz) ** 2)[ks + 1:ke + 1])

        strain2 = 2. * (dudx ** 2 + dvdy ** 2 + dwdz ** 2 + horiz + vert_x + vert_y)

        if self.surface:
            # Bottom level: vertical shear fully from MO (diff_smag2.cxx:69-115).
            dudz_mo, dvdz_mo = sfc["dudz_mo"], sfc["dvdz_mo"]
            wslab = w[ks:ks + 2]
            dwdx = (wslab - im(wslab)) * dxi
            dwdy = (wslab - jm(wslab)) * dyi
            bot = 2. * (dudx[0] ** 2 + dvdy[0] ** 2 + dwdz[0] ** 2 + horiz[0]
                        + 0.5 * dudz_mo ** 2
                        + 0.125 * (dwdx[0] ** 2 + ip(dwdx)[0] ** 2 + dwdx[1] ** 2 + ip(dwdx)[1] ** 2)
                        + 0.5 * dvdz_mo ** 2
                        + 0.125 * (dwdy[0] ** 2 + jp(dwdy)[0] ** 2 + dwdy[1] ** 2 + jp(dwdy)[1] ** 2))
            strain2 = torch.cat([bot[None], strain2[1:]])

        return strain2 + cst.dsmall

    def exec_viscosity(self, ctx, s, sfc, aux):
        ks, ke = ctx.ks, ctx.ke
        strain2 = self.calc_strain2(ctx, s, sfc)
        mlen2 = torch.as_tensor(self.mlen2, dtype=ctx.dtype,
                                device=strain2.device)[:, None, None]

        if self.thermo is not None and getattr(self.thermo, "scalars", ()):
            n2 = self.thermo.get_n2(ctx, s)
            if self.surface:
                n2 = torch.cat([sfc["dbdz_mo"][None], n2[1:]])
            evisc_int = mlen2 * torch.sqrt(torch.maximum(
                strain2 - n2 * (1. / self.tPr), strain2 * cst.dsmall))
        else:
            evisc_int = mlen2 * torch.sqrt(strain2)
            if not self.surface:
                # Van Driest damping near resolved walls (diff_smag2.cxx:160-225)
                u, v = s["u"], s["v"]
                dzhi = ctx.dzhi
                u_tau_bot = (((self.visc * (u[ks] - u[ks - 1]) * dzhi[ks]) ** 2
                              + (self.visc * (v[ks] - v[ks - 1]) * dzhi[ks]) ** 2) ** 0.25)
                u_tau_top = (((self.visc * (u[ke] - u[ke - 1]) * dzhi[ke]) ** 2
                              + (self.visc * (v[ke] - v[ke - 1]) * dzhi[ke]) ** 2) ** 0.25)
                A = 26.
                zc = _col(ctx.z, slice(ks, ke))
                fac_bot = 1. - torch.exp(-(zc * u_tau_bot[None]) / (A * self.visc))
                fac_top = 1. - torch.exp(-((ctx.zsize - zc) * u_tau_top[None]) / (A * self.visc))
                fac = torch.minimum(fac_bot, fac_top)
                evisc_int = fac ** 2 * mlen2 * torch.sqrt(strain2)

        # ghost levels mirror the edge levels
        evisc = torch.cat([evisc_int[:1], evisc_int, evisc_int[-1:]])
        aux = dict(aux)
        aux["evisc"] = evisc
        return aux

    # ------------------------------------------------------------------
    def _term_z(self, ctx, flux_z):
        """The divergence of a vertical flux on the interior levels."""
        ks, ke = ctx.ks, ctx.ke
        return ((_col(ctx.rhorefh, slice(ks + 1, ke + 1)) * flux_z[ks + 1:ke + 1]
                 - _col(ctx.rhorefh, slice(ks, ke)) * flux_z[ks:ke])
                / _col(ctx.rhoref, slice(ks, ke)) * _col(ctx.dzi, slice(ks, ke)))

    def _wall_fluxes(self, ctx, flux_z, name, sfc):
        """The surface model's wall fluxes in place of the gradient form."""
        if self.surface:
            flux_z[ctx.ks] = -sfc[name + "_fluxbot"]
            flux_z[ctx.ke] = -self.fluxtop(name)
        return flux_z

    def exec(self, ctx, s, t, aux, sfc):
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"], s["v"], s["w"]
        evisc = aux["evisc"]
        dxi, dyi = ctx.dxi, ctx.dyi
        visc = self.visc
        rho = ctx.rhoref
        rhoh = ctx.rhorefh
        dzi = ctx.dzi
        dzhi = ctx.dzhi
        t = dict(t)

        # ---- u ----
        ev_e = evisc + visc
        ev_w = im(evisc) + visc
        ev_n = 0.25 * (im(evisc) + evisc + im(jp(evisc)) + jp(evisc)) + visc
        ev_s = jm(ev_n)
        ev_hu = 0.25 * (im(evisc) + evisc)
        ev_zu = _set_rows(u, ks, ke + 1, (ev_hu[ks:ke + 1] + ev_hu[ks - 1:ke]) + visc)

        term_x = ((ev_e * (ip(u) - u) - ev_w * (u - im(u))) * 2. * dxi * dxi)[ks:ke]
        term_y = ((ev_n * ((jp(u) - u) * dyi + (jp(v) - im(jp(v))) * dxi)
                   - ev_s * ((u - jm(u)) * dyi + (v - im(v)) * dxi)) * dyi)[ks:ke]
        flux_z = _set_rows(u, ks, ke + 1,
                           ev_zu[ks:ke + 1] * ((u[ks:ke + 1] - u[ks - 1:ke]) * _col(dzhi, slice(ks, ke + 1))
                                               + (w - im(w))[ks:ke + 1] * dxi))
        flux_z = self._wall_fluxes(ctx, flux_z, "u", sfc)
        t["u"] = add_rows(t["u"], ks, ke, term_x + term_y + self._term_z(ctx, flux_z))

        # ---- v ----
        ev_e2 = 0.25 * (jm(evisc) + evisc + ip(jm(evisc)) + ip(evisc)) + visc
        ev_w2 = im(ev_e2)
        ev_n2 = evisc + visc
        ev_s2 = jm(evisc) + visc
        ev_hv = 0.25 * (jm(evisc) + evisc)
        ev_zv = _set_rows(v, ks, ke + 1, (ev_hv[ks:ke + 1] + ev_hv[ks - 1:ke]) + visc)

        term_x = ((ev_e2 * ((ip(v) - v) * dxi + (ip(u) - jm(ip(u))) * dyi)
                   - ev_w2 * ((v - im(v)) * dxi + (u - jm(u)) * dyi)) * dxi)[ks:ke]
        term_y = ((ev_n2 * (jp(v) - v) - ev_s2 * (v - jm(v))) * 2. * dyi * dyi)[ks:ke]
        flux_z = _set_rows(v, ks, ke + 1,
                           ev_zv[ks:ke + 1] * ((v[ks:ke + 1] - v[ks - 1:ke]) * _col(dzhi, slice(ks, ke + 1))
                                               + (w - jm(w))[ks:ke + 1] * dyi))
        flux_z = self._wall_fluxes(ctx, flux_z, "v", sfc)
        t["v"] = add_rows(t["v"], ks, ke, term_x + term_y + self._term_z(ctx, flux_z))

        # ---- w ---- (diff_w, interior half levels)
        lo, hi = ks + 1, ke
        ev_xw = 0.25 * (im(evisc)[lo - 1:hi - 1] + im(evisc)[lo:hi] + evisc[lo - 1:hi - 1] + evisc[lo:hi]) + visc
        ev_yw = 0.25 * (jm(evisc)[lo - 1:hi - 1] + jm(evisc)[lo:hi] + evisc[lo - 1:hi - 1] + evisc[lo:hi]) + visc
        ev_t = evisc[lo:hi] + visc
        ev_b = evisc[lo - 1:hi - 1] + visc

        dzhi_w = _col(dzhi, slice(lo, hi))
        wx = ((ip(ev_xw)) * ((ip(w) - w)[lo:hi] * dxi + (ip(u)[lo:hi] - ip(u)[lo - 1:hi - 1]) * dzhi_w)
              - ev_xw * ((w - im(w))[lo:hi] * dxi + (u[lo:hi] - u[lo - 1:hi - 1]) * dzhi_w)) * dxi
        wy = ((jp(ev_yw)) * ((jp(w) - w)[lo:hi] * dyi + (jp(v)[lo:hi] - jp(v)[lo - 1:hi - 1]) * dzhi_w)
              - ev_yw * ((w - jm(w))[lo:hi] * dyi + (v[lo:hi] - v[lo - 1:hi - 1]) * dzhi_w)) * dyi
        wz = ((_col(rho, slice(lo, hi)) * ev_t * (w[lo + 1:hi + 1] - w[lo:hi]) * _col(dzi, slice(lo, hi))
               - _col(rho, slice(lo - 1, hi - 1)) * ev_b * (w[lo:hi] - w[lo - 1:hi - 1]) * _col(dzi, slice(lo - 1, hi - 1)))
              / _col(rhoh, slice(lo, hi)) * 2. * dzhi_w)
        t["w"] = add_rows(t["w"], lo, hi, wx + wy + wz)
        return self.exec_scalars(ctx, s, t, aux, sfc)

    def exec_scalars(self, ctx, s, t, aux, sfc):
        """t with every scalar's diffusion (diff_c) added (new tensors for
        the scalars)."""
        ks, ke = ctx.ks, ctx.ke
        evisc = aux["evisc"]
        dxi, dyi = ctx.dxi, ctx.dyi
        dzhi = ctx.dzhi
        t = dict(t)
        for name in ctx.scalar_names:
            a = s[name]
            svisc = self.viscs[name]
            ev_e = 0.5 * (evisc + ip(evisc)) / self.tPr + svisc
            ev_w = 0.5 * (im(evisc) + evisc) / self.tPr + svisc
            ev_n = 0.5 * (evisc + jp(evisc)) / self.tPr + svisc
            ev_s = 0.5 * (jm(evisc) + evisc) / self.tPr + svisc

            term_h = ((ev_e * (ip(a) - a) - ev_w * (a - im(a))) * dxi * dxi
                      + (ev_n * (jp(a) - a) - ev_s * (a - jm(a))) * dyi * dyi)[ks:ke]

            ev_z = 0.5 * (evisc[ks:ke + 1] + evisc[ks - 1:ke]) / self.tPr + svisc
            flux_z = _set_rows(a, ks, ke + 1,
                               ev_z * (a[ks:ke + 1] - a[ks - 1:ke]) * _col(dzhi, slice(ks, ke + 1)))
            flux_z = self._wall_fluxes(ctx, flux_z, name, sfc)
            t[name] = add_rows(t[name], ks, ke,
                               term_h + self._term_z(ctx, flux_z))
        return t

    def fluxtop(self, name):
        """Static top flux: Flux-type BC value, else 0 (Neumann/freeslip)."""
        bc = self.boundary.bcs.get(name)
        if bc is not None and bc.bctop == "flux":
            return bc.top
        return 0.

    def get_dn(self, ctx, s, aux):
        """Max diffusion number per unit dt (calc_dnmul, diff_smag2.cxx:700+)."""
        ks, ke = ctx.ks, ctx.ke
        evisc = aux["evisc"]
        tprfac_i = 1. / min(1., self.tPr)
        dxidxi = ctx.dxi ** 2
        dyidyi = ctx.dyi ** 2
        dzi2 = _col(ctx.dzi, slice(ks, ke)) ** 2
        return torch.max(torch.abs(evisc[ks:ke] * tprfac_i * (dxidxi + dyidyi + dzi2)))
