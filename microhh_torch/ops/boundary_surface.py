"""Monin-Obukhov (MOST) surface boundary (``microhh_tpu/ops/boundary_surface.py``;
reference ``src/boundary_surface.cxx``).

All surface planes (ustar, obuk, fluxes, gradients) live in the ``sfc`` dict
of (jtot, itot) tensors and are recomputed each substep
(``Boundary_surface::exec``, boundary_surface.cxx:830-975).  The port carries
the constant-roughness surface; 2-D z0 maps and Charnock roughness are
ROADMAP Queue 1 item 14.
"""

import os

import numpy as np
import torch

from .. import constants as cst
from . import most
from .boundary import (make_bcs, top_ghost_2nd, assemble_ghosts, DIRICHLET,
                       NEUMANN, FLUX, USTAR)
from .stencil import im, ip, jm, jp


class BoundarySurface:
    is_surface = True

    def __init__(self, ini, fields, grid):
        self.grid = grid
        self.fields = fields
        self.bcs = make_bcs(ini, fields)
        self.viscs = {"u": fields.visc, "v": fields.visc}
        for name, f in fields.sp.items():
            self.viscs[name] = f.visc
        self.offsets = {"u": grid.utrans, "v": grid.vtrans}

        if (not ini.get_bool("boundary", "swconstantz0", default=True)
                or ini.get_bool("boundary", "swcharnock", default=False)):
            raise NotImplementedError(
                "2-D roughness maps and Charnock roughness are not ported "
                "(ROADMAP Queue 1 item 14)")
        self.z0m = ini.get_float("boundary", "z0m")
        self.z0h = ini.get_float("boundary", "z0h")

        mbcbot = self.bcs["u"].bcbot
        if mbcbot == NEUMANN:
            raise ValueError("Neumann bc is not supported in surface model")
        self.mbcbot = mbcbot
        if mbcbot == USTAR:
            self.ustarin = ini.get_float("boundary", "ustar")
        for name in fields.sp:
            if self.bcs[name].bcbot == NEUMANN:
                raise ValueError("Fixed gradient bc is not supported in surface model")
            if self.bcs[name].bcbot == DIRICHLET and mbcbot == USTAR:
                raise ValueError("Fixed ustar + Dirichlet scalar bc not supported")

        self.thermo = None  # set by Model after construction
        self._lut = None
        # Newton z/L by default, the reference's LUT with MICROHH_MOST_LUT=1
        # (same switch as the JAX package).
        self.use_lut = os.environ.get("MICROHH_MOST_LUT", "0") == "1"

    def _thermobc(self):
        if self.thermo is None or not getattr(self.thermo, "scalars", ()):
            return FLUX
        return self.bcs[self.thermo.scalars[0]].bcbot

    def _get_lut(self, device):
        if self._lut is None:
            zsl = self.grid.z[self.grid.kstart]
            self._lut = most.prepare_lut(
                self.z0m, self.z0h, zsl,
                mbcbot_dirichlet=(self.mbcbot == DIRICHLET),
                thermobc_flux=(self._thermobc() == FLUX))
        zL, f = self._lut
        return (torch.as_tensor(zL, device=device),
                torch.as_tensor(f, device=device))

    # ------------------------------------------------------------------
    def init_surface_state(self, dtype=np.float64):
        """Initial sfc dict of numpy planes (reference init_surface)."""
        g = self.grid
        shape = (g.jtot, g.itot)

        def z():
            return np.zeros(shape, dtype=dtype)

        sfc = {"ustar": np.full(shape, 0.1, dtype=dtype),
               "obuk": np.full(shape, -cst.dbig, dtype=dtype),
               "dudz_mo": z(), "dvdz_mo": z(), "dbdz_mo": z()}
        if self.mbcbot == USTAR:
            sfc["ustar"][:] = self.ustarin
        for name in ("u", "v"):
            bc = self.bcs[name]
            sfc[name + "_bot"] = np.full(shape, bc.bot - self.offsets[name], dtype=dtype)
            sfc[name + "_fluxbot"] = z()
            sfc[name + "_gradbot"] = z()
        for name in self.fields.sp:
            bc = self.bcs[name]
            sfc[name + "_bot"] = z()
            sfc[name + "_fluxbot"] = z()
            sfc[name + "_gradbot"] = z()
            if bc.bcbot == DIRICHLET:
                sfc[name + "_bot"][:] = bc.bot
            elif bc.bcbot == FLUX:
                sfc[name + "_fluxbot"][:] = bc.bot
        return sfc

    # ------------------------------------------------------------------
    def _calc_dutot(self, ctx, s, sfc):
        """Filtered wind-speed difference (boundary_surface_kernels.h:136-183)."""
        ks = ctx.ks
        u = s["u"][ks]
        v = s["v"][ks]

        def filt_u(a):
            row = 0.5 * im(a) + a + ip(a) + 0.5 * ip(a, 2)
            return (jm(row) + row + jp(row)) / 9.

        def filt_v(a):
            col = 0.5 * jm(a) + a + jp(a) + 0.5 * jp(a, 2)
            return (im(col) + col + ip(col)) / 9.

        ubot, vbot = sfc["u_bot"], sfc["v_bot"]
        du = filt_u(u) - 0.5 * (ubot + ip(ubot))
        dv = filt_v(v) - 0.5 * (vbot + jp(vbot))
        return torch.clamp(torch.sqrt(du * du + dv * dv), min=0.1)

    def exec(self, ctx, s, sfc, aux):
        """Stability + surface fluxes/gradients; returns the new sfc."""
        g = self.grid
        ks = ctx.ks
        zsl = float(g.z[ks])
        z0m, z0h = self.z0m, self.z0h
        sfc = dict(sfc)

        dutot = self._calc_dutot(ctx, s, sfc)

        thermo_on = self.thermo is not None and getattr(self.thermo, "scalars", ())
        if not thermo_on:
            # stability_neutral (boundary_surface.cxx:141-186)
            obuk = torch.full_like(dutot, -cst.dbig)
            if self.mbcbot == USTAR:
                ustar = sfc["ustar"]
            else:
                ustar = dutot * most.fm(zsl, z0m, obuk)
        else:
            bfluxbot = self.thermo.get_buoyancy_fluxbot(ctx, s, sfc)
            thermobc = self._thermobc()
            if self.mbcbot == USTAR and thermobc == FLUX:
                ustar = sfc["ustar"]
                obuk = -(ustar ** 3) / (cst.kappa * bfluxbot)
            elif self.mbcbot == DIRICHLET and thermobc == FLUX:
                Ri = -cst.kappa * bfluxbot * zsl / dutot ** 3
                if self.use_lut:
                    zL_lut, f_lut = self._get_lut(dutot.device)
                    zL = most.lookup_zL(zL_lut, f_lut, Ri).to(ctx.dtype)
                else:
                    zL = most.solve_zL_flux(Ri, zsl / sfc["obuk"], zsl, z0m)
                obuk = zsl / zL
                ustar = dutot * most.fm(zsl, z0m, obuk)
            elif self.mbcbot == DIRICHLET and thermobc == DIRICHLET:
                b, bbot = self.thermo.get_buoyancy_surf(ctx, s, sfc)
                db = b - bbot + self.thermo.get_db_ref()
                Ri = cst.kappa * db * zsl / dutot ** 2
                if self.use_lut:
                    zL_lut, f_lut = self._get_lut(dutot.device)
                    zL = most.lookup_zL(zL_lut, f_lut, Ri).to(ctx.dtype)
                else:
                    zL = most.solve_zL_dirichlet(Ri, zsl / sfc["obuk"], zsl,
                                                 z0m, z0h)
                obuk = zsl / zL
                ustar = dutot * most.fm(zsl, z0m, obuk)
            else:
                raise ValueError("unsupported mbcbot/thermobc combination")

        sfc["ustar"] = ustar
        sfc["obuk"] = obuk

        # surfm (boundary_surface.cxx:188-320)
        u, v = s["u"][ks], s["v"][ks]
        ubot, vbot = sfc["u_bot"], sfc["v_bot"]
        ufm = ustar * most.fm(zsl, z0m, obuk)
        if self.mbcbot == DIRICHLET:
            sfc["u_fluxbot"] = -(u - ubot) * 0.5 * (im(ufm) + ufm)
            sfc["v_fluxbot"] = -(v - vbot) * 0.5 * (jm(ufm) + ufm)
        elif self.mbcbot == USTAR:
            minval = 1.e-2
            du, dv = u - ubot, v - vbot
            vonu2 = torch.clamp(0.25 * (im(dv) ** 2 + im(jp(dv)) ** 2 + dv ** 2 + jp(dv) ** 2), min=minval)
            uonv2 = torch.clamp(0.25 * (jm(du) ** 2 + jm(ip(du)) ** 2 + du ** 2 + ip(du) ** 2), min=minval)
            u2 = torch.clamp(du ** 2, min=minval)
            v2 = torch.clamp(dv ** 2, min=minval)
            ustaronu4 = 0.5 * (im(ustar) ** 4 + ustar ** 4)
            ustaronv4 = 0.5 * (jm(ustar) ** 4 + ustar ** 4)
            sfc["u_fluxbot"] = -torch.sign(du) * torch.sqrt(ustaronu4 / (1. + vonu2 / u2))
            sfc["v_fluxbot"] = -torch.sign(dv) * torch.sqrt(ustaronv4 / (1. + uonv2 / v2))
        sfc["u_gradbot"] = (u - ubot) / zsl
        sfc["v_gradbot"] = (v - vbot) / zsl

        # surfs per scalar (boundary_surface.cxx:322-380)
        fh2d = ustar * most.fh(zsl, z0h, obuk)
        for name in self.fields.sp:
            bc = self.bcs[name]
            var = s[name][ks]
            if bc.bcbot == DIRICHLET:
                varbot = sfc[name + "_bot"]
                sfc[name + "_fluxbot"] = -(var - varbot) * fh2d
                sfc[name + "_gradbot"] = (var - varbot) / zsl
            elif bc.bcbot == FLUX:
                fluxbot = sfc[name + "_fluxbot"]
                varbot = fluxbot / fh2d + var
                sfc[name + "_bot"] = varbot
                sfc[name + "_gradbot"] = (var - varbot) / zsl

        # MO gradients for the SGS model (calc_duvdz_mo / calc_dbdz_mo)
        du_c = 0.5 * ((u - ubot) + (ip(u) - ip(ubot)))
        dv_c = 0.5 * ((v - vbot) + (jp(v) - jp(vbot)))
        fac = most.fm(zsl, z0m, obuk) * most.phim(zsl / obuk) / (cst.kappa * zsl)
        sfc["dudz_mo"] = du_c * fac
        sfc["dvdz_mo"] = dv_c * fac
        if thermo_on:
            bfluxbot = self.thermo.get_buoyancy_fluxbot(ctx, s, sfc)
            sfc["dbdz_mo"] = -bfluxbot / (cst.kappa * zsl * ustar) * most.phih(zsl / obuk)
        return sfc

    # ------------------------------------------------------------------
    def restart_fields(self):
        """Surface planes that must survive a restart bitwise (reference
        boundary_surface.cxx:638-685)."""
        names = ["dudz_mo", "dvdz_mo", "dbdz_mo", "obuk", "ustar"]
        for n, bc in self.bcs.items():
            if n not in ("u", "v") and bc.bcbot == FLUX:
                names.append(n + "_gradbot")
        return names

    def save(self, sfc, iotime, path="."):
        for name in self.restart_fields():
            if name in sfc:
                np.ascontiguousarray(np.asarray(sfc[name])).tofile(
                    "%s/%s.%07d" % (path, name, iotime))

    def load(self, sfc, iotime, path=".", dtype=np.float64):
        g = self.grid
        sfc = dict(sfc)
        for name in self.restart_fields():
            fn = "%s/%s.%07d" % (path, name, iotime)
            if os.path.exists(fn):
                sfc[name] = np.fromfile(fn, dtype=dtype).reshape(g.jtot, g.itot)
        return sfc

    def flux_ghost_names(self):
        """Fields whose ghost planes depend on the surface model's output
        (what the refill after ``exec`` must update): the scalars always,
        u and v only under the ustar BC."""
        names = list(self.fields.sp.keys())
        if self.mbcbot == USTAR:
            names = ["u", "v"] + names
        return tuple(names)

    def set_ghost_cells(self, ctx, s, sfc, names=None):
        """Ghost fill from the surface model's 2-D bot/grad planes (bottom)
        and the static ini BCs (top), 2nd order; ``names`` restricts it to
        those fields."""
        out = dict(s)
        ks = ctx.ks
        if names is None:
            names = ["u", "v"] + list(self.fields.sp.keys())
        for name in names:
            a = s[name]
            bc = self.bcs[name]
            if self.mbcbot == USTAR and name in ("u", "v"):
                bot = -sfc[name + "_gradbot"] * ctx.dzh[ks] + a[ks]
            elif name in ("u", "v"):
                bot = 2. * sfc[name + "_bot"] - a[ks]
            else:
                # scalars: both Dirichlet and Flux reduce to a gradient fill
                bot = -sfc[name + "_gradbot"] * ctx.dzh[ks] + a[ks]
            top = top_ghost_2nd(ctx, a, bc.bctop, bc.top, self.viscs[name],
                                self.offsets.get(name, 0.))
            out[name] = assemble_ghosts(ctx, a, bot, top)
        return out
