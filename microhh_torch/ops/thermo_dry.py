"""Dry thermodynamics (``microhh_tpu/ops/thermo_dry.py``; reference
``src/thermo_dry.cxx``).

Prognostic potential temperature ``th``; buoyancy tendency
``wt += g/thref_h * (interp(th) - thref_h)`` (thermo_dry.cxx:165-179); the
Boussinesq or anelastic base state (calc_base_state, :243-288) in numpy;
with ``swbaroclinic`` the large-scale meridional gradient ``dthetady_ls``
advected by v, ``tht -= dthetady_ls * interp(v)`` at either order.  On the
model's main path the buoyancy runs inside the RK tendency kernel; a
baroclinic case takes a path that calls ``exec`` (model.build_step).
"""

import numpy as np
import torch

from .. import constants as cst
from ..timedep import Timedep
from .. import fd
from .advec_2 import add_rows
from .stencil import i2, jm, jp


def exner(p):
    return (p / cst.p0) ** (cst.Rd / cst.cp)


class ThermoDry:
    def __init__(self, ini, grid, fields):
        self.grid = grid
        self.fields = fields
        fields.init_prognostic_field("th", "Potential Temperature", "K", "thermo")
        fields.sp["th"].visc = ini.get_float("fields", "svisc", subitem="th")

        sw = ini.get_str("thermo", "swbasestate", default="")
        if sw not in ("boussinesq", "anelastic"):
            raise ValueError('Invalid option for "swbasestate"')
        self.swbasestate = sw
        self.pbot = ini.get_float("thermo", "pbot")
        if sw == "boussinesq":
            self.thref0 = ini.get_float("thermo", "thref0")
        self.swbaroclinic = ini.get_bool("thermo", "swbaroclinic",
                                         default=False)
        if self.swbaroclinic:
            self.dthetady_ls = ini.get_float("thermo", "dthetady_ls")
        ini.flag_as_used("thermo", "thref0")
        ini.flag_as_used("thermo", "pbot")
        # swtimedep_pbot (thermo_dry.cxx:364, 494-497): interpolated as the
        # reference does, into pbot alone; the dry base state is static, so
        # nothing reads it during a run
        self.swtimedep_pbot = ini.get_bool("thermo", "swtimedep_pbot",
                                           default=False)
        self.tdep_pbot = None

    def update_timedep(self, sfc, itime):
        if self.tdep_pbot is not None:
            self.pbot = float(self.tdep_pbot.interpolate(itime))
        return sfc

    @property
    def scalars(self):
        return ("th",)

    def create_basestate(self, input_nc):
        """Fill thref/threfh/pref/rhoref (reference create, :376-445)."""
        if self.swtimedep_pbot:
            self.tdep_pbot = Timedep(input_nc, "p_sbot", "time_surface")
        g = self.grid
        kc, ks, ke = g.kcells, g.kstart, g.kend
        thref = np.zeros(kc)
        threfh = np.zeros(kc)

        if self.swbasestate == "anelastic":
            init = input_nc.groups["init"]
            thref[ks:ke] = np.asarray(init.variables["th"][:g.ktot], dtype=np.float64)

            # calc_base_state (thermo_dry.cxx:243-288)
            threfh[ks] = thref[ks] - g.z[ks] * (thref[ks + 1] - thref[ks]) * g.dzhi[ks + 1]
            threfh[ke] = thref[ke - 1] + (g.zh[ke] - g.z[ke - 1]) * (thref[ke - 1] - thref[ke - 2]) * g.dzhi[ke - 1]
            thref[ks - 1] = 2. * threfh[ks] - thref[ks]
            thref[ke] = 2. * threfh[ke] - thref[ke - 1]
            threfh[ks + 1:ke] = 0.5 * (thref[ks:ke - 1] + thref[ks + 1:ke])
        else:
            thref[:] = self.thref0
            threfh[:] = self.thref0

        pref = np.zeros(kc)
        prefh = np.zeros(kc)
        prefh[ks] = self.pbot
        pref[ks] = self.pbot * np.exp(-cst.grav * g.z[ks] / (cst.Rd * threfh[ks] * exner(prefh[ks])))
        for k in range(ks + 1, ke + 1):
            prefh[k] = prefh[k - 1] * np.exp(-cst.grav * g.dz[k - 1] / (cst.Rd * thref[k - 1] * exner(pref[k - 1])))
            pref[k] = pref[k - 1] * np.exp(-cst.grav * g.dzh[k] / (cst.Rd * threfh[k] * exner(prefh[k])))
        pref[ks - 1] = 2. * prefh[ks] - pref[ks]
        exnref = exner(pref)
        exnrefh = exner(prefh)

        if self.swbasestate == "anelastic":
            with np.errstate(divide="ignore", invalid="ignore"):
                rhoref = pref / (cst.Rd * thref * exnref)
                rhorefh = prefh / (cst.Rd * threfh * exnrefh)
            rhoref[~np.isfinite(rhoref)] = 1.
            rhorefh[~np.isfinite(rhorefh)] = 1.
            self.fields.rhoref = rhoref
            self.fields.rhorefh = rhorefh
        # Boussinesq: rhoref stays 1.

        self.thref = thref
        self.threfh = threfh
        self.pref = pref
        self.prefh = prefh
        self.exnref = exnref
        self.exnrefh = exnrefh

    def save_basestate(self, iotime, path="."):
        g = self.grid
        with open("%s/thermo_basestate.%07d" % (path, iotime), "wb") as f:
            for arr in (self.thref, self.threfh, self.pref, self.prefh):
                arr[g.kstart:g.kend].tofile(f)

    # -- tensor ops ---------------------------------------------------------
    def _prof(self, arr, ctx, like):
        return torch.as_tensor(arr, dtype=ctx.dtype, device=like.device)

    def exec(self, ctx, s, t, aux):
        """wt += g/threfh * (interp(th) - threfh) on half levels ks+1..ke-1;
        with swbaroclinic, tht -= dthetady_ls * (v at the cell centre) on
        the interior levels (new tensors)."""
        ks, ke = ctx.ks, ctx.ke
        th = s["th"]
        col = self._prof(self.threfh, ctx, th)[ks + 1:ke][:, None, None]
        if ctx.spatial_order == 2:
            th_h = i2(th[ks:ke - 1], th[ks + 1:ke])
        else:
            th_h = (fd.ci0 * th[ks - 1:ke - 2] + fd.ci1 * th[ks:ke - 1]
                    + fd.ci2 * th[ks + 1:ke] + fd.ci3 * th[ks + 2:ke + 1])
        t = dict(t)
        t["w"] = add_rows(t["w"], ks + 1, ke, cst.grav / col * (th_h - col))
        if self.swbaroclinic:
            v = s["v"]
            if ctx.spatial_order == 2:
                v_c = i2(v, jp(v))[ks:ke]
            else:
                v_c = (fd.ci0 * jm(v) + fd.ci1 * v + fd.ci2 * jp(v)
                       + fd.ci3 * jp(v, 2))[ks:ke]
            t["th"] = add_rows(t["th"], ks, ke, -self.dthetady_ls * v_c)
        return t

    def get_buoyancy(self, ctx, s):
        """b = g/thref*(th - thref), full column (thermo_dry.cxx
        calc_buoyancy); the statistics' budgets read it."""
        thref = self._prof(self.thref, ctx, s["th"])[:, None, None]
        return cst.grav / thref * (s["th"] - thref)

    def get_n2(self, ctx, s):
        """N2 on interior levels (thermo_dry.cxx calc_N2)."""
        ks, ke = ctx.ks, ctx.ke
        th = s["th"]
        thref = self._prof(self.thref, ctx, th)[ks:ke][:, None, None]
        return (cst.grav / thref * 0.5 * (th[ks + 1:ke + 1] - th[ks - 1:ke - 1])
                * ctx.dzi[ks:ke][:, None, None])

    def get_buoyancy_fluxbot(self, ctx, s, sfc):
        """bfluxbot = g/threfh[ks] * thfluxbot."""
        return float(cst.grav / self.threfh[self.grid.kstart]) * sfc["th_fluxbot"]

    def get_buoyancy_surf(self, ctx, s, sfc):
        """(b at kstart, bbot) for the Obukhov solve."""
        ks = ctx.ks
        thref = float(self.thref[ks])
        threfh = float(self.threfh[ks])
        b = cst.grav / thref * (s["th"][ks] - thref)
        bbot = cst.grav / threfh * (sfc["th_bot"] - threfh)
        return b, bbot

    def get_db_ref(self):
        ks = self.grid.kstart
        return float(cst.grav / self.thref[ks] * (self.thref[ks] - self.threfh[ks]))
