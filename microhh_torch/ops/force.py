"""Large-scale forcings (``microhh_tpu/ops/force.py``; reference
``src/force.cxx``).

Ported: ``swlspres`` in {0, geo (with Coriolis, 2nd order), dpdx, uflux},
large-scale source terms (``swls`` + ``lslist``) and subsidence (``swwls`` = mean | local),
with static profiles from the input ``init`` group.  On the model's generic
path these collapse into the per-level tables of the tendency kernels
(ops/fused.py generic_col_tables), which do not carry uflux;
``Force.__call__`` is their op path and what the 4th-order step runs.
Nudging and the time-dependent profiles are not ported yet (ROADMAP Queue 1
item 9), nor is the 4th-order Coriolis stencil (item 11).
"""

import numpy as np
import torch

from . import not_ported
from .advec_2 import add_rows
from .stencil import im, ip, jm, jp


def _prof(input_nc, name, ktot):
    init = input_nc.groups["init"]
    return np.asarray(init.variables[name][:ktot], dtype=np.float64)


class Force:
    def __init__(self, ini, grid, fields, input_nc):
        self.grid = grid
        self.swlspres = ini.get_str("force", "swlspres", default="0")
        if self.swlspres in ("0", "false"):
            self.swlspres = "0"
        self.swls = ini.get_str("force", "swls", default="0")
        self.swwls = ini.get_str("force", "swwls", default="0")
        self.swnudge = ini.get_str("force", "swnudge", default="0")
        if self.swnudge not in ("0", "false"):
            raise not_ported("[force] swnudge", 9)
        for item in ("swtimedep_geo", "swtimedep_ls", "swtimedep_wls"):
            if ini.get_bool("force", item, default=False):
                raise not_ported("[force] %s (time-dependent forcing)" % item, 9)
        self.tdep_geo = False
        kt = grid.ktot

        if self.swlspres == "uflux":
            self.uflux = ini.get_float("force", "uflux")
        elif self.swlspres == "dpdx":
            self.dpdx = ini.get_float("force", "dpdx")
        elif self.swlspres == "geo":
            if grid.spatial_order != 2:
                raise not_ported("[force] swlspres=geo at swspatialorder=4", 11)
            self.fc = ini.get_float("force", "fc")
            self.ug = _prof(input_nc, "u_geo", kt)[:, None, None]
            self.vg = _prof(input_nc, "v_geo", kt)[:, None, None]
        elif self.swlspres != "0":
            raise ValueError("%s is an illegal value for swlspres" % self.swlspres)

        self.lslist = []
        if self.swls == "1":
            self.lslist = ini.get_list(str, "force", "lslist", default=[])
            self.ls_profs = {n: _prof(input_nc, n + "_ls", kt)[:, None, None]
                             for n in self.lslist}
        if self.swwls == "1":
            self.swwls = "mean"  # legacy alias
        if self.swwls in ("mean", "local"):
            self.swwls_mom = ini.get_bool("force", "swwls_mom", default=False)
            self.wls = _prof(input_nc, "w_ls", kt)
        elif self.swwls != "0":
            raise ValueError("%s is an illegal value for swwls" % self.swwls)

    def __call__(self, ctx, s, t, aux, sfc=None):
        """t plus the forcing tendencies (a new dict of new tensors)."""
        ks, ke = ctx.ks, ctx.ke
        t = dict(t)
        if self.swlspres == "uflux":
            # a uniform body force that fixes the domain-mean u at uflux
            # after this substep (force.cxx flux kernels): the two
            # dz-weighted means stay on the device
            dzc = ctx.dz[ks:ke][:, None, None]
            norm = ctx.itot * ctx.jtot * ctx.zsize
            um = torch.sum(s["u"][ks:ke] * dzc) / norm
            utm = torch.sum(t["u"][ks:ke] * dzc) / norm
            fbody = (self.uflux - um - ctx.utrans) / aux["subdt"] - utm
            t["u"] = add_rows(t["u"], ks, ke, fbody)
        elif self.swlspres == "dpdx":
            t["u"] = add_rows(t["u"], ks, ke, -self.dpdx)
        elif self.swlspres == "geo":
            fc = self.fc
            ug, vg = ctx.tensor(self.ug), ctx.tensor(self.vg)
            u, v = s["u"], s["v"]
            # coriolis_2nd (force.cxx:78-140)
            v_at_u = 0.25 * (v + ip(v) + jm(v) + jm(ip(v)))[ks:ke]
            u_at_v = 0.25 * (u + im(u) + jp(u) + im(jp(u)))[ks:ke]
            t["u"] = add_rows(t["u"], ks, ke, fc * (v_at_u + ctx.vtrans - vg))
            t["v"] = add_rows(t["v"], ks, ke, -fc * (u_at_v + ctx.utrans - ug))

        for name in self.lslist:
            t[name] = add_rows(t[name], ks, ke, ctx.tensor(self.ls_profs[name]))

        if self.swwls in ("mean", "local"):
            wls = ctx.tensor(self.wls[:, None, None])
            names = list(ctx.scalar_names)
            if self.swwls_mom:
                names += ["u", "v"]
            dzhi = ctx.dzhi
            for name in names:
                a = s[name]
                if self.swwls == "mean":
                    # advec_wls_2nd on the mean profile (force.cxx:324-335)
                    a = torch.mean(a, dim=(1, 2), keepdim=True)
                ddz_dn = (a[ks:ke] - a[ks - 1:ke - 1]) * dzhi[ks:ke][:, None, None]
                ddz_up = (a[ks + 1:ke + 1] - a[ks:ke]) * dzhi[ks + 1:ke + 1][:, None, None]
                t[name] = add_rows(t[name], ks, ke,
                                   torch.where(wls > 0., -wls * ddz_dn, -wls * ddz_up))
        return t


def foldable_geo(force):
    """True when the forcing is a static geostrophic wind and nothing else,
    which a tendency kernel folds in whole (the gate of
    microhh_tpu/model.py:763-766); any other forcing runs as this op."""
    return (isinstance(force, Force) and force.swlspres == "geo"
            and not force.tdep_geo and force.swls == "0"
            and force.swwls == "0" and force.swnudge == "0")


class NoForce:
    def __call__(self, ctx, s, t, aux, sfc=None):
        return t


def make_force(ini, grid, fields, input_nc):
    swlspres = ini.get_str("force", "swlspres", default="0")
    swls = ini.get_str("force", "swls", default="0")
    swwls = ini.get_str("force", "swwls", default="0")
    swnudge = ini.get_str("force", "swnudge", default="0")
    if swlspres in ("0", "false") and swls == "0" and swwls == "0" and swnudge == "0":
        return NoForce()
    return Force(ini, grid, fields, input_nc)
