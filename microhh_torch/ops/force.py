"""Large-scale forcings (``microhh_tpu/ops/force.py``; reference
``src/force.cxx``).

Ported: ``swlspres`` in {0, geo (with Coriolis at 2nd and 4th order), dpdx,
uflux},
large-scale source terms (``swls`` + ``lslist``) and subsidence (``swwls`` = mean | local),
with profiles from the input ``init`` group.  ``swtimedep_geo``,
``swtimedep_ls`` and ``swtimedep_wls`` make the geostrophic wind, the listed
large-scale sources and the subsidence follow series of the ``timedep``
group over ``time_ls`` (force.cxx:354-415, 744-756): ``update_timedep``
interpolates them on the host every iteration into ``sfc`` (``__geo_u``,
``__geo_v``, ``__ls_<name>``, ``__wls``; float64 on the model's device), and
the consumers cast them to the run's dtype where they read them.  On the
model's generic path these collapse into the per-level tables of the
tendency kernels (ops/fused.py generic_col_tables), which do not carry
uflux; ``Force.__call__`` is their op path and what the 4th-order step
runs.  The 2nd-order Coriolis term keeps the reference's offset stencil,
the 4th-order one is centred, as in the JAX package.  Nudging is not ported
yet (ROADMAP Queue 1 item 9).
"""

import numpy as np
import torch

from .. import fd
from . import not_ported
from ..timedep import Timedep, sfc_device
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
        if ini.get_bool("force", "swtimedep_nudge", default=False):
            raise not_ported("[force] swtimedep_nudge", 9)
        self.tdep_geo = {}
        self.tdep_ls = {}
        self.tdep_wls = None
        kt = grid.ktot

        if self.swlspres == "uflux":
            self.uflux = ini.get_float("force", "uflux")
        elif self.swlspres == "dpdx":
            self.dpdx = ini.get_float("force", "dpdx")
        elif self.swlspres == "geo":
            self.fc = ini.get_float("force", "fc")
            self.ug = _prof(input_nc, "u_geo", kt)[:, None, None]
            self.vg = _prof(input_nc, "v_geo", kt)[:, None, None]
            if ini.get_bool("force", "swtimedep_geo", default=False):
                self.tdep_geo = {"u": Timedep(input_nc, "u_geo", "time_ls"),
                                 "v": Timedep(input_nc, "v_geo", "time_ls")}
        elif self.swlspres != "0":
            raise ValueError("%s is an illegal value for swlspres" % self.swlspres)

        self.lslist = []
        if self.swls == "1":
            self.lslist = ini.get_list(str, "force", "lslist", default=[])
            if ini.get_bool("force", "swtimedep_ls", default=False):
                for n in ini.get_list(str, "force", "timedeplist_ls",
                                      default=[]):
                    self.tdep_ls[n] = Timedep(input_nc, n + "_ls", "time_ls")
            # a time-dependent entry has no init profile: zeros until its
            # first update, as in the JAX package
            self.ls_profs = {n: (np.zeros((kt, 1, 1)) if n in self.tdep_ls
                                 else _prof(input_nc, n + "_ls", kt)[:, None, None])
                             for n in self.lslist}
        if self.swwls == "1":
            self.swwls = "mean"  # legacy alias
        if self.swwls in ("mean", "local"):
            self.swwls_mom = ini.get_bool("force", "swwls_mom", default=False)
            self.wls = _prof(input_nc, "w_ls", kt)
            if ini.get_bool("force", "swtimedep_wls", default=False):
                self.tdep_wls = Timedep(input_nc, "w_ls", "time_ls")
        elif self.swwls != "0":
            raise ValueError("%s is an illegal value for swwls" % self.swwls)

    @property
    def has_timedep(self):
        return bool(self.tdep_ls or self.tdep_geo or self.tdep_wls is not None)

    def update_timedep(self, sfc, itime):
        """sfc with this iteration's profiles, interpolated on the host and
        cut to ktot levels (an input may hold more levels than a run)."""
        if not self.has_timedep:
            return sfc
        kt = self.grid.ktot
        device = sfc_device(sfc)

        def prof(td):
            return torch.as_tensor(td.interpolate(itime)[:kt], device=device)

        sfc = dict(sfc)
        for n, td in self.tdep_ls.items():
            sfc["__ls_" + n] = prof(td)
        for n, td in self.tdep_geo.items():
            sfc["__geo_" + n] = prof(td)
        if self.tdep_wls is not None:
            sfc["__wls"] = prof(self.tdep_wls)
        return sfc

    def profiles(self, ctx, sfc=None):
        """This iteration's forcing columns, (ktot,) in the run's dtype on
        its device: "ug" and "vg" (swlspres geo), "ls" by name of lslist
        and "wls" (swwls); a time series' value where update_timedep put it
        into sfc, else the static profile."""
        def pick(key, static):
            if sfc is not None and key in sfc:
                return sfc[key].to(ctx.dtype)
            return ctx.tensor(np.asarray(static).reshape(-1)[:ctx.ktot])

        out = {"ls": {n: pick("__ls_" + n, self.ls_profs[n])
                      for n in self.lslist}}
        if self.swlspres == "geo":
            out["ug"] = pick("__geo_u", self.ug)
            out["vg"] = pick("__geo_v", self.vg)
        if self.swwls in ("mean", "local"):
            out["wls"] = pick("__wls", self.wls)
        return out

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
        prof = self.profiles(ctx, sfc)
        if self.swlspres == "geo":
            fc = self.fc
            ug, vg = prof["ug"][:, None, None], prof["vg"][:, None, None]
            u, v = s["u"], s["v"]
            if ctx.spatial_order == 2:
                # coriolis_2nd (force.cxx:78-140)
                v_at_u = 0.25 * (v + ip(v) + jm(v) + jm(ip(v)))[ks:ke]
                u_at_v = 0.25 * (u + im(u) + jp(u) + im(jp(u)))[ks:ke]
            else:
                # coriolis_4th (microhh_tpu/ops/force.py:153-160): centred four-point
                # interpolants in i, then in j
                ci0, ci1, ci2, ci3 = fd.ci0, fd.ci1, fd.ci2, fd.ci3

                def vi(a):
                    return ci0 * im(a, 2) + ci1 * im(a, 1) + ci2 * a + ci3 * ip(a, 1)

                def ui(a):
                    return ci0 * jm(a, 2) + ci1 * jm(a, 1) + ci2 * a + ci3 * jp(a, 1)

                v_at_u = (ci0 * vi(jm(v, 1)) + ci1 * vi(v) + ci2 * vi(jp(v, 1))
                          + ci3 * vi(jp(v, 2)))[ks:ke]
                u_at_v = (ci0 * ui(im(u, 1)) + ci1 * ui(u) + ci2 * ui(ip(u, 1))
                          + ci3 * ui(ip(u, 2)))[ks:ke]
            t["u"] = add_rows(t["u"], ks, ke, fc * (v_at_u + ctx.vtrans - vg))
            t["v"] = add_rows(t["v"], ks, ke, -fc * (u_at_v + ctx.utrans - ug))

        for name in self.lslist:
            t[name] = add_rows(t[name], ks, ke,
                               prof["ls"][name][:, None, None])

        if self.swwls in ("mean", "local"):
            wls = prof["wls"][:, None, None]
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
    def profiles(self, ctx, sfc=None):
        """This iteration's forcing columns, (ktot,) in the run's dtype on
        its device: "ug" and "vg" (swlspres geo), "ls" by name of lslist
        and "wls" (swwls); a time series' value where update_timedep put it
        into sfc, else the static profile."""
        def pick(key, static):
            if sfc is not None and key in sfc:
                return sfc[key].to(ctx.dtype)
            return ctx.tensor(np.asarray(static).reshape(-1)[:ctx.ktot])

        out = {"ls": {n: pick("__ls_" + n, self.ls_profs[n])
                      for n in self.lslist}}
        if self.swlspres == "geo":
            out["ug"] = pick("__geo_u", self.ug)
            out["vg"] = pick("__geo_v", self.vg)
        if self.swwls in ("mean", "local"):
            out["wls"] = pick("__wls", self.wls)
        return out

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
