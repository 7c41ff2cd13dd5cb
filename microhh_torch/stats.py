"""Statistics of the default mask: horizontally averaged profiles and time
series to NetCDF (``microhh_tpu/stats.py``; reference ``src/stats.cxx``).

One file ``<sim>.default.<starttime>.nc`` with dims z/zh/time, ``time`` and
``iter`` at the root and the profiles in per-component groups ("default",
"thermo", "budget"), with ``area``/``areah`` (stats.cxx:627-694).  The
profile operations are the JAX package's: mean, moments 2-4, resolved
w-flux, gradient, diffusive and total flux (stats.cxx:865-905); the surface
series (ustar, obuk, *_bot), zi, the moist cloud diagnostics and the
Smagorinsky eddy viscosity; budgets through ``budget.Budget``.

Every reduction runs in plain torch on the model's device; one sample makes
one host transfer.  The file is netCDF-4 with groups (``utils/nc``, the JAX
package's layout) where h5py imports, else netCDF-3 through scipy
(``utils/nc_classic``), whose read side presents the same groups.

Masks (``masklist``, ``xymasklist``) and ``swtendency`` raise item 8 in
``model.check_slice``.
"""

import os
import re

import numpy as np
import torch

from .ops.boundary import ghost_filled
from .ops.stencil import i2, im, jm
from .ops.thermo_moist import (ThermoMoist, sat_adjust,
                               virtual_temperature)
from .timeloop import IFACTOR


def stats_writer():
    """(module, format) of the writer this machine has: ``utils/nc``
    (netCDF-4, groups) where h5py imports, else ``utils/nc_classic``."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        from .utils import nc_classic
        return nc_classic, "netCDF-3 64-bit offset (scipy, no h5py)"
    from .utils import nc
    return nc, "netCDF-4 (h5py)"


def open_stats(path):
    """A statistics file for reading, in either format: netCDF-3 (the
    ``CDF`` magic) through ``utils/nc_classic``, else ``utils/nc``.  Both
    present ``variables`` at the root and ``groups[name].variables``."""
    with open(path, "rb") as f:
        magic = f.read(3)
    if magic == b"CDF":
        from .utils import nc_classic as nc
    else:
        from .utils import nc
    return nc.Dataset(path, "r")


class Stats:
    @staticmethod
    def consume_options(ini):
        """Read the [stats]/[budget] options without building the writer
        (init mode, as the reference constructs Stats in every mode)."""
        ini.flag_as_used("stats", "swstats")
        if not ini.get_int("stats", "swstats", default=0):
            return
        ini.get_float("stats", "sampletime")
        ini.get_bool("stats", "swtendency", default=False)
        ini.get_list(str, "stats", "whitelist", default=[])
        ini.get_list(str, "stats", "blacklist", default=[])
        ini.get_list(str, "stats", "masklist", default=[])
        ini.get_list(str, "stats", "xymasklist", default=[])
        ini.get_str("budget", "swbudget", default="0")

    def __init__(self, model):
        ini = model.ini
        self.model = model
        self.sampletime = ini.get_float("stats", "sampletime")
        self.isampletime = int(self.sampletime * IFACTOR + 0.5)
        ini.flag_as_used("stats", "swstats")

        g = model.grid
        tl = model.timeloop
        nc, self.format = stats_writer()
        self.path = os.path.join(model.workdir, "%s.default.%07d.nc"
                                 % (model.casename or "run", tl.iotime))
        print("stats: writing %s as %s" % (self.path, self.format),
              flush=True)
        f = nc.Dataset(self.path, "w")
        f.createDimension("z", g.ktot)
        f.createDimension("zh", g.ktot + 1)
        f.createDimension("time", None)
        vz = f.createVariable("z", "f8", ("z",))
        vz[:] = g.z[g.kstart:g.kend]
        vzh = f.createVariable("zh", "f8", ("zh",))
        vzh[:] = g.zh[g.kstart:g.kend + 1]
        self.v_time = f.createVariable("time", "f8", ("time",))
        self.v_iter = f.createVariable("iter", "i4", ("time",))

        self.file = f
        self.groups = {}
        self.vars = {}
        self._idx = 0

        self._whitelist = ini.get_list(str, "stats", "whitelist", default=[])
        self._blacklist = ini.get_list(str, "stats", "blacklist", default=[])

        from .budget import Budget
        self.budget = Budget(model)
        self._register(model)
        self.budget.register(self)

    def _group(self, name):
        if name not in self.groups:
            self.groups[name] = self.file.createGroup(name)
        return self.groups[name]

    def _allowed(self, name):
        """[stats] whitelist/blacklist regex filters (stats.cxx:558,
        include/stats.h:90,178-185): whitelist (if set) must match; any
        blacklist match drops the variable."""
        if self._whitelist and not any(re.fullmatch(w, name)
                                       for w in self._whitelist):
            return False
        if any(re.fullmatch(b, name) for b in self._blacklist):
            return False
        return True

    def add_prof(self, name, longname, unit, zdim, group="default"):
        if not self._allowed(name):
            return
        g = self._group(group)
        v = g.createVariable(name, "f8", ("time", zdim))
        v.setncattr("units", unit)
        v.setncattr("long_name", longname)
        self.vars[name] = v

    def add_time_series(self, name, longname, unit, group="default"):
        if not self._allowed(name):
            return
        g = self._group(group)
        v = g.createVariable(name, "f8", ("time",))
        v.setncattr("units", unit)
        v.setncattr("long_name", longname)
        self.vars[name] = v

    def _register(self, model):
        fields = model.fields
        names = [n for n in fields.prognostic_names if n != "w"]
        for name in names:
            zdim = "z"
            self.add_prof(name, name, "-", zdim)
            for mom in ("2", "3", "4"):
                self.add_prof(name + "_" + mom, "moment %s of %s" % (mom, name), "-", zdim)
            self.add_prof(name + "_w", "Resolved flux of %s" % name, "-", "zh")
            self.add_prof(name + "_grad", "Gradient of %s" % name, "-", "zh")
            self.add_prof(name + "_diff", "Diffusive flux of %s" % name, "-", "zh")
            self.add_prof(name + "_flux", "Total flux of %s" % name, "-", "zh")
        self.add_prof("w", "w", "m s-1", "zh")
        for mom in ("2", "3", "4"):
            self.add_prof("w_" + mom, "moment %s of w" % mom, "-", "zh")
        self.add_prof("p", "Pressure", "Pa", "z")
        if getattr(model.diff, "cs", None) is not None:
            self.add_prof("evisc", "Eddy viscosity", "m2 s-1", "z")
        self.add_prof("area", "Fractional area contained in mask", "-", "z")
        self.add_prof("areah", "Fractional area contained in mask", "-", "zh")
        bnd = model.boundary
        if getattr(bnd, "is_surface", False):
            self.add_time_series("ustar", "Surface friction velocity", "m s-1")
            self.add_time_series("obuk", "Obukhov length", "m")
        if getattr(bnd, "sw_charnock", False):
            self.add_time_series("z0m", "Roughness length momentum", "m")
            self.add_time_series("z0h", "Roughness length heat", "m")
        if getattr(bnd, "is_lsm", False):
            for name, ln, unit in (("H", "Sensible heat flux", "W m-2"),
                                   ("LE", "Latent heat flux", "W m-2"),
                                   ("G", "Soil heat flux", "W m-2"),
                                   ("wl", "Liquid water reservoir", "m")):
                self.add_time_series(name, ln, unit, "land_surface")
            if getattr(bnd, "sw_tile_stats", False):
                for tile in ("veg", "soil", "wet"):
                    for pre, unit in (("H", "W m-2"), ("LE", "W m-2"),
                                      ("G", "W m-2"), ("c", "-")):
                        self.add_time_series("%s_%s" % (pre, tile),
                                             "%s of %s tile" % (pre, tile),
                                             unit, "land_surface_tiles")
        micro_sw = getattr(model.micro, "sw", None)
        for name, ln in (("rr", "Mean surface rain rate"),
                         ("rs", "Mean surface snow rate"),
                         ("rg", "Mean surface graupel rate")):
            if micro_sw == "nsw6" or (name == "rr" and micro_sw == "2mom_warm"):
                self.add_time_series(name, ln, "kg m-2 s-1", "thermo")
        for name in fields.sp:
            self.add_time_series(name + "_bot", "Surface " + name, "-")
        if getattr(model.thermo, "scalars", ()):
            self.add_time_series("zi", "Boundary Layer Depth", "m", "thermo")
        if isinstance(model.thermo, ThermoMoist):
            # moist diagnostic profiles (thermo_moist.cxx:1777-1819) and the
            # cloud diagnostics of ql/qi/qlqi (:1791-1805)
            self.add_prof("thv", "Virtual potential temperature", "K",
                          "z", "thermo")
            self.add_prof("thv_2", "Variance of thv", "K2", "z", "thermo")
            self.add_prof("T", "Absolute temperature", "K", "z", "thermo")
            self.add_prof("T_2", "Variance of T", "K2", "z", "thermo")
            self.add_prof("rh", "Relative humidity", "-", "z", "thermo")
            self.add_prof("qsat", "Saturation specific humidity", "kg kg-1",
                          "z", "thermo")
            for base in ("ql", "qi", "qlqi"):
                self.add_prof(base, "%s mixing ratio" % base, "kg kg-1",
                              "z", "thermo")
                self.add_prof(base + "_frac", "%s cloud fraction" % base,
                              "-", "z", "thermo")
                self.add_time_series(base + "_path", "%s water path" % base,
                                     "kg m-2", "thermo")
                self.add_time_series(base + "_cover", "%s projected cover" % base,
                                     "-", "thermo")
        # radiation flux profiles (radiation_rrtmgp.cxx:620-642,
        # radiation_gcss.cxx:445-446); no radiation scheme is ported yet
        rad = getattr(model, "radiation", None)
        if getattr(rad, "sw", None) == "rrtmgp":
            sfxs = [""] + (["_clear"] if rad.sw_clear_sky_stats else [])
            for sfx in sfxs:
                if rad.sw_longwave:
                    for d in ("up", "dn"):
                        self.add_prof("lw_flux_%s%s" % (d, sfx),
                                      "Longwave %swelling flux" % d,
                                      "W m-2", "zh", "radiation")
                if rad.sw_shortwave:
                    for d in ("up", "dn", "dn_dir"):
                        self.add_prof("sw_flux_%s%s" % (d, sfx),
                                      "Shortwave %s flux" % d,
                                      "W m-2", "zh", "radiation")
            if rad.sw_shortwave:
                self.add_time_series("sza", "Solar zenith angle", "rad",
                                     "radiation")
                self.add_time_series("sw_flux_dn_toa",
                                     "Shortwave downwelling TOA flux",
                                     "W m-2", "radiation")
        elif getattr(rad, "sw", None) == "gcss":
            self.add_prof("sflx", "Total shortwave radiative flux",
                          "W m-2", "z", "radiation")
            self.add_prof("lflx", "Total longwave radiative flux",
                          "W m-2", "z", "radiation")

    # ------------------------------------------------------------------
    def diag(self, s, sfc, p=None):
        """Every default-mask output of one state as a dict of tensors on
        the model's device (the JAX package's ``_build_diag``)."""
        model = self.model
        ctx = model.ctx
        ks, ke = ctx.ks, ctx.ke
        fields = model.fields
        bnd = model.boundary
        is_surface = getattr(bnd, "is_surface", False)
        has_smag = getattr(model.diff, "cs", None) is not None

        def hmean(a):
            return torch.mean(a, dim=(1, 2))

        def zero(n=None):
            return torch.zeros(() if n is None else (n,), dtype=ctx.dtype,
                               device=ctx.device)

        out = {}
        s = ghost_filled(bnd, ctx, s, sfc)
        aux = model.diff.exec_viscosity(ctx, s, sfc, {}) if has_smag else {}

        scalars = [n for n in fields.prognostic_names if n != "w"]
        w = s["w"]
        dzhi = ctx.dzhi
        for name in scalars:
            a = s[name]
            amean_full = torch.mean(a, dim=(1, 2), keepdim=True)
            out[name] = hmean(a[ks:ke])
            for mom in (2, 3, 4):
                out["%s_%d" % (name, mom)] = hmean(((a - amean_full) ** mom)[ks:ke])
            # resolved flux at half levels ks..ke
            if name == "u":
                wloc = i2(im(w), w)
            elif name == "v":
                wloc = i2(jm(w), w)
            else:
                wloc = w
            flux = zero(ke - ks + 1)
            flux[1:-1] = hmean(wloc[ks + 1:ke] * i2(a[ks:ke - 1], a[ks + 1:ke]))
            out[name + "_w"] = flux
            # gradient at half levels
            grad = zero(ke - ks + 1)
            grad[1:-1] = hmean(a[ks + 1:ke] - a[ks:ke - 1]) * dzhi[ks + 1:ke]
            grad[0] = torch.mean(a[ks] - a[ks - 1]) * dzhi[ks]
            grad[-1] = torch.mean(a[ke] - a[ke - 1]) * dzhi[ke]
            out[name + "_grad"] = grad
            # diffusive flux
            dflux = zero(ke - ks + 1)
            if has_smag:
                evisc = aux["evisc"]
                tPr = model.diff.tPr
                if name in ("u", "v"):
                    ev_s = im(evisc) if name == "u" else jm(evisc)
                    evh = 0.25 * (ev_s[ks + 1:ke] + evisc[ks + 1:ke]
                                  + ev_s[ks:ke - 1] + evisc[ks:ke - 1]) + fields.visc
                else:
                    evh = (0.5 * (evisc[ks + 1:ke] + evisc[ks:ke - 1]) / tPr
                           + model.diff.viscs.get(name, fields.visc))
                din = -hmean(evh * (a[ks + 1:ke] - a[ks:ke - 1])) * dzhi[ks + 1:ke]
            else:
                visc = (fields.visc if name in ("u", "v")
                        else getattr(model.diff, "viscs", {}).get(name, fields.visc))
                din = -visc * hmean(a[ks + 1:ke] - a[ks:ke - 1]) * dzhi[ks + 1:ke]
            dflux[1:-1] = din
            if is_surface and name + "_fluxbot" in sfc:
                dflux[0] = torch.mean(sfc[name + "_fluxbot"])
            out[name + "_diff"] = dflux
            out[name + "_flux"] = out[name + "_w"] + dflux

        out["w"] = hmean(w[ks:ke + 1])
        wmean_full = torch.mean(w, dim=(1, 2), keepdim=True)
        for mom in (2, 3, 4):
            out["w_%d" % mom] = hmean(((w - wmean_full) ** mom)[ks:ke + 1])

        if has_smag:
            out["evisc"] = hmean(aux["evisc"][ks:ke])
        out["area"] = zero(ke - ks) + 1.
        out["areah"] = zero(ke - ks + 1) + 1.

        if is_surface:
            out["ustar"] = torch.mean(sfc["ustar"])
            out["obuk"] = torch.mean(sfc["obuk"])
            for name in fields.sp:
                out[name + "_bot"] = torch.mean(sfc[name + "_bot"])
            if getattr(bnd, "sw_charnock", False):
                out["z0m"] = torch.mean(sfc["z0m"])
                out["z0h"] = torch.mean(sfc["z0h"])
            if getattr(bnd, "is_lsm", False):
                for key in ("H", "LE", "G"):
                    out[key] = torch.mean(sfc[key])
                out["wl"] = torch.mean(s["wl"])
                if getattr(bnd, "sw_tile_stats", False):
                    for tile in ("veg", "soil", "wet"):
                        for pre in ("H", "LE", "G", "c"):
                            key = "%s_%s" % (pre, tile)
                            out[key] = torch.mean(sfc[key])
        micro_sw = getattr(model.micro, "sw", None)
        if micro_sw in ("2mom_warm", "nsw6"):
            # the viscosity's aux carries no surface rain rate, so these
            # are zero, as in the JAX package
            keys = ("rr",) if micro_sw == "2mom_warm" else ("rr", "rs", "rg")
            for key in keys:
                out[key] = torch.mean(aux.get(key + "_bot", zero()))
        else:
            # the JAX package writes zeros over the surface values here
            for name in fields.sp:
                out[name + "_bot"] = zero()

        # zi: height of the max gradient of the first thermo scalar
        # (thermo_dry.cxx calc_zi)
        tsc = getattr(model.thermo, "scalars", ())
        if tsc:
            prof = hmean(s[tsc[0]][ks:ke])
            kinv = torch.argmax(prof[1:] - prof[:-1]) + 1
            out["zi"] = ctx.z[ks:ke][kinv]

        if isinstance(model.thermo, ThermoMoist):
            rho = ctx.rhoref[ks:ke][:, None, None]
            dzc = ctx.dz[ks:ke][:, None, None]

            def cloud(base, q):
                out[base] = hmean(q)
                out[base + "_frac"] = hmean((q > 0.).to(ctx.dtype))
                out[base + "_path"] = torch.mean(torch.sum(rho * q * dzc, dim=0))
                out[base + "_cover"] = torch.mean(
                    torch.any(q > 0., dim=0).to(ctx.dtype))

            th = model.thermo
            pref_a, exnref_a, _, _ = th._p_profiles(ctx, None)
            pz = pref_a[ks:ke][:, None, None]
            exn = exnref_a[ks:ke][:, None, None]
            thl, qt = s["thl"][ks:ke], s["qt"][ks:ke]
            ql, qi, T, qs = sat_adjust(thl, qt, pz, exn, reads=th.reads)
            cloud("ql", ql)
            cloud("qi", qi)
            cloud("qlqi", ql + qi)
            thv = virtual_temperature(exn, thl, qt, ql, qi)
            for nm, fld in (("thv", thv), ("T", T)):
                mean = torch.mean(fld, dim=(1, 2), keepdim=True)
                out[nm] = mean[:, 0, 0]
                out[nm + "_2"] = hmean((fld - mean) ** 2)
            out["rh"] = hmean(torch.clamp(qt / qs, max=1.))
            out["qsat"] = hmean(qs)

        if self.budget.sw:
            out.update(self.budget.profiles(ctx, s, {"p": p} if p is not None
                                            else None))

        # radiation flux profiles (no radiation scheme is ported yet)
        rad = getattr(model, "radiation", None)
        time_ = model.timeloop.time
        if getattr(rad, "sw", None) == "rrtmgp" and (rad.sw_longwave
                                                     or rad.sw_shortwave):
            out.update(rad.flux_profiles(ctx, s, time_, model.thermo))
            if rad.sw_clear_sky_stats:
                out.update(rad.flux_profiles(ctx, s, time_, model.thermo,
                                             clear=True))
            if rad.sw_shortwave:
                sza, toa = rad.solar_series(ctx, time_)
                out["sza"], out["sw_flux_dn_toa"] = (
                    torch.as_tensor(sza, dtype=ctx.dtype, device=ctx.device),
                    torch.as_tensor(toa, dtype=ctx.dtype, device=ctx.device))
        elif getattr(rad, "sw", None) == "gcss":
            out.update(rad.flux_profiles(ctx, s, time_, model.thermo))
        return out

    # ------------------------------------------------------------------
    def do_statistics(self, itime):
        return itime % self.isampletime == 0

    def to_host(self, out):
        """The outputs as float64 numpy arrays, in one device-to-host copy."""
        names = list(out)
        flat = [out[n].reshape(-1).to(torch.float64) for n in names]
        host = torch.cat(flat).cpu().numpy()
        res, i = {}, 0
        for n, f in zip(names, flat):
            res[n] = host[i:i + f.numel()].reshape(out[n].shape)
            i += f.numel()
        return res

    def maybe_exec(self, model, s, sfc):
        """Write a sample at a sampling time; ``p`` for the budgets from
        the last step's aux."""
        tl = model.timeloop
        if not self.do_statistics(tl.itime):
            return
        aux = getattr(model, "_last_aux", None)
        p = aux.get("p") if aux else None
        out = self.to_host(self.diag(s, sfc, p))
        i = self._idx
        self.v_time[i] = tl.time
        self.v_iter[i] = tl.iteration
        for name, v in out.items():
            if name in self.vars:
                self.vars[name][i] = v
        self._idx += 1
        self.file.sync()

    def close(self):
        self.file.close()
