"""Cross sections, dumps and column output (``microhh_tpu/output.py``;
reference ``src/cross.cxx``, ``src/dump.cxx``, ``src/column.cxx``).

The files are the reference's, so its post-processing tools read them:
a cross file ``<var>.<xz|yz|xy>.<idx>.<iotime>`` holds one raw slice, a
dump ``<var>.<iotime>`` the raw interior field, and the column file
``<case>.column.<iotime>.nc`` per-(x, y) profiles over time.  The model's
tensors come to the host once a sample; what is computed from them there
(log gradients, paths, cloud base and top) is the JAX package's numpy, in
the run's precision, so that the two packages write the same bytes from the
same state.  Radiation and soil variables have no source in the port yet
(ROADMAP items 13 and 14c): a crosslist or column entry of theirs is left
out, as the JAX package leaves it out without radiation or a land surface.
"""

import os

import numpy as np
import torch

from .timeloop import IFACTOR

# radiation flux cross variables (radiation_rrtmgp.cxx exec_all_stats)
_RAD_FLUX_NAMES = frozenset(
    b + sfx for b in ("lw_flux_up", "lw_flux_dn", "sw_flux_up",
                      "sw_flux_dn", "sw_flux_dn_dir")
    for sfx in ("", "_clear"))
_RADIATION = _RAD_FLUX_NAMES | {"sflx", "lflx", "sw_flux_dn_diff_filtered"}


def host(a):
    """A tensor (or a number) as a numpy array on the host."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class Cross:
    """``[cross] swcross``: xz, yz and xy slices of the crosslist at the
    levels and rows nearest the ini's coordinates, every sampletime."""

    def __init__(self, model):
        ini = model.ini
        self.sw = ini.get_str("cross", "swcross", default="0") not in ("0", "false")
        if not self.sw:
            return
        self.sampletime = ini.get_float("cross", "sampletime")
        self.isampletime = int(self.sampletime * IFACTOR + 0.5)
        self.crosslist = ini.get_list(str, "cross", "crosslist", default=[])
        g = model.grid
        self.model = model

        def nearest(vals, coords):
            return [int(np.abs(coords - v).argmin()) for v in vals]

        xz = ini.get_list(float, "cross", "xz", default=[])
        yz = ini.get_list(float, "cross", "yz", default=[])
        xy = ini.get_list(float, "cross", "xy", default=[])
        self.jxz = nearest(xz, g.y)
        self.jxzh = nearest(xz, g.yh)
        self.ixz = nearest(yz, g.x)
        self.ixzh = nearest(yz, g.xh)
        self.kxy = nearest(xy, g.z[g.kstart:g.kend])
        self.kxyh = nearest(xy, g.zh[g.kstart:g.kend + 1])
        if ini.get_list(float, "cross", "xy_soil", default=[]):
            # soil cross levels need the land surface (cross.cxx:283)
            raise ValueError("[cross] xy_soil requires the land surface")

    @property
    def np_dtype(self):
        return {torch.float32: np.float32,
                torch.float64: np.float64}[self.model.dtype]

    def do_cross(self, itime):
        return self.sw and itime % self.isampletime == 0

    def _plane(self, data, name, iotime):
        """A 2-D xy plane, <name>.xy.<iotime> (cross.cxx:639-652), in the
        run's precision."""
        fname = "%s.xy.%07d" % (name, iotime)
        host(data).astype(self.np_dtype).tofile(
            os.path.join(self.model.workdir, fname))

    def _field(self, base, s, aux, cache):
        """A crosslist field on the host, full column (ghost levels
        included where the model has them): the prognostics, p, and the
        thermo's diagnostics (thermo_moist.cxx:1860-1866: b, ql, qi,
        qlqi, qsat, T); None for a field the run does not have."""
        if base in cache:
            return cache[base]
        m = self.model
        g = m.grid
        ks, ke = g.kstart, g.kend

        def interior(a):
            full = np.zeros((g.kcells, g.jtot, g.itot), dtype=self.np_dtype)
            full[ks:ke] = host(a)
            return full

        th = m.thermo
        out = None
        if base in s:
            out = host(s[base])
        elif base == "p" and aux is not None and aux.get("p") is not None:
            # the 2nd-order solvers keep the interior pressure
            p = aux["p"]
            out = host(p) if p.shape[0] == g.kcells else interior(p)
        elif base == "b" and hasattr(th, "get_buoyancy"):
            b = host(th.get_buoyancy(m.ctx, s))
            out = b if b.shape[0] == g.kcells else interior(b[ks:ke])
        elif base in ("ql", "qi", "qlqi", "T", "qsat") and hasattr(th, "get_ql"):
            from .ops.thermo_moist import sat_adjust
            pref, exnref, _, _ = th._p_profiles(m.ctx, None)
            p = pref[ks:ke][:, None, None]
            exn = exnref[ks:ke][:, None, None]
            ql, qi, T, qs = sat_adjust(s["thl"][ks:ke], s["qt"][ks:ke], p,
                                       exn)
            out = interior({"ql": ql, "qi": qi, "qlqi": ql + qi, "T": T,
                            "qsat": qs}[base])
        cache[base] = out
        return out

    def exec(self, s, aux, iotime, sfc=None):
        """Write every crosslist entry of the state s (the last step's aux
        for p) at iotime."""
        if not self.sw:
            return
        m = self.model
        g = m.grid
        ks, ke = g.kstart, g.kend
        cache = {}
        for name in self.crosslist:
            if name in _RADIATION:
                # no radiation in the port yet: left out, as the JAX
                # package leaves it out without radiation
                continue
            if name == "w500hpa":
                self._w500hpa(s, aux, iotime)
                continue
            # 2-D planes: surface-state entries (<s>bot, <s>fluxbot, ustar,
            # obuk, ...) and the aux planes
            if sfc is not None:
                key = None
                if (name.endswith("bot") and not name.endswith("fluxbot")
                        and (name[:-3] + "_bot") in sfc):
                    key = name[:-3] + "_bot"
                elif name.endswith("fluxbot") and (name[:-7] + "_fluxbot") in sfc:
                    key = name[:-7] + "_fluxbot"
                elif name in sfc:
                    key = name
                if key is not None:
                    self._plane(sfc[key], name, iotime)
                    continue
            if aux is not None and name in aux and name != "p":
                self._plane(aux[name], name, iotime)
                continue
            # cloud base and top height maps (cross_height; NaN where the
            # column is cloud-free)
            if name in ("qlbase", "qltop", "qlqibase", "qlqitop"):
                q = self._field("ql" if name in ("qlbase", "qltop")
                                else "qlqi", s, aux, cache)
                if q is None:
                    continue
                cloudy = q[ks:ke] > 0.
                zc = np.asarray(g.z)[ks:ke]
                kidx = np.arange(cloudy.shape[0])[:, None, None]
                anyc = cloudy.any(axis=0)
                if name.endswith("base"):
                    kk = np.where(cloudy, kidx, cloudy.shape[0]).min(axis=0)
                else:
                    kk = np.where(cloudy, kidx, -1).max(axis=0)
                h = np.where(anyc, zc[np.clip(kk, 0, len(zc) - 1)], np.nan)
                self._plane(h, name, iotime)
                continue
            # <s>path: density-weighted vertical integral (cross_path)
            if name.endswith("path"):
                base = self._field(name[:-4], s, aux, cache)
                if base is None:
                    continue
                rho = np.asarray(m.fields.rhoref)[ks:ke][:, None, None]
                dz = np.asarray(g.dz)[ks:ke][:, None, None]
                self._plane((rho * dz * base[ks:ke]).sum(axis=0), name, iotime)
                continue
            # <s>lngrad: the log of the squared gradient (calc_lngrad_2nd)
            if name.endswith("lngrad"):
                a = self._field(name[:-6], s, aux, cache)
                if a is None:
                    continue
                gx = 0.5 * (np.roll(a, -1, -1) - np.roll(a, 1, -1)) * g.dxi
                gy = 0.5 * (np.roll(a, -1, -2) - np.roll(a, 1, -2)) * g.dyi
                dzi = np.asarray(g.dzi)[:, None, None]
                gz = np.zeros_like(a)
                gz[ks:ke] = 0.5 * (a[ks + 1:ke + 1] - a[ks - 1:ke - 1]) * dzi[ks:ke]
                data = np.log(1e-30 + gx ** 2 + gy ** 2 + gz ** 2).astype(
                    self.np_dtype)
                self._slices(data, name, (0, 0, 0), 0., iotime)
                continue
            data = self._field(name, s, aux, cache)
            if data is None:
                continue
            loc = m.fields.mp[name].loc if name in m.fields.mp else (0, 0, 0)
            offset = g.utrans if name == "u" else (g.vtrans if name == "v" else 0.)
            self._slices(data, name, loc, offset, iotime)

    def _w500hpa(self, s, aux, iotime):
        """w at the first half level above 500 hPa (thermo_moist.cxx:299
        calc_w500hpa); only a moist run has the pressure profile."""
        m = self.model
        th = m.thermo
        if not hasattr(th, "_p_profiles"):
            return
        ks, ke = m.grid.kstart, m.grid.kend
        _, _, prefh, _ = th._p_profiles(m.ctx, aux)
        above = np.nonzero(host(prefh)[ks:ke + 1] <= 5.e4)[0]
        if above.size == 0 or above[0] in (0, ke - ks):
            raise RuntimeError("w500hpa: no 500 hPa level inside the domain")
        self._plane(s["w"][ks + above[0]], "w500hpa", iotime)

    def _slices(self, data, name, loc, offset, iotime):
        m = self.model
        g = m.grid
        ks, ke = g.kstart, g.kend
        interior = data[ks:ke + (1 if loc[2] else 0)] + offset
        for j in (self.jxzh if loc[1] else self.jxz):
            fname = "%s.xz.%05d.%07d" % (name, j, iotime)
            interior[:, j, :].astype(data.dtype).tofile(
                os.path.join(m.workdir, fname))
        for i in (self.ixzh if loc[0] else self.ixz):
            fname = "%s.yz.%05d.%07d" % (name, i, iotime)
            interior[:, :, i].astype(data.dtype).tofile(
                os.path.join(m.workdir, fname))
        for k in (self.kxyh if loc[2] else self.kxy):
            fname = "%s.xy.%05d.%07d" % (name, k, iotime)
            interior[k, :, :].astype(data.dtype).tofile(
                os.path.join(m.workdir, fname))


class Dump:
    def __init__(self, model):
        ini = model.ini
        self.sw = ini.get_str("dump", "swdump", default="0") not in ("0", "false")
        if not self.sw:
            return
        self.sampletime = ini.get_float("dump", "sampletime")
        self.isampletime = int(self.sampletime * IFACTOR + 0.5)
        self.dumplist = ini.get_list(str, "dump", "dumplist", default=[])
        self.model = model

    def do_dump(self, itime):
        return itime % self.isampletime == 0

    def exec(self, s, aux, iotime):
        m = self.model
        ks, ke = m.grid.kstart, m.grid.kend
        for name in self.dumplist:
            if name in s:
                data = s[name][ks:ke]
            elif name == "p" and aux is not None and aux.get("p") is not None:
                # the port's 2nd-order solvers keep the interior pressure
                p = aux["p"]
                data = p[ks:ke] if p.shape[0] == m.grid.kcells else p
            else:
                continue
            fname = os.path.join(m.workdir, "%s.%07d" % (name, iotime))
            np.ascontiguousarray(host(data)).tofile(fname)


class Column:
    """``[column] swcolumn``: the prognostic profiles at the columns nearest
    the ini's (x, y) coordinates, every sampletime, in a netCDF time series
    (netCDF-4 where h5py imports, else netCDF-3, as the statistics'
    files)."""

    @staticmethod
    def consume_options(ini):
        """Option reads only (init mode; see Stats.consume_options)."""
        if ini.get_str("column", "swcolumn", default="0") in ("0", "false"):
            return
        ini.get_float("column", "sampletime")
        ini.get_list(float, "column", "coordinates", subitem="x", default=[])
        ini.get_list(float, "column", "coordinates", subitem="y", default=[])

    def __init__(self, model):
        ini = model.ini
        self.sw = ini.get_str("column", "swcolumn", default="0") not in ("0", "false")
        if not self.sw:
            return
        self.sampletime = ini.get_float("column", "sampletime")
        self.isampletime = int(self.sampletime * IFACTOR + 0.5)
        cx = ini.get_list(float, "column", "coordinates", subitem="x", default=[])
        cy = ini.get_list(float, "column", "coordinates", subitem="y", default=[])
        g = model.grid
        self.cols = [(int(np.abs(g.x - x).argmin()), int(np.abs(g.y - y).argmin()))
                     for x, y in zip(cx, cy)]
        self.model = model

        from .stats import stats_writer
        nc, _ = stats_writer()
        tl = model.timeloop
        path = os.path.join(model.workdir, "%s.column.%07d.nc"
                            % (model.casename or "run", tl.iotime))
        f = nc.Dataset(path, "w")
        f.createDimension("z", g.ktot)
        f.createDimension("zh", g.ktot + 1)
        f.createDimension("col", max(len(self.cols), 1))
        f.createDimension("time", None)
        f.createVariable("z", "f8", ("z",))[:] = g.z[g.kstart:g.kend]
        f.createVariable("zh", "f8", ("zh",))[:] = g.zh[g.kstart:g.kend + 1]
        self.v_time = f.createVariable("time", "f8", ("time",))
        self.vars = {}
        for name in model.fields.prognostic_names:
            zdim = "zh" if name == "w" else "z"
            self.vars[name] = f.createVariable(name, "f8", ("time", "col", zdim))
        self.file = f
        self._idx = 0

    def do_column(self, itime):
        return self.sw and itime % self.isampletime == 0

    def exec(self, s, time, sfc=None):
        if not self.sw or not self.cols:
            return
        g = self.model.grid
        ks, ke = g.kstart, g.kend
        i = self._idx
        self.v_time[i] = time
        ii = torch.tensor([c[0] for c in self.cols])
        jj = torch.tensor([c[1] for c in self.cols])
        for name, var in self.vars.items():
            hi = ke + 1 if name == "w" else ke
            a = s[name]
            # (levels, columns) in one copy to the host
            prof = host(a[ks:hi][:, jj.to(a.device), ii.to(a.device)])
            for c in range(len(self.cols)):
                var[i, c] = prof[:, c]
        self._idx += 1
        self.file.sync()

    def close(self):
        if self.sw:
            self.file.close()
