"""Gaussian point and line emission sources of scalars
(``microhh_tpu/ops/source.py``; reference ``src/source.cxx``).

Each source adds ``strength / norm * exp(-((x-x0)/sx)^2 - ...)`` to one
scalar's tendency; ``norm`` is the discrete integral of the blob, so the
emitted mass rate equals ``strength`` exactly (source.cxx:110-165).  A line
source flattens the Gaussian over [x0, x0 + line_x].  With ``swvmr`` the
strength is in kmol(tracer)/s and the norm is weighted with rho/xmair, so
the tendency is a volume mixing ratio (source.cxx:217-221, 450-460).

The blobs and their norms are built on the host in float64 with the JAX
package's expressions, after the base state exists (the norm reads the
anelastic density); the blobs of one scalar are summed into one tensor of
the run's type on its device, so a substep adds one field per sourced
scalar.  ``sw_profile`` takes the z-shape from ``emission_profile_<i>`` of
the init group.  With ``swtimedep_location`` or ``swtimedep_strength``
(source.cxx:215-236, 318-404) the series ``source_{x0,y0,z0,strength}_<n>``
over ``time_source`` are interpolated on the host every iteration into
``sfc["__src_<key>"]`` (float64 scalars on the model's device), and every
substep builds each blob and its norm anew on the device in the run's
dtype, as the JAX package's ``_exec_timedep`` does.
"""

import numpy as np
import torch

from .. import constants as cst
from ..timedep import Timedep, sfc_device


def axis_dist(c, c0, line):
    """Distance of c from the point c0 or from the segment [c0, c0+line]
    (numpy arrays, or tensors with c0 a 0-dim tensor)."""
    if line == 0.:
        return c - c0
    where = torch.where if torch.is_tensor(c) else np.where
    return where(c < c0, c - c0, where(c > c0 + line, c - c0 - line, 0.))


class Source:
    def __init__(self, ini, grid, fields, input_nc=None):
        self.sourcelist = ini.get_list(str, "source", "sourcelist")
        n = len(self.sourcelist)

        def getlist(name):
            return ini.get_list(float, "source", name)

        self.x0, self.y0, self.z0 = (getlist("source_" + c)
                                     for c in ("x0", "y0", "z0"))
        self.sx, self.sy, self.sz = (getlist("sigma_" + c) for c in "xyz")
        self.strength = getlist("strength")
        self.line = [ini.get_list(float, "source", "line_" + c,
                                  default=[0.] * n) for c in "xyz"]
        swvmr = ini.get_list(str, "source", "swvmr", default=["false"] * n)
        self.swvmr = [v.lower() in ("1", "true") for v in swvmr]
        self.grid = grid
        self.fields = fields
        self.total = None   # built at first use, after create_basestate

        self.sw_profile = ini.get_bool("source", "sw_profile", default=False)
        self.profiles = None
        if self.sw_profile:
            if any(v != 0. for line in self.line for v in line):
                raise ValueError("Emission profiles with line emissions are "
                                 "not supported (source.cxx:242)")
            idx = ini.get_list(int, "source", "profile_index")
            init = input_nc.groups["init"]
            self.profiles = [np.asarray(
                init.variables["emission_profile_%d" % i][:grid.ktot],
                dtype=np.float64) for i in idx]
        # the interpolated parameters by key, source_<c>_<n>
        self.tdep = {}
        timedep = {c: ini.get_bool("source", "swtimedep_" + c, default=False)
                   for c in ("location", "strength")}
        if self.sw_profile and any(timedep.values()):
            raise ValueError("Emission profiles with time dependent location/"
                             "strength are not supported (source.cxx:383)")
        keys = ((["x0", "y0", "z0"] if timedep["location"] else [])
                + (["strength"] if timedep["strength"] else []))
        for i in range(n):
            for c in keys:
                key = "source_%s_%d" % (c, i)
                self.tdep[key] = Timedep(input_nc, key, "time_source")

    def update_timedep(self, sfc, itime):
        """sfc with this iteration's locations and strengths."""
        if not self.tdep:
            return sfc
        sfc = dict(sfc)
        device = sfc_device(sfc)
        for key, td in self.tdep.items():
            sfc["__src_" + key] = torch.tensor(float(td.interpolate(itime)),
                                               dtype=torch.float64,
                                               device=device)
        return sfc

    def blobs(self):
        """(scalar, normalised 3-D source field in float64) per source, on
        the interior levels."""
        g = self.grid
        ks, ke = g.kstart, g.kend
        X = g.x[None, None, :]
        Y = g.y[None, :, None]
        Z = g.z[ks:ke][:, None, None]
        dV = g.dx * g.dy * g.dz[ks:ke][:, None, None]
        rho = self.fields.rhoref[ks:ke][:, None, None]
        for n, name in enumerate(self.sourcelist):
            ex = axis_dist(X, self.x0[n], self.line[0][n]) / self.sx[n]
            ey = axis_dist(Y, self.y0[n], self.line[1][n]) / self.sy[n]
            if self.sw_profile:
                blob = (np.exp(-ex ** 2 - ey ** 2)
                        * self.profiles[n][:, None, None])
            else:
                ez = axis_dist(Z, self.z0[n], self.line[2][n]) / self.sz[n]
                blob = np.exp(-ex ** 2 - ey ** 2 - ez ** 2)
            scaling = rho / cst.xmair if self.swvmr[n] else 1.
            norm = float(np.sum(blob * scaling * dV))
            yield name, (self.strength[n] / norm) * blob

    def __call__(self, ctx, s, t, aux, sfc=None):
        """Add every source into its scalar's carry, in place."""
        if self.tdep:
            return self._exec_timedep(ctx, t, sfc)
        if self.total is None:
            self.total = {}
            for name, blob in self.blobs():
                field = ctx.tensor(blob)
                if name in self.total:
                    self.total[name] += field
                else:
                    self.total[name] = field
        for name, field in self.total.items():
            t[name][ctx.ks:ctx.ke] += field
        return t


    def _exec_timedep(self, ctx, t, sfc):
        """The blobs and their norms from this iteration's parameters, on
        the device in the run's dtype (source.cxx:362-404 recomputes them
        on the host every step), each source added in turn."""
        g = self.grid
        ks, ke = ctx.ks, ctx.ke
        X = ctx.tensor(g.x)[None, None, :]
        Y = ctx.tensor(g.y)[None, :, None]
        Z = ctx.tensor(g.z[ks:ke])[:, None, None]
        dV = g.dx * g.dy * ctx.tensor(g.dz[ks:ke])[:, None, None]
        rho = ctx.tensor(self.fields.rhoref[ks:ke])[:, None, None]

        def param(c, n, default):
            key = "__src_source_%s_%d" % (c, n)
            if sfc is not None and key in sfc:
                return sfc[key].to(ctx.dtype)
            return torch.tensor(default, dtype=ctx.dtype, device=ctx.device)

        for n, name in enumerate(self.sourcelist):
            x0, y0, z0 = (param(c, n, getattr(self, c)[n])
                          for c in ("x0", "y0", "z0"))
            strength = param("strength", n, self.strength[n])
            blob = torch.exp(
                -(axis_dist(X, x0, self.line[0][n]) / self.sx[n]) ** 2
                - (axis_dist(Y, y0, self.line[1][n]) / self.sy[n]) ** 2
                - (axis_dist(Z, z0, self.line[2][n]) / self.sz[n]) ** 2)
            scaling = rho / cst.xmair if self.swvmr[n] else 1.
            norm = torch.sum(blob * scaling * dV)
            t[name][ks:ke] += (strength / norm) * blob
        return t


def make_source(ini, grid, fields, input_nc=None):
    if ini.get_str("source", "swsource", default="0") in ("0", "false"):
        return None
    return Source(ini, grid, fields, input_nc)
