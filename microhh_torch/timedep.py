"""Time-dependent boundary and forcing data (``microhh_tpu/timedep.py``;
reference ``src/timedep.cxx``).

Series come from the input dataset's ``timedep`` group (variable ``<name>``
over the dimension ``time_surface``, ``time_ls``, ``time_source`` or
``time_latlon``; a profile carries a z dimension) and are interpolated on
the host in float64 at the current integer time, with the interpolation
factors of the reference (``timeloop.cxx get_interpolation_factors``).  The
values enter the step as entries of the surface-state dict ``sfc``, on the
model's device, under the JAX package's key names; a consumer casts them to
the run's dtype where it uses them.
"""

import numpy as np
import torch

from .timeloop import IFACTOR

BC_SUFFIX = {"dirichlet": "_bot", "flux": "_fluxbot"}   # else _gradbot


class Timedep:
    def __init__(self, input_nc, name, dim="time_surface"):
        self.name = name
        group = input_nc.groups.get("timedep") if input_nc is not None else None
        if group is None or name not in group.variables:
            raise KeyError("timedep variable %s not found" % name)
        self.time = np.asarray(group.variables[dim][:], dtype=np.float64)
        self.data = np.asarray(group.variables[name][:], dtype=np.float64)
        self.itime = (self.time * IFACTOR + 0.5).astype(np.uint64)

    def interpolate(self, itime):
        """Linear interpolation at integer time (timeloop.cxx:603-642); a
        time outside the series raises ValueError."""
        it = np.asarray(self.itime, dtype=np.float64)
        t = float(itime)
        if t < it[0] or t > it[-1]:
            raise ValueError("Interpolation time out of range for %s" % self.name)
        i1 = int(np.searchsorted(it, t, side="right"))
        if i1 >= len(it):
            i1 = len(it) - 1
        i0 = i1 - 1
        fac0 = (it[i1] - t) / (it[i1] - it[i0])
        fac1 = (t - it[i0]) / (it[i1] - it[i0])
        return fac0 * self.data[i0] + fac1 * self.data[i1]


def sfc_device(sfc):
    """The device of the surface state's planes (the CPU for an empty
    dict): where the interpolated values go."""
    for v in sfc.values():
        return v.device
    return torch.device("cpu")


def bc_key(boundary, scalar):
    """The surface plane that a value of ``scalar`` at the bottom sets, by
    its bottom boundary condition."""
    return scalar + BC_SUFFIX.get(boundary.bcs[scalar].bcbot, "_gradbot")


def _surface_key(sfc, key, what):
    if key not in sfc:
        raise NotImplementedError(
            "%s requires a surface boundary scheme (the default boundary "
            "takes its values from the ini)" % what)
    return sfc[key]


class Sbot2D:
    """[boundary] sbot_2d_list: bottom values that vary over the plane, read
    from the binary maps ``<scalar>_bot_in.<iotime>`` (reference
    boundary.cxx:269, :625-660 static, :349-540 time-dependent).  Static maps
    are loaded once at the start of a run (``apply_static``); with
    ``swtimedep_sbot_2d`` a window of the previous and the next map, spaced
    ``sbot_2d_loadtime`` seconds apart, is interpolated every iteration
    (``update``)."""

    def __init__(self, ini, fields):
        self.list = ini.get_list(str, "boundary", "sbot_2d_list", default=[])
        self.swtimedep = ini.get_bool("boundary", "swtimedep_sbot_2d",
                                      default=False)
        self.loadtime = (ini.get_float("boundary", "sbot_2d_loadtime")
                         if self.swtimedep else None)
        self._window = None   # (itime_prev, itime_next, {fld: (prev, next)})

    @staticmethod
    def _np_dtype(model):
        return np.float64 if model.dtype == torch.float64 else np.float32

    def _read(self, model, fld, itime):
        iotime = int(itime // model.timeloop.iiotimeprec)
        path = "%s/%s_bot_in.%07d" % (model.workdir, fld, iotime)
        g = model.grid
        return np.fromfile(path, dtype=self._np_dtype(model)).reshape(
            g.jtot, g.itot)

    def apply_static(self, model, sfc):
        """Load <s>_bot_in.0000000 into the matching plane (the reference
        does this once in set_values, boundary.cxx:636-660)."""
        if not self.list or self.swtimedep:
            return sfc
        sfc = dict(sfc)
        for fld in self.list:
            key = bc_key(model.boundary, fld)
            plane = _surface_key(sfc, key, "sbot_2d_list")
            sfc[key] = torch.as_tensor(self._read(model, fld, 0),
                                       device=plane.device)
        return sfc

    def update(self, model, sfc, itime):
        """Advance the window of maps and interpolate (boundary.cxx
        update_time_dependent, :482-540)."""
        if not self.swtimedep or not self.list:
            return sfc
        ildt = int(self.loadtime * IFACTOR + 0.5)
        if self._window is None:
            it_prev = (int(itime) // ildt) * ildt
            maps = {fld: (self._read(model, fld, it_prev),
                          self._read(model, fld, it_prev + ildt))
                    for fld in self.list}
            self._window = (it_prev, it_prev + ildt, maps)
        it_prev, it_next, maps = self._window
        # advance only when itime passes the window's end (boundary.cxx:487),
        # so that a last step exactly at it_next reads no further map
        while int(itime) > it_next:
            it_prev, it_next = it_next, it_next + ildt
            maps = {fld: (maps[fld][1], self._read(model, fld, it_next))
                    for fld in self.list}
        self._window = (it_prev, it_next, maps)
        fac1 = (float(itime) - it_prev) / (it_next - it_prev)
        sfc = dict(sfc)
        for fld in self.list:
            prev, nxt = maps[fld]
            key = bc_key(model.boundary, fld)
            plane = _surface_key(sfc, key, "swtimedep_sbot_2d")
            sfc[key] = torch.as_tensor((1. - fac1) * prev + fac1 * nxt,
                                       dtype=model.dtype, device=plane.device)
        return sfc


class BoundaryTimedep:
    """[boundary] swtimedep + timedeplist: an entry ``<scalar>_sbot`` sets the
    scalar's bottom value every iteration (reference boundary.cxx:269-360):
    the Dirichlet value, the flux or the gradient, by its bottom BC."""

    def __init__(self, ini, fields, input_nc):
        self.sw = ini.get_bool("boundary", "swtimedep", default=False)
        self.items = {}
        if not self.sw:
            return
        for entry in ini.get_list(str, "boundary", "timedeplist", default=[]):
            if entry.endswith("_sbot"):
                self.items[entry[:-5]] = Timedep(input_nc, entry,
                                                 "time_surface")

    def update(self, model, sfc, itime):
        """sfc with the interpolated bottom values, each a plane of the
        run's dtype filled with the float64 value."""
        if not self.items:
            return sfc
        sfc = dict(sfc)
        for scalar, td in self.items.items():
            key = bc_key(model.boundary, scalar)
            plane = _surface_key(sfc, key, "[boundary] swtimedep")
            sfc[key] = torch.full_like(plane, float(td.interpolate(itime)))
        return sfc
