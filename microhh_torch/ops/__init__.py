"""Physics-operator factories (``microhh_tpu/ops/__init__.py``).

The port carries the drycblles, the moist (bomex/rico) and the buoyancy
(SBL_Smag, SBL_DNN) slices at 2nd order: ``advec 2`` and the interpolated
``2i4``, ``2i5``, ``2i53``, ``2i62``, or none (``0``); ``diff smag2``, the
constant-viscosity ``2``, the DNN closure ``dnn_local``, ``dnn_global``,
``dnn_stats``, or none (``0``); ``thermo dry`` (with ``swbaroclinic``),
``moist`` and ``buoy``, or none; the MOST surface or the ``default``
boundary; ``pres 2`` or none (``0``), with ``2mom_warm`` microphysics,
``force`` and ``limiter`` (ops/microphys.py, ops/force.py, ops/limiter.py),
open lateral boundaries for scalars and emission sources
(ops/boundary_outflow.py, ops/source.py; the jaenschwalde slice); and the
4th-order DNS stack (moser180, weakscaling): ``advec 4`` and ``4m``,
``diff 4``, ``pres 4``, the ``default`` boundary, ``thermo buoy`` or none.
The disabled schemes are ``DisabledOp`` and ``PresDisabled`` (the
reference's ``*_disabled.cxx``).  Every other scheme raises
NotImplementedError naming the ROADMAP item that ports it; model.check_slice
refuses a 4th-order scheme on a 2nd-order grid and the reverse.
"""

import torch


def not_ported(what, item):
    return NotImplementedError("%s is not ported to microhh_torch yet "
                               "(ROADMAP Queue 1 item %s)" % (what, item))


class DisabledOp:
    """The shared no-op scheme (advec/diff/pres/thermo ``*_disabled.cxx``):
    no tendency, no eddy viscosity, no limit."""

    def __init__(self, *a, **k):
        pass

    def exec(self, ctx, s, t, aux, *a, **k):
        return t

    def exec_viscosity(self, ctx, s, sfc, aux):
        return aux

    def cfl_max(self, ctx, s):
        return None

    def get_dn(self, ctx, s, aux):
        return None


class PresDisabled(DisabledOp):
    """``swpres=0``: no projection; the divergence is reported as 0."""

    def set_values(self, ctx):
        pass

    def exec(self, ctx, s, t, aux, subdt):
        return aux

    def divergence_max(self, ctx, s):
        return torch.zeros((), dtype=ctx.dtype, device=ctx.device)


DNN_VARIANTS = ("dnn_local", "dnn_global", "dnn_stats")
_ROADMAP_THERMO = {"vapor": 9}
_ROADMAP_BOUNDARY = {"surface_bulk": 14, "surface_lsm": 14}


def make_advec(ini, grid, fields):
    sw = ini.get_str("advec", "swadvec", default=str(grid.spatial_order))
    if sw == "0":
        return DisabledOp()
    if sw == "2":
        from .advec_2 import Advec2
        return Advec2(ini, grid)
    if sw == "4":
        from .advec_4 import Advec4
        return Advec4(ini, grid)
    if sw == "4m":
        from .advec_4m import Advec4m
        return Advec4m(ini, grid)
    from .advec_interp import CLASSES
    if sw in CLASSES:
        return CLASSES[sw](ini, grid)
    raise ValueError("%s is an illegal value for swadvec" % sw)


def make_diff(ini, grid, fields, boundary):
    sw = ini.get_str("diff", "swdiff", default=str(grid.spatial_order))
    if sw == "0":
        return DisabledOp()
    if sw == "2":
        from .diff_2 import Diff2
        return Diff2(ini, grid, fields)
    if sw == "smag2":
        from .diff_smag2 import DiffSmag2
        return DiffSmag2(ini, grid, fields, boundary)
    if sw == "4":
        from .diff_4 import Diff4
        return Diff4(ini, grid, fields)
    if sw in DNN_VARIANTS:
        from .diff_dnn import DiffDNN
        return DiffDNN(ini, grid, fields, boundary, variant=sw)
    raise ValueError("%s is an illegal value for swdiff" % sw)


def make_pres(ini, grid, fields):
    sw = ini.get_str("pres", "swpres", default=str(grid.spatial_order))
    if sw == "2":
        from .pres_2 import Pres2
        return Pres2(ini, grid, fields)
    if sw == "4":
        from .pres_4 import Pres4
        return Pres4(ini, grid, fields)
    if sw == "0":
        return PresDisabled()
    raise ValueError("%s is an illegal value for swpres" % sw)


def make_thermo(ini, grid, fields):
    sw = ini.get_str("thermo", "swthermo", default="0")
    if sw == "0":
        from .thermo import ThermoDisabled
        return ThermoDisabled()
    if sw == "dry":
        from .thermo_dry import ThermoDry
        return ThermoDry(ini, grid, fields)
    if sw == "moist":
        from .thermo_moist import ThermoMoist
        return ThermoMoist(ini, grid, fields)
    if sw == "buoy":
        from .thermo_buoy import ThermoBuoy
        return ThermoBuoy(ini, grid, fields)
    if sw in _ROADMAP_THERMO:
        raise not_ported("[thermo] swthermo=%s" % sw, _ROADMAP_THERMO[sw])
    raise ValueError("%s is an illegal value for swthermo" % sw)


def make_boundary(ini, fields, grid):
    sw = ini.get_str("boundary", "swboundary", default="default")
    if sw == "surface":
        from .boundary_surface import BoundarySurface
        return BoundarySurface(ini, fields, grid)
    if sw == "default":
        from .boundary import DefaultBoundary
        return DefaultBoundary(ini, fields, grid)
    if sw in _ROADMAP_BOUNDARY:
        raise not_ported("[boundary] swboundary=%s" % sw, _ROADMAP_BOUNDARY[sw])
    raise ValueError("%s is an illegal value for swboundary" % sw)
