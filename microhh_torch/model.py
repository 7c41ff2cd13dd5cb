"""Model orchestration of the PyTorch port (``microhh_tpu/model.py``; reference
``src/model.cxx``).

One RK step runs eagerly on the model's device, on one of five paths of
the JAX package's step: two of its RK-folded fused step at 2nd order, its
2nd-order substep without the RK fold, its plain 2nd-order substep with the
op producers, and its plain substep with the fused advection + diffusion
producer at 4th order.

* The dry path (thermo dry, or no thermo and no scalar: the drycblles,
  sullivan2011 and neutral Ekman slices; the JAX package's tiled kernels
  with ``fold_ghosts``): per substep the MOST row of the eddy viscosity, the
  MOST surface, the folded RK sweep K22 (eddy viscosity, tendencies with
  the static sponge and a static geostrophic wind folded in, RK update and
  Poisson right-hand side in one k-march) with its wall patches, and the
  projection (DFT K5 -> Thomas K3 -> inverse DFT K6 -> K4 apply).
  ``build_step(fold=False)`` keeps the three kernels K1 -> K2 -> K4 rhs in
  K22's place.
* The generic path (any other thermo or advection scheme: thermo moist
  with 2mom_warm, large-scale forcing and the limiter, the bomex/rico
  slice; thermo buoy, the SBL_Smag slice; the interpolated schemes 2i4,
  2i5, 2i53, 2i62; ``microhh_tpu/model.py:370-487``): per substep the ghost
  fill, the base-state update, the eddy viscosity (K1 in its ghost-filled
  moist mode, or K14 with the thermo's N2 field), the buoyancy and the
  warm-rain scheme (K11) into the carry, the MOST surface and the refill of
  the flux-dependent ghosts, an interpolated scheme's advection into the
  carry (K12/K13), the column tables, the tendency sweeps K8/K9 and K10
  (K15 for a single scalar; without their advec_2 terms after K12/K13), the
  projection, and the limiter as a clamp of s.
* The 2nd-order substep without the RK fold (``microhh_tpu/model.py:371-417,
  535-587``), for a case in which another producer changes the tendency
  after advection and diffusion, so that the RK update cannot ride the
  sweep: open lateral boundaries (``scalar_outflow``, the jaenschwalde
  plume) on the generic path; on the dry path any forcing but a static
  geostrophic wind, a limiter or source, and top boundary conditions that
  rule the clamped kernels out.  Ghost fill, base state,
  eddy viscosity (K1 in its ghost mode, or K14), thermo and microphysics
  into the carry, the MOST surface and the refill of the flux-dependent
  ghosts, an interpolated scheme's advection (K12/K13), then K18 and K19
  (generic; every scalar in one launch) or K20 (dry) onto the carry with
  the wall patches, the outflow correction, buffer, source and force unless
  folded into the kernel, the projection ``Pres2.exec`` (plain-torch input
  and output around K5, K21, K6), the limiter in its tendency form and the
  low-storage RK update in place.
* The plain 2nd-order substep (``microhh_tpu/model.py:370-399, 535-587``
  with ``fused`` None: its ``_maybe_build_fused`` builds nothing for another
  diffusion than smag2, a boundary other than the MOST surface, or another
  advection than advec 2 and the interpolated schemes), for the DNN closure
  (SBL_DNN and its two variants), ``swdiff`` 2 or 0 and the ``default``
  boundary (taylorgreen, conservation, eady): the substep above with
  ``diff.exec_viscosity`` (the DNN closure's: the eddy viscosity through
  K14, then its stresses; smag2's through K1 or K14; none for Diff2 and no
  diffusion) in place of the eddy viscosity alone and ``advec.exec`` (K12/
  K13 for an interpolated scheme) then ``diff.exec`` (plain torch, as the
  JAX package runs them in XLA) in place of K18/K19; the projection is
  again K5, K21, K6 (none for ``swpres=0``).  The default boundary fills
  the ghost levels in place, so there the step updates the caller's
  tensors.
* The 4th-order path (advec 4 or 4m, diff 4, pres 4, the default boundary,
  thermo buoy or none: the moser180 and weakscaling slice;
  ``microhh_tpu/model.py:535-587``): per substep the in-place ghost fill,
  the buoyancy into the carry, a copy of w under conservation-type ghosts,
  advection + diffusion into the carry (K16, and K17 for the scalars), the
  sponge and the forcing (``uflux`` needs the substep's dt), the projection
  (``rfft2``, two k-axis matrix products, ``irfft2``: library calls, as in
  the JAX package, which has no kernel there), and the low-storage RK
  update of s and the carry, in place.  There is no RK fold at 4th order.

The time loop takes the adaptive-dt limits from one pass (K7; the CFL rate
of an interpolated or a 4th-order scheme from its own ``cfl_max``, the
4th-order diffusion number a constant of the grid) and the sedimentation
limit, and does the integer-time bookkeeping, the status
table, the statistics (``stats.py``, ``budget.py``), the cross sections,
dumps and columns (``output.py``) and the restarts, as the reference's main
loop (``src/model.cxx:303-557``) does; ``post`` re-reads the saved states
and writes the same outputs of each.  ``run()`` takes the JAX package's
device-side chunked loop where it can (``_run_chunked``: dt computed on the
device from step to step between two output events, the dry RK step
captured as CUDA graphs on the card, ``graph_step.py``), else the per-step
host loop; ``MICROHH_CHUNK=0`` asks for the latter.  The per-step loop
takes the time-dependent bottom values, forcings, surface pressure, sources
and 2-D bottom maps (``timedep.py``) at the top of every iteration; a case
with any of those but a geostrophic wind, subsidence or surface pressure
stays off the chunked loop, as in the JAX package.  An option outside
these slices raises NotImplementedError naming its ROADMAP item.  The model runs on the device
it is given, by default the first CUDA device; ``device="cpu"`` runs every
kernel's plain-torch version instead.
"""

import os
import time as _time

import numpy as np
import torch

from .config import Ini
from .graph_step import ChunkLoop
from .grid import Grid
from .fields import Fields
from .timeloop import Timeloop
from . import ops
from .ops import PresDisabled, not_ported
from .ops.advec_2 import Advec2
from .ops.advec_interp import AdvecInterp
from .ops.advec_interp_fused import AdvecInterpFused
from .ops.boundary import NEUMANN, FLUX, ghost_filled, w_cons
from .ops.boundary_outflow import BoundaryOutflow
from .ops.buffer import make_buffer
from .ops.diff_smag2 import DiffSmag2
from .ops.force import NoForce, foldable_geo, make_force
from .ops.fused import (Fused, FusedGeneric, PresGlue, exec_viscosity,
                        generic_col_tables, generic_tendencies,
                        generic_tendencies_rk, generic_viscosity, tendencies,
                        tendencies_rk, tendencies_rk_fold, pressure_rk,
                        surface_evisc_row)
from .ops.limiter import Limiter
from .ops.microphys import Microphys2momWarm, make_microphys
from .ops.o4_fused import O4Fused
from .output import Column, Cross, Dump
from .ops.source import make_source
from .ops.stencil import ip, jp, i2
from .ops.thermo import ThermoDisabled
from .ops.thermo_dry import ThermoDry
from .stats import Stats
from .timedep import BoundaryTimedep, Sbot2D

NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class Context:
    """Grid and metric constants of the step, as tensors of the run's dtype
    on its device, plus float64 numpy copies for the kernels' per-level tables."""

    def __init__(self, grid, fields, dtype, device):
        self.dtype = dtype
        self.device = torch.device(device)
        g = grid
        self.ks, self.ke = g.kstart, g.kend
        self.itot, self.jtot, self.ktot = g.itot, g.jtot, g.ktot
        self.kcells = g.kcells
        self.spatial_order = g.spatial_order
        self.dxi, self.dyi = float(g.dxi), float(g.dyi)
        self.zsize = g.zsize
        self.utrans, self.vtrans = float(g.utrans), float(g.vtrans)
        for name in ("z", "zh", "dz", "dzh", "dzi", "dzhi"):
            setattr(self, name, self.tensor(getattr(g, name)))
        self.scalar_names = tuple(fields.sp.keys())
        self.np_z = np.asarray(g.z, dtype=np.float64)
        self.np_dzi = np.asarray(g.dzi, dtype=np.float64)
        self.np_dzhi = np.asarray(g.dzhi, dtype=np.float64)
        if g.spatial_order == 4:
            # the 4th-order metrics (grid.py), as tensors and for the tables
            self.dzi4, self.dzhi4 = self.tensor(g.dzi4), self.tensor(g.dzhi4)
            self.np_dzi4 = np.asarray(g.dzi4, dtype=np.float64)
            self.np_dzhi4 = np.asarray(g.dzhi4, dtype=np.float64)
            self.dzhi4bot, self.dzhi4top = float(g.dzhi4bot), float(g.dzhi4top)
        self.basestate_version = 0
        self.refresh_basestate(fields)

    def refresh_basestate(self, fields):
        """Take the base state's density from fields again.  A table that
        bakes the density in (the interpolated schemes' ladder weights)
        compares ``basestate_version`` with the one it was built at."""
        self.rhoref = self.tensor(fields.rhoref)
        self.rhorefh = self.tensor(fields.rhorefh)
        self.np_rhoref = np.asarray(fields.rhoref, dtype=np.float64)
        self.np_rhorefh = np.asarray(fields.rhorefh, dtype=np.float64)
        self.basestate_version += 1

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)


def check_slice(ini, grid, sim_mode):
    """Raise NotImplementedError for an option the port does not carry."""
    def switch(section, item):
        return ini.get_str(section, item, default="0") not in ("0", "false")

    decay = ini.items.get("decay", {}).get("swdecay", {})
    thermo = ini.get_str("thermo", "swthermo", default="0")
    moist = thermo == "moist"
    order = str(grid.spatial_order)
    # the schemes that belong to the 4th-order stack, by section
    fourth = {"advec": ("4", "4m"), "diff": ("4",), "pres": ("4",)}
    mixed = [sec for sec, sws in fourth.items()
             if (ini.get_str(sec, "sw" + sec, default=order) in sws)
             != (order == "4")]
    boundary = ini.get_str("boundary", "swboundary", default="default")
    outside = [
        (mixed, "[%s] a scheme of another order than [grid] swspatialorder=%s"
         % ("], [".join(mixed), order), 11),
        (order == "4" and thermo not in ("0", "buoy"),
         "[thermo] swthermo=%s at swspatialorder=4" % thermo, 11),
        (order == "4" and boundary != "default",
         "[boundary] swboundary=%s at swspatialorder=4" % boundary, 11),
        # K1 has no Van Driest damping, which the Smagorinsky closure takes
        # near resolved walls when neither the surface model nor a thermo
        # scalar is there (diff_smag2.cxx:160-225)
        (order == "2" and boundary != "surface" and thermo == "0"
         and ini.get_str("diff", "swdiff", default=order) == "smag2",
         "[diff] swdiff=smag2 with [boundary] swboundary=%s and [thermo] "
         "swthermo=0 (the Van Driest wall damping)" % boundary, 14),
        (switch("micro", "swmicro") and not moist,
         "[micro] swmicro without [thermo] swthermo=moist", 9),
        (switch("radiation", "swradiation"), "[radiation] swradiation", 13),
        (any(v not in ("0", "false") for v in decay.values()),
         "[decay] swdecay", 9),
        (ini.get_str("IB", "sw_immersed_boundary",
                     default=ini.get_str("IB", "swib", default="0"))
         not in ("0", "false", "disabled"), "[IB] immersed boundary", 14),
        (ini.get_bool("grid", "swtimedep", default=False),
         "[grid] swtimedep", 14),
        (ini.get_bool("buffer", "swupdate", default=False),
         "[buffer] swupdate", 9),
    ]
    if sim_mode != "init":
        stats = ini.get_int("stats", "swstats", default=0) != 0
        outside += [
            (stats and ini.get_list(str, "stats", "masklist", default=[]),
             "[stats] masklist", 8),
            (stats and ini.get_list(str, "stats", "xymasklist", default=[]),
             "[stats] xymasklist", 8),
            (stats and ini.get_bool("stats", "swtendency", default=False),
             "[stats] swtendency", 8),
        ]
    for active, what, item in outside:
        if active:
            raise not_ported(what, item)


class Model:
    """``input_nc``: the case's input profiles (a ``utils/nc`` Dataset or
    MemoryDataset); by default ``<workdir>/<casename>_input.nc`` when it
    exists."""

    def __init__(self, ini, sim_mode, casename="", workdir=".",
                 dtype=torch.float32, device="cuda", input_nc=None):
        if isinstance(ini, str):
            ini = Ini(ini)
        self.ini = ini
        self.sim_mode = sim_mode
        self.casename = casename
        self.workdir = workdir
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; device='cpu' runs the "
                               "plain-torch versions of the kernels")

        self.input_nc = input_nc
        nc_path = os.path.join(workdir, "%s_input.nc" % casename)
        if input_nc is None and os.path.exists(nc_path):
            from .utils import nc
            self.input_nc = nc.Dataset(nc_path, "r")

        # [master] npx/npy: the process-grid decomposition, read in every
        # mode like the reference; the port runs on one device.
        ini.get_int("master", "npx", default=1)
        ini.get_int("master", "npy", default=1)
        self.grid = Grid(ini)
        if self.input_nc is not None and "z" in self.input_nc.variables:
            self.grid.set_z(np.asarray(self.input_nc.variables["z"][:self.grid.ktot]))
        else:
            dz = self.grid.zsize / self.grid.ktot
            self.grid.set_z(np.linspace(0.5 * dz, self.grid.zsize - 0.5 * dz,
                                        self.grid.ktot))
        check_slice(ini, self.grid, sim_mode)

        self.fields = Fields(ini, self.grid)
        # thermo and microphysics register their scalars before the BCs
        self.thermo = ops.make_thermo(ini, self.grid, self.fields)
        self.micro = make_microphys(ini, self.grid, self.fields)
        self.micro.thermo = self.thermo
        self.boundary = ops.make_boundary(ini, self.fields, self.grid)
        self.advec = ops.make_advec(ini, self.grid, self.fields)
        self.diff = ops.make_diff(ini, self.grid, self.fields, self.boundary)
        self.diff.thermo = self.thermo
        self.boundary.thermo = self.thermo
        self.pres = ops.make_pres(ini, self.grid, self.fields)
        self.force = make_force(ini, self.grid, self.fields, self.input_nc)
        self.buffer = make_buffer(ini, self.grid, self.fields, self.input_nc)
        self.limiter = Limiter(ini, self.fields)
        self.source = make_source(ini, self.grid, self.fields, self.input_nc)
        self.outflow = BoundaryOutflow(ini, self.grid, self.grid.spatial_order)
        if self.outflow.active and self.input_nc is not None:
            self.outflow.create(self.input_nc)
        self.timeloop = Timeloop(ini, sim_mode)
        # time-dependent bottom values and 2-D bottom maps
        # (microhh_tpu/model.py:140-153; [grid] swtimedep raises in
        # check_slice)
        self.btimedep = BoundaryTimedep(ini, self.fields, self.input_nc)
        self.sbot2d = Sbot2D(ini, self.fields)
        # [master] wallclocklimit in hours (reference master.cxx:80-89)
        self.wallclocklimit = ini.get_float("master", "wallclocklimit",
                                            default=1.e8)
        self._wall_start = _time.time()
        self._last_wallclock = _time.time()
        self._last_sfc = None
        self._last_aux = None
        # the run's statistics, cross sections, dumps and columns (when
        # switched on), built by run_case
        self.stats = None
        self.cross = None
        self.dump = None
        self.column = None
        self.built = False
        self.fused = None
        self.advec_fused = None
        self.o4 = None
        self.unfolded = False
        self.plain = False
        # the chunked loop (build_chunk), and (steps, seconds) of the last
        # run's loop
        self._chunk = None
        self.loop_wall = None

    def at_wall_clock_limit(self):
        return (_time.time() - self._wall_start) > self.wallclocklimit * 3600. - 600.

    # ------------------------------------------------------------------
    def finish_setup(self):
        """Base state + solver precomputation; call before init/run."""
        self.thermo.create_basestate(self.input_nc)
        self.ctx = Context(self.grid, self.fields, self.dtype, self.device)
        self.pres.set_values(self.ctx)

    # ------------------------------------------------------------------
    #  init mode
    # ------------------------------------------------------------------
    def save_initial_state(self, state=None):
        """Write the restart files of time 0.  ``state``: initial fields to
        save instead of Fields.create's (a case without an input NetCDF that
        sets its mean profiles itself)."""
        np_dtype = NP_DTYPE[self.dtype]
        if state is None:
            state = self.fields.create(self.input_nc, dtype=np_dtype)
        # the MOST warm-start planes belong to every restart chain
        # (boundary_surface.cxx save)
        sfc0 = self.boundary.init_surface_state(dtype=np_dtype)
        self.boundary.save(sfc0, 0, self.workdir)
        self.grid.save(os.path.join(self.workdir, "grid.%07d" % 0))
        self.fields.save(state, 0, self.workdir)
        self.timeloop.save(0, self.workdir)
        if hasattr(self.thermo, "save_basestate"):
            self.thermo.save_basestate(0, self.workdir)
        return state

    # ------------------------------------------------------------------
    #  the step
    # ------------------------------------------------------------------
    def build_step(self, unfolded=None, fold=True):
        """Build the kernel wrappers and the RK carry for this case: the
        dry path for thermo dry (or no thermo and no scalar: the neutral
        set) with advec 2, whose kernels read clamped k neighbours instead
        of ghost cells (exact for a free-slip top and a Neumann or flux top
        for th); else the generic path, on which an interpolated scheme runs
        as a producer (K12/K13) before tendency kernels that leave their
        advection out (microhh_tpu/model.py:712-737).  At 4th order the
        plain substep with K16/K17 as its advection + diffusion producer
        (the gates of microhh_tpu/model.py:862-906, less the TPU's own).

        Both 2nd-order paths fold the RK update into their tendency kernels
        unless something changes the tendency after them
        (microhh_tpu/model.py:278-306, 319-333): open boundaries on the
        generic path; on the dry path, whose RK kernels fold the static
        sponge and a static geostrophic wind (as a Coriolis term,
        microhh_tpu/model.py:762-769) and read clamped neighbours, any
        other forcing, a limiter or source, and any top boundary condition
        other than free slip with a Neumann or flux th.  Those cases take
        the substep without the RK fold on ghost-filled fields (K18/K19 or
        K20).  ``unfolded=True`` forces that substep (its own check against
        the RK-folded paths).

        Where the JAX package builds no fused kernels it runs its op path
        (microhh_tpu/model.py:696-711, 746-750, 919-926), and so does the
        port, on the plain substep: for a diffusion other than smag2 (the
        DNN closure, ``2`` or none), a boundary other than the MOST surface,
        or an advection other than advec 2 or an interpolated scheme (its
        gate on scalars under a thermo without ``get_n2`` never holds: every
        thermo has one, thermo 0's giving none).  That is the
        substep without the RK fold with the op producers ``advec.exec``
        (K12/K13 for an interpolated scheme) and ``diff.exec`` in place of
        the tendency kernels (and for ``swpres=0``, whose projection the
        RK-folded kernels carry).  Where the diffusion has an eddy viscosity,
        K1 (or K14 with the thermo's N2) computes it: through the closure's
        ``exec_viscosity`` for the DNN, directly for smag2; K7 then serves
        the limits.  Diff2 and no diffusion have none, and the limits are
        the scheme's own ``cfl_max`` and the diffusion's ``get_dn``.
        A thermo dry case with more scalars than th, or with
        ``swbaroclinic`` (whose term the dry kernels do not carry), takes
        the generic path.

        The dry RK sweep is K22 by default: the eddy viscosity and the
        Poisson right-hand side come out of the same k-march, the form the
        JAX package runs at 512^2 planes (its size gate below that was a
        VMEM budget and is not copied).  ``fold=False`` keeps the three
        kernels K1 -> K2 -> K4 rhs, so that the two forms can be held
        against each other."""
        ctx = self.ctx
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        self.t = {n: torch.zeros(shape, dtype=self.dtype, device=self.device)
                  for n in self.fields.prognostic_names}
        self.fold = False
        self.built = True
        if ctx.spatial_order == 4:
            self.generic = False
            self.o4 = O4Fused(self.advec, self.diff, ctx)
            return
        self.glue = PresGlue(ctx)
        interp = isinstance(self.advec, AdvecInterp)
        smag = isinstance(self.diff, DiffSmag2)
        self.advec_fused = AdvecInterpFused(self.advec, ctx) if interp else None
        self.plain = not (
            smag and getattr(self.boundary, "is_surface", False)
            and (interp or isinstance(self.advec, Advec2))
            and not isinstance(self.pres, PresDisabled))
        if self.plain:
            self.generic = self.unfolded = True
            self.skip_force = self.skip_buffer = False
            closure = self.diff if smag else getattr(self.diff, "smag", None)
            self.fused = (None if closure is None else
                          FusedGeneric(ctx, closure, self.thermo, self.force))
            if hasattr(self.diff, "bind"):
                self.diff.bind(self.fused)
            return
        neutral = (isinstance(self.thermo, ThermoDisabled)
                   and not ctx.scalar_names)
        dry = (isinstance(self.thermo, ThermoDry)
               and ctx.scalar_names == ("th",)
               and not self.thermo.swbaroclinic)
        self.generic = interp or not (dry or neutral)
        if self.generic:
            self.fused = FusedGeneric(ctx, self.diff, self.thermo, self.force,
                                      advec=not interp)
            # uflux reads the tendency, so it cannot ride the RK fold
            # (microhh_tpu/model.py:319-333)
            self.unfolded = (bool(unfolded) or self.outflow.active
                             or getattr(self.force, "swlspres", "0") == "uflux")
            # K18 folds a static geostrophic wind; the sponge runs as its op
            self.skip_force = self.fused.fold_force
            self.skip_buffer = False
            return
        bcs = self.boundary.bcs
        clamp_ok = (all(bcs[n].bctop == NEUMANN and bcs[n].top == 0.
                        for n in ("u", "v"))
                    and (neutral or bcs["th"].bctop in (NEUMANN, FLUX)))
        # the dry kernels fold the static sponge and a static geostrophic wind
        self.skip_buffer = self.buffer is not None
        self.skip_force = foldable_geo(self.force)
        idle = ((isinstance(self.force, NoForce) or self.skip_force)
                and not self.limiter.limitlist and self.source is None)
        self.unfolded = bool(unfolded) or not (clamp_ok and idle)
        top_grad = 0.
        if not (self.unfolded or neutral):
            bc = bcs["th"]
            top_grad = (bc.top if bc.bctop == NEUMANN
                        else -bc.top / self.boundary.viscs["th"])
        self.fold = bool(fold) and not self.unfolded
        self.fused = Fused(ctx, self.diff, self.thermo, self.buffer, top_grad,
                           ghosts=self.unfolded,
                           force=self.force if self.skip_force else None,
                           has_thermo=not neutral)

    def kernels(self):
        """The hand-written kernels of the step, in step order, then K7,
        which the limits launch, where the path has it."""
        if self.o4 is not None:
            return ([self.o4.k_mom, self.o4.k_scal] if self.ctx.scalar_names
                    else [self.o4.k_mom])
        fz = self.fused
        micro = ([self.micro.k_micro]
                 if isinstance(self.micro, Microphys2momWarm) else [])
        advec = []
        if self.advec_fused is not None:
            # K13 takes the scalars that no flux limiter holds
            advec = [self.advec_fused.k_mom] + (
                [self.advec_fused.k_scal]
                if set(self.ctx.scalar_names) - set(self.advec.fluxlimit_list)
                else [])
        if self.plain:
            pres = []
            if not isinstance(self.pres, PresDisabled):
                fwd, inv = self.pres.dft_kernels(self.dtype)
                pres = [fwd, self.pres.k_tdma_ri, inv]
            if fz is None:
                return micro + advec + pres
            evisc = [fz.k_evisc_n2] if fz.stratified == 2 else [fz.k_evisc]
            return evisc + micro + advec + pres + [fz.k_limits]
        # K5 and K6 in the form this shape and dtype take
        fwd, inv = self.pres.dft_kernels(self.dtype)
        solve = [fwd, self.pres.k_tdma, inv, self.glue.k_apply]
        if self.fold:
            return [fz.k_tend_fold] + solve + [fz.k_limits]
        if self.unfolded:
            pres = [fwd, self.pres.k_tdma_ri, inv]
        else:
            pres = [self.glue.k_rhs] + solve
        if not self.generic:
            tend = fz.k_tendencies if self.unfolded else fz.k_tend
            return [fz.k_evisc, tend] + pres + [fz.k_limits]
        evisc = [fz.k_evisc_n2] if fz.stratified == 2 else [fz.k_evisc]
        if self.unfolded:
            sweeps = [fz.k_uvw_acc] + ([fz.k_scalar_acc] if fz.names else [])
        else:
            sweeps = [fz.k_uvw] + ([fz.k_scalar] if len(fz.names) == 1
                                   else [fz.k_scalars] if fz.names else [])
        return evisc + micro + advec + sweeps + pres + [fz.k_limits]

    def device_dt(self):
        """True on the dry RK path, whose kernels (K22, or K2 and K4 rhs,
        and K4 apply) read the step's dt from the device: its step makes no
        host read, so the chunked loop captures it.  The other paths' step
        reads dt to the host once."""
        return self.o4 is None and not (self.generic or self.unfolded)

    def substep(self, s, sfc, aux, dt, sub, out=None):
        """One low-storage RK substep on the RK-folded path (model.py:370-515
        of the JAX package): the carry self.t is updated in place (K22
        replaces the tensors of u's and v's carry in the dict).  dt: a
        0-dim tensor on the dry path (subdt and its inverse are taken on
        the device), a number on the others.  out: on the dry path, the
        arrays that receive the new state (on the card)."""
        if self.o4 is not None:
            return self._substep_o4(s, sfc, aux, dt, sub)
        if self.unfolded:
            return self._substep_unfolded(s, sfc, aux, dt, sub)
        if self.generic:
            return self._substep_generic(s, sfc, aux, dt, sub)
        ctx, tl, fz = self.ctx, self.timeloop, self.fused
        subdt = tl.rk_cb[sub] * dt
        can = tl.rk_ca[(sub + 1) % tl.n_substeps]
        # sub == 0: cA[0] == 0, so the carry is zero and the sweep does not
        # read it
        first = sub == 0
        if self.fold:
            # the eddy viscosity rides the sweep; its MOST row is taken here,
            # before the surface model, so that it sees the last substep's
            # MO gradients as K1's does (microhh_tpu/model.py:383-394)
            se_row = (surface_evisc_row(fz.smag, ctx, s, sfc, fz.has_thermo)
                      if fz.smag.surface else None)
            sfc = self.boundary.exec(ctx, s, sfc, aux)
            s_star, aux, rhs = tendencies_rk_fold(
                fz, ctx, s, self.t, aux, sfc, subdt, can, first, se_row,
                out=out)
        else:
            aux = exec_viscosity(fz, ctx, s, sfc, aux)
            sfc = self.boundary.exec(ctx, s, sfc, aux)
            s_star = tendencies_rk(fz, ctx, s, self.t, aux, sfc, subdt, can,
                                   first, out=out)
            rhs = None
        aux["subdt"] = subdt
        s_new, aux = pressure_rk(self.glue, ctx, self.pres, s_star, self.t,
                                 aux, subdt, can, rhs)
        return s_new, sfc, aux

    def _substep_generic(self, s, sfc, aux, dt, sub):
        """The generic substep (microhh_tpu/model.py:370-487): every
        additive producer adds into the carry before the tendency kernels,
        which fold the RK update in; the limiter clamps s after the
        projection."""
        ctx, tl, fz, bnd = self.ctx, self.timeloop, self.fused, self.boundary
        s = bnd.set_ghost_cells(ctx, s, sfc)
        if getattr(self.thermo, "swupdatebasestate", False):
            aux = self.thermo.update_basestate(ctx, s, aux, sfc)
        aux = generic_viscosity(fz, ctx, s, sfc, aux)
        # thermo dry returns new tensors, the others add in place
        self.t.update(self.thermo.exec(ctx, s, self.t, aux))
        _, aux = self.micro.exec(ctx, s, self.t, aux, dt)
        sfc = bnd.exec(ctx, s, sfc, aux)
        s = bnd.set_ghost_cells(ctx, s, sfc, names=bnd.flux_ghost_names())
        if self.advec_fused is not None:
            # additive and independent of the carry, so the fold stays exact
            self.advec_fused.exec(ctx, s, self.t, aux)
        cols = generic_col_tables(fz, ctx, s, self.force, self.buffer, sfc)
        if self.source is not None:
            # additive and independent of the carry, like the producers above
            # (microhh_tpu/model.py:438)
            self.source(ctx, s, self.t, aux, sfc)
        subdt = tl.rk_cb[sub] * dt
        can = tl.rk_ca[(sub + 1) % tl.n_substeps]
        s_star = generic_tendencies_rk(fz, ctx, s, self.t, aux, sfc, subdt,
                                       can, cols)
        aux["subdt"] = subdt
        s_new, aux = pressure_rk(self.glue, ctx, self.pres, s_star, self.t,
                                 aux, subdt, can)
        self.limiter.clamp(ctx, s_new, self.t, subdt, can)
        return s_new, sfc, aux

    def _substep_unfolded(self, s, sfc, aux, dt, sub):
        """The 2nd-order substep without the RK fold
        (microhh_tpu/model.py:371-417 and 535-587): the tendency kernels add
        onto the carry, then the outflow correction, buffer, source, force,
        projection and limiter work on the carry, and the low-storage RK
        update closes the substep.  The carry and the RK update are in
        place, the latter on the tensors the ghost fill made (and a copy of
        w, which has no ghost level to fill), so the caller's state stays
        as it was; under a boundary that fills the ghosts in place (the
        default one) the whole update is in place, and the caller's tensors
        are the new state.  On the plain path the diffusion's
        exec_viscosity (smag2's through K1 or K14) and the op producers
        advec.exec (K12/K13 for an interpolated scheme) and diff.exec stand
        in for the eddy viscosity and the tendency kernels
        (microhh_tpu/model.py:553-555)."""
        ctx, tl, fz, bnd, t = self.ctx, self.timeloop, self.fused, self.boundary, self.t
        s = bnd.set_ghost_cells(ctx, s, sfc)
        if not getattr(bnd, "in_place", False):
            s["w"] = s["w"].clone()
        if getattr(self.thermo, "swupdatebasestate", False):
            aux = self.thermo.update_basestate(ctx, s, aux, sfc)
        if self.plain and not isinstance(self.diff, DiffSmag2):
            aux = self.diff.exec_viscosity(ctx, s, sfc, aux)
        else:
            aux = generic_viscosity(fz, ctx, s, sfc, aux)
        if self.generic:
            # thermo dry returns new tensors, the others add in place; on
            # the dry path the buoyancy is K20's
            t.update(self.thermo.exec(ctx, s, t, aux))
            _, aux = self.micro.exec(ctx, s, t, aux, dt)
        sfc = bnd.exec(ctx, s, sfc, aux)
        if getattr(bnd, "is_surface", False):
            s = bnd.set_ghost_cells(ctx, s, sfc, names=bnd.flux_ghost_names())
        if self.plain:
            if self.advec_fused is not None:
                # additive and independent of the carry: the op's function
                self.advec_fused.exec(ctx, s, t, aux)
            else:
                t.update(self.advec.exec(ctx, s, t, aux))
            t.update(self.diff.exec(ctx, s, t, aux, sfc))
        elif self.generic:
            if self.advec_fused is not None:
                self.advec_fused.exec(ctx, s, t, aux)
            generic_tendencies(fz, ctx, s, t, aux, sfc)
        else:
            tendencies(fz, ctx, s, t, aux, sfc)
        if self.outflow.active:
            self.outflow.correct(ctx, s, t, aux,
                                 tPr=getattr(self.diff, "tPr", 1.),
                                 sviscs=getattr(self.diff, "viscs", None))
        subdt = tl.rk_cb[sub] * dt
        aux["subdt"] = subdt
        if self.buffer is not None and not self.skip_buffer:
            self.buffer(ctx, s, t, aux)
        if self.source is not None:
            self.source(ctx, s, t, aux, sfc)
        if not self.skip_force:
            t.update(self.force(ctx, s, t, aux, sfc))
        aux = self.pres.exec(ctx, s, t, aux, subdt)
        if self.limiter.limitlist:
            t.update(self.limiter(ctx, s, t, aux, subdt))
        self._rk_update(s, sub, subdt)
        return s, sfc, aux

    def _rk_update(self, s, sub, subdt):
        """The low-storage RK update (timeloop.cxx:250-334), in place: the
        carry's ghost levels are zero, so whole tensors are updated."""
        tl, t = self.timeloop, self.t
        can = tl.rk_ca[(sub + 1) % tl.n_substeps]
        for n in self.fields.prognostic_names:
            s[n].add_(t[n], alpha=subdt)
            if can != 0.:
                t[n].mul_(can)
            else:
                t[n].zero_()

    def _substep_o4(self, s, sfc, aux, dt, sub):
        """The 4th-order substep (the JAX package's plain substep,
        microhh_tpu/model.py:535-587, with the fused producer of :550-552).
        Everything is in place: the ghost levels of s, the carry self.t and
        the RK update of s, so the caller's tensors are the new state."""
        ctx, tl, t = self.ctx, self.timeloop, self.t
        s = self.boundary.set_ghost_cells(ctx, s, sfc)
        self.thermo.exec(ctx, s, t, aux)
        sfc = self.boundary.exec(ctx, s, sfc, aux)
        # conservation-type w ghosts around advection and the projection,
        # plain ones for the diffusion (model.cxx:387-412)
        s_cons = dict(s, w=w_cons(ctx, s["w"]))
        self.o4.exec(ctx, s_cons, s, t, aux)
        subdt = tl.rk_cb[sub] * dt
        aux["subdt"] = subdt
        if self.buffer is not None:
            self.buffer(ctx, s, t, aux)
        if self.source is not None:
            self.source(ctx, s, t, aux, sfc)
        t.update(self.force(ctx, s, t, aux, sfc))
        self.pres.exec(ctx, s_cons, t, aux, subdt)
        if self.limiter.limitlist:
            t.update(self.limiter(ctx, s, t, aux, subdt))
        self._rk_update(s, sub, subdt)
        return s, sfc, aux

    def step(self, s, sfc, dt, out=None):
        """One RK step of size dt: returns (s, sfc, aux).  dt: a number
        or a 0-dim tensor of the model's dtype on its device; the dry RK
        path takes it as a device scalar (a number is put there), the others
        as a number (a tensor is read to the host).
        out: the arrays of the new state, written by the last substep on the
        dry RK path on the card (the chunked loop's graphs alternate between
        two states); else the step returns new ones.  The 4th-order path
        updates the tensors of s in place, and so does the plain path under
        the default boundary, which fills the ghosts in place."""
        if out is not None and not (self.device_dt()
                                    and self.device.type == "cuda"):
            raise ValueError("out= is the dry RK path's on the card: the "
                             "other paths and the plain versions return new "
                             "arrays")
        if not self.device_dt():
            dt = float(dt)
        elif not torch.is_tensor(dt):
            dt = torch.full((), dt, dtype=self.dtype, device=self.device)
        if self.generic and not self.unfolded:
            # the producers add into the carry from the first substep on
            # (the steps that update in place leave the carry zero)
            for a in self.t.values():
                a.zero_()
        aux = {}
        nsub = self.timeloop.n_substeps
        for sub in range(nsub):
            s, sfc, aux = self.substep(s, sfc, aux, dt, sub,
                                       out if sub == nsub - 1 else None)
        return s, sfc, aux

    def limits(self, s, sfc):
        """Adaptive-dt rates per unit dt: the CFL rate and the diffusion
        number from K7's per-level maxima (the JAX package's slim limits,
        model.py:596-630: max commutes with the positive per-level dt
        factors and the MOST bottom-row override applied here; on the
        generic and the plain path they equal its cfl_max + evisc + get_dn,
        :631-657, which on the plain path also evaluates the DNN closure's
        network and discards it), and the sedimentation rate of the
        microphysics.  K7's CFL is the advec_2
        expression; an interpolated scheme gives its own (cfl_max, in plain
        torch: 2 passes over u, v and w) and K7 serves the evisc maxima.
        Without an eddy viscosity (the 4th-order path, Diff2, no
        diffusion) there is no K7: the scheme's own CFL and the diffusion's
        get_dn, each left out where the scheme has none
        (microhh_tpu/model.py:631-657)."""
        ctx, fz = self.ctx, self.fused
        out = {}
        if self.o4 is not None or fz is None:
            cfl = self.advec.cfl_max(ctx, s)
            dn = self.diff.get_dn(ctx, s, {})
            if cfl is not None:
                out["cfl_rate"] = cfl
            if dn is not None:
                out["dn_rate"] = dn
        else:
            out = self._evisc_limits(s, sfc)
        mrate = self.micro.get_time_limit_rate(ctx, s)
        if mrate is not None:
            out["micro_rate"] = mrate
        return out

    def _evisc_limits(self, s, sfc):
        """The CFL and diffusion-number rates of a path with an eddy
        viscosity, from K7."""
        ctx, fz = self.ctx, self.fused
        if self.generic:
            s = self.boundary.set_ghost_cells(ctx, s, sfc)
            if fz.stratified == 2:
                th = self.thermo.get_n2(ctx, s).contiguous()
            else:
                th = s[fz.n2_scalar] if fz.stratified else s["u"]
        else:
            if fz.ghosts:
                s = self.boundary.set_ghost_cells(ctx, s, sfc)
            th = s["th"] if fz.has_thermo else s["u"]
        cflk, evk = fz.limits(s["u"], s["v"], s["w"], th)
        if fz.smag.surface:
            row = surface_evisc_row(fz.smag, ctx, s, sfc, bool(fz.stratified))
            evk = torch.cat([torch.max(row)[None], evk[1:]])
        tprfac_i = 1. / min(1., self.diff.tPr)
        dzi2 = ctx.dzi[ctx.ks:ctx.ke] ** 2
        dn = torch.max(torch.abs(evk * tprfac_i
                                 * (ctx.dxi ** 2 + ctx.dyi ** 2 + dzi2)))
        cfl = (torch.max(cflk) if isinstance(self.advec, Advec2)
               else self.advec.cfl_max(ctx, s))
        out = {"dn_rate": dn}
        if cfl is not None:
            out["cfl_rate"] = cfl
        return out

    def diagnostics(self, s, sfc):
        """Status-line quantities after a ghost fill (model.py:664-688);
        at 4th order the divergence is taken under conservation-type w
        ghosts, the type under which the projection is exact.  The caller's
        state keeps its ghost levels, as the JAX package's does, so that
        the outputs after the status line read the step's."""
        ctx = self.ctx
        s = ghost_filled(self.boundary, ctx, s, sfc)
        if ctx.spatial_order == 4:
            s = dict(s, w=w_cons(ctx, s["w"]))
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"], s["v"], s["w"]
        dzc = ctx.dz[ks:ke][:, None, None]
        norm = ctx.itot * ctx.jtot * ctx.zsize
        mom = torch.sum((i2(u, ip(u))[ks:ke] + i2(v, jp(v))[ks:ke]
                         + i2(w[ks:ke], w[ks + 1:ke + 1])) * dzc) / norm
        tke = 0.5 * torch.sum((i2(u * u, ip(u) ** 2)[ks:ke]
                               + i2(v * v, jp(v) ** 2)[ks:ke]
                               + i2(w[ks:ke] ** 2, w[ks + 1:ke + 1] ** 2)) * dzc) / norm
        if ctx.scalar_names:
            mass = torch.sum(s[ctx.scalar_names[0]][ks:ke] * dzc) / norm
        else:
            mass = torch.zeros((), dtype=ctx.dtype, device=ctx.device)
        return {"div": self.pres.divergence_max(ctx, s), "mom": mom,
                "tke": tke, "mass": mass}

    # ------------------------------------------------------------------
    #  run mode
    # ------------------------------------------------------------------
    def load_state(self):
        tl = self.timeloop
        iotime = int(tl.istarttime // tl.iiotimeprec)
        tl.load(iotime, self.workdir)
        return self.fields.load(iotime, self.workdir, dtype=NP_DTYPE[self.dtype])

    def as_device_state(self, state_np):
        """(s, sfc) tensors on the model's device from numpy planes."""
        ctx = self.ctx
        s = {n: ctx.tensor(state_np[n]) for n in self.fields.prognostic_names}
        sfc_np = self.boundary.init_surface_state(dtype=NP_DTYPE[self.dtype])
        if self.sim_mode != "init":
            tl = self.timeloop
            sfc_np = self.boundary.load(sfc_np, int(tl.itime // tl.iiotimeprec),
                                        self.workdir, dtype=NP_DTYPE[self.dtype])
        return s, {k: ctx.tensor(v) for k, v in sfc_np.items()}

    def save_restart(self, s):
        tl = self.timeloop
        iotime = int(tl.iotime)
        self.fields.save({n: s[n].cpu().numpy() for n in s}, iotime, self.workdir)
        if self._last_sfc is not None:
            self.boundary.save({k: v.cpu().numpy() for k, v in self._last_sfc.items()},
                               iotime, self.workdir)
        tl.save(iotime, self.workdir)

    def _status_path(self):
        return os.path.join(self.workdir, "%s.out" % (self.casename or "run"))

    def print_status(self, s, sfc, cfl, dn, status_file):
        tl = self.timeloop
        d = {k: float(v) for k, v in self.diagnostics(s, sfc).items()}
        now = _time.time()
        cpudt = now - self._last_wallclock
        self._last_wallclock = now
        status_file.write(
            "%8d %11.3E %10.4f %11.3E %8.4f %8.4f %11.3E %16.8E %16.8E %16.8E\n"
            % (tl.iteration, tl.time, cpudt, tl.dt, cfl, dn,
               d["div"], d["mom"], d["tke"], d["mass"]))
        status_file.flush()
        if not np.isfinite(cfl):
            raise RuntimeError("Simulation has non-finite numbers")
        return d

    # ------------------------------------------------------------------
    #  the device-side chunked time loop (microhh_tpu/model.py:974-1143):
    #  between two output events the adaptive-dt loop runs on the device,
    #  dt taken from step to step there; the host reads two flags a step
    # ------------------------------------------------------------------
    def _chunk_supported(self):
        """The JAX package's gate (microhh_tpu/model.py:980-991): adaptive
        dt, not post mode, MICROHH_CHUNK not 0, and none of the time
        dependences it names, since a chunk makes no host update between
        its steps: time-dependent bottom values, large-scale sources or
        emission sources, or 2-D bottom maps.  Like the JAX package's, the
        chunked loop makes no update at all: a time-dependent geostrophic
        wind, subsidence or surface pressure, which this gate lets through,
        keeps its static profile there."""
        return (os.environ.get("MICROHH_CHUNK", "1") != "0"
                and self.timeloop.adaptivestep
                and self.sim_mode != "post"
                and not self.btimedep.items
                and not getattr(self.force, "tdep_ls", None)
                and not getattr(self.source, "tdep", None)
                and not self.sbot2d.swtimedep)

    def update_timedep(self, sfc):
        """sfc with every time-dependent value at the current integer time
        (model.cxx:339-343; microhh_tpu/model.py:1255-1271)."""
        itime = self.timeloop.itime
        if self.btimedep.items:
            sfc = self.btimedep.update(self, sfc, itime)
        if getattr(self.force, "has_timedep", False):
            sfc = self.force.update_timedep(sfc, itime)
        if getattr(self.thermo, "tdep_pbot", None) is not None:
            sfc = self.thermo.update_timedep(sfc, itime)
        if getattr(self.source, "tdep", None):
            sfc = self.source.update_timedep(sfc, itime)
        if self.sbot2d.swtimedep:
            sfc = self.sbot2d.update(self, sfc, itime)
        return sfc

    def build_chunk(self, capture=True):
        """The chunk's carried scalars and body (graph_step.ChunkLoop),
        made once per model at its first call; on the card the dry RK
        step's graphs are captured at its first chunk.  capture False keeps
        the body eager on the card (the check of the graphs against it)."""
        if self._chunk is None:
            self._chunk = ChunkLoop(self, capture=capture)
        return self._chunk

    def _chunk_horizon(self, at_wall_limit):
        """Integer time to the nearest restart, statistics, dump or end
        event (microhh_tpu/model.py:1062-1077)."""
        tl = self.timeloop
        ih = tl.idtmax * max(tl.outputiter, 1) * 100  # fallback bound
        if at_wall_limit:
            ih = min(ih, tl.iiotimeprec - tl.itime % tl.iiotimeprec)
        ih = min(ih, tl.isavetime - tl.itime % tl.isavetime)
        if tl.itime < tl.iendtime:
            ih = min(ih, tl.iendtime - tl.itime)
        for comp in self.outputs():
            ih = min(ih, comp.isampletime - tl.itime % comp.isampletime)
        return ih

    def outputs(self):
        """The switched-on components that sample at their own times:
        statistics, cross sections, dumps and columns."""
        return [c for c in (self.stats, self.cross, self.dump, self.column)
                if c is not None and getattr(c, "sw", True)]

    def write_outputs(self, s, sfc, aux, iotime):
        """At a sampling step, in the JAX package's order: statistics,
        cross sections, dump, columns (microhh_tpu/model.py:1285-1294).
        aux: the last step's (its pressure), or post mode's."""
        tl = self.timeloop
        if self.stats is not None:
            self.stats.maybe_exec(self, s, sfc)
        if self.cross is not None and self.cross.do_cross(tl.itime):
            self.cross.exec(s, aux, iotime, sfc)
        if self.dump is not None and self.dump.do_dump(tl.itime):
            self.dump.exec(s, aux, iotime)
        if self.column is not None and self.column.do_column(tl.itime):
            self.column.exec(s, tl.time, sfc)

    def _host_limits(self, s, sfc):
        """The rates of Model.limits, read to the host in one transfer."""
        lim = self.limits(s, sfc)
        if not lim:
            return {}
        return dict(zip(lim, torch.stack(list(lim.values())).tolist()))

    def _advance_chunk(self, s, sfc, ih, nmax):
        """One chunk from (s, sfc): at most nmax steps, the last clamped
        onto the integer horizon ih; then the host bookkeeping of
        microhh_tpu/model.py:1125-1141.  Returns (s, sfc, the limit rates
        of the final state)."""
        from .timeloop import IFACTOR
        tl, loop = self.timeloop, self.build_chunk()
        loop.start(tl.dt, ih / IFACTOR)
        s, sfc, aux = loop.run(s, sfc, nmax)
        lim = self.limits(s, sfc)
        carried = [loop.tau, loop.dt] + [x.to(loop.tau.dtype)
                                         for x in (loop.n, loop.done)]
        vals = torch.stack(carried + list(lim.values())).tolist()
        tau, dt_dev, n, done = vals[0], vals[1], int(vals[2]), bool(vals[3])
        if n == 0:
            raise RuntimeError("chunk made no progress (dt underflow?)")
        if self.outputs() and "p" in aux:
            # the graphs' pressure lives in their pool: keep a copy
            self._last_aux = {"p": aux["p"].clone()}
        self._last_sfc = sfc
        tl.iteration += n
        if done:
            tl.itime += ih       # exact: the last dt was clamped
        else:
            tl.itime += int(round(tau * IFACTOR))
        tl.time = tl.itime / IFACTOR
        tl.idt = max(int(round(dt_dev * IFACTOR)), 1)
        tl.dt = tl.idt / IFACTOR
        tl.iotime = tl.itime // tl.iiotimeprec
        if tl.itime >= tl.iendtime:
            tl.loop = False
        return s, sfc, dict(zip(lim, vals[4:]))

    def _run_chunked(self, status_file):
        """The event-driven outer loop around the chunks
        (microhh_tpu/model.py:1079-1143): status, statistics, dump, then
        the restart (not at the first pass) and the end, between chunks."""
        tl = self.timeloop
        s, sfc = self.as_device_state(self.load_state())
        sfc = self.sbot2d.apply_static(self, sfc)
        if not self.built:
            self.build_step()
        self.build_chunk()
        t0, it0 = _time.perf_counter(), tl.iteration
        lim = self._host_limits(s, sfc)
        first = True
        while True:
            cfl = lim.get("cfl_rate", 0.) * tl.dt
            dn = lim.get("dn_rate", 0.) * tl.dt
            if tl.do_check():
                self.print_status(s, sfc, cfl, dn, status_file)
            if tl.is_stats_step():
                self.write_outputs(s, sfc, self._last_aux, tl.iotime)
            if (not first and tl.do_save(self.at_wall_clock_limit())
                    and tl.iteration != 0):
                self._last_sfc = sfc
                self.save_restart(s)
            first = False
            if tl.is_finished():
                break
            ih = self._chunk_horizon(self.at_wall_clock_limit())
            nmax = 1 << 30
            if tl.outputiter > 0:
                nmax = tl.outputiter - tl.iteration % tl.outputiter
            s, sfc, lim = self._advance_chunk(s, sfc, ih, nmax)
        self.loop_wall = (tl.iteration - it0, _time.perf_counter() - t0)
        self.final_sfc = sfc
        return s

    def run(self, max_iters=None):
        """The time loop: adaptive dt landing on the statistics' and dumps'
        sampling times, status table, statistics, dumps, restarts.  Returns
        the final state.  Without max_iters it is the chunked loop where
        the JAX package takes it (microhh_tpu/model.py:1219-1229: adaptive
        dt, MICROHH_CHUNK not 0, MICROHH_PROFILE unset), else the per-step
        host loop (model.py:1231-1343 of the JAX package).  ``loop_wall``:
        (steps, seconds) of the loop, its set-up left out."""
        if (max_iters is None and self._chunk_supported()
                and os.environ.get("MICROHH_PROFILE") is None):
            with open(self._status_path(), "a") as status_file:
                status_file.write(
                    "%8s %11s %10s %11s %8s %8s %11s %16s %16s %16s\n"
                    % ("ITER", "TIME", "CPUDT", "DT", "CFL", "DNUM",
                       "DIV", "MOM", "TKE", "MASS"))
                return self._run_chunked(status_file)
        tl = self.timeloop
        s, sfc = self.as_device_state(self.load_state())
        sfc = self.sbot2d.apply_static(self, sfc)
        if not self.built:
            self.build_step()
        cflmax = getattr(self.advec, "cflmax", 1.0)
        cflmin = getattr(self.advec, "cflmin", 1.e-5)
        dnmax = getattr(self.diff, "dnmax", None)
        niter = 0
        t0 = _time.perf_counter()
        with open(self._status_path(), "a") as status_file:
            status_file.write("%8s %11s %10s %11s %8s %8s %11s %16s %16s %16s\n"
                              % ("ITER", "TIME", "CPUDT", "DT", "CFL", "DNUM",
                                 "DIV", "MOM", "TKE", "MASS"))
            while True:
                sfc = self.update_timedep(sfc)
                # adaptive time step (model.cxx:730-751)
                tl.reset_time_step_limit(self.at_wall_clock_limit())
                # land on the sampling times (stats get_time_limit), before
                # the CFL and diffusion limits, in the JAX package's order
                for comp in self.outputs():
                    tl.set_time_step_limit(
                        comp.isampletime - tl.itime % comp.isampletime)
                # one read of the rates to the host
                lim = self._host_limits(s, sfc)
                cfl = lim.get("cfl_rate", 0.) * tl.dt
                dn = lim.get("dn_rate", 0.) * tl.dt
                if "cfl_rate" in lim:
                    tl.set_time_step_limit(tl.idt * cflmax / max(cfl, cflmin))
                if dnmax is not None and dn > 0.:
                    tl.set_time_step_limit(tl.idt * dnmax / dn)
                if "micro_rate" in lim:
                    micro_cfl = max(lim["micro_rate"] * tl.dt, 1e-5)
                    tl.set_time_step_limit(tl.idt * self.micro.cflmax / micro_cfl)
                tl.set_time_step()
                if tl.do_check():
                    self.print_status(s, sfc, cfl, dn, status_file)
                if tl.is_stats_step():
                    self.write_outputs(s, sfc, self._last_aux, tl.iotime)
                if tl.is_finished():
                    break
                s, sfc, aux = self.step(s, sfc, tl.dt)
                if self.outputs():
                    # the pressure for the budgets and the outputs; nothing
                    # else of the step's aux outlives it
                    self._last_aux = {"p": aux.get("p")}
                self._last_sfc = sfc
                tl.step_time()
                if tl.do_save(self.at_wall_clock_limit()):
                    self.save_restart(s)
                niter += 1
                if max_iters is not None and niter >= max_iters:
                    break
        self.loop_wall = (niter, _time.perf_counter() - t0)
        self.final_sfc = sfc
        return s

    # ------------------------------------------------------------------
    #  post-processing mode (microhh_tpu/model.py:1349-1383; reference
    #  model.cxx:523-543): re-read restart files and re-run the output
    #  blocks, no time integration
    # ------------------------------------------------------------------
    def _rediagnose(self, s, sfc):
        """(sfc, aux) of a state read back: the eddy viscosity as the
        step's path computes it, and the surface where the boundary has a
        surface model.  The caller's state keeps its ghost levels."""
        ctx, fz = self.ctx, self.fused
        s_g = ghost_filled(self.boundary, ctx, s, sfc)
        if fz is None or (self.plain and not isinstance(self.diff, DiffSmag2)):
            aux = self.diff.exec_viscosity(ctx, s_g, sfc, {})
        elif self.generic or self.unfolded:
            aux = generic_viscosity(fz, ctx, s_g, sfc, {})
        else:
            aux = exec_viscosity(fz, ctx, s_g, sfc, {})
        if getattr(self.boundary, "is_surface", False):
            sfc = self.boundary.exec(ctx, s_g, sfc, aux)
        return sfc, aux

    def post(self):
        """Every saved time from the start to the end, postproctime apart:
        its restart files read back, the surface and the eddy viscosity
        re-diagnosed, then the statistics, cross sections, dump and
        columns of that state."""
        tl = self.timeloop
        if not self.built:
            self.build_step()
        while True:
            iotime = int(tl.iotime)
            tl.load(iotime, self.workdir)
            state = self.fields.load(iotime, self.workdir,
                                     dtype=NP_DTYPE[self.dtype])
            s, sfc = self.as_device_state(state)
            sfc, aux = self._rediagnose(s, sfc)
            self.write_outputs(s, sfc, aux, iotime)
            tl.step_post_proc_time()
            if tl.is_finished():
                break


def run_case(case_dir, casename, mode, dtype=torch.float32, device="cuda",
             input_nc=None):
    """CLI entry: microhh {init,run,post} casename (reference
    main/microhh.cxx; microhh_tpu/model.py:1386-1417).  ``input_nc``: the
    case's input profiles in memory (``cases.py``) in place of
    ``<case_dir>/<casename>_input.nc``."""
    ini = Ini(os.path.join(case_dir, "%s.ini" % casename))
    model = Model(ini, mode, casename, workdir=case_dir, dtype=dtype,
                  device=device, input_nc=input_nc)
    model.finish_setup()
    if mode == "init":
        # the run-time output options are consumed in init mode too, like
        # the reference, so init does not flag them as unused
        for section in ("stats", "cross", "dump", "column", "budget"):
            for item, subs in ini.items.get(section, {}).items():
                for sub in subs:
                    ini.flag_as_used(section, item, sub)
        model.save_initial_state()
    elif mode in ("run", "post"):
        if ini.get_int("stats", "swstats", default=0):
            model.stats = Stats(model)
        for attr, kind in (("cross", Cross), ("dump", Dump),
                           ("column", Column)):
            comp = kind(model)
            setattr(model, attr, comp if comp.sw else None)
        try:
            if mode == "run":
                model.run()
            else:
                model.post()
        finally:
            if model.stats is not None:
                model.stats.close()
            if model.column is not None:
                model.column.close()
    else:
        raise ValueError("unknown mode %s" % mode)
    unused = model.ini.unused_items()
    if unused:
        print("WARNING unused ini options:", ", ".join(
            "[%s] %s%s" % (s, i, "[%s]" % su if su else "") for s, i, su in unused))
    return model
