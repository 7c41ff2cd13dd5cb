"""The 2nd-order plain substep for every configuration that the JAX package
runs on its op path at order 2, the port against the JAX package in float64
on the CPU:

* the operators, on inputs made from a numpy seed, <= 1e-12 of each
  field's maximum: ``DefaultBoundary`` at order 2 for each BC type and with
  the grid's translation (whole arrays, ghost levels included), ``Diff2``,
  the disabled advection, diffusion and pressure, ``ThermoDry`` with
  ``swbaroclinic`` at both orders, and ``swlspres=uflux`` at order 2;
* two steps of ``Model.run`` of taylorgreen (``jtot=1``), conservation,
  andren1994 with its passive scalar and eady (RK4, ``utrans``), each as
  its ini is written at a small size, from one set of restart files,
  against the JAX package's op path: every prognostic field, ghost levels
  included, <= 1e-10 of its maximum.  taylorgreen, conservation and eady
  take the plain substep; andren1994 with its scalar the generic kernels
  (K1 unstratified, K8/K9, K15), as the JAX package's gate sends it there:
  its thermo 0 has a ``get_n2``;
* the chunked loop of taylorgreen against the JAX package's;
* the routing: for each gate of the JAX package's ``_maybe_build_fused``
  (its kernels built with ``force_fused``), the path the port takes and the
  kernels ``Model.kernels()`` names; thermo dry with ``swbaroclinic`` goes
  to the generic kernels, whose step calls the thermo's ``exec``, where
  the JAX package's dry kernels would leave the baroclinic term out (two
  steps against its op path); smag2 on the plain substep (advec 0: K14
  and K7), two steps against the op path;
* conservation's statistics (``swstats=1`` with diff 0 and thermo 0)
  through both packages' ``run_case``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from chip_smoke import case_ini, read_stats, stats_agree
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.model import run_case as jrun_case
from microhh_torch import cases
from microhh_torch import model as model_module
from microhh_torch.config import Ini
from microhh_torch.model import Model, run_case
from test_torch_timedep import jax_run, port_run, write_nc

SEED = 11


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def pair(tmp_path, casename, text, mem=None, fused=False):
    """The port's model and the JAX package's of one ini, both set up for
    a run, the JAX one on mem written as its input file; fused: the JAX
    package's kernels built (force_fused), to read its gates."""
    tm = Model(Ini(text), "run", casename, workdir=str(tmp_path),
               dtype=torch.float64, device="cpu", input_nc=mem)
    tm.finish_setup()
    if mem is not None:
        write_nc(tmp_path / ("%s_input.nc" % casename), mem)
    jm = JModel(JIni(text), "run", casename, workdir=str(tmp_path),
                dtype=np.float64)
    jm.force_fused = fused
    jm.finish_setup()
    return tm, jm


def seeded(tm, seed=SEED, names=None):
    """Seeded numpy fields of the model's shape, ghost levels included."""
    rng = np.random.RandomState(seed)
    shape = (tm.ctx.kcells, tm.ctx.jtot, tm.ctx.itot)
    names = names or tm.fields.prognostic_names
    return {n: rng.randn(*shape) for n in names}


def initial_files(tmp_path, casename, text, mem):
    """The JAX package's init of a case into tmp_path/jax, on mem written
    as its input file where the case has one, and a copy of its restart
    files in tmp_path/torch; returns the two directories."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir(parents=True)
    tdir.mkdir(parents=True)
    if mem is not None:
        write_nc(jdir / ("%s_input.nc" % casename), mem)
    jm = JModel(JIni(text), "init", casename, workdir=str(jdir),
                dtype=np.float64)
    jm.finish_setup()
    jm.save_initial_state()
    for fn in os.listdir(str(jdir)):
        if not fn.endswith(".nc"):
            shutil.copy(str(jdir / fn), str(tdir / fn))
    return jdir, tdir


def as_jax(fields):
    import jax.numpy as jnp
    return {n: jnp.asarray(a) for n, a in fields.items()}


def as_torch(tm, fields):
    return {n: tm.ctx.tensor(a) for n, a in fields.items()}


# --------------------------------------------------------------------------
#  the operators
# --------------------------------------------------------------------------

BOUNDARIES = {
    "noslip_dirichlet_utrans": (
        "mbcbot=noslip\nmbctop=noslip\nsbcbot=dirichlet\nsbctop=dirichlet\n"
        "sbot=1.5\nstop=-0.5\nubot=0.3\nutop=2.\nvbot=-0.2\nvtop=0.7",
        "utrans=5.\nvtrans=-2."),
    "freeslip_neumann": (
        "mbcbot=freeslip\nmbctop=freeslip\nsbcbot=neumann\nsbctop=neumann\n"
        "sbot=0.01\nstop=-0.003", ""),
    "noslip_flux": (
        "mbcbot=noslip\nmbctop=freeslip\nsbcbot=flux\nsbctop=flux\n"
        "sbot=0.1\nstop=-0.02", "utrans=1.5"),
    "freeslip_noslip_mixed": (
        "mbcbot=freeslip\nmbctop=noslip\nsbcbot=dirichlet\nsbctop=flux\n"
        "sbot=2.\nstop=0.05\nutop=1.", "vtrans=3."),
}


def boundary_ini(bcs, grid_extra):
    """conservation.ini at 8 x 6 x 8 with another [boundary] section, a
    second scalar and a non-zero viscosity (a flux BC divides by it)."""
    text = case_ini("conservation", itot=8, jtot=6, ktot=8, slist="s,q",
                    visc="1e-3", svisc="2e-3")
    head, rest = text.split("[boundary]")
    tail = rest[rest.index("[time]"):]
    text = head + "[boundary]\n" + bcs + "\n\n" + tail
    return text.replace("[grid]\n", "[grid]\n" + grid_extra + "\n")


@pytest.mark.parametrize("bcs", sorted(BOUNDARIES))
def test_default_boundary_2nd_matches_jax(bcs, tmp_path):
    """Every field's ghost levels from the static BCs, in place; whole
    arrays against the JAX package's fill; names= fills only those."""
    tm, jm = pair(tmp_path, "conservation", boundary_ini(*BOUNDARIES[bcs]))
    assert tm.ctx.spatial_order == 2 and tm.boundary.in_place
    state = seeded(tm)
    js = jm.boundary.set_ghost_cells(jm.ctx, as_jax(state), {})
    ts = as_torch(tm, state)
    before = dict(ts)
    out = tm.boundary.set_ghost_cells(tm.ctx, ts, {})
    assert out is ts and all(out[n] is before[n] for n in ts)
    for n in ts:
        assert rel(ts[n], js[n]) <= 1e-12, n
    # w has no ghost level at 2nd order
    assert np.array_equal(ts["w"].numpy(), state["w"])
    part = as_torch(tm, state)
    tm.boundary.set_ghost_cells(tm.ctx, part, {}, names=("s",))
    assert rel(part["s"], js["s"]) <= 1e-12
    for n in ("u", "v", "q"):
        assert np.array_equal(part[n].numpy(), state[n]), n


def test_diff2_matches_jax(tmp_path):
    """swdiff=2: the tendencies of every field and the diffusion number."""
    text = case_ini("taylorgreen", itot=12, ktot=8).replace(
        "[fields]\n", "[fields]\nslist=s\nsvisc=3e-4\n").replace(
        "[boundary]\n", "[boundary]\nsbcbot=neumann\nsbctop=neumann\n"
        "sbot=0.\nstop=0.\n")
    tm, jm = pair(tmp_path, "taylorgreen", text)
    assert type(tm.diff).__name__ == "Diff2" == type(jm.diff).__name__
    state = seeded(tm)
    tend = seeded(tm, SEED + 1)
    jt = jm.diff.exec(jm.ctx, as_jax(state), as_jax(tend), {}, {})
    tt = tm.diff.exec(tm.ctx, as_torch(tm, state), as_torch(tm, tend), {})
    for n in tt:
        assert rel(tt[n], jt[n]) <= 1e-12, n
    assert rel(float(tm.diff.get_dn(tm.ctx, None, {})),
               float(jm.diff.get_dn(jm.ctx, None, {}))) <= 1e-12
    assert tm.diff.exec_viscosity(tm.ctx, None, {}, {"a": 1}) == {"a": 1}


def test_disabled_ops_match_jax(tmp_path):
    """swadvec=0, swdiff=0 and swpres=0: no tendency, no eddy viscosity,
    no limit, and a divergence of 0."""
    text = case_ini("conservation", itot=8, jtot=8, ktot=8, swadvec=0,
                    swpres=0)
    tm, jm = pair(tmp_path, "conservation", text)
    state, tend = seeded(tm), seeded(tm, SEED + 1)
    for op, jop in ((tm.advec, jm.advec), (tm.diff, jm.diff)):
        assert type(op).__name__ == "DisabledOp" == type(jop).__name__
        ts, tt = as_torch(tm, state), as_torch(tm, tend)
        out = op.exec(tm.ctx, ts, tt, {})
        assert out is tt and all(np.array_equal(tt[n].numpy(), tend[n])
                                 for n in tt)
        assert op.cfl_max(tm.ctx, ts) is None is jop.cfl_max(jm.ctx, state)
        assert op.get_dn(tm.ctx, ts, {}) is None is jop.get_dn(jm.ctx, state,
                                                                {})
        assert op.exec_viscosity(tm.ctx, ts, {}, {"a": 1}) == {"a": 1}
    assert type(tm.pres).__name__ == "PresDisabled" == type(jm.pres).__name__
    ts, tt = as_torch(tm, state), as_torch(tm, tend)
    assert tm.pres.exec(tm.ctx, ts, tt, {}, 2.) == {}
    assert all(np.array_equal(tt[n].numpy(), tend[n]) for n in tt)
    div = tm.pres.divergence_max(tm.ctx, ts)
    assert div.dtype == torch.float64 and float(div) == 0. == float(
        jm.pres.divergence_max(jm.ctx, as_jax(state)))


@pytest.mark.parametrize("order", [2, 4])
def test_thermo_dry_baroclinic_matches_jax(order, tmp_path, monkeypatch):
    """ThermoDry.exec with swbaroclinic: the buoyancy and the -dthetady_ls v
    term, at either order (at 4th order the step refuses thermo dry, so
    check_slice is set aside here)."""
    monkeypatch.setattr(model_module, "check_slice", lambda *a: None)
    text = case_ini("eady", itot=8, jtot=6, ktot=8, swspatialorder=order)
    if order == 4:
        text = text.replace("swadvec=2i5", "swadvec=4").replace(
            "swpres=2", "swpres=4").replace("swdiff=0", "swdiff=4").replace(
            "swlspres=geo", "swlspres=0")
    mem = cases.eady_input(8, 1000.)
    tm, jm = pair(tmp_path, "eady", text, mem)
    assert tm.thermo.swbaroclinic and tm.thermo.dthetady_ls == -1e-4
    state, tend = seeded(tm), seeded(tm, SEED + 1)
    state["th"] += 300.
    jt = jm.thermo.exec(jm.ctx, as_jax(state), as_jax(tend), {})
    tt = tm.thermo.exec(tm.ctx, as_torch(tm, state), as_torch(tm, tend), {})
    for n in tt:
        assert rel(tt[n], jt[n]) <= 1e-12, n
    assert rel(tt["th"], tend["th"]) > 1e-6    # the baroclinic term acted


def test_uflux_at_order_2_matches_jax(tmp_path):
    """swlspres=uflux: the body force that holds the domain mean of u,
    which reads the tendency and the substep's dt."""
    text = case_ini("conservation", itot=8, jtot=6, ktot=8).replace(
        "[thermo]", "[force]\nswlspres=uflux\nuflux=0.7\n\n[thermo]").replace(
        "[grid]\n", "[grid]\nutrans=0.25\n")
    tm, jm = pair(tmp_path, "conservation", text)
    state, tend = seeded(tm), seeded(tm, SEED + 1)
    jt = jm.force(jm.ctx, as_jax(state), as_jax(tend), {"subdt": 0.37}, {})
    tt = tm.force(tm.ctx, as_torch(tm, state), as_torch(tm, tend),
                  {"subdt": 0.37}, {})
    for n in tt:
        assert rel(tt[n], jt[n]) <= 1e-12, n
    assert rel(tt["u"], tend["u"]) > 1e-3


# --------------------------------------------------------------------------
#  the four cases, two steps each
# --------------------------------------------------------------------------

# the ini overrides of each case at its test size, its kernels, and its
# substeps a step
CASES = {
    "taylorgreen": ({"itot": 16, "ktot": 8},
                    ["dft_fwd", "tdma_ri", "dft_inv"], 3),
    "conservation": ({"itot": 8, "jtot": 8, "ktot": 8, "swstats": 0},
                     ["dft_fwd", "tdma_ri", "dft_inv"], 3),
    "andren1994": ({"itot": 8, "jtot": 8, "ktot": 8},
                   ["evisc", "tend_uvw", "tend_scalar_rk", "pres_rhs",
                    "dft_fwd", "tdma", "dft_inv", "pres_apply", "limits"], 3),
    "eady": ({"itot": 8, "jtot": 8, "ktot": 8},
             ["advec_mom", "advec_scalars", "dft_fwd", "tdma_ri", "dft_inv"],
             5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_two_steps_match_jax_op_path(case, tmp_path):
    over, names, nsub = CASES[case]
    text = case_ini(case, **over)
    ini = Ini(text)
    mem = cases.case_input(case, ini.get_int("grid", "ktot"),
                           ini.get_float("grid", "zsize"))
    jdir, tdir = initial_files(tmp_path, case, text, mem)
    jm, js = jax_run(jdir, case, text, 2)
    tm, ts = port_run(tdir, case, text, mem, 2)
    assert jm._fused is None                 # the JAX package's op path
    assert tm.timeloop.n_substeps == nsub
    if case == "andren1994":
        assert tm.generic and not (tm.plain or tm.unfolded)
        assert tm.fused.stratified == 0 and tm.fused.names == ("s",)
    else:
        assert tm.plain and tm.unfolded
    assert [k.name for k in tm.kernels()] == names
    assert tm.timeloop.iteration == jm.timeloop.iteration == 2
    assert tm.timeloop.itime == jm.timeloop.itime
    if case == "taylorgreen":
        assert tm.ctx.jtot == 1
    if case == "eady":
        assert tm.ctx.utrans == 5. and tm.thermo.swbaroclinic
    # the plain substep's state keeps its ghost levels, the RK-folded
    # kernels' s* has zero ones (each substep fills them anew)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    levels = slice(None) if tm.plain else slice(ks, ke)
    for n in tm.fields.prognostic_names:
        assert np.isfinite(ts[n]).all(), n
        assert rel(ts[n][levels], js[n][levels]) <= 1e-10, n


@pytest.mark.parametrize("case", ["taylorgreen"])
def test_case_chunked_run_matches_jax(case, tmp_path):
    """Model.run() without max_iters (the chunked loop, eager) to a few
    adaptive steps, against the JAX package's run()."""
    over = dict(CASES[case][0], endtime=0.03)
    text = case_ini(case, **over)
    ini = Ini(text)
    mem = cases.case_input(case, ini.get_int("grid", "ktot"),
                           ini.get_float("grid", "zsize"))
    jdir, tdir = initial_files(tmp_path, case, text, mem)
    jm = JModel(JIni(text), "run", case, workdir=str(jdir), dtype=np.float64)
    jm.finish_setup()
    js, _ = jm.run()
    tm = Model(Ini(text), "run", case, workdir=str(tdir), dtype=torch.float64,
               device="cpu", input_nc=mem)
    tm.finish_setup()
    ts = tm.run()
    assert tm._chunk is not None and tm.timeloop.iteration >= 2
    assert tm.timeloop.iteration == jm.timeloop.iteration
    assert tm.timeloop.itime == jm.timeloop.itime
    # the port's loop fills the final state's ghost levels in place (its
    # limits after the last step), the JAX package's returns the last
    # substep's: compare both after a fill
    js = jm.boundary.set_ghost_cells(jm.ctx, js, {})
    ts = tm.boundary.set_ghost_cells(tm.ctx, ts, {})
    for n in tm.fields.prognostic_names:
        assert rel(ts[n].numpy(), np.asarray(js[n])) <= 1e-10, n


# --------------------------------------------------------------------------
#  the routing
# --------------------------------------------------------------------------

def drycblles_text(**over):
    return case_ini("drycblles", itot=8, jtot=8, ktot=8, swstats=0, **over)


def baroclinic_text():
    return drycblles_text().replace(
        "swthermo=dry", "swthermo=dry\nswbaroclinic=1\ndthetady_ls=-1e-4")


# the port's path, the JAX package's (where it differs) and the kernels
ROUTES = {
    # the plain substep: no kernels of the JAX package
    "taylorgreen": (lambda: case_ini("taylorgreen", itot=16, ktot=8),
                    "taylorgreen", "plain", None,
                    ["dft_fwd", "tdma_ri", "dft_inv"]),
    "drycblles_advec_0": (lambda: drycblles_text(swadvec=0), "drycblles",
                          "plain", None, ["evisc_n2", "dft_fwd", "tdma_ri",
                                          "dft_inv", "limits"]),
    # the generic kernels: thermo 0 with a scalar (K1 unstratified), thermo
    # dry with a scalar besides th (K14 with the dry N2)
    "andren1994_with_s": (
        lambda: case_ini("andren1994", itot=8, jtot=8, ktot=8), "andren1994",
        "generic", None,
        ["evisc", "tend_uvw", "tend_scalar_rk", "pres_rhs", "dft_fwd", "tdma",
         "dft_inv", "pres_apply", "limits"]),
    "drycblles_with_s": (
        lambda: drycblles_text().replace(
            "[fields]\n", "[fields]\nslist=s\nsvisc[s]=1e-5\n").replace(
            "sbctop=neumann", "sbctop=neumann\nsbot[s]=0.\nstop[s]=0."),
        "drycblles", "generic", None,
        ["evisc_n2", "tend_uvw", "tend_scalars", "pres_rhs", "dft_fwd",
         "tdma", "dft_inv", "pres_apply", "limits"]),
    "drycblles_baroclinic": (
        baroclinic_text, "drycblles", "generic", "dry",
        ["evisc_n2", "tend_uvw", "tend_scalar_rk", "pres_rhs", "dft_fwd",
         "tdma", "dft_inv", "pres_apply", "limits"]),
    # uflux reads the tendency: the substep without the RK fold
    "drycblles_uflux": (
        lambda: drycblles_text().replace(
            "swlspres=0", "swlspres=uflux\nuflux=0.5"),
        "drycblles", "unfolded", None,
        ["evisc", "tendencies", "dft_fwd", "tdma_ri", "dft_inv", "limits"]),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routing_follows_the_jax_gates(route, tmp_path):
    """The path of each gate: plain where the JAX package builds no
    kernels, generic where it builds its generic set, the dry substep
    without the RK fold where its RK fold is off; and the kernels that
    Model.kernels() names for it."""
    make, casename, path, jax_path, names = ROUTES[route]
    text = make()
    ini = Ini(text)
    mem = cases.case_input(casename, ini.get_int("grid", "ktot"),
                           ini.get_float("grid", "zsize"))
    tm, jm = pair(tmp_path, casename, text, mem, fused=True)
    tm.build_step()
    jm.build_step()
    fz = jm._fused
    assert tm.plain == (fz is None) == (path == "plain")
    if path == "generic":
        assert tm.generic and not tm.unfolded
    if path == "unfolded":
        assert tm.unfolded and not tm.generic
    jax_path = jax_path or path
    if jax_path == "generic":
        assert fz.generic and jm._use_rkfold_generic
    if jax_path == "unfolded":
        assert not (fz.generic or jm._use_rkfold)
    if jax_path == "dry":
        assert jm._use_rkfold and not fz.generic
    assert [k.name for k in tm.kernels()] == names


def test_dry_baroclinic_two_steps_match_jax(tmp_path):
    """drycblles with swbaroclinic on the generic kernels, against the JAX
    package's op path, whose thermo exec carries the term."""
    text = baroclinic_text()
    mem = cases.drycblles_input(8)
    jdir, tdir = initial_files(tmp_path, "drycblles", text, mem)
    jm, js = jax_run(jdir, "drycblles", text, 2)
    tm, ts = port_run(tdir, "drycblles", text, mem, 2)
    assert jm._fused is None and tm.generic and tm.thermo.swbaroclinic
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in tm.fields.prognostic_names:
        assert rel(ts[n][ks:ke], js[n][ks:ke]) <= 1e-10, n


def test_smag2_on_the_plain_substep_matches_jax(tmp_path):
    """drycblles with swadvec=0: smag2 on the plain substep, its eddy
    viscosity through K14 with the MOST row and diff.exec in plain torch,
    the limits from K7 without a CFL rate; two steps against the JAX
    package's op path."""
    text = drycblles_text(swadvec=0)
    mem = cases.drycblles_input(8)
    jdir, tdir = initial_files(tmp_path, "drycblles", text, mem)
    jm, js = jax_run(jdir, "drycblles", text, 2)
    tm, ts = port_run(tdir, "drycblles", text, mem, 2)
    assert tm.plain and tm.fused.stratified == 2
    state = {n: tm.ctx.tensor(a) for n, a in ts.items()}
    assert set(tm.limits(state, tm.final_sfc)) == {"dn_rate"}
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in tm.fields.prognostic_names:
        assert rel(ts[n][ks:ke], js[n][ks:ke]) <= 1e-10, n


def test_smag2_without_the_surface_or_a_thermo_scalar_raises(tmp_path):
    """K1 carries no Van Driest damping: smag2 under the default boundary
    with thermo 0 stays outside the slice (item 14)."""
    text = case_ini("taylorgreen", itot=16, ktot=8).replace(
        "[diff]\n", "[diff]\nswdiff=smag2\n")
    with pytest.raises(NotImplementedError, match="item 14"):
        Model(Ini(text), "run", "taylorgreen", dtype=torch.float64,
              device="cpu")


# --------------------------------------------------------------------------
#  statistics without an eddy viscosity
# --------------------------------------------------------------------------

def test_conservation_stats_match_jax(tmp_path, monkeypatch):
    """conservation as written at 8^3 to two samples (swstats=1, diff 0,
    thermo 0, a passive scalar) through both packages' run_case."""
    monkeypatch.setenv("MICROHH_CHUNK", "0")
    dirs = {}
    for label in ("t", "j"):
        wd = tmp_path / label
        wd.mkdir()
        (wd / "conservation.ini").write_text(case_ini(
            "conservation", itot=8, jtot=8, ktot=8, endtime=10, savetime=10))
        dirs[label] = str(wd)
    for mode in ("init", "run"):
        run_case(dirs["t"], "conservation", mode, dtype=torch.float64,
                 device="cpu")
        jrun_case(dirs["j"], "conservation", mode, dtype=np.float64)
    name = "conservation.default.0000000.nc"
    a = read_stats(os.path.join(dirs["t"], name))
    b = read_stats(os.path.join(dirs["j"], name))
    assert list(b["time"]) == [0., 10.] and set(a) == set(b)
    assert ("default", "s_diff") in b and ("default", "evisc") not in b
    errs = stats_agree(a, b, "conservation")
    assert max(errs.values()) <= 1e-10, max(errs.items(), key=lambda kv: kv[1])


# --------------------------------------------------------------------------
#  chip_smoke.py's checks of these paths, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,n,k,forms", [
    ("taylorgreen", (16, 1), 8, "plain_kernel_cases"),
    ("conservation", 8, 8, "plain_kernel_cases"),
    ("andren1994", 8, 8, "generic_kernel_cases"),
    ("eady", 8, 8, "plain_kernel_cases")])
def test_chip_smoke_written_kernel_cases_on_the_cpu(case, n, k, forms,
                                                    monkeypatch):
    """chip_smoke.py's [30] check of a case's kernels at its path's shapes
    and [4e]'s seeded state, on a small model on the CPU (both calls take
    the plain version here): path_forms picks the path's cases, and they
    hold every kernel that the path launches."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    m = chip_smoke.build_case(torch, case, n, k, torch.float64, "cpu")
    m.build_step()
    cases_fn, _ = chip_smoke.path_forms(m)
    assert cases_fn is getattr(chip_smoke, forms)
    errs = chip_smoke.check_kernels_full(torch, m, cases_fn)
    assert {kern.name for kern in m.kernels()} == set(errs)
    assert all(err == 0. for err in errs.values())
    s, sfc = m.as_device_state(chip_smoke.generic_state(m, 7))
    s, sfc, _ = m.step(s, sfc, m.timeloop.dt)
    assert all(bool(torch.isfinite(a).all()) for a in s.values())
