"""Time-dependent boundaries and forcings of the port (``microhh_torch/
timedep.py`` and its consumers) against the JAX package's, in float64 on
the CPU:

* ``Timedep``, ``BoundaryTimedep`` and ``Sbot2D`` bit for bit against the
  originals on the same inputs (the out-of-range raise, the bottom BC's
  plane, the window of 2-D maps);
* gabls1's cooling ramp through ``Model.run()`` on the per-step loop (as
  tests/test_timedep.py::test_gabls1_cooling_ramp), and gabls1 as written
  with a steep series two steps against the JAX Model fed the same file;
* the geostrophic wind, large-scale sources and subsidence over time
  (``Force.update_timedep``, the op ``Force.__call__`` and the generic
  path's column tables) and a two-step run of a dry case with all three,
  which takes the substep without the RK fold; ``swtimedep_pbot`` through
  the moist base-state update;
* the time-dependent strength and location of a source (as
  tests/test_source.py::test_timedep_strength_and_location);
* ``sbot_2d_list`` static and time-dependent, with map files in tmp_path.

Every comparison is held to 1e-10 (the classes bit for bit), and each test
has a control: a steep series of its own shows that leaving the update out
changes the result by at least 1e3 times that tolerance.
"""

import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from microhh_tpu import timedep as JT
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops import pallas_fused as JF
from microhh_tpu.utils import nc as jnc
from microhh_torch import cases, timedep as TT
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import fused as F
from microhh_torch.timeloop import IFACTOR
from microhh_torch.utils.nc import MemoryDataset

TOL = 1e-10
CONTROL = 1e3 * TOL
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# --------------------------------------------------------------------------
#  inputs and pairs of runs
# --------------------------------------------------------------------------

def time_dim(name):
    """The time axis of a timedep variable, by the reference's names."""
    if name.startswith("source_"):
        return "time_source"
    if name.endswith("_sbot"):
        return "time_surface"
    return "time_ls"


def write_nc(path, mem):
    """A MemoryDataset (z, the init group and a timedep group of series
    and profiles over time) as the netCDF-4 file a case script writes."""
    f = jnc.Dataset(str(path), "w")
    z = np.asarray(mem.variables["z"][:])
    f.createDimension("z", len(z))
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, var in mem.groups["init"].variables.items():
        g.createVariable(name, "f8", ("z",))[:] = np.asarray(var[:])
    if "timedep" in mem.groups:
        tv = mem.groups["timedep"].variables
        td = f.createGroup("timedep")
        for name in tv:
            if name.startswith("time_"):
                td.createDimension(name, len(tv[name][:]))
                td.createVariable(name, "f8", (name,))[:] = np.asarray(tv[name][:])
        for name, var in tv.items():
            if not name.startswith("time_"):
                a = np.asarray(var[:])
                dims = (time_dim(name),) + (("z",) if a.ndim == 2 else ())
                td.createVariable(name, "f8", dims)[:] = a
    f.close()


def with_timedep(mem, **series):
    """mem with its timedep group replaced by the given arrays."""
    return MemoryDataset({"z": mem.variables["z"][:]},
                         {"init": dict(mem.groups["init"].variables),
                          "timedep": series})


def initial_files(tmp_path, casename, text, mem=None, script=None):
    """The JAX package's init of a case into tmp_path/jax (its input the
    file of script, run there, or mem written by write_nc) and a copy of its
    restart files in tmp_path/torch; returns the two directories."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    (jdir / ("%s.ini" % casename)).write_text(text)
    if script is not None:
        cwd = os.getcwd()
        os.chdir(str(jdir))
        try:
            import runpy
            runpy.run_path(script)
        finally:
            os.chdir(cwd)
    else:
        write_nc(jdir / ("%s_input.nc" % casename), mem)
    jm = JModel(JIni(text), "init", casename, workdir=str(jdir),
                dtype=np.float64)
    jm.finish_setup()
    jm.save_initial_state()
    for fn in os.listdir(str(jdir)):
        if not fn.endswith((".nc", ".ini")):
            shutil.copy(str(jdir / fn), str(tdir / fn))
    return jdir, tdir


def jax_run(jdir, casename, text, iters):
    jm = JModel(JIni(text), "run", casename, workdir=str(jdir),
                dtype=np.float64)
    jm.finish_setup()
    s, _ = jm.run(max_iters=iters)
    return jm, {k: np.asarray(v) for k, v in s.items()}


def port_run(tdir, casename, text, mem, iters, update=True):
    """The port's run of the copied restart files; update=False leaves
    the time-dependent values at their start (the control)."""
    tm = Model(Ini(text), "run", casename, workdir=str(tdir),
               dtype=torch.float64, device="cpu", input_nc=mem)
    tm.finish_setup()
    if not update:
        tm.update_timedep = lambda sfc: sfc
    s = tm.run(max_iters=iters)
    return tm, {k: v.numpy() for k, v in s.items()}


def state_err(tm, a, b):
    ks, ke = tm.ctx.ks, tm.ctx.ke
    return max(rel(a[n][ks:ke], b[n][ks:ke]) for n in tm.fields.prognostic_names)


def pair_against_jax(tmp_path, casename, text, mem, script=None, iters=2):
    """iters steps of the case on the per-step loop in the JAX package and
    in the port from one set of restart files, and the port's run without
    the updates: returns (port model, error against JAX, change without the
    updates)."""
    jdir, tdir = initial_files(tmp_path, casename, text, mem, script)
    jm, js = jax_run(jdir, casename, text, iters)
    tm, ts = port_run(tdir, casename, text, mem, iters)
    _, off = port_run(tdir, casename, text, mem, iters, update=False)
    for key, plane in tm.final_sfc.items():
        if key.endswith(("_bot", "_fluxbot")) and key in jm.final_sfc:
            assert rel(plane.numpy(), jm.final_sfc[key]) <= TOL, key
    return tm, state_err(tm, ts, js), state_err(tm, off, ts)


# --------------------------------------------------------------------------
#  Timedep, BoundaryTimedep, Sbot2D
# --------------------------------------------------------------------------

def series_input():
    rng = np.random.RandomState(3)
    t = np.cumsum(rng.rand(9) * 500.)
    t[0] = 0.
    return MemoryDataset({"z": np.arange(4.)}, {"timedep": {
        "time_surface": t, "x_sbot": rng.randn(9),
        "time_ls": t[:5], "y_ls": rng.randn(5, 4)}})


def test_timedep_interpolates_bit_for_bit_and_raises_outside():
    mem = series_input()
    for name, dim in (("x_sbot", "time_surface"), ("y_ls", "time_ls")):
        mine, ref = TT.Timedep(mem, name, dim), JT.Timedep(mem, name, dim)
        assert np.array_equal(mine.itime, ref.itime)
        end = int(ref.itime[-1])
        for itime in list(ref.itime.astype(int)) + [
                int(x) for x in np.linspace(0, end, 37)]:
            assert np.array_equal(mine.interpolate(itime),
                                  ref.interpolate(itime)), itime
        # the last point of the series is inside it; a step past it raises
        assert np.array_equal(mine.interpolate(end), ref.data[-1])
        for itime in (-1, end + 1):
            with pytest.raises(ValueError, match="out of range"):
                mine.interpolate(itime)
            with pytest.raises(ValueError, match="out of range"):
                ref.interpolate(itime)
    with pytest.raises(KeyError):
        TT.Timedep(mem, "th_sbot")


class FakeBoundary:
    def __init__(self, bcbot):
        self.bcs = {n: type("BC", (), {"bcbot": b})
                    for n, b in bcbot.items()}


class FakeModel:
    """What BoundaryTimedep and Sbot2D read of a model."""

    def __init__(self, bcbot, dtype, workdir=".", n=(6, 5)):
        self.boundary = FakeBoundary(bcbot)
        self.dtype = dtype
        self.workdir = workdir
        self.grid = type("G", (), {"itot": n[0], "jtot": n[1]})
        self.timeloop = type("TL", (), {"iiotimeprec": IFACTOR})


BCS = {"th": "dirichlet", "qt": "flux", "s": "neumann"}
KEYS = {"th": "th_bot", "qt": "qt_fluxbot", "s": "s_gradbot"}


def test_boundary_timedep_sets_the_bc_plane_bit_for_bit():
    rng = np.random.RandomState(4)
    t = np.array([0., 100., 400.])
    mem = MemoryDataset({}, {"timedep": dict(
        time_surface=t, th_sbot=[290., 250., 300.],
        qt_sbot=rng.rand(3), s_sbot=rng.randn(3))})
    text = ("[boundary]\nswtimedep=1\n"
            "timedeplist=th_sbot,qt_sbot,s_sbot,u_geo\n")
    mine = TT.BoundaryTimedep(Ini(text), None, mem)
    ref = JT.BoundaryTimedep(JIni(text), None, mem)
    assert set(mine.items) == set(ref.items) == set(BCS)
    sfc0 = {k: 0.5 + rng.rand(5, 6) for k in KEYS.values()}
    for itime in (0, 37 * IFACTOR, 250 * IFACTOR, 400 * IFACTOR):
        a = mine.update(FakeModel(BCS, torch.float64),
                        {k: torch.tensor(v) for k, v in sfc0.items()}, itime)
        b = ref.update(FakeModel(BCS, np.float64),
                       {k: jnp.asarray(v) for k, v in sfc0.items()}, itime)
        for k in KEYS.values():
            assert a[k].dtype == torch.float64
            assert np.array_equal(a[k].numpy(), np.asarray(b[k])), (itime, k)
    # control: the update replaces the start value (290 K at 0)
    assert float(a["th_bot"][0, 0]) == 300.
    # a float32 plane takes the float64 value rounded once
    a32 = mine.update(FakeModel(BCS, torch.float32),
                      {k: torch.tensor(v, dtype=torch.float32)
                       for k, v in sfc0.items()}, 37 * IFACTOR)
    want = np.float32(ref.items["th"].interpolate(37 * IFACTOR))
    assert a32["th_bot"].dtype == torch.float32
    assert np.all(a32["th_bot"].numpy() == want)
    with pytest.raises(NotImplementedError, match="surface"):
        mine.update(FakeModel(BCS, torch.float64), {}, 0)


def write_maps(wd, maps, dtype=np.float64):
    for iotime, fld in maps.items():
        fld.astype(dtype).tofile(os.path.join(wd, "th_bot_in.%07d" % iotime))


@pytest.mark.parametrize("timedep", [False, True])
def test_sbot2d_window_bit_for_bit(tmp_path, timedep):
    rng = np.random.RandomState(5)
    maps = {it: 260. + 10. * rng.rand(5, 6) for it in (0, 300, 600, 900)}
    write_maps(str(tmp_path), maps)
    text = "[boundary]\nsbot_2d_list=th\n" + (
        "swtimedep_sbot_2d=1\nsbot_2d_loadtime=300\n" if timedep else "")
    mine, ref = TT.Sbot2D(Ini(text), None), JT.Sbot2D(JIni(text), None)
    assert mine.swtimedep == ref.swtimedep == timedep
    tmod = FakeModel(BCS, torch.float64, str(tmp_path))
    jmod = FakeModel(BCS, np.float64, str(tmp_path))
    sfc_t = {"th_bot": torch.full((5, 6), 265., dtype=torch.float64)}
    sfc_j = {"th_bot": jnp.full((5, 6), 265.)}
    if not timedep:
        a = mine.apply_static(tmod, sfc_t)["th_bot"].numpy()
        assert np.array_equal(a, np.asarray(ref.apply_static(jmod, sfc_j)["th_bot"]))
        assert np.array_equal(a, maps[0])
        assert mine.update(tmod, sfc_t, 0) is sfc_t
        return
    assert mine.apply_static(tmod, sfc_t) is sfc_t
    # the window advances only past its end: 600 reads no map after it
    for sec in (120, 300, 301, 450, 600, 610, 900):
        a = mine.update(tmod, sfc_t, sec * IFACTOR)["th_bot"].numpy()
        b = np.asarray(ref.update(jmod, sfc_j, sec * IFACTOR)["th_bot"])
        assert np.array_equal(a, b), sec
        assert mine._window[:2] == ref._window[:2], sec
    assert np.array_equal(a, maps[900])
    # control: half way between two maps is neither of them
    mid = mine.update(tmod, sfc_t, 750 * IFACTOR)
    assert rel(mid["th_bot"].numpy(), maps[900]) >= CONTROL


# --------------------------------------------------------------------------
#  gabls1: the cooling ramp on the per-step loop, and as written
# --------------------------------------------------------------------------

def gabls1_text(n=8, k=16, **over):
    from chip_smoke import case_ini
    return case_ini("gabls1", itot=n, jtot=n, ktot=k, **over)


def test_gabls1_cooling_ramp(tmp_path):
    """gabls1 as written (8^2x16, to 120 s): Model.run() takes the per-step
    loop, which the chunked loop's gate keeps it on, and th_bot follows
    its series to the end, where obuk is stable and the fields finite."""
    text = gabls1_text(endtime=120, savetime=120)
    mem = cases.gabls1_input(16, 400.)
    _, tdir = initial_files(tmp_path, "gabls1", text, mem)
    tm = Model(Ini(text), "run", "gabls1", workdir=str(tdir),
               dtype=torch.float64, device="cpu", input_nc=mem)
    tm.finish_setup()
    assert tm.btimedep.items and not tm._chunk_supported()
    s = tm.run()
    assert tm._chunk is None and tm.timeloop.time == 120.
    want = 265. - 2.25 * 120. / 32400.
    bot = tm.final_sfc["th_bot"]
    assert float(bot.max() - bot.min()) == 0.
    assert abs(float(bot.mean()) - want) <= 1e-12
    assert float(tm.final_sfc["obuk"].mean()) > 0.
    assert all(bool(torch.isfinite(v).all()) for v in s.values())
    # control: without the update th_bot keeps the ini's 265 K
    off = Model(Ini(text), "run", "gabls1", workdir=str(tdir),
                dtype=torch.float64, device="cpu", input_nc=mem)
    off.finish_setup()
    off.update_timedep = lambda sfc: sfc
    off.run(max_iters=3)
    assert float(off.final_sfc["th_bot"].mean()) == 265.


def test_gabls1_steep_series_two_steps_match_jax(tmp_path):
    """gabls1 as written at 8^2x16 on the dry RK-folded path (K22), its
    th_sbot a steep series of the test's own: two steps against the JAX
    package <= 1e-10, the bottom value at every step the series', and
    without the update the state moves by more than 1e3 times that."""
    mem = with_timedep(cases.gabls1_input(16, 400.),
                       time_surface=np.array([0., 30., 32400.]),
                       th_sbot=np.array([255., 285., 262.75]))
    text = gabls1_text()
    tm, err, off = pair_against_jax(tmp_path, "gabls1", text, mem)
    assert tm.fold and tm.device_dt()
    assert err <= TOL, err
    assert off >= CONTROL, off
    want = TT.Timedep(mem, "th_sbot").interpolate(tm.timeloop.itime -
                                                  tm.timeloop.idt)
    assert float(tm.final_sfc["th_bot"][0, 0]) == want


# --------------------------------------------------------------------------
#  forcings over time: geostrophic wind, large-scale sources, subsidence
# --------------------------------------------------------------------------

FORCE_INI = """
[grid]
itot=8
jtot=8
ktot=16
xsize=400.
ysize=400.
zsize=400.
swspatialorder=2

[advec]
swadvec=2
cflmax=1.2

[diff]
swdiff=smag2
dnmax=0.3

[thermo]
swthermo=dry
swbasestate=boussinesq
thref0=300.
pbot=100000.

[force]
swlspres=geo
fc=1.0e-4
swtimedep_geo=1
swwls=mean
swtimedep_wls=1
swls=1
lslist=th
swtimedep_ls=1
timedeplist_ls=th

[boundary]
swboundary=surface
mbcbot=noslip
mbctop=freeslip
sbcbot=flux
sbctop=neumann
sbot[th]=0.01
stop[th]=0.003
z0m=0.1
z0h=0.1

[fields]
visc=1.e-5
svisc=1.e-5
rndamp[th]=0.1
rndz=200.
rndexp=2.

[time]
starttime=0
endtime=400
savetime=400
dt=4.
dtmax=10.
adaptivestep=true
rkorder=3
"""


def force_input(ktot=16, zsize=400.):
    """Static profiles and steep series (over 20 s) of the geostrophic
    wind, the subsidence and the th source (whose static profile a
    time-dependent entry replaces with zeros until its first update)."""
    z = cases.uniform_z(ktot, zsize)
    one = np.ones(ktot)
    t = np.array([0., 20., 800.])
    return MemoryDataset({"z": z}, {
        "init": {"th": 300. + 0.003 * z, "u": 5. * one, "v": 0. * one,
                 "u_geo": 5. * one, "v_geo": 0. * one,
                 "w_ls": -0.01 * one, "th_ls": 1e-5 * one},
        "timedep": {"time_ls": t,
                    "u_geo": np.outer([5., 15., 7.], one),
                    "v_geo": np.outer([0., -8., 1.], one) + 0.01 * z,
                    "w_ls": np.outer([-0.01, -0.3, -0.03], one),
                    "th_ls": np.outer([0., 3e-2, 1e-5], one)}})


def test_force_update_and_op_match_jax(tmp_path):
    mem = force_input()
    write_nc(tmp_path / "ftd_input.nc", mem)
    jm = JModel(JIni(FORCE_INI), "run", "ftd", workdir=str(tmp_path),
                dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(FORCE_INI), "run", "ftd", dtype=torch.float64,
               device="cpu", input_nc=mem)
    tm.finish_setup()
    assert tm.force.has_timedep and jm.force.has_timedep
    rng = np.random.RandomState(6)
    shape = (tm.grid.kcells, 8, 8)
    s = {n: 3. + rng.randn(*shape) for n in ("u", "v", "w")}
    s["th"] = 300. + rng.randn(*shape)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for sec in (0., 7., 20., 333.):
        itime = int(sec * IFACTOR)
        a = tm.force.update_timedep({}, itime)
        b = jm.force.update_timedep({}, itime)
        assert set(a) == set(b) == {"__geo_u", "__geo_v", "__wls", "__ls_th"}
        for k in a:
            assert a[k].dtype == torch.float64
            assert np.array_equal(a[k].numpy(), np.asarray(b[k])), (sec, k)
        t0 = {n: np.zeros(shape) for n in s}
        ta = tm.force(tm.ctx, {n: torch.tensor(v) for n, v in s.items()},
                      {n: torch.tensor(v) for n, v in t0.items()}, {}, a)
        tb = jm.force(jm.ctx, {n: jnp.asarray(v) for n, v in s.items()},
                      {n: jnp.asarray(v) for n, v in t0.items()}, {}, b)
        for n in ("u", "v", "th"):
            assert rel(ta[n][ks:ke], np.asarray(tb[n])[ks:ke]) <= TOL, (sec, n)
        # control: the static profiles give another tendency
        static = tm.force(tm.ctx, {n: torch.tensor(v) for n, v in s.items()},
                          {n: torch.tensor(v) for n, v in t0.items()}, {}, {})
        if sec == 20.:
            for n in ("u", "v", "th"):
                assert rel(static[n][ks:ke], ta[n][ks:ke]) >= CONTROL, n


def test_force_timedep_two_steps_match_jax(tmp_path):
    """The dry case with the three time-dependent forcings: the port takes
    the substep without the RK fold (a time-dependent geostrophic wind is
    not folded), two steps against the JAX package <= 1e-10."""
    mem = force_input()
    jdir, tdir = initial_files(tmp_path, "ftd", FORCE_INI, mem)
    jm, js = jax_run(jdir, "ftd", FORCE_INI, 2)
    tm, ts = port_run(tdir, "ftd", FORCE_INI, mem, 2)
    assert tm.unfolded and not tm.skip_force and not tm.fold
    assert not tm._chunk_supported() and not jm._chunk_supported()
    assert state_err(tm, ts, js) <= TOL
    _, off = port_run(tdir, "ftd", FORCE_INI, mem, 2, update=False)
    assert state_err(tm, off, ts) >= CONTROL


RICO_TDEP = """
[force]
swtimedep_geo=1
swtimedep_ls=1
timedeplist_ls=thl
swtimedep_wls=1
"""


@pytest.mark.parametrize("swwls", ["mean", "local"])
def test_generic_col_tables_read_the_timedep_profiles(tmp_path, swwls):
    """The generic path's column tables with this iteration's ug, vg, thl
    source and subsidence from sfc, against the JAX package's
    generic_col_tables <= 1e-12; without them the tables differ."""
    from chip_smoke import rico_ini, rico_state
    from test_torch_generic import COLS, jax_model
    kt, zsize = 24, 4000.
    text = rico_ini(16, kt).replace("[force]\n", RICO_TDEP.lstrip(), 1)
    text = text.replace("swwls=mean", "swwls=" + swwls)
    base = cases.rico_input(kt, zsize)
    z = base.variables["z"][:]
    one = np.ones(kt)
    mem = with_timedep(base, time_ls=np.array([0., 100.]),
                       u_geo=np.stack([one * -9., one * 4. + z * 1e-3]),
                       v_geo=np.stack([one * -3.8, one * 2.]),
                       thl_ls=np.stack([one * -2e-5, one * 3e-5]),
                       w_ls=np.stack([-0.005 * z / 2260., 0.004 * one]))
    write_nc(tmp_path / "rico_input.nc", mem)
    jm = jax_model(text, str(tmp_path), "rico")
    tm = Model(Ini(text), "run", "rico", dtype=torch.float64, device="cpu",
               input_nc=mem)
    tm.finish_setup()
    tm.build_step()
    assert tm.generic and not tm.unfolded and tm.force.tdep_ls
    st = {k: torch.tensor(v) for k, v in rico_state(tm, 5).items()}
    sfc = {k: torch.tensor(v) for k, v in tm.boundary.init_surface_state().items()}
    st = tm.boundary.set_ghost_cells(tm.ctx, st, sfc)
    itime = 37 * IFACTOR
    sfc_t = tm.force.update_timedep(sfc, itime)
    sfc_j = jm.force.update_timedep({}, itime)
    cj_uvw, cj_s = JF.generic_col_tables(
        jm._fused, jm.ctx, {k: jnp.asarray(v.numpy()) for k, v in st.items()},
        sfc_j, {}, jm.force, jm.buffer, jm.decay)
    ct, cts = F.generic_col_tables(tm.fused, tm.ctx, st, tm.force, tm.buffer,
                                   sfc_t)
    cj_uvw = np.asarray(cj_uvw)
    for tc in (F.T_UG, F.T_VG, F.T_ADDU, F.T_ADDV, F.T_WLSDN, F.T_WLSUP):
        jc = COLS[tc]
        assert (np.abs(cj_uvw[:, jc]).max() == 0. == float(ct[:, tc].abs().max())
                or rel(ct[:, tc], cj_uvw[:, jc]) <= 1e-12), tc
    for i, n in enumerate(tm.fused.names):
        cj = np.asarray(cj_s[n])
        for tc in (F.T_FACZ, F.T_ADDS, F.T_WLSDN, F.T_WLSUP):
            jc = COLS[tc]
            assert (np.abs(cj[:, jc]).max() == 0. == float(cts[i, :, tc].abs().max())
                    or rel(cts[i, :, tc], cj[:, jc]) <= 1e-12), (n, tc)
    # control: the static tables (the thl source zero before its update)
    ct0, cts0 = F.generic_col_tables(tm.fused, tm.ctx, st, tm.force,
                                     tm.buffer)
    assert rel(ct0[:, F.T_UG], ct[:, F.T_UG]) >= CONTROL
    assert rel(cts0[0, :, F.T_ADDS], cts[0, :, F.T_ADDS]) >= CONTROL


# --------------------------------------------------------------------------
#  surface pressure over time
# --------------------------------------------------------------------------

PBOT_INI = FORCE_INI.replace("""swthermo=dry
swbasestate=boussinesq
thref0=300.
pbot=100000.""", """swthermo=moist
swbasestate=anelastic
pbot=100000.
swupdatebasestate=1
swtimedep_pbot=1""").replace("sbot[th]=0.01", "sbot[thl]=0.01\nsbot[qt]=1e-5"
                             ).replace("stop[th]=0.003",
                                       "stop[thl]=0.003\nstop[qt]=0."
                                       ).replace("rndamp[th]", "rndamp[thl]")


def pbot_text():
    start = PBOT_INI.index("[force]")
    end = PBOT_INI.index("[boundary]")
    return PBOT_INI[:start] + PBOT_INI[end:]


def pbot_input(ktot=16, zsize=400.):
    z = cases.uniform_z(ktot, zsize)
    return MemoryDataset({"z": z}, {
        "init": {"thl": 300. + 0.003 * z, "qt": np.full(ktot, 5e-3),
                 "u": np.zeros(ktot), "v": np.zeros(ktot)},
        "timedep": {"time_surface": np.array([0., 800.]),
                    "p_sbot": np.array([100000., 60000.])}})


def test_timedep_pbot_enters_the_base_state_update(tmp_path):
    text = pbot_text()
    mem = pbot_input()
    write_nc(tmp_path / "ftd_input.nc", mem)
    jm = JModel(JIni(text), "init", "ftd", workdir=str(tmp_path),
                dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(text), "init", "ftd", dtype=torch.float64, device="cpu",
               input_nc=mem)
    tm.finish_setup()
    assert tm.thermo.tdep_pbot is not None
    state = tm.fields.create(mem, dtype=np.float64)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ("thl", "qt"):     # the ghost levels as the ghost fill makes them
        state[n][ks - 1], state[n][ke] = state[n][ks], state[n][ke - 1]
    sj = {k: jnp.asarray(v) for k, v in state.items()}
    st = {k: torch.tensor(v) for k, v in state.items()}
    itime = 400 * IFACTOR
    static = tm.thermo.pbot
    a = tm.thermo.update_timedep({}, itime)
    b = jm.thermo.update_timedep({}, itime)
    assert a == {}
    assert tm.thermo.pbot == float(b["__pbot"]) == 80000.
    aux_t = tm.thermo.update_basestate(tm.ctx, st, {}, a)
    aux_j = jm.thermo.update_basestate(jm.ctx, sj, {}, b)
    assert float(aux_t["prefh"][ks]) == 80000.
    for key in ("pref", "prefh", "exnref", "exnrefh"):
        assert rel(aux_t[key][ks:ke], np.asarray(aux_j[key])[ks:ke]) <= TOL, key
    # control: the static surface pressure
    tm.thermo.pbot = static
    aux0 = tm.thermo.update_basestate(tm.ctx, st, {}, {})
    assert rel(aux0["pref"][ks:ke], aux_t["pref"][ks:ke]) >= CONTROL


def test_timedep_pbot_of_thermo_dry(tmp_path):
    """thermo dry takes p_sbot into its pbot alone, as the JAX package and
    the reference do (its base state is static); the update is made."""
    start, end = FORCE_INI.index("[force]"), FORCE_INI.index("[boundary]")
    text = (FORCE_INI[:start] + FORCE_INI[end:]).replace(
        "pbot=100000.", "pbot=100000.\nswtimedep_pbot=1")
    mem = force_input()
    mem = with_timedep(mem, time_surface=np.array([0., 800.]),
                       p_sbot=np.array([100000., 60000.]))
    write_nc(tmp_path / "ftd_input.nc", mem)
    jm = JModel(JIni(text), "init", "ftd", workdir=str(tmp_path),
                dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(text), "init", "ftd", dtype=torch.float64, device="cpu",
               input_nc=mem)
    tm.finish_setup()
    for sec in (0., 123., 800.):
        sfc = {"th_bot": torch.zeros(2, 2, dtype=torch.float64)}
        assert tm.thermo.update_timedep(sfc, int(sec * IFACTOR)) is sfc
        jm.thermo.update_timedep({}, int(sec * IFACTOR))
        assert tm.thermo.pbot == jm.thermo.pbot == 100000. - 50. * sec


# --------------------------------------------------------------------------
#  sources over time
# --------------------------------------------------------------------------

def port_source(text, mem):
    """The port's Source with its grid, fields and context (the JAX
    package's source test runs no dynamics, which the port's Model does not
    carry at 2nd order: advec 0, diff 0, the default boundary)."""
    from microhh_torch.fields import Fields
    from microhh_torch.grid import Grid
    from microhh_torch.model import Context
    from microhh_torch.ops.source import make_source
    ini = Ini(text)
    g = Grid(ini)
    dz = g.zsize / g.ktot
    g.set_z(np.linspace(0.5 * dz, g.zsize - 0.5 * dz, g.ktot))
    fields = Fields(ini, g)
    src = make_source(ini, g, fields, mem)
    return src, Context(g, fields, torch.float64, "cpu"), g


def test_source_strength_and_location_match_jax(tmp_path):
    """The blob and its norm built on the device from this iteration's
    strength and location, against the JAX package's _exec_timedep <=
    1e-10; the emitted rate is the interpolated strength and the blob's
    centroid the interpolated location, as in tests/test_source.py."""
    from test_source import INI as SRC_INI, _emitted_rate, _write_timedep_nc
    _write_timedep_nc(tmp_path / "src_input.nc")
    text = SRC_INI % {"extra": "swtimedep_strength=1\nswtimedep_location=1"}
    jm = JModel(JIni(text), "run", "src", workdir=str(tmp_path),
                dtype=np.float64)
    jm.finish_setup()
    with jnc.Dataset(str(tmp_path / "src_input.nc"), "r") as f:
        td = f.groups["timedep"].variables
        mem = MemoryDataset({}, {"timedep": {k: v[:] for k, v in td.items()}})
    source, ctx, g = port_source(text, mem)
    assert set(source.tdep) == set(jm.source.tdep) and len(source.tdep) == 4
    ks, ke = g.kstart, g.kend
    shape = (g.kcells, g.jtot, g.itot)
    for time_s, strength, x0, z0 in ((0., 1., 800., 300.),
                                     (50., 2., 1200., 400.),
                                     (150., 4., 2000., 600.)):
        itime = int(time_s * IFACTOR)
        sfc_t = source.update_timedep({}, itime)
        sfc_j = jm.source.update_timedep({}, itime)
        for k in sfc_t:
            assert float(sfc_t[k]) == float(sfc_j[k]), k
        ta = source(ctx, None, {"co2": torch.zeros(shape,
                                                   dtype=torch.float64)},
                    {}, sfc_t)
        tb = jm.source(jm.ctx, None, {"co2": jnp.zeros(shape)}, {}, sfc_j)
        fld = ta["co2"].numpy()[ks:ke]
        assert rel(fld, np.asarray(tb["co2"])[ks:ke]) <= TOL, time_s
        rate = _emitted_rate(jm, {"co2": ta["co2"].numpy()})
        assert abs(rate - strength) < 1e-9 * max(1., strength), rate
        x = g.x[None, None, :]
        z = g.z[ks:ke][:, None, None]
        assert abs((fld * x).sum() / fld.sum() - x0) < g.dx
        assert abs((fld * z).sum() / fld.sum() - z0) < 2 * (g.zsize / g.ktot)
    # control: without the update the ini's strength and location
    t0 = source(ctx, None, {"co2": torch.zeros(shape, dtype=torch.float64)},
                {}, {})
    assert rel(t0["co2"][ks:ke], fld) >= CONTROL


# --------------------------------------------------------------------------
#  2-D bottom maps through a run
# --------------------------------------------------------------------------

def sbot2d_text(extra):
    text = gabls1_text(endtime=120, savetime=120)
    text = text.replace("swtimedep=1\ntimedeplist=th_sbot\n", "")
    return text.replace("sbcbot=dirichlet",
                        "sbcbot=dirichlet\nsbot_2d_list=th" + extra)


def test_sbot2d_static_run(tmp_path):
    """A 2-D Dirichlet map in place of th's sbot, through two steps."""
    x_map = 265. + np.tile(np.arange(8.), (8, 1))
    text = sbot2d_text("")
    mem = cases.gabls1_input(16, 400.)
    _, tdir = initial_files(tmp_path, "gabls1", text, mem)
    write_maps(str(tdir), {0: x_map})
    tm, s = port_run(tdir, "gabls1", text, mem, 2)
    assert tm._chunk_supported()
    assert np.array_equal(tm.final_sfc["th_bot"].numpy(), x_map)
    assert all(np.isfinite(v).all() for v in s.values())


def test_sbot2d_timedep_run(tmp_path):
    """swtimedep_sbot_2d through Model.run() to 120 s: the per-step loop,
    and the last bottom plane the map of 120 s, read at the end of its
    window; the control run without the update keeps the ini's 265 K."""
    maps = {0: np.full((8, 8), 265.), 60: np.full((8, 8), 264.),
            120: np.full((8, 8), 266.), 180: np.full((8, 8), 267.)}
    text = sbot2d_text("\nswtimedep_sbot_2d=1\nsbot_2d_loadtime=60")
    mem = cases.gabls1_input(16, 400.)
    _, tdir = initial_files(tmp_path, "gabls1", text, mem)
    write_maps(str(tdir), maps)
    tm = Model(Ini(text), "run", "gabls1", workdir=str(tdir),
               dtype=torch.float64, device="cpu", input_nc=mem)
    tm.finish_setup()
    assert not tm._chunk_supported()
    tm.run()
    assert tm.timeloop.time == 120.
    assert np.array_equal(tm.final_sfc["th_bot"].numpy(), maps[120])
    off, _ = port_run(tdir, "gabls1", text, mem, 2, update=False)
    assert float(off.final_sfc["th_bot"].mean()) == 265.
