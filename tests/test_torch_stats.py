"""The port's statistics (``microhh_torch/stats.py``, ``output.py``'s Dump,
``utils/nc_classic.py``) against the JAX package's, float64 on the CPU:

* one seeded state per thermo variant (dry: drycblles; buoy: SBL_Smag;
  moist with 2mom_warm: rico; none: the neutral Ekman LES) with seeded
  surface planes, through the JAX ``Stats._build_diag`` and the port's
  ``Stats.diag``: the same outputs, each <= 1e-10 of its scale
  (``chip_smoke.stats_scales``: the magnitude of what its mean sums);
* a drycblles 8^2 x 16 run to two samples through both packages'
  ``run_case``: the same sample times, iterations, variables, groups, dims
  and shapes, the same fill (``p``), values <= 1e-10 of their scale, and
  the same dumps;
* the netCDF-3 writer with h5py made unimportable: the run writes through
  it and reads back, through its group view, the values the netCDF-4
  writer wrote, with the fill where nothing was written;
* ``cases.drycblles_input`` and ``cases.bomex_input`` bit for bit against
  the files their scripts write;
* ``check_slice``: the five cases with statistics run as written, and
  ``masklist``, ``xymasklist`` and ``swtendency`` raise item 8.
"""

import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from chip_smoke import (DRYCBL_INI, RICO_ZSIZE, SBL_ZSIZE, andren_ini,
                        case_ini, initial_state, read_stats, rico_ini,
                        rico_state, sbl_ini, sbl_state, stats_agree,
                        stats_scales, unfolded_state)
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.stats import Stats as JStats
from microhh_tpu.utils import nc as jnc
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.model import Model, run_case
from microhh_torch.stats import Stats, open_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = "\n[stats]\nswstats=1\nsampletime=300\n"
N, KT = 8, 16

VARIANTS = {
    "dry": ("drycblles", DRYCBL_INI % {"n": N, "k": KT} + STATS,
            lambda: cases.drycblles_input(KT), lambda m: initial_state(m, 5)),
    "buoy": ("SBL", sbl_ini(N, KT), lambda: cases.sbl_input(KT, SBL_ZSIZE),
             lambda m: sbl_state(m, 6)),
    "moist": ("rico", rico_ini(N, KT) + STATS,
              lambda: cases.rico_input(KT, RICO_ZSIZE),
              lambda m: rico_state(m, 7)),
    "none": ("andren1994", andren_ini((N, N), KT) + STATS,
             lambda: cases.andren1994_input(KT), lambda m: unfolded_state(m, 8)),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def write_input(mem, path):
    """A MemoryDataset as the <case>_input.nc the JAX package reads."""
    f = jnc.Dataset(path, "w")
    z = np.asarray(mem.variables["z"])
    f.createDimension("z", len(z))
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, a in mem.groups["init"].variables.items():
        g.createVariable(name, "f8", ("z",))[:] = np.asarray(a)
    f.close()


def as_file(out, z, budget=()):
    """A dict of profiles as read_stats gives a file of one sample."""
    ref = {"z": z}
    for name, a in out.items():
        group = "budget" if name in budget else "default"
        ref[group, name] = (None, np.asarray(a, dtype=np.float64)[None])
    return ref


def seeded_sfc(sfc_np, seed):
    """Random surface planes: ustar > 0, obuk < 0, the rest of either
    sign."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sfc_np.items():
        a = 0.1 * rng.randn(*v.shape)
        if k == "ustar":
            a = 0.2 + np.abs(a)
        elif k == "obuk":
            a = -50. - 100. * np.abs(a)
        out[k] = a
    return out


def diag_pair(tmp_path, casename, text, mem, state_of, p=None, p_port=None):
    """(port outputs, JAX outputs, port model) of one seeded state; p (JAX)
    and p_port (the port): the last step's pressure for the budgets."""
    twd, jwd = tmp_path / "t", tmp_path / "j"
    twd.mkdir()
    jwd.mkdir()
    tm = Model(Ini(text), "run", casename, workdir=str(twd),
               dtype=torch.float64, device="cpu", input_nc=mem())
    tm.finish_setup()
    write_input(tm.input_nc, str(jwd / ("%s_input.nc" % casename)))
    jm = JModel(JIni(text), "run", casename, workdir=str(jwd),
                dtype=np.float64)
    jm.finish_setup()
    state = state_of(tm)
    sfc = seeded_sfc(tm.boundary.init_surface_state(), 9)
    js, jt, jsfc = jm.as_device_state({k: v.copy() for k, v in state.items()})
    jsfc = dict(jsfc, **{k: v for k, v in sfc.items() if k in jsfc})
    jout = JStats(jm)._build_diag(jm)(js, jt, jsfc, p)
    ts, _ = tm.as_device_state(state)
    tsfc = {k: tm.ctx.tensor(v) for k, v in sfc.items()}
    tout = Stats(tm).diag(ts, tsfc, None if p_port is None
                          else tm.ctx.tensor(p_port))
    return ({k: v.numpy() for k, v in tout.items()},
            {k: np.asarray(v) for k, v in jout.items()}, tm)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_diag_matches_jax(variant, tmp_path):
    """Every default-mask output of one seeded state, the port's against
    the JAX package's, <= 1e-10 of its scale."""
    tout, jout, tm = diag_pair(tmp_path, *VARIANTS[variant])
    assert set(tout) == set(jout)
    if variant == "moist":
        assert {"ql_cover", "qlqi_path", "thv_2", "rh", "rr", "zi"} <= set(tout)
        assert np.asarray(jout["ql_frac"]).max() > 0.
    z = tm.grid.z[tm.grid.kstart:tm.grid.kend]
    scales = stats_scales(as_file(jout, z))
    for name in jout:
        assert tout[name].shape == jout[name].shape, name
        err = np.abs(tout[name] - jout[name]).max() / scales["default", name]
        assert err <= 1e-10, (name, err)


def drycblles_dir(path):
    """A drycblles case directory at 8^2 x 16 run to 300 s (two samples),
    with th, u and p dumped at each sample."""
    os.makedirs(path)
    text = case_ini("drycblles", itot=N, jtot=N, ktot=KT, endtime=300)
    text += "\n[dump]\nswdump=1\nsampletime=300\ndumplist=u,th,p\n"
    with open(os.path.join(path, "drycblles.ini"), "w") as f:
        f.write(text)
    return path


def test_drycblles_run_matches_jax(tmp_path, monkeypatch):
    """Both packages' run_case of drycblles 8^2 x 16 to two samples: the
    same file layout and values <= 1e-10 of their scale, and the same
    dumps."""
    monkeypatch.setenv("MICROHH_CHUNK", "0")
    twd = drycblles_dir(str(tmp_path / "t"))
    jwd = drycblles_dir(str(tmp_path / "j"))
    mem = cases.drycblles_input(KT)
    write_input(mem, os.path.join(jwd, "drycblles_input.nc"))
    for mode in ("init", "run"):
        run_case(twd, "drycblles", mode, dtype=torch.float64, device="cpu",
                 input_nc=mem)
    from microhh_tpu.model import run_case as jrun_case
    for mode in ("init", "run"):
        jrun_case(jwd, "drycblles", mode, dtype=np.float64)
    name = "drycblles.default.0000000.nc"
    a = read_stats(os.path.join(twd, name))
    b = read_stats(os.path.join(jwd, name))
    assert list(b["time"]) == [0., 300.]
    errs = stats_agree(a, b, "drycblles")
    assert max(errs.values()) <= 1e-10, max(errs.items(), key=lambda kv: kv[1])
    assert ("default", "p") in b and ("thermo", "zi") in b
    with open_stats(os.path.join(twd, name)) as f, \
            jnc.Dataset(os.path.join(jwd, name), "r") as g:
        for dim in ("z", "zh"):
            assert np.array_equal(f.variables[dim][:], g.variables[dim][:])
        assert set(f.groups) == set(g.groups)
    for var in ("u", "th", "p"):
        for iot in (0, 300):
            fname = "%s.%07d" % (var, iot)
            jpath = os.path.join(jwd, fname)
            tpath = os.path.join(twd, fname)
            assert os.path.exists(tpath) == os.path.exists(jpath), fname
            if os.path.exists(jpath):
                x, y = np.fromfile(tpath), np.fromfile(jpath)
                assert x.shape == y.shape == (N * N * KT,)
                assert np.abs(x - y).max() <= 1e-10 * np.abs(y).max(), fname


def test_nc_classic_without_h5py(tmp_path, monkeypatch):
    """With h5py unimportable the run writes netCDF-3 through scipy; read
    back through the group view it holds what the netCDF-4 writer wrote
    in the same run, bit for bit, and the fill where nothing was
    written."""
    mem = cases.drycblles_input(KT)
    files = {}
    for label, hide in (("h5", False), ("classic", True)):
        wd = drycblles_dir(str(tmp_path / label))
        if hide:
            monkeypatch.setitem(sys.modules, "h5py", None)
        for mode in ("init", "run"):
            run_case(wd, "drycblles", mode, dtype=torch.float64,
                     device="cpu", input_nc=mem)
        files[label] = os.path.join(wd, "drycblles.default.0000000.nc")
    with open(files["classic"], "rb") as f:
        assert f.read(4) == b"CDF\x02"
    with open(files["h5"], "rb") as f:
        assert f.read(4) == b"\x89HDF"
    a = read_stats(files["classic"])
    monkeypatch.delitem(sys.modules, "h5py")
    b = read_stats(files["h5"])
    assert set(a) == set(b)
    fill = 9.969209968386869e+36
    for key in b:
        x, y = (a[key], b[key]) if not isinstance(key, tuple) else (
            a[key][1], b[key][1])
        if isinstance(key, tuple):
            assert a[key][0] == b[key][0], key
        # a record the h5py file never grew holds the fill in netCDF-3
        n = len(y)
        assert x.shape[1:] == y.shape[1:] and np.array_equal(x[:n], y), key
        assert np.all(x[n:] == fill), key
    p = a["default", "p"][1]
    assert p.shape == (2, KT) and np.all(p == fill)
    with open_stats(files["classic"]) as f:
        zi = f.groups["thermo"].variables["zi"]
        assert zi.dimensions == ("time",) and zi[:].shape == (2,)
        assert f.groups["default"].variables["th"].getncattr("units") \
            in ("-", b"-")


@pytest.mark.parametrize("case,ktot", [("drycblles", 32), ("bomex", 48)])
def test_case_inputs_match_their_generators(case, ktot, tmp_path, monkeypatch):
    """cases.drycblles_input and cases.bomex_input hold, bit for bit, what
    cases/<case>/<case>_input.py writes."""
    case_dir = os.path.join(ROOT, "cases", case)
    shutil.copy(os.path.join(case_dir, "%s.ini" % case), tmp_path)
    monkeypatch.chdir(tmp_path)
    runpy.run_path(os.path.join(case_dir, "%s_input.py" % case))
    ini = Ini(str(tmp_path / ("%s.ini" % case)))
    mem = cases.case_input(case, ktot, ini.get_float("grid", "zsize"))
    with jnc.Dataset(str(tmp_path / ("%s_input.nc" % case)), "r") as f:
        assert np.array_equal(np.asarray(f.variables["z"][:]),
                              np.asarray(mem.variables["z"][:]))
        written = f.groups["init"].variables
        mine = mem.groups["init"].variables
        assert set(written) == set(mine)
        for name in written:
            assert np.array_equal(np.asarray(written[name][:]),
                                  np.asarray(mine[name][:])), name


AS_WRITTEN = [("drycblles", "drycblles"), ("bomex", "bomex"),
              ("SBL_Smag", "SBL"), ("sullivan2011", "sullivan2011"),
              ("moser180", "moser180"), ("SBL_DNN", "SBL")]


@pytest.mark.parametrize("case,name", AS_WRITTEN)
def test_cases_with_stats_run_as_written(case, name, tmp_path):
    """check_slice lets the five cases through as written in run mode, and
    their statistics register (moser180 with its budget_4 group)."""
    ini = Ini(os.path.join(ROOT, "cases", case, "%s.ini" % name))
    mem = cases.case_input(name, ini.get_int("grid", "ktot"),
                           ini.get_float("grid", "zsize"))
    m = Model(ini, "run", name, workdir=str(tmp_path), dtype=torch.float64,
              device="cpu", input_nc=mem)
    st = Stats(m)
    assert "th" in st.vars or "thl" in st.vars or "b" in st.vars \
        or "s" in st.vars
    if name == "moser180":
        assert st.budget.sw and st.budget.order == 4
        assert "budget" in st.groups and "tke_diss" in st.vars
    st.close()


@pytest.mark.parametrize("option", ["masklist=wplus", "xymasklist=sea",
                                    "swtendency=1"])
def test_mask_and_tendency_stats_raise_item_8(option):
    text = case_ini("drycblles", itot=N, jtot=N, ktot=KT)
    text = text.replace("[stats]\n", "[stats]\n%s\n" % option)
    with pytest.raises(NotImplementedError, match="item 8"):
        Model(Ini(text), "run", "drycblles", dtype=torch.float64,
              device="cpu")
