"""The PyTorch port's host modules against microhh_tpu's: the numpy copies
(config, grid, fields, timeloop, utils/nc) give the same values bit for bit,
``python -m microhh_torch init`` writes the same restart files as
``python -m microhh_tpu init``, and the port imports no jax."""

import os
import re
import runpy
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import microhh_tpu.config as jconfig
import microhh_tpu.fields as jfields
import microhh_tpu.grid as jgrid
import microhh_tpu.timeloop as jtimeloop
from microhh_tpu.ops.thermo_dry import ThermoDry as JThermoDry
import microhh_torch.config as tconfig
import microhh_torch.fields as tfields
import microhh_torch.grid as tgrid
import microhh_torch.timeloop as ttimeloop
from microhh_torch.ops.thermo_dry import ThermoDry as TThermoDry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = os.path.join(ROOT, "cases", "drycblles")
INI = os.path.join(CASE, "drycblles.ini")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _grid(mod_config, mod_grid):
    g = mod_grid.Grid(mod_config.Ini(INI))
    dz = g.zsize / g.ktot
    g.set_z(np.linspace(0.5 * dz, g.zsize - 0.5 * dz, g.ktot))
    return g


def test_ini_matches():
    a, b = jconfig.Ini(INI), tconfig.Ini(INI)
    assert a.items == b.items
    for section, items in a.items.items():
        for item, subs in items.items():
            for sub in subs:
                assert (a.get_str(section, item, subitem=sub)
                        == b.get_str(section, item, subitem=sub))
    assert a.unused_items() == b.unused_items()


def test_fd_matches():
    """The finite-difference coefficients and interpolators the advection
    schemes read: every public name of the JAX package's fd module has an
    equal counterpart in the port's."""
    import inspect
    import microhh_tpu.fd as jfd
    import microhh_torch.fd as tfd
    rng = np.random.RandomState(0)
    names = [n for n in dir(jfd) if not n.startswith("_")]
    assert {"interp4_ws", "interp3_ws", "interp4c", "interp6_ws",
            "interp5_ws", "ci0"} <= set(names)
    for name in names:
        a, b = getattr(jfd, name), getattr(tfd, name)
        if callable(a):
            args = rng.randn(len(inspect.signature(a).parameters), 7)
            assert np.array_equal(a(*args), b(*args)), name
        elif isinstance(a, float):
            assert a == b, name


def test_grid_matches():
    a, b = _grid(jconfig, jgrid), _grid(tconfig, tgrid)
    for name in ("x", "xh", "y", "yh", "z", "zh", "dz", "dzh", "dzi", "dzhi"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert (a.kstart, a.kend, a.kcells, a.dxi, a.dyi) == \
        (b.kstart, b.kend, b.kcells, b.dxi, b.dyi)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fields_create_matches(dtype):
    out = []
    for cfg, grd, fld, thermo in ((jconfig, jgrid, jfields, JThermoDry),
                                  (tconfig, tgrid, tfields, TThermoDry)):
        ini = cfg.Ini(INI)
        g = _grid(cfg, grd)
        f = fld.Fields(ini, g)
        thermo(ini, g, f)
        out.append(f.create(None, dtype=dtype))
    assert sorted(out[0]) == sorted(out[1]) == ["th", "u", "v", "w"]
    for name in out[0]:
        assert out[0][name].dtype == out[1][name].dtype
        assert np.array_equal(out[0][name], out[1][name]), name
    assert np.abs(out[0]["th"]).max() > 0.   # the seeded perturbation


def test_timeloop_matches():
    a = jtimeloop.Timeloop(jconfig.Ini(INI), "run")
    b = ttimeloop.Timeloop(tconfig.Ini(INI), "run")
    for tl in (a, b):
        for step in range(5):
            tl.reset_time_step_limit()
            tl.set_time_step_limit(tl.idt * 1.2 / 0.7)
            tl.set_time_step()
            tl.step_time()
    assert vars(a) == vars(b)
    assert (a.rk_ca, a.rk_cb, a.do_check(), a.do_save()) == \
        (b.rk_ca, b.rk_cb, b.do_check(), b.do_save())


def _write_case(workdir):
    """drycblles ini + the case script's _input.nc (netCDF through h5py)."""
    shutil.copy(INI, workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        runpy.run_path(os.path.join(CASE, "drycblles_input.py"))
    finally:
        os.chdir(cwd)


def test_nc_reader_matches(tmp_path):
    _write_case(str(tmp_path))
    from microhh_tpu.utils import nc as jnc
    from microhh_torch.utils import nc as tnc
    path = str(tmp_path / "drycblles_input.nc")
    with jnc.Dataset(path) as a, tnc.Dataset(path) as b:
        assert sorted(a.variables) == sorted(b.variables)
        assert sorted(a.groups) == sorted(b.groups) == ["init"]
        for name in ("u", "v", "th"):
            assert np.array_equal(a.groups["init"].variables[name][:],
                                  b.groups["init"].variables[name][:])
        assert np.array_equal(a.variables["z"][:], b.variables["z"][:])


def test_init_restart_files_bitwise(tmp_path):
    from microhh_tpu.__main__ import main as tpu_main
    d_tpu, d_torch = tmp_path / "tpu", tmp_path / "torch"
    for d in (d_tpu, d_torch):
        d.mkdir()
    _write_case(str(d_tpu))
    shutil.copy(d_tpu / "drycblles_input.nc", d_torch)
    shutil.copy(INI, d_torch)
    before = set(os.listdir(d_tpu))
    tpu_main(["init", "drycblles", "--dir", str(d_tpu)])
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "microhh_torch", "init", "drycblles",
         "--dir", str(d_torch), "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    written = sorted(set(os.listdir(d_tpu)) - before)
    assert sorted(set(os.listdir(d_torch)) - before) == written
    for name in ("u.0000000", "th.0000000", "grid.0000000", "time.0000000",
                 "thermo_basestate.0000000", "obuk.0000000"):
        assert name in written
    for name in written:
        a = (d_tpu / name).read_bytes()
        b = (d_torch / name).read_bytes()
        assert a == b, name


def test_port_imports_no_jax():
    code = ("import sys, microhh_torch, microhh_torch.model, "
            "microhh_torch.__main__, microhh_torch.kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'microhh_tpu')]; "
            "assert not bad, bad; print('clean')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|microhh_tpu)\b")
    offenders = []
    pkg = os.path.join(ROOT, "microhh_torch")
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    for n, line in enumerate(f, 1):
                        if pattern.match(line):
                            offenders.append("%s:%d" % (path, n))
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        offenders += ["chip_smoke.py:%d" % n for n, line in enumerate(f, 1)
                      if pattern.match(line)]
    assert not offenders, offenders


# --------------------------------------------------------------------------
#  the host parts of the open-boundary and source slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,ktot", [("jaenschwalde", 64),
                                       ("sullivan2011", 64),
                                       ("andren1994", 40),
                                       ("drycbl", 128),
                                       ("prandtlslope", 256),
                                       ("rayleighbenard", 128),
                                       ("rayleightaylor", 128),
                                       ("moser600", 128),
                                       ("gabls1", 64),
                                       ("gabls4s3", 288),
                                       ("arm", 64)])
def test_case_inputs_match_their_generators(case, ktot, tmp_path, monkeypatch):
    """cases.<case>_input holds, bit for bit, what cases/<case>/<case>_input.py
    writes: z and every group (init, and the timedep series of gabls1,
    gabls4s3's stand-in and arm)."""
    from microhh_tpu.utils import nc as jnc
    from microhh_torch import cases
    case_dir = os.path.join(ROOT, "cases", case)
    shutil.copy(os.path.join(case_dir, "%s.ini" % case), tmp_path)
    monkeypatch.chdir(tmp_path)
    runpy.run_path(os.path.join(case_dir, "%s_input.py" % case))
    mem = getattr(cases, "%s_input" % case)(ktot)
    with jnc.Dataset(str(tmp_path / ("%s_input.nc" % case)), "r") as f:
        assert np.array_equal(np.asarray(f.variables["z"][:]),
                              np.asarray(mem.variables["z"][:]))
        written = f.groups["init"].variables
        mine = mem.groups["init"].variables
        assert set(written) == set(mine)
        for name in written:
            assert np.array_equal(np.asarray(written[name][:]),
                                  np.asarray(mine[name][:])), name
        assert set(f.groups) == set(mem.groups)
        for group in f.groups:
            written = f.groups[group].variables
            mine = mem.groups[group].variables
            assert set(written) == set(mine), group
            for name in written:
                assert np.array_equal(np.asarray(written[name][:]),
                                      np.asarray(mine[name][:])), (group, name)


def _jaenschwalde_pair(extra=""):
    """The JAX package's and the port's grid, fields and moist base state of
    a 32x16x16 jaenschwalde, from the same in-memory input."""
    from microhh_tpu.ops.thermo_moist import ThermoMoist as JThermoMoist
    from microhh_torch import cases
    from microhh_torch.ops.thermo_moist import ThermoMoist as TThermoMoist
    with open(os.path.join(ROOT, "cases", "jaenschwalde",
                           "jaenschwalde.ini")) as f:
        text = f.read()
    for key, val in (("itot", 32), ("jtot", 16), ("ktot", 16)):
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    text += extra
    mem = cases.jaenschwalde_input(16)
    out = []
    for config, grid, fields, thermo in (
            (jconfig, jgrid, jfields, JThermoMoist),
            (tconfig, tgrid, tfields, TThermoMoist)):
        ini = config.Ini(text)
        g = grid.Grid(ini)
        g.set_z(np.asarray(mem.variables["z"][:]))
        fl = fields.Fields(ini, g)
        thermo(ini, g, fl).create_basestate(mem)
        out.append((ini, g, fl))
    return out, mem


@pytest.mark.parametrize("extra", ["", "line_x=300,0,0,0,0,0,0,0,0\n"
                                       "line_z=0,0,50,0,0,0,0,0,0\n"])
def test_source_blobs_match_bitwise(extra):
    """Source.blobs: the normalised Gaussian and line blobs with their
    rho/xmair-weighted norms are the JAX package's, bit for bit (pure
    numpy on both sides), built after the anelastic base state."""
    from microhh_tpu.ops.source import Source as JSource
    from microhh_torch.ops.source import Source as TSource
    text = extra and ("\n[source]\n" + extra)
    (jset, tset), mem = _jaenschwalde_pair(text)
    js = JSource(*jset, mem)
    js._build()
    src = TSource(*tset, mem)
    mine = list(src.blobs())
    assert len(mine) == len(js.blobs) == 9
    assert src.line[0][0] == (300. if extra else 0.)
    assert np.array_equal(jset[2].rhoref, tset[2].rhoref)
    for (jn, jb), (tn, tb) in zip(js.blobs, mine):
        assert jn == tn == "co2"
        assert np.array_equal(jb, tb)


def test_outflow_profiles_match_bitwise():
    from microhh_tpu.ops.boundary_outflow import BoundaryOutflow as JOutflow
    from microhh_torch.ops.boundary_outflow import BoundaryOutflow as TOutflow
    (jset, tset), mem = _jaenschwalde_pair()
    mem.groups["init"].variables["co2_inflow"][:] = np.linspace(0.1, 0.4, 16)
    a = JOutflow(jset[0], jset[1], 2)
    b = TOutflow(tset[0], tset[1], 2)
    a.create(mem)
    b.create(mem)
    assert a.active and b.active and a.scalars == b.scalars == ["co2"]
    assert a.direction == b.direction
    assert set(a.inflow_profiles) == set(b.inflow_profiles) == {"co2"}
    assert np.array_equal(a.inflow_profiles["co2"], b.inflow_profiles["co2"])
    assert b.inflow_profiles["co2"][tset[1].kstart] == 0.1
