"""Cross sections, columns and post mode (``microhh_torch/output.py``,
``Model.post``) against the JAX package, in float64 on the CPU, on a
vanheerwaarden2016-like case (64x1x48 on its levels scaled to that depth,
its crosslist b, blngrad, w, u with xy at 0.03 and 0.15 and xz at 0, plus a
yz plane, v, wlngrad and bpath, and two columns):

* ``Cross.exec`` and ``Column.exec`` of one seeded state in both packages:
  every cross file byte for byte, every column value bit for bit;
* both packages' ``run_case`` to 3 s on the chunked loop, which lands on
  every sample time: the same cross files within 1e-10 of their variable's
  scale, the columns likewise, the same sample times;
* post mode (the port's through its CLI) from the same restart files: the
  cross files byte for byte, the columns bit for bit, the statistics within
  1e-12 of each profile's scale;
* ``p`` in the crosslist: the port writes its slices, as the reference does
  (the JAX package writes the whole field under the name of an xy plane);
* ``chip_smoke.py``'s card-against-CPU output check and its eady reading,
  run here CPU against CPU."""

import os
import re
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as C
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.output import Column as JColumn
from microhh_tpu.output import Cross as JCross
from microhh_torch import cases
from microhh_torch.__main__ import main
from microhh_torch.config import Ini
from microhh_torch.model import Model, run_case
from microhh_torch.output import Column, Cross
from microhh_torch.stats import open_stats
from test_torch_stats import write_input

CASE = "vanheerwaarden2016"
N, K = 64, 48


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def case_text(**over):
    """The case's ini at N x 1 x K to 3 s, a sample and a restart every
    1 s, postproctime 1 s, the crosslist widened, two columns."""
    over = dict({"crosslist": "b,blngrad,w,u,v,wlngrad,bpath"}, **over)
    text = C.case_ini(CASE, itot=N, jtot=1, ktot=K,
                      zsize="%.17g" % cases.vanheerwaarden2016_z(K)[1],
                      endtime=3, savetime=1, sampletime=1, **over)
    text = text.replace("starttime=0", "starttime=0\npostproctime=1")
    text = text.replace("xz=0", "xz=0\nyz=0.5, 1.3")
    return text + ("\n[column]\nswcolumn=1\nsampletime=1\n"
                   "coordinates[x]=0.3,1.1\ncoordinates[y]=0,0\n")


def case_dirs(tmp_path, text):
    mem = cases.vanheerwaarden2016_input(K)
    dirs = {}
    for side in ("t", "j"):
        dirs[side] = str(tmp_path / side)
        os.makedirs(dirs[side])
        with open(os.path.join(dirs[side], "%s.ini" % CASE), "w") as f:
            f.write(text)
    write_input(mem, os.path.join(dirs["j"], "%s_input.nc" % CASE))
    return dirs, mem


def column_values(path):
    with open_stats(path) as f:
        return {v: np.asarray(f.variables[v][:])
                for v in ("z", "zh", "time", "u", "v", "w", "b")}


def test_cross_and_column_of_one_state_equal_jax(tmp_path):
    dirs, mem = case_dirs(tmp_path, case_text())
    jm = JModel(JIni(open(os.path.join(dirs["j"], CASE + ".ini")).read()),
                "run", CASE, workdir=dirs["j"], dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(open(os.path.join(dirs["t"], CASE + ".ini")).read()),
               "run", CASE, workdir=dirs["t"], dtype=torch.float64,
               device="cpu", input_nc=mem)
    tm.finish_setup()
    rng = np.random.default_rng(17)
    shape = (tm.grid.kcells, 1, N)
    s = {n: rng.standard_normal(shape) for n in tm.fields.prognostic_names}
    s["b"] = 3. * tm.grid.z[:, None, None] + 0.1 * s["b"]   # bpath, blngrad
    jc, tc = JCross(jm), Cross(tm)
    jcol, tcol = JColumn(jm), Column(tm)
    assert tc.kxy == jc.kxy and tc.jxz == jc.jxz and tc.ixz == jc.ixz
    for iotime, time_ in ((0, 0.), (10, 1.)):
        jc.exec({k: jnp.asarray(v) for k, v in s.items()}, None, iotime, {})
        tc.exec({k: torch.tensor(v) for k, v in s.items()}, None, iotime, {})
        jcol.exec({k: jnp.asarray(v) for k, v in s.items()}, time_)
        tcol.exec({k: torch.tensor(v) for k, v in s.items()}, time_)
    jcol.close()
    tcol.close()
    jf, tf = C.cross_files(dirs["j"]), C.cross_files(dirs["t"])
    assert sorted(jf) == sorted(tf)
    kinds = {C.CROSS_NAME.match(f).group(2) for f in jf}
    assert kinds == {"xy", "xz", "yz"}
    assert {C.CROSS_NAME.match(f).group(1) for f in jf} == {
        "b", "blngrad", "w", "u", "v", "wlngrad"}
    for f in jf:
        with open(os.path.join(dirs["j"], f), "rb") as a, \
                open(os.path.join(dirs["t"], f), "rb") as b:
            assert a.read() == b.read(), f
    for plane in ("bpath.xy.0000000", "bpath.xy.0000010"):
        with open(os.path.join(dirs["j"], plane), "rb") as a, \
                open(os.path.join(dirs["t"], plane), "rb") as b:
            assert a.read() == b.read(), plane
    name = "%s.column.0000000.nc" % CASE
    jv = column_values(os.path.join(dirs["j"], name))
    tv = column_values(os.path.join(dirs["t"], name))
    for v in jv:
        assert np.array_equal(jv[v], tv[v]), v
    assert tv["u"].shape == (2, 2, K) and tv["w"].shape == (2, 2, K + 1)


def test_pressure_cross_is_its_slices(tmp_path):
    text = case_text(crosslist="p")
    dirs, mem = case_dirs(tmp_path, text)
    tm = Model(Ini(text), "run", CASE, workdir=dirs["t"],
               dtype=torch.float64, device="cpu", input_nc=mem)
    tm.finish_setup()
    rng = np.random.default_rng(3)
    g = tm.grid
    s = {n: torch.tensor(rng.standard_normal((g.kcells, 1, N)))
         for n in tm.fields.prognostic_names}
    p = rng.standard_normal((g.kcells, 1, N))
    Cross(tm).exec(s, {"p": torch.tensor(p)}, 20, {})
    files = C.cross_files(dirs["t"])
    assert sorted(files) == ["p.xy.%05d.0000020" % k for k in (3, 13)] + [
        "p.xz.00000.0000020"] + ["p.yz.%05d.0000020" % i for i in (15, 41)]
    ks, ke = g.kstart, g.kend
    assert np.array_equal(files["p.xz.00000.0000020"], p[ks:ke, 0, :].ravel())
    assert np.array_equal(files["p.xy.00013.0000020"], p[ks + 13, 0, :])
    assert np.array_equal(files["p.yz.00041.0000020"], p[ks:ke, 0, 41])


def test_run_and_post_outputs_match_jax(tmp_path):
    dirs, mem = case_dirs(tmp_path, case_text())
    for mode in ("init", "run"):
        run_case(dirs["t"], CASE, mode, dtype=torch.float64, device="cpu",
                 input_nc=mem)
    from microhh_tpu.model import run_case as jrun_case
    for mode in ("init", "run"):
        jrun_case(dirs["j"], CASE, mode, dtype=np.float64)
    stats = "%s.default.0000000.nc" % CASE
    col = "%s.column.0000000.nc" % CASE
    jf, tf = C.cross_files(dirs["j"]), C.cross_files(dirs["t"])
    # the chunked loop lands on every sample time in both packages
    assert sorted(jf) == sorted(tf)
    assert {f[-7:] for f in jf} == {"%07d" % (10 * t) for t in range(4)}
    assert C.cross_agree(tf, jf, "run") <= 1e-10
    jv = column_values(os.path.join(dirs["j"], col))
    tv = column_values(os.path.join(dirs["t"], col))
    assert np.array_equal(jv["time"], tv["time"])
    for v in ("u", "w", "b"):
        assert (np.abs(tv[v] - jv[v]).max()
                <= 1e-10 * np.abs(jv[v]).max()), v
    a = C.read_stats(os.path.join(dirs["t"], stats))
    b = C.read_stats(os.path.join(dirs["j"], stats))
    assert max(C.stats_agree(a, b, "run").values()) <= 1e-10

    # post mode from the JAX package's restart files in both
    for f in os.listdir(dirs["j"]):
        if re.match(r"^(u|v|w|b|time)\.\d{7}$", f):
            shutil.copy(os.path.join(dirs["j"], f), os.path.join(dirs["t"], f))
    for side in ("t", "j"):
        for f in C.cross_files(dirs[side]):
            os.remove(os.path.join(dirs[side], f))
        os.remove(os.path.join(dirs[side], stats))
        os.remove(os.path.join(dirs[side], col))
    main(["post", CASE, "--dir", dirs["t"], "--device", "cpu",
          "--precision", "double", "--memory-input"])
    jrun_case(dirs["j"], CASE, "post", dtype=np.float64)
    jf, tf = C.cross_files(dirs["j"]), C.cross_files(dirs["t"])
    # 4 samples of 6 fields, each on 2 xy, 1 xz and 2 yz planes
    assert sorted(jf) == sorted(tf) and len(jf) == 4 * 6 * 5
    for f in jf:
        with open(os.path.join(dirs["j"], f), "rb") as x, \
                open(os.path.join(dirs["t"], f), "rb") as y:
            assert x.read() == y.read(), f
    jv = column_values(os.path.join(dirs["j"], col))
    tv = column_values(os.path.join(dirs["t"], col))
    for v in jv:
        assert np.array_equal(jv[v], tv[v]), v
    a = C.read_stats(os.path.join(dirs["t"], stats))
    b = C.read_stats(os.path.join(dirs["j"], stats))
    assert list(b["time"]) == [0., 1., 2., 3.]
    assert max(C.stats_agree(a, b, "post").values()) <= 1e-12


def test_chip_smoke_output_check_on_the_cpu():
    # [4b]'s drycblslope statistics run on the levels of drycblslope_z(32)
    over = {case: o for _, case, _, o in C.STATS_CASES}["drycblslope"]
    assert float(over["zsize"]) == cases.drycblslope_z(32)[1]
    out = C.check_outputs(torch, devices=("cpu", "cpu"))
    assert out["cross_files"] == 4 * 4 * 3      # 4 samples, 4 fields, 3 planes
    assert max(v for k, v in out.items() if k != "cross_files") == 0.


def test_chip_smoke_eady_reading_on_the_cpu():
    """The reading's two CPU runs, the second from the fields shifted
    periodically, are the same flow: they differ by roundoff alone."""
    res = C.eady_reading(torch, device="cpu")
    assert res["velocity_scale"] > 0.3
    assert max(res["card_vs_cpu"].values()) == 0.
    assert 0. < max(res["cpu_vs_cpu_shifted"].values()) <= 1e-11
