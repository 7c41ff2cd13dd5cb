"""The 2-D and geostrophic 4th-order runs (drycblslope, vanheerwaarden2016,
ekman) against the JAX package, in float64 on the CPU, on inputs made from a
seed with numpy:

* K16/K17's plain versions in their 2-D form (jtot = 1; both schemes, with
  and without scalars) against the JAX package's op path, which is what it
  runs there (its fused kernels want jtot > 1): ``advec.exec`` then
  ``diff.exec`` (<= 1e-12);
* the 4th-order Coriolis term against ``microhh_tpu/ops/force.py`` with a
  translation and random geostrophic profiles (<= 1e-12);
* two RK3 steps of drycblslope (32x1x32), vanheerwaarden2016 (64x1x48) and
  ekman (4x4x64, as written) through ``Model.run`` from the JAX package's
  restart files (<= 1e-10; each velocity component over the flow's
  velocity scale, the largest |u + utrans|, |v + vtrans|, |w|, each
  scalar over its own maximum: ekman's w stays at roundoff);
* drycblslope's statistics file with ``swbudget=4`` through ``run_case``
  against the JAX package's (<= 1e-10 of each profile's scale);
* the three inputs of ``cases.py`` bit for bit against the files their
  scripts write, and each ini as written built and stepped once.
drycblslope and vanheerwaarden2016 run on levels scaled to the test's
depth (``cases.drycblslope_z``, ``cases.vanheerwaarden2016_z``)."""

import os
import runpy

import numpy as np
import pytest
import torch

from chip_smoke import case_ini, read_stats, stats_agree
from microhh_tpu.utils import nc as jnc
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.model import Model, run_case
from microhh_torch.output import Cross
from test_torch_o4 import OPS_INI, T, TOL, jx, pair, rand_state, rel, tx
from test_torch_stats import write_input
from test_torch_timedep import initial_files, jax_run, port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def ops_2d(wd, swadvec, scalars):
    """OPS_INI at jtot = 1 (16x1x8 on a stretched column), with thermo buoy
    and the scalar s1, or with neither."""
    text = OPS_INI % {"ktot": 8, "swadvec": swadvec, "zsize": 1.,
                      "thermo": ""}
    text = text.replace("jtot=12", "jtot=1")
    if not scalars:
        text = (text.replace("swthermo=buoy", "swthermo=0")
                .replace("slist=s1\n", ""))
    eta = -1. + 2. * (np.arange(8) + 0.5) / 8
    z = 0.5 * (1. + np.tanh(1.5 * eta) / np.tanh(1.5))
    return pair(wd, text, "o4", z, fused=False)


@pytest.mark.parametrize("scalars", [True, False])
@pytest.mark.parametrize("swadvec", ["4", "4m"])
def test_k16_k17_2d_plain_match_jax_op_path(tmp_path, swadvec, scalars):
    """O4Fused.exec at jtot = 1 (its 2-D form: no y terms, no diffusion of
    v) against the JAX package's advec.exec + diff.exec, with distinct w
    arrays under the two ghost types."""
    jm, tm = ops_2d(str(tmp_path), swadvec, scalars)
    assert jm._o4_fused is None                 # the JAX op path at jtot = 1
    assert tm.o4 is not None and not tm.o4.dim3
    want_names = ["o4_mom_2d"] + (["o4_scalars_2d"] if scalars else [])
    assert [k.name for k in tm.kernels()] == want_names
    assert tm.o4.info_scheme() == {"4": 2, "4m": 3}[swadvec]
    assert set(tm.ctx.scalar_names) == ({"b", "s1"} if scalars else set())
    s, t = rand_state(tm, 31)
    rng = np.random.default_rng(5)
    wc = rng.standard_normal(s["w"].shape)
    want = jm.advec.exec(jm.ctx, jx(dict(s, w=wc)), jx(t), {})
    want = jm.diff.exec(jm.ctx, jx(s), want, {})
    tt = tx(t)
    got = tm.o4.exec(tm.ctx, tx(dict(s, w=wc)), tx(s), tt, {})
    for n in t:
        assert got[n] is tt[n]
        assert rel(got[n], want[n]) <= TOL, n
    # v is advected but not diffused: its carry moves with its advection
    # alone
    tv = T(t["v"])
    adv = tm.advec.momentum(tm.ctx, T(s["u"]), T(s["v"]), T(wc))[1]
    tv[tm.ctx.ks:tm.ctx.ke] += adv
    assert rel(got["v"], tv) <= 1e-14


def test_coriolis_4th_matches_jax(tmp_path):
    """swlspres=geo at order 4 (the centred four-point interpolants) with a
    translation, on random fields and geostrophic profiles."""
    rng = np.random.default_rng(12)
    text = (OPS_INI % {"ktot": 8, "swadvec": "4", "zsize": 1., "thermo": ""}
            ).replace("[fields]", "[force]\nswlspres=geo\nfc=1.3e-4\n\n"
                      "[fields]").replace("swspatialorder=4",
                                          "swspatialorder=4\nutrans=0.7\n"
                                          "vtrans=-0.2")
    prof = {"u_geo": rng.standard_normal(8), "v_geo": rng.standard_normal(8)}
    jm, tm = pair(str(tmp_path), text, "o4", np.linspace(1 / 16, 15 / 16, 8),
                  prof, fused=False)
    s, t = rand_state(tm, 13)
    want = jm.force(jm.ctx, jx(s), jx(t), {})
    got = tm.force(tm.ctx, tx(s), tx(t), {})
    for n in t:
        assert rel(got[n], want[n]) <= TOL, n
    changed = {n for n in t if not np.array_equal(got[n].numpy(), t[n])}
    assert changed == {"u", "v"}
    # centred: the 2nd-order offset stencil gives another term
    tm.ctx.spatial_order = 2
    try:
        other = tm.force(tm.ctx, tx(s), tx(t), {})
    finally:
        tm.ctx.spatial_order = 4
    assert rel(other["u"], want["u"]) > 1e-6


CASES = {
    "drycblslope": {"itot": 32, "jtot": 1, "ktot": 32, "swstats": 0,
                    "swbudget": 0,
                    "zsize": "%.17g" % cases.drycblslope_z(32)[1]},
    "vanheerwaarden2016": {"itot": 64, "jtot": 1, "ktot": 48, "swstats": 0,
                           "swbudget": 0, "swcross": 0,
                           "zsize": "%.17g" % cases.vanheerwaarden2016_z(48)[1]},
    "ekman": {}}


def flow_err(tm, a, b):
    """The largest difference of each field: velocity components over the
    flow's velocity scale (in b), scalars over their own maximum."""
    ks, ke = tm.ctx.ks, tm.ctx.ke
    g = tm.grid
    scale = max(float(np.abs(b["u"][ks:ke] + g.utrans).max()),
                float(np.abs(b["v"][ks:ke] + g.vtrans).max()),
                float(np.abs(b["w"][ks:ke + 1]).max()))
    out = {}
    for n in tm.fields.prognostic_names:
        d = float(np.abs(a[n][ks:ke] - b[n][ks:ke]).max())
        out[n] = d / (scale if n in ("u", "v", "w")
                      else max(float(np.abs(b[n][ks:ke]).max()), 1e-300))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_case_two_steps_match_jax(tmp_path, case):
    text = case_ini(case, **CASES[case])
    ini = Ini(text)
    mem = cases.case_input(case, ini.get_int("grid", "ktot"),
                           ini.get_float("grid", "zsize"))
    jdir, tdir = initial_files(tmp_path, case, text, mem)
    jm, js = jax_run(jdir, case, text, 2)
    tm, ts = port_run(tdir, case, text, mem, 2)
    assert tm.timeloop.iteration == jm.timeloop.iteration == 2
    assert tm.timeloop.itime == jm.timeloop.itime
    names = {"ekman": ["o4_mom"]}.get(case, ["o4_mom_2d", "o4_scalars_2d"])
    assert [k.name for k in tm.kernels()] == names
    assert tm._chunk_supported()
    assert all(np.isfinite(v).all() for v in ts.values())
    errs = flow_err(tm, ts, js)
    assert max(errs.values()) <= 1e-10, errs
    if case == "ekman":
        # the Coriolis term turned the geostrophic start
        assert float(np.abs(ts["v"]).max()) > 1e-3


def test_drycblslope_stats_match_jax(tmp_path, monkeypatch):
    """drycblslope 32x1x32 with its swbudget=4 through both packages'
    run_case to 0.8 s (three samples): the same file layout, values <=
    1e-10 of their scale, the budget group there."""
    monkeypatch.setenv("MICROHH_CHUNK", "0")
    over = dict(CASES["drycblslope"], swstats=1, swbudget=4, endtime=0.8)
    mem = cases.drycblslope_input(32)
    dirs = {}
    for side in ("t", "j"):
        dirs[side] = str(tmp_path / side)
        os.makedirs(dirs[side])
        with open(os.path.join(dirs[side], "drycblslope.ini"), "w") as f:
            f.write(case_ini("drycblslope", **over))
    write_input(mem, os.path.join(dirs["j"], "drycblslope_input.nc"))
    for mode in ("init", "run"):
        run_case(dirs["t"], "drycblslope", mode, dtype=torch.float64,
                 device="cpu", input_nc=mem)
    from microhh_tpu.model import run_case as jrun_case
    for mode in ("init", "run"):
        jrun_case(dirs["j"], "drycblslope", mode, dtype=np.float64)
    name = "drycblslope.default.0000000.nc"
    a = read_stats(os.path.join(dirs["t"], name))
    b = read_stats(os.path.join(dirs["j"], name))
    assert list(b["time"]) == [0., 0.4, 0.8]
    errs = stats_agree(a, b, "drycblslope")
    assert max(errs.values()) <= 1e-10, max(errs.items(), key=lambda kv: kv[1])
    assert any(k[0] == "budget" for k in b if isinstance(k, tuple))


@pytest.mark.parametrize("case", ["drycblslope", "vanheerwaarden2016",
                                  "ekman"])
def test_case_inputs_equal_the_case_scripts(tmp_path, monkeypatch, case):
    text = open(os.path.join(ROOT, "cases", case, "%s.ini" % case)).read()
    (tmp_path / ("%s.ini" % case)).write_text(text)
    monkeypatch.chdir(tmp_path)
    runpy.run_path(os.path.join(ROOT, "cases", case, "%s_input.py" % case))
    f = jnc.Dataset(str(tmp_path / ("%s_input.nc" % case)), "r")
    ini = Ini(text)
    mem = cases.case_input(case, ini.get_int("grid", "ktot"),
                           ini.get_float("grid", "zsize"))
    assert np.array_equal(np.asarray(f.variables["z"][:]),
                          np.asarray(mem.variables["z"][:]))
    init = f.groups["init"]
    assert set(init.variables) == set(mem.groups["init"].variables)
    for name in init.variables:
        assert np.array_equal(np.asarray(init.variables[name][:]),
                              np.asarray(mem.groups["init"].variables[name][:])), name
    if case != "ekman":
        # the ini's zsize is the height of the script's levels (to the
        # digit the ini prints)
        _, zsize = getattr(cases, "%s_z" % case)()
        assert abs(zsize - ini.get_float("grid", "zsize")) <= 2e-16 * zsize


@pytest.mark.parametrize("case", ["drycblslope", "vanheerwaarden2016",
                                  "ekman"])
def test_cases_as_written_build_and_step(case):
    """Each ini as written (full size, its inputs from cases.py) builds on
    the port's 4th-order path and takes a finite float64 step; the
    vanheerwaarden2016 ini's cross sections are read as written."""
    ini = Ini(case_ini(case))
    m = Model(ini, "run", case, dtype=torch.float64, device="cpu",
              input_nc=cases.case_input(case, ini.get_int("grid", "ktot"),
                                        ini.get_float("grid", "zsize")))
    m.finish_setup()
    m.build_step()
    assert m.o4.dim3 == (case == "ekman")
    s, sfc = m.as_device_state(m.fields.create(m.input_nc, dtype=np.float64))
    s, sfc, _ = m.step(s, sfc, m.timeloop.dt)
    assert all(bool(torch.isfinite(a).all()) for a in s.values())
    if case == "vanheerwaarden2016":
        cross = Cross(m)
        assert cross.sw and cross.crosslist == ["b", "blngrad", "w", "u"]
        assert cross.jxz == [0] and len(cross.kxy) == 2
