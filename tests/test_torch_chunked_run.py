"""The port's device-side chunked time loop (``Model._run_chunked``,
``graph_step.py``) against the JAX package's, float64 on the CPU:

* drycblles at 12^3 with the ini edits of tests/test_chunked_run.py
  (cflmax 0.002, so that dt is CFL-limited), run to 180 s with statistics
  every 45 s and a status line every 4 steps, so that chunks end both at a
  sample time (``done``) and after ``outputiter`` steps (``nmax``): both
  packages' chunked ``run_case`` give the same restart u and th (<= 1e-10
  of their scale), the same ITER and TIME columns and DT, CFL and DNUM
  within 1e-10; the port's chunked loop against its own per-step loop
  (``MICROHH_CHUNK=0``) to 1e-9, the JAX test's own bound, with the same
  final iteration and time;
* ``next_dt`` in each of its branches against a numpy transcription of
  microhh_tpu/model.py:1009-1026;
* the dispatch: fixed dt, ``MICROHH_CHUNK=0``, ``MICROHH_PROFILE`` and
  ``max_iters`` each take the per-step loop; a chunk of no step raises; a
  chunk lands on its horizon exactly at ``done``;
* the step's dt as a 0-dim tensor: K22's, K2's and K4's plain versions
  (and whole steps on both forms) equal their float forms bit for bit; the
  wrappers pass it to the kernels as a device scalar, and write s* into
  ``out`` when given; the other paths keep dt a number;
* chip_smoke.py's long chunked runs (``chunked_drift``,
  ``chunked_captured_against_eager``) with the card's runs sent to the
  CPU.
"""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import build_model, initial_state
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.graph_step import ChunkLoop, next_dt
from microhh_torch.model import Model, run_case
from microhh_torch.ops import fused as F
from microhh_torch.timeloop import IFACTOR
from test_torch_kmarch import Recorder
from test_torch_stats import write_input

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, ENDTIME, OUTPUTITER = 12, 180, 4


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def prep(d):
    """cases/drycblles at N^3 with tests/test_chunked_run.py's edits, run
    to ENDTIME (one restart at the end), statistics every 45 s, a status
    line every OUTPUTITER steps."""
    os.makedirs(d)
    with open(os.path.join(ROOT, "cases", "drycblles", "drycblles.ini")) as f:
        ini = f.read()
    for key, val in (("itot", N), ("jtot", N), ("ktot", N),
                     ("endtime", ENDTIME), ("savetime", ENDTIME),
                     ("sampletime", 45), ("cflmax", 0.002),
                     ("outputiter", OUTPUTITER)):
        ini = re.sub(r"(?m)^%s=\S+" % key, "%s=%s" % (key, val), ini)
    with open(os.path.join(d, "drycblles.ini"), "w") as f:
        f.write(ini)
    return d


def outputs(d):
    end = "%07d" % ENDTIME
    with open(os.path.join(d, "drycblles.out")) as f:
        rows = [line.split() for line in f if line.split()[0].isdigit()]
    return {"u": np.fromfile(os.path.join(d, "u." + end)),
            "th": np.fromfile(os.path.join(d, "th." + end)), "rows": rows}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's run_case chunked and per-step, and the JAX package's
    chunked (its compile dominates: it runs once)."""
    base = tmp_path_factory.mktemp("chunked")
    mem = cases.drycblles_input(N)
    out = {}
    for tag, chunk in (("port", "1"), ("port_per_step", "0")):
        d = prep(str(base / tag))
        old = os.environ.get("MICROHH_CHUNK")
        os.environ["MICROHH_CHUNK"] = chunk
        try:
            for mode in ("init", "run"):
                m = run_case(d, "drycblles", mode, dtype=torch.float64,
                             device="cpu", input_nc=mem)
        finally:
            if old is None:
                os.environ.pop("MICROHH_CHUNK")
            else:
                os.environ["MICROHH_CHUNK"] = old
        out[tag] = dict(outputs(d), model=m)
    from microhh_tpu.model import run_case as jrun_case
    d = prep(str(base / "jax"))
    write_input(mem, os.path.join(d, "drycblles_input.nc"))
    for mode in ("init", "run"):
        jrun_case(d, "drycblles", mode, dtype=np.float64)
    out["jax"] = outputs(d)
    return out


def test_chunked_run_matches_jax(runs):
    """Both packages' chunked run_case: restart fields <= 1e-10 of their
    scale, ITER and TIME identical, DT, CFL and DNUM <= 1e-10 relative;
    chunks ended at nmax and at done, over at least 8 steps."""
    a, b = runs["port"], runs["jax"]
    for f in ("u", "th"):
        assert a[f].shape == b[f].shape == (N ** 3,)
        err = np.abs(a[f] - b[f]).max() / np.abs(b[f]).max()
        assert err <= 1e-10, (f, err)
    assert len(a["rows"]) == len(b["rows"])
    for ra, rb in zip(a["rows"], b["rows"]):
        assert ra[:2] == rb[:2]
        for col in (3, 4, 5):
            x, y = float(ra[col]), float(rb[col])
            assert abs(x - y) <= 1e-10 * abs(y), (ra, rb)
    iters = [int(r[0]) for r in a["rows"]]
    assert iters[-1] >= 8 and OUTPUTITER in iters
    chunk = a["model"]._chunk
    # more chunks than status lines after the first: some ended at a
    # sample time, not after outputiter steps
    assert chunk.counters["chunks"] > len(iters) - 1
    assert chunk.counters["steps"] == iters[-1]
    # adaptive stepping engaged (dt below dtmax = 60)
    assert float(a["rows"][-1][3]) < 10.


def test_chunked_matches_per_step(runs):
    """The port's chunked loop against its per-step loop: <= 1e-9, the
    same final iteration and time (tests/test_chunked_run.py's bound)."""
    a, b = runs["port"], runs["port_per_step"]
    assert b["model"]._chunk is None
    for f in ("u", "th"):
        assert np.abs(a[f] - b[f]).max() <= 1e-9, f
    assert a["rows"][-1][:2] == b["rows"][-1][:2]


# --------------------------------------------------------------------------
#  next_dt
# --------------------------------------------------------------------------

def next_dt_numpy(lim, dt_prev, remaining, dtmax, cflmax, cflmin, dnmax,
                  mcflmax):
    """microhh_tpu/model.py:1009-1026 (build_chunk's next_dt), in numpy."""
    dt = np.float64(dtmax)
    if "cfl_rate" in lim:
        cfl = np.maximum(lim["cfl_rate"] * dt_prev, cflmin)
        dt = np.minimum(dt, dt_prev * cflmax / cfl)
    if dnmax is not None and "dn_rate" in lim:
        dn = lim["dn_rate"] * dt_prev
        dt = np.minimum(dt, np.where(
            dn > 0., dt_prev * dnmax / np.maximum(dn, 1e-30), np.inf))
    if "micro_rate" in lim:
        mc = np.maximum(lim["micro_rate"] * dt_prev, 1e-5)
        dt = np.minimum(dt, dt_prev * mcflmax / mc)
    last = remaining <= dt
    return np.where(last, remaining, dt), last


RULES = dict(dtmax=60., cflmax=1.2, cflmin=1e-5, dnmax=0.3, mcflmax=1.2)

# (lim, dt_prev, remaining, rules changed, which bound holds)
BRANCHES = {
    "cfl": ({"cfl_rate": 0.5, "dn_rate": 0.01}, 2., 100., {}, 2.4),
    "cflmin": ({"cfl_rate": 0., "dn_rate": 0.}, 2., 100., {}, 60.),
    "dn": ({"cfl_rate": 0.001, "dn_rate": 0.2}, 2., 100., {}, 1.5),
    "dn_zero": ({"cfl_rate": 0.5, "dn_rate": 0.}, 2., 100., {}, 2.4),
    "no_dnmax": ({"cfl_rate": 0.001, "dn_rate": 0.2}, 2., 100.,
                 {"dnmax": None}, 60.),
    "micro": ({"cfl_rate": 0.01, "dn_rate": 0.01, "micro_rate": 2.}, 2.,
              100., {}, 0.6),
    "dtmax": ({"cfl_rate": 0.001, "dn_rate": 0.001}, 7., 100.,
              {"dtmax": 9.}, 9.),
    "last_step": ({"cfl_rate": 0.5, "dn_rate": 0.01}, 2., 1.75, {}, 1.75),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_next_dt_matches_the_jax_formula(branch):
    lim, dt_prev, remaining, change, want = BRANCHES[branch]
    rules = dict(RULES, **change)
    T = lambda x: torch.tensor(x, dtype=torch.float64)
    dt, last = next_dt({k: T(v) for k, v in lim.items()}, T(dt_prev),
                       T(remaining), **rules)
    ref, ref_last = next_dt_numpy(lim, dt_prev, remaining, **rules)
    assert dt.dtype == torch.float64 and dt.dim() == 0
    assert float(dt) == float(ref) and bool(last) == bool(ref_last)
    assert abs(float(dt) - want) <= 1e-12 * want
    assert bool(last) == (branch == "last_step")


# --------------------------------------------------------------------------
#  the dispatch, and a chunk's bookkeeping
# --------------------------------------------------------------------------

class PerStep(Exception):
    pass


@pytest.mark.parametrize("how", ["chunked", "fixed_dt", "chunk_0", "profile",
                                 "max_iters"])
def test_run_dispatch(how, tmp_path, monkeypatch):
    """run() takes the chunked loop unless dt is fixed, MICROHH_CHUNK is 0,
    MICROHH_PROFILE is set or max_iters is given (the JAX package's gate,
    microhh_tpu/model.py:1219-1229)."""
    monkeypatch.delenv("MICROHH_CHUNK", raising=False)
    monkeypatch.delenv("MICROHH_PROFILE", raising=False)
    d = prep(str(tmp_path / "case"))
    text = open(os.path.join(d, "drycblles.ini")).read()
    if how == "fixed_dt":
        text = text.replace("adaptivestep=true", "adaptivestep=false")
    if how == "chunk_0":
        monkeypatch.setenv("MICROHH_CHUNK", "0")
    if how == "profile":
        monkeypatch.setenv("MICROHH_PROFILE", str(tmp_path / "prof"))
    m = Model(Ini(text), "run", "drycblles", workdir=d, dtype=torch.float64,
              device="cpu", input_nc=cases.drycblles_input(N))
    monkeypatch.setattr(Model, "_run_chunked", lambda self, f: "chunked")

    def per_step(self):
        raise PerStep()

    monkeypatch.setattr(Model, "load_state", per_step)
    kw = {"max_iters": 3} if how == "max_iters" else {}
    if how == "chunked":
        assert m._chunk_supported() and m.run(**kw) == "chunked"
    else:
        with pytest.raises(PerStep):
            m.run(**kw)


def small_model(tmp_path):
    m = build_model(torch, 8, 8, torch.float64, "cpu", workdir=str(tmp_path))
    m.build_step()
    st = initial_state(m, seed=3)
    s = {n: m.ctx.tensor(st[n]) for n in m.fields.prognostic_names}
    sfc = {k: m.ctx.tensor(v) for k, v in
           m.boundary.init_surface_state(dtype=np.float64).items()}
    return m, s, sfc


def test_chunk_bookkeeping(tmp_path):
    """A chunk of no step raises; one cut at nmax advances the iteration by
    nmax and the integer time by its rounded sum; one that ends at done
    lands on its horizon exactly."""
    m, s, sfc = small_model(tmp_path)
    tl = m.timeloop
    with pytest.raises(RuntimeError, match="no progress"):
        m._advance_chunk(s, sfc, 10 ** 12, 0)
    it0 = tl.iteration
    s, sfc, lim = m._advance_chunk(s, sfc, 10 ** 12, 3)
    assert tl.iteration == it0 + 3 and tl.loop
    loop = m._chunk
    assert int(loop.n) == 3 and not bool(loop.done)
    assert tl.itime == int(round(float(loop.tau) * IFACTOR))
    assert set(lim) == {"cfl_rate", "dn_rate"}
    itime = tl.itime
    ih = int(0.5 * IFACTOR) + 7
    s, sfc, _ = m._advance_chunk(s, sfc, ih, 100)
    assert bool(loop.done) and tl.itime == itime + ih
    assert tl.idt == max(int(round(float(loop.dt) * IFACTOR)), 1)
    assert not loop.captured() and loop.counters["chunks"] == 3
    for n in s:
        assert bool(torch.isfinite(s[n]).all()), n


def test_eager_loop_needs_no_card(tmp_path):
    """ChunkLoop on the CPU runs its body eagerly: the scalars live on the
    model's device in its dtype, and the step's out= is the card's."""
    m, s, sfc = small_model(tmp_path)
    loop = ChunkLoop(m)
    assert loop.dt.dtype == torch.float64 and loop.flags.dtype == torch.int32
    assert not loop.captured()
    with pytest.raises(ValueError, match="card"):
        m.step(s, sfc, 1., out={n: torch.zeros_like(a) for n, a in s.items()})


def test_chip_smoke_chunk_checks_run_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's long chunked runs with the card's runs sent to the
    CPU: chunked_drift reads each restart's iteration and the three runs'
    errors (all zero here, where the three are one computation), and
    chunked_captured_against_eager fails where nothing was captured."""
    import chip_smoke
    orig = chip_smoke.chunked_outputs
    monkeypatch.setattr(chip_smoke, "chunked_outputs",
                        lambda torch_, n, device, *a: orig(torch_, n, "cpu",
                                                           *a))
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    path = str(tmp_path / "drift.json")
    rows = chip_smoke.chunked_drift(torch, path, n=8, endtime=40,
                                    savetime=10)
    assert [r["time"] for r in rows] == [10, 20, 30, 40]
    its = [r["iteration"]["cpu"] for r in rows]
    assert its == sorted(its) and its[0] >= 1
    for r in rows:
        assert len(set(r["iteration"].values())) == 1
        assert r["captured_vs_eager"] == r["eager_vs_cpu"] == 0.
    assert os.path.getsize(path) > 0
    with pytest.raises(AssertionError, match="did not capture"):
        chip_smoke.chunked_captured_against_eager(torch, n=8, endtime=40,
                                                  min_steps=1)


# --------------------------------------------------------------------------
#  dt as a device scalar
# --------------------------------------------------------------------------

def carries(m, seed):
    rng = np.random.RandomState(seed)
    return {n: m.ctx.tensor(rng.randn(*m.t[n].shape)) for n in m.t}


def clone(d):
    return {k: v.clone() for k, v in d.items()}


def equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("first,carry", [(True, True), (False, True),
                                         (False, False)])
def test_tensor_dt_is_the_float_dt(first, carry, tmp_path):
    """K22's, K2's and K4's plain versions with 0-dim tensor cB*dt, 1/(cB*dt)
    and dt give their float forms' results bit for bit."""
    m, s, sfc = small_model(tmp_path)
    fz, gl, ctx = m.fused, m.glue, m.ctx
    cbdt, can = 0.7, (-5. / 9. if carry else 0.)
    T = lambda x: torch.tensor(x, dtype=torch.float64)
    t0 = carries(m, 4)
    row = torch.rand(ctx.jtot, ctx.itot, dtype=torch.float64)
    p = torch.rand(ctx.ktot, ctx.jtot, ctx.itot, dtype=torch.float64)
    out = {}
    for kind, (a, b) in (("float", (cbdt, 1. / cbdt)),
                         ("tensor", (T(cbdt), 1. / T(cbdt)))):
        t = clone(t0)
        ss, e, rhs = fz.tend_rk_fold(s, t, row, a, can, b, first, carry)
        t2 = clone(t0)
        ss2 = fz.tend_rk(s, t2, e, a, can, first, carry)
        r = gl.rhs(ss2["u"], ss2["v"], ss2["w"], b)
        st = clone(ss2)
        gl.apply(p, st, t2, a, can, carry)
        out[kind] = (ss, e, rhs, t, ss2, t2, r, st)
    for x, y in zip(out["float"], out["tensor"]):
        if isinstance(x, dict):
            assert equal(x, y)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("fold", [True, False])
def test_step_takes_dt_as_a_device_scalar(fold, tmp_path):
    """Whole steps with dt a 0-dim tensor and a float, on K22 and on
    K1 -> K2 -> K4 rhs: the same state, bit for bit."""
    m, s, sfc = small_model(tmp_path)
    m.build_step(fold=fold)
    assert m.device_dt()
    res = []
    for dt in (3.0, torch.tensor(3.0, dtype=torch.float64)):
        for t in m.t.values():
            t.zero_()
        s2, sfc2, aux = m.step(clone(s), clone(sfc), dt)
        res.append((s2, sfc2, aux["p"]))
    assert equal(res[0][0], res[1][0]) and equal(res[0][1], res[1][1])
    assert torch.equal(res[0][2], res[1][2])


def test_other_paths_take_dt_as_a_number(tmp_path, monkeypatch):
    """The substep without the RK fold keeps dt a number: a 0-dim tensor
    is read to the host once, a number is passed as it is (no device
    scalar, no rounding to the model's dtype), and both give the same
    state bit for bit."""
    m, s, sfc = small_model(tmp_path)
    m.build_step(unfolded=True)
    assert not m.device_dt()
    seen = []
    orig = Model.substep

    def substep(self, s, sfc, aux, dt, sub, out=None):
        seen.append(dt)
        return orig(self, s, sfc, aux, dt, sub, out)

    monkeypatch.setattr(Model, "substep", substep)
    res = []
    for dt in (3.0, torch.tensor(3.0, dtype=torch.float64)):
        for t in m.t.values():
            t.zero_()
        s2, sfc2, _ = m.step(clone(s), clone(sfc), dt)
        res.append((s2, sfc2))
    assert all(type(dt) is float and dt == 3.0 for dt in seen)
    assert len(seen) == 2 * m.timeloop.n_substeps
    assert equal(res[0][0], res[1][0]) and equal(res[0][1], res[1][1])


@pytest.mark.parametrize("kernel", ["tend_rk_fold", "tend_rk", "pres_rhs",
                                    "pres_apply"])
def test_wrappers_pass_device_scalars(kernel, tmp_path, monkeypatch):
    """On the kernel path the wrappers pass cB*dt, 1/(cB*dt) and dt as 0-dim
    tensors (the one given, or a number put on the device), and K22 and
    K2 write s* into ``out`` with its ghost planes zeroed."""
    monkeypatch.setattr(F, "on_cpu", lambda t: False)
    m = build_model(torch, 40, 16, torch.float32, "cpu")
    m.build_step(fold=kernel == "tend_rk_fold")
    fz, gl, ctx = m.fused, m.glue, m.ctx
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    s = {n: torch.zeros(shape) for n in F.PROGNOSTIC}
    t = {n: torch.zeros(shape) for n in F.PROGNOSTIC}
    out = {n: torch.full(shape, 7.) for n in F.PROGNOSTIC}
    e = torch.zeros((ctx.ktot, ctx.jtot, ctx.itot))
    cbdt = torch.tensor(0.5)
    rec = Recorder(kernel)
    if kernel == "tend_rk_fold":
        fz.k_tend_fold = rec
        ss, _, _ = fz.tend_rk_fold(s, t, None, cbdt, -0.6, 2., True, True,
                                   out=out)
        a = rec.calls[-1][1]
        scalars = {30: cbdt, 32: 2.}
        stars = a[6:10]
    elif kernel == "tend_rk":
        fz.k_tend = rec
        ss = fz.tend_rk(s, t, e, cbdt, -0.6, True, True, out=out)
        a = rec.calls[-1][1]
        scalars = {23: cbdt}
        stars = a[5:9]
    elif kernel == "pres_rhs":
        gl.k_rhs = rec
        gl.rhs(s["u"], s["v"], s["w"], 2.)
        a = rec.calls[-1][1]
        scalars = {11: 2.}
    else:
        gl.k_apply = rec
        gl.apply(e, s, t, cbdt, -0.6, True)
        a = rec.calls[-1][1]
        scalars = {14: cbdt}
    for i, want in scalars.items():
        assert torch.is_tensor(a[i]) and a[i].dim() == 0, i
        assert a[i].dtype == torch.float32 and float(a[i]) == float(want)
        if torch.is_tensor(want):
            assert a[i] is want
    if kernel in ("tend_rk_fold", "tend_rk"):
        assert [x is out[n] for x, n in zip(stars, F.PROGNOSTIC)] == [True] * 4
        for n in F.PROGNOSTIC:
            assert ss[n] is out[n]
            assert not bool(out[n][:ctx.ks].any())
            assert not bool(out[n][ctx.ke:].any())
            assert bool((out[n][ctx.ks:ctx.ke] == 7.).all())
    with pytest.raises(TypeError):
        fz.tend_rk_fold(s, t, None, torch.tensor(0.5, dtype=torch.float64),
                        -0.6, 2., True, True)
