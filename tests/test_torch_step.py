"""Whole RK3 steps of the port against the JAX package: the drycbl config of
__graft_entry__ at 16x16x16, float64 on the CPU, port Model.step against
microhh_tpu's Model(...); force_fused=True; _step_raw (the full-plane Pallas
kernels in interpret mode with fold_ghosts; the limits through limits_pass,
the JAX package's default slim limits).  All interior fields, p, the limits
and the diagnostics agree to 1e-10.  Also the port's host loop: status
table and a bitwise restart chain."""

import os

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops.pallas_fused import FusedLES2
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops.fused import exec_viscosity

N = 16
INI = graft._DRYCBL_INI % {"itot": N, "jtot": N, "ktot": N}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def initial_state(m, seed=5):
    """__graft_entry__'s state (seeded th perturbation + 300 K + 3 K/km)
    with seeded velocities, so that every term of the step is active."""
    st = m.fields.create(None, dtype=np.float64)
    g = m.grid
    ks, ke = g.kstart, g.kend
    st["th"][ks:ke] += (300. + 0.003 * g.z[ks:ke])[:, None, None]
    rng = np.random.RandomState(seed)
    for n in ("u", "v"):
        st[n][ks:ke] += 0.5 * rng.randn(g.ktot, g.jtot, g.itot)
    st["w"][ks + 1:ke] += 0.1 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    return st


def test_two_rk3_steps_match_jax(monkeypatch):
    monkeypatch.setenv("MICROHH_SLIM_LIMITS", "1")
    calls = []
    orig = FusedLES2.limits_pass

    def counted(self, *a):
        calls.append(1)
        return orig(self, *a)

    monkeypatch.setattr(FusedLES2, "limits_pass", counted)
    jm = JModel(JIni(INI), "run", "graft", dtype=np.float64)
    jm.force_fused = True
    jm.finish_setup()
    jm.build_step()
    assert jm._use_rkfold and jm._fused.fold_ghosts and not jm._fused.tiled
    js, _, jsfc = jm.as_device_state(initial_state(jm))
    tm = Model(Ini(INI), "run", "graft", dtype=torch.float64, device="cpu")
    tm.finish_setup()
    tm.build_step()
    ts, tsfc = tm.as_device_state(initial_state(tm))
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for dt in (1.5, 2.5):
        jlim = jm._limits_fn(js, jsfc)
        tlim = tm.limits(ts, tsfc)
        assert calls, "the JAX limits did not run limits_pass"
        for k in ("cfl_rate", "dn_rate"):
            assert rel(float(tlim[k]), float(jlim[k])) <= 1e-10, k
        # K7's per-level maxima against the op path they replace
        ev = exec_viscosity(tm.fused, tm.ctx, ts, tsfc, {})["evisc_int"]
        ev = torch.nn.functional.pad(ev, (0, 0, 0, 0, ks, tm.ctx.kcells - ke))
        assert rel(float(tlim["cfl_rate"]),
                   float(tm.advec.cfl_max(tm.ctx, ts))) <= 1e-14
        assert rel(float(tlim["dn_rate"]),
                   float(tm.diff.get_dn(tm.ctx, ts, {"evisc": ev}))) <= 1e-14
        js, jsfc, jaux = jm._step_raw(js, jsfc, jm.pres_params, dt, 0.)
        ts, tsfc, taux = tm.step(ts, tsfc, dt)
        for n in ("u", "v", "w", "th"):
            assert rel(ts[n][ks:ke], np.asarray(js[n])[ks:ke]) <= 1e-10, n
        assert rel(taux["p"], np.asarray(jaux["p"])[ks:ke]) <= 1e-10
        for k in tsfc:
            assert rel(tsfc[k], jsfc[k]) <= 1e-10, k
    jd = jm._diag_fn(js, jsfc)
    td = tm.diagnostics(ts, tsfc)
    for k in ("mom", "tke", "mass"):
        assert rel(float(td[k]), float(jd[k])) <= 1e-10, k
    # the divergence is a roundoff residual: held to 1e-10 of its scale
    # max|u| * dxi instead of to its own magnitude
    scale = float(ts["u"].abs().max()) * tm.ctx.dxi
    assert abs(float(td["div"]) - float(jd["div"])) <= 1e-10 * scale
    assert float(td["div"]) <= 1e-12 * scale


RESTART_INI = INI.replace("dt=6.", "dt=2.\nadaptivestep=false") \
                 .replace("endtime=3600", "endtime=4") \
                 .replace("savetime=3600", "savetime=2")


def _case(workdir, starttime=0):
    ini = Ini(RESTART_INI.replace("starttime=0", "starttime=%d" % starttime))
    return Model(ini, "run", "graft", workdir=str(workdir),
                 dtype=torch.float64, device="cpu")


def test_run_loop_restart_chain_is_bitwise(tmp_path):
    """Init, 2 steps in one run, and the same 2 steps as 1 + a restart + 1:
    the restart files of the two chains are identical."""
    for sub in ("a", "b"):
        d = tmp_path / sub
        d.mkdir()
        init = Model(Ini(RESTART_INI), "init", "graft", workdir=str(d),
                     dtype=torch.float64, device="cpu")
        init.finish_setup()
        init.save_initial_state(initial_state(init))
    a = _case(tmp_path / "a")
    a.finish_setup()
    s_a = a.run()
    b1 = _case(tmp_path / "b")
    b1.finish_setup()
    b1.run(max_iters=1)
    b2 = _case(tmp_path / "b", starttime=2)
    b2.finish_setup()
    s_b = b2.run()
    assert a.timeloop.iteration == b2.timeloop.iteration == 2
    for n in ("u", "v", "w", "th"):
        assert torch.equal(s_a[n][1:-1], s_b[n][1:-1]), n
    names = sorted(f for f in os.listdir(tmp_path / "a") if f.endswith("0000004"))
    assert "u.0000004" in names and "obuk.0000004" in names
    for f in names:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes(), f
    rows = [line.split() for line in open(tmp_path / "a" / "graft.out")
            if line.split()[0].isdigit()]
    assert [int(r[0]) for r in rows] == [0, 2]     # outputiter=20, and the end
    assert all(np.isfinite(float(x)) for r in rows for x in r)
