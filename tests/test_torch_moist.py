"""The port's moist modules against the JAX package, in float64 on the CPU:

* host copies, bit for bit: ThermoMoist.create_basestate, rico_profiles
  against the file cases/rico/rico_input.py writes, and the in-memory
  dataset against utils/nc.Dataset on that file;
* ops against the JAX op path (<= 1e-12 of each output's maximum): the
  saturation functions on tensors, numpy arrays and Python floats,
  sat_adjust (cloudy, with ice, and cloud-free), the buoyancy and the other
  thermo functions, update_basestate against its lax.scan, Force, the
  limiter in both forms;
* the 2mom_warm op path (K11's plain version) against the JAX op path and
  against the Micro2Fused Pallas kernel in interpret mode: rainy, with
  strong sedimentation, and cloud-free."""

import os
import runpy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from microhh_tpu.config import Ini as JIni
from microhh_tpu.ops import force as jforce
from microhh_tpu.ops import limiter as jlimiter
from microhh_tpu.ops import thermo_moist as jtm
from microhh_torch.cases import rico_input, rico_profiles
from microhh_torch.config import Ini
from microhh_torch.ops import force as tforce
from microhh_torch.ops import limiter as tlimiter
from microhh_torch.ops import thermo_moist as ttm
from microhh_torch.utils import nc as tnc

from test_torch_generic import (INI, KT, ROOT, ZSIZE, T, jx, rel, rico,
                                tx)  # noqa: F401  (rico: the shared fixture)

TOL = 1e-12


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def test_create_basestate_bitwise(rico):
    jm, tm, _, _, _ = rico
    for name in ("thvref", "thvrefh", "pref", "prefh", "exnref", "exnrefh"):
        assert np.array_equal(getattr(tm.thermo, name),
                              getattr(jm.thermo, name)), name
    assert np.array_equal(tm.fields.rhoref, jm.fields.rhoref)
    assert np.array_equal(tm.fields.rhorefh, jm.fields.rhorefh)


def test_rico_profiles_match_the_generator(tmp_path, monkeypatch):
    (tmp_path / "rico.ini").write_text("ktot=%d\nzsize=%g\n" % (KT, ZSIZE))
    monkeypatch.chdir(tmp_path)
    runpy.run_path(os.path.join(ROOT, "cases", "rico", "rico_input.py"))
    mem = rico_input(KT, ZSIZE)
    with tnc.Dataset(str(tmp_path / "rico_input.nc")) as f:
        z = f.variables["z"][:]
        assert np.array_equal(mem.variables["z"][:KT], z)
        init = f.groups["init"]
        profs = rico_profiles(z)
        assert set(profs) == set(init.variables)
        for name, prof in profs.items():
            assert np.array_equal(prof, init.variables[name][:]), name
            assert np.array_equal(mem.groups["init"].variables[name][:KT],
                                  init.variables[name][:KT]), name


def _sat_inputs(kind):
    rng = np.random.RandomState({"cloudy": 1, "ice": 2, "clear": 3}[kind])
    shape = (6, 5, 7)
    p = rng.uniform(9e4 if kind == "clear" else 6e4, 1.02e5, shape)
    exn = (p / 1e5) ** (287.04 / 1005.)
    if kind == "clear":
        thl = rng.uniform(290., 305., shape)
        qt = rng.uniform(1e-4, 2e-3, shape)
    elif kind == "ice":
        thl = rng.uniform(235., 275., shape)
        qt = rng.uniform(1e-3, 6e-3, shape)
    else:
        thl = rng.uniform(285., 300., shape)
        qt = rng.uniform(8e-3, 2.4e-2, shape)
    return thl, qt, p, exn


@pytest.mark.parametrize("kind", ["cloudy", "ice", "clear"])
def test_sat_adjust_matches_jax(kind):
    args = _sat_inputs(kind)
    a = jtm.sat_adjust(*(jnp.array(x) for x in args))
    b = ttm.sat_adjust(*(T(x) for x in args))
    for x, y in zip(b, a):
        y = np.asarray(y)
        if np.abs(y).max() == 0.:
            assert float(x.abs().max()) == 0.
        else:
            assert rel(x, y) <= TOL
    if kind == "clear":
        assert float(b[0].abs().max()) == 0.
    else:
        assert float(b[0].max() + b[1].max()) > 0.
    # the scalar (host) path against the JAX package's numpy scalar path
    # (the stopping rule then holds for the one point alone)
    for idx in [(0, 0, 0), (3, 2, 5), (5, 4, 6)]:
        c = ttm.sat_adjust(*[float(x[idx]) for x in args])
        d = jtm.sat_adjust(*[np.float64(x[idx]) for x in args])
        for x, y in zip(c, d):
            assert abs(x - float(y)) <= 1e-14 * abs(float(y))


@pytest.mark.parametrize("name", [
    "esat_liq", "esat_ice", "water_fraction", "qsat_liq", "qsat_ice", "qsat",
    "dqsatdT_liq", "dqsatdT_ice", "dqsatdT", "exner"])
def test_saturation_functions_match_jax(name):
    """Each function on a tensor, a numpy array and a Python float (the
    three backends of the port) against the JAX package's."""
    rng = np.random.RandomState(6)
    T_ = rng.uniform(220., 310., 40)    # ice, mixed and liquid phases
    p = rng.uniform(6e4, 1.02e5, 40)
    args = (p,) if name == "exner" else (T_,) if name in (
        "esat_liq", "esat_ice", "water_fraction") else (p, T_)
    ref = np.asarray(getattr(jtm, name)(*(jnp.array(a) for a in args)))
    fn = getattr(ttm, name)
    assert rel(fn(*(T(a) for a in args)), ref) <= TOL
    assert rel(fn(*args), ref) <= TOL
    assert rel([fn(*(float(a[n]) for a in args)) for n in range(40)],
               ref) <= TOL


def test_thermo_ops_match_jax(rico):
    jm, tm, s, sfc, t = rico
    sj, st = jx(s), tx(s)
    tj = jm.thermo.exec(jm.ctx, sj, jx(t), {})
    tt = tm.thermo.exec(tm.ctx, st, tx(t), {})
    assert rel(tt["w"], tj["w"]) <= TOL
    assert rel(tm.thermo.get_ql(tm.ctx, st), jm.thermo.get_ql(jm.ctx, sj)) <= TOL
    assert float(tm.thermo.get_ql(tm.ctx, st).max()) > 0.
    sfc = dict(sfc)
    rng = np.random.RandomState(4)
    for name in ("thl_fluxbot", "qt_fluxbot", "thl_bot", "qt_bot"):
        sfc[name] = rng.rand(*sfc["ustar"].shape) * (1e-4 if "qt" in name else 1.)
    sfc["thl_bot"] += 299.
    sfc["qt_bot"] = 0.01 + 0.01 * sfc["qt_bot"]
    assert rel(tm.thermo.get_buoyancy_fluxbot(tm.ctx, st, tx(sfc)),
               jm.thermo.get_buoyancy_fluxbot(jm.ctx, sj, jx(sfc))) <= TOL
    for x, y in zip(tm.thermo.get_buoyancy_surf(tm.ctx, st, tx(sfc)),
                    jm.thermo.get_buoyancy_surf(jm.ctx, sj, jx(sfc))):
        assert rel(x, y) <= TOL
    assert rel(tm.thermo.get_db_ref(), jm.thermo.get_db_ref()) <= TOL


def test_update_basestate_matches_jax_scan(rico):
    jm, tm, s, sfc, _ = rico
    a = jm.thermo.update_basestate(jm.ctx, jx(s), {}, jx(sfc))
    tm.thermo.reads.clear()
    b = tm.thermo.update_basestate(tm.ctx, tx(s), {}, tx(sfc))
    assert tm.thermo.reads == {"basestate": 1}
    for name in ("pref", "prefh", "exnref", "exnrefh"):
        assert rel(b[name], a[name]) <= TOL, name
    # the evolved mean state moves the profiles off the create() ones
    assert rel(b["pref"], tm.thermo.pref) > 1e-8


@pytest.mark.parametrize("variant", ["geo-mean", "geo-local", "dpdx-mom"])
def test_force_matches_jax(rico, variant):
    jm, tm, s, _, t = rico
    text = INI
    if variant == "dpdx-mom":
        text = text.replace("swlspres=geo", "swlspres=dpdx\ndpdx=1.e-4").replace(
            "swwls=mean", "swwls=mean\nswwls_mom=true")
    elif variant == "geo-local":
        text = text.replace("swwls=mean", "swwls=local")
    fj = jforce.make_force(JIni(text), jm.grid, jm.fields, jm.input_nc)
    ft = tforce.make_force(Ini(text), tm.grid, tm.fields, tm.input_nc)
    a = fj(jm.ctx, jx(s), jx(t), {})
    b = ft(tm.ctx, tx(s), tx(t), {})
    for n in ("u", "v", "thl", "qt", "qr"):
        assert rel(b[n], a[n]) <= TOL, n


def test_limiter_forms_match(rico):
    jm, tm, s, _, t = rico
    ks, ke = tm.ctx.ks, tm.ctx.ke
    ini = Ini(INI)
    lt = tlimiter.Limiter(ini, tm.fields)
    lj = jlimiter.Limiter(JIni(INI), jm.fields)
    assert lt.limitlist == ["qt", "qr", "nr"]
    s = dict(s)
    s["qr"] = np.abs(s["qr"])
    tt = dict(t)
    tt["qr"] = -np.abs(t["qr"]) * 10.   # tendencies that would go negative
    subdt = 0.8
    a = lj(jm.ctx, jx(s), jx(tt), {}, subdt)
    b = lt(tm.ctx, tx(s), tx(tt), {}, subdt)
    for n in ("qt", "qr", "nr", "thl"):
        assert rel(b[n], a[n]) <= TOL, n
    # the s*-clamp form (microhh_tpu/model.py:470-484) against the same
    # formula in jnp, and against the tendency form it is equivalent to
    can = -153. / 128.
    s_new = {n: T(s[n] + subdt * tt[n]) for n in ("qt", "qr", "nr")}
    carry = {n: T(can * tt[n]) for n in s_new}
    lt.clamp(tm.ctx, s_new, carry, subdt, can)
    for n in s_new:
        sold = jnp.array(s[n] + subdt * tt[n])
        sclip = sold.at[ks:ke].set(jnp.maximum(sold[ks:ke], 0.))
        c = jnp.array(can * tt[n]).at[ks:ke].add(
            can * (sclip[ks:ke] - sold[ks:ke]) / subdt)
        assert rel(s_new[n], sclip) <= TOL, n
        assert rel(carry[n], c) <= TOL, n
        assert float(s_new[n][ks:ke].min()) >= 0.
        via_tend = T(s[n]) + subdt * b[n]
        assert rel(s_new[n][ks:ke], via_tend[ks:ke]) <= 1e-12, n


def _micro_state(rico, case):
    jm, tm, s, _, _ = rico
    s = dict(s)
    if case == "strong":
        s["qr"] = 50. * s["qr"]
    elif case == "cloudfree":
        s["qt"] = 0.5 * s["qt"]
    # strong: fall speeds near W_MAX cross ~2.5 cells in one dt
    dt = 2.5 * float(tm.grid.dz.min()) / 9.65 if case == "strong" else 2.
    return s, dt


@pytest.mark.parametrize("case", ["rainy", "strong", "cloudfree"])
def test_k11_micro_plain_matches_tpu_kernel(rico, case):
    jm, tm, _, _, t = rico
    s, dt = _micro_state(rico, case)
    jm.micro.force_fused = True
    jm.micro._fused = None
    tj, auxj = jm.micro.exec(jm.ctx, jx(s), jx(t), {}, dt)
    assert jm.micro._fused is not None, "the Pallas kernel did not run"
    tt = tx(t)
    _, auxt = tm.micro.exec(tm.ctx, tx(s), tt, {}, dt)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ("qr", "nr", "qt", "thl"):
        d = tt[n][ks:ke] - T(t[n][ks:ke])
        e = np.asarray(tj[n])[ks:ke] - t[n][ks:ke]
        assert rel(d, e) <= TOL, n
        assert torch.equal(tt[n][:ks], T(t[n][:ks])), n
    assert rel(auxt["rr_bot"], auxj["rr_bot"]) <= TOL
    ql = tm.thermo.get_ql(tm.ctx, tx(s))
    if case == "cloudfree":
        assert float(ql.max()) == 0.
    else:
        assert float(ql.max()) > 0.
    if case == "strong":   # drops cross more than one cell in one dt
        rate = float(tm.micro.get_time_limit_rate(tm.ctx, tx(s)))
        assert rate * dt > 1.


def test_micro_op_path_matches_jax(rico):
    jm, tm, _, _, t = rico
    s, dt = _micro_state(rico, "rainy")
    jm.micro.force_fused = False
    try:
        tj, auxj = jm.micro.exec(jm.ctx, jx(s), jx(t), {}, dt)
    finally:
        jm.micro.force_fused = True
    tt = tx(t)
    _, auxt = tm.micro.exec(tm.ctx, tx(s), tt, {}, dt)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ("qr", "nr", "qt", "thl"):
        assert rel(tt[n][ks:ke] - T(t[n][ks:ke]),
                   np.asarray(tj[n])[ks:ke] - t[n][ks:ke]) <= TOL, n
    assert rel(auxt["rr_bot"], auxj["rr_bot"]) <= TOL
    assert rel(float(tm.micro.get_time_limit_rate(tm.ctx, tx(s))),
               float(jm.micro.get_time_limit_rate(jm.ctx, jx(s)))) <= TOL
