"""The port's 2nd-order substep without the RK fold (model.py
``_substep_unfolded``) against the JAX package, in float64 on the CPU:

* K18/K19 plain (``tend_uvw_acc``, ``tend_scalar_acc`` and the all-scalars
  ``tend_scalars_acc``) vs FusedLES2.tend_uv, tend_w and tend_scalar in
  Pallas interpret mode, advection on and off, with and without the
  Coriolis fold (<= 1e-12 of each output's maximum);
* K20 plain (``tendencies``) vs FusedLES2.tendencies(..., t_in=t) with
  fold_ghosts off, sponge and Coriolis folds on and off, and vs the same call
  under MICROHH_STREAM=1 (the k-streaming ``_stream_call``, which returns
  interior increments) (<= 1e-12);
* K21 (``tdma_ri``, K3's solve in place on the spectrum) vs the JAX
  package's form of it: Pres2._tdma_ri with ``_tdma_interpret`` on the same
  spectrum times dz^2, split into its real and imaginary parts, the Nyquist
  column included, per mode (<= 1e-12), and Pres2.exec (<= 1e-10);
* Source and BoundaryOutflow.correct vs the JAX ops (<= 1e-12), the sources'
  exact emission rate, and the advec_2 flux the outflow correction takes out
  under any scheme (ROADMAP Queue 3);
* two RK3 steps of a 16x8x24 jaenschwalde, a sullivan2011 (forced onto the
  unfolded substep: its default is the RK-folded one) and a Dirichlet-top
  drycblles case vs the JAX Model (<= 1e-10), with co2 and its inflow
  profile carried across as numpy arrays;
* the port's own two paths: drycblles and rico on the unfolded substep vs
  their RK-folded steps (<= 1e-10), and the limiter's two forms on qt;
* the options that stay outside the slice raise, naming their ROADMAP item.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import (DRYCBL_INI, build_jaenschwalde, build_sullivan,
                        case_ini, rico_ini, rico_state, unfolded_state)
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops import pallas_fused as JF
from microhh_tpu.utils import nc as jnc
from microhh_torch import cases
from microhh_torch.cases import rico_input
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import fused as F
from microhh_torch.ops.limiter import Limiter
from microhh_torch.ops.pres_2 import tdma_plain

TOL = 1e-12
N, KT = (16, 8), 24


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def jx(d):
    return {k: jnp.array(v) for k, v in d.items()}


def tx(d):
    return {k: T(v) for k, v in d.items()}


def write_input(wd, casename, mem):
    """<casename>_input.nc as the case's input script writes it, from the
    port's in-memory dataset."""
    z = np.asarray(mem.variables["z"][:])
    f = jnc.Dataset(os.path.join(wd, "%s_input.nc" % casename), "w")
    f.createDimension("z", len(z))
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, var in mem.groups["init"].variables.items():
        g.createVariable(name, "f8", ("z",))[:] = np.asarray(var[:])
    f.close()


def jax_model(tm, wd):
    """The JAX Model of a port model's ini, on its input written to wd."""
    if tm.input_nc is not None:
        write_input(wd, tm.casename, tm.input_nc)
    jm = JModel(JIni(tm.ini_text), "run", tm.casename, workdir=wd,
                dtype=np.float64)
    jm.force_fused = True
    jm.finish_setup()
    jm.build_step()
    return jm


def torch_model(build, n=N, k=KT, **step):
    tm = build(torch, n, k, torch.float64, "cpu")
    tm.build_step(**step)
    return tm


def _with_text(build, case, **over):
    def wrapped(*a, **kw):
        m = build(*a, **kw)
        m.ini_text = case_ini(case, **over)
        return m
    return wrapped


build_jaen = _with_text(build_jaenschwalde, "jaenschwalde", itot=N[0],
                        jtot=N[1], ktot=KT)
build_sull = _with_text(build_sullivan, "sullivan2011", itot=N[0], jtot=N[1],
                        ktot=KT, swstats=0)


def random_sfc(tm, seed):
    sfc = tm.boundary.init_surface_state()
    rng = np.random.RandomState(seed)
    for name in ("dudz_mo", "dvdz_mo", "u_fluxbot", "v_fluxbot"):
        sfc[name] = 0.1 * rng.randn(*sfc[name].shape)
    sfc["dbdz_mo"] = 1e-4 * rng.rand(*sfc["dbdz_mo"].shape)
    return sfc


def filled_state(jm, tm, seed):
    """A seeded state, ghost-filled by both packages (held equal), a random
    surface state and random carries, as numpy arrays."""
    state = unfolded_state(tm, seed)
    sfc = random_sfc(tm, seed + 1)
    sj = jm.boundary.set_ghost_cells(jm.ctx, jx(state), jx(sfc))
    st = tm.boundary.set_ghost_cells(tm.ctx, tx(state), tx(sfc))
    for n in st:
        assert rel(st[n], sj[n]) <= TOL, n
    s = {k: np.asarray(v) for k, v in sj.items()}
    rng = np.random.RandomState(seed + 2)
    t = {n: 1e-3 * rng.randn(*s[n].shape) for n in s}
    return s, sfc, t


@pytest.fixture(scope="module")
def jaen(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("jaen"))
    tm = torch_model(build_jaen)
    jm = jax_model(tm, wd)
    assert jm._fused.generic and jm._fused.no_advec
    assert jm.outflow.active and not jm._use_rkfold_generic
    assert tm.generic and tm.unfolded and not tm.fused.advec
    return (jm, tm) + filled_state(jm, tm, seed=5)


@pytest.fixture(scope="module")
def sull(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("sull"))
    # its default is the RK-folded step with the Coriolis term in K22
    # (tests/test_torch_fold.py); this is its substep without the RK fold
    tm = torch_model(build_sull, unfolded=True)
    jm = jax_model(tm, wd)
    assert not tm.generic and tm.unfolded
    assert tm.skip_force and tm.skip_buffer and tm.fused.coriolis
    return (jm, tm) + filled_state(jm, tm, seed=9)


# --------------------------------------------------------------------------
#  K18, K19
# --------------------------------------------------------------------------

def _viscosities(jm, tm, s, sfc):
    ej = JF.fused_generic_viscosity(jm._fused, jm.ctx, jx(s), jx(sfc), {},
                                    jm.thermo)["evisc"]
    et = F.generic_viscosity(tm.fused, tm.ctx, tx(s), tx(sfc), {})["evisc"]
    assert rel(et, ej) <= TOL
    return ej, et


@pytest.mark.parametrize("coriolis", [False, True])
@pytest.mark.parametrize("advec", [False, True])
def test_k18_tend_uvw_acc_matches_tpu_kernels(jaen, monkeypatch, advec,
                                              coriolis):
    jm, tm, s, sfc, t = jaen
    jfz, tfz = jm._fused, tm.fused
    ej, et = _viscosities(jm, tm, s, sfc)
    monkeypatch.setattr(jfz, "no_advec", not advec)
    monkeypatch.setattr(tfz, "advec", advec)
    if coriolis:
        # a static geostrophic wind, folded on both sides
        rng = np.random.RandomState(1)
        ug, vg = rng.randn(KT), rng.randn(KT)
        cc = jfz.cc_tend.copy()
        cc[:, JF.C_UG], cc[:, JF.C_VG] = ug, vg
        monkeypatch.setattr(jfz, "cc_tend", cc)
        monkeypatch.setattr(jfz, "fold_coriolis", True)
        monkeypatch.setattr(jfz, "fc", 1e-2)
        ct = tfz.ct_static.clone()
        ct[:, F.T_UG], ct[:, F.T_VG] = T(ug), T(vg)
        monkeypatch.setattr(tfz, "ct_static", ct)
        monkeypatch.setattr(tfz, "fold_force", True)
        monkeypatch.setattr(tfz, "fc", 1e-2)
    sj, tj = jx(s), jx(t)
    ut, vt = jfz.tend_uv(sj["u"], sj["v"], sj["w"], ej, tj["u"], tj["v"])
    wt = jfz.tend_w(sj["u"], sj["v"], sj["w"], ej, tj["w"])
    tt = tx(t)
    tfz.tend_uvw_acc(tx(s), tt, et)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n, ref in (("u", ut), ("v", vt), ("w", wt)):
        assert rel(tt[n], ref) <= TOL, n
        # the ghost levels of the carry and half level ks of w stay
        assert torch.equal(tt[n][:ks], T(t[n][:ks])), n
        assert torch.equal(tt[n][ke:], T(t[n][ke:])), n
        assert rel(tt[n] - T(t[n]), np.asarray(ref) - t[n]) <= 1e-10, n
    assert torch.equal(tt["w"][ks], T(t["w"][ks]))


@pytest.mark.parametrize("name", ["thl", "qt", "co2"])
@pytest.mark.parametrize("advec", [False, True])
def test_k19_tend_scalar_acc_matches_tpu_kernel(jaen, monkeypatch, advec,
                                                name):
    jm, tm, s, sfc, t = jaen
    jfz, tfz = jm._fused, tm.fused
    assert set(tfz.names) == {"thl", "qt", "co2"}
    ej, et = _viscosities(jm, tm, s, sfc)
    monkeypatch.setattr(jfz, "no_advec", not advec)
    monkeypatch.setattr(tfz, "advec", advec)
    sj = jx(s)
    ref = jfz.tend_scalar(sj[name], sj["u"], sj["v"], sj["w"], ej,
                          jm.diff.viscs.get(name, jm.diff.visc),
                          jnp.array(t[name]))
    tt = tx(t)
    tfz.tend_scalar_acc(tx(s), tt, et, name)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    assert rel(tt[name], ref) <= TOL
    assert rel(tt[name] - T(t[name]), np.asarray(ref) - t[name]) <= 1e-10
    assert torch.equal(tt[name][:ks], T(t[name][:ks]))
    assert torch.equal(tt[name][ke:], T(t[name][ke:]))
    for other in tt:
        if other != name:
            assert torch.equal(tt[other], T(t[other])), other


@pytest.mark.parametrize("advec", [False, True])
def test_k19_all_scalars_in_one_call_match_tpu_kernel(jaen, monkeypatch,
                                                      advec):
    """K19 for every scalar in one call (tend_scalars_acc, plain) against
    FusedLES2.tend_scalar once a scalar in Pallas interpret mode."""
    jm, tm, s, sfc, t = jaen
    jfz, tfz = jm._fused, tm.fused
    ej, et = _viscosities(jm, tm, s, sfc)
    monkeypatch.setattr(jfz, "no_advec", not advec)
    monkeypatch.setattr(tfz, "advec", advec)
    sj = jx(s)
    tt = tx(t)
    tfz.tend_scalars_acc(tx(s), tt, et)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for name in tfz.names:
        ref = jfz.tend_scalar(sj[name], sj["u"], sj["v"], sj["w"], ej,
                              jm.diff.viscs.get(name, jm.diff.visc),
                              jnp.array(t[name]))
        assert rel(tt[name], ref) <= TOL, name
        assert rel(tt[name] - T(t[name]), np.asarray(ref) - t[name]) <= 1e-10
        assert torch.equal(tt[name][:ks], T(t[name][:ks])), name
        assert torch.equal(tt[name][ke:], T(t[name][ke:])), name
    for other in ("u", "v", "w"):
        assert torch.equal(tt[other], T(t[other])), other


def test_generic_tendencies_match(jaen):
    """K18 and K19 per scalar with the MOST wall rows, as one substep uses
    them, vs fused_generic_tendencies."""
    jm, tm, s, sfc, t = jaen
    auxj = JF.fused_generic_viscosity(jm._fused, jm.ctx, jx(s), jx(sfc), {},
                                      jm.thermo)
    auxt = F.generic_viscosity(tm.fused, tm.ctx, tx(s), tx(sfc), {})
    ref = JF.fused_generic_tendencies(jm._fused, jm.ctx, jx(s), jx(t), auxj,
                                      jx(sfc))
    tt = tx(t)
    F.generic_tendencies(tm.fused, tm.ctx, tx(s), tt, auxt, tx(sfc))
    for n in tt:
        assert rel(tt[n], ref[n]) <= TOL, n


# --------------------------------------------------------------------------
#  K20, and the k-streaming form of the same sweep
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stream", ["0", "1"])
@pytest.mark.parametrize("fold_buffer,fold_force", [(True, True),
                                                    (True, False),
                                                    (False, True),
                                                    (False, False)])
def test_k20_tendencies_match_tpu_kernels(sull, monkeypatch, fold_buffer,
                                          fold_force, stream):
    jm, tm, s, sfc, t = sull
    buffer_j = jm.buffer if fold_buffer else None
    force_j = jm.force if fold_force else None
    jfz = JF.FusedLES2(jm.ctx, jm.diff, jm.thermo, True, interpret=True,
                       buffer=buffer_j, force=force_j, fold_ghosts=False)
    tfz = F.Fused(tm.ctx, tm.diff, tm.thermo,
                  tm.buffer if fold_buffer else None, 0., ghosts=True,
                  force=tm.force if fold_force else None)
    assert tfz.coriolis == fold_force and jfz.fold_coriolis == fold_force
    sj, st = jx(s), tx(s)
    ej = JF.fused_exec_viscosity(jfz, jm.ctx, sj, jx(sfc), {})["evisc"]
    et = F.generic_viscosity(tfz, tm.ctx, st, tx(sfc), {})["evisc"]
    assert rel(et, ej) <= TOL
    monkeypatch.setenv("MICROHH_STREAM", stream)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    out = jfz.tendencies(sj["u"], sj["v"], sj["w"], sj["th"], ej, t_in=jx(t))
    if stream == "0":
        tt = tx(t)
        tfz.tendencies(st, tt, et)
        for n, ref in zip(F.PROGNOSTIC, out):
            assert ref.shape[0] == tm.ctx.kcells
            assert rel(tt[n], ref) <= TOL, n
            assert rel(tt[n] - T(t[n]), np.asarray(ref) - t[n]) <= 1e-10, n
            assert torch.equal(tt[n][:ks], T(t[n][:ks])), n
            assert torch.equal(tt[n][ke:], T(t[n][ke:])), n
        assert torch.equal(tt["w"][ks], T(t["w"][ks]))
        return
    # _stream_call returns interior increments without the carry; its w
    # pass leaves half level ks to the caller, K20 holds it at zero
    tt = {n: torch.zeros_like(st[n]) for n in F.PROGNOSTIC}
    tfz.tendencies(st, tt, et)
    for n, ref in zip(F.PROGNOSTIC, out):
        assert ref.shape[0] == tm.ctx.ktot
        lo = 1 if n == "w" else 0
        assert rel(tt[n][ks + lo:ke], np.asarray(ref)[lo:]) <= TOL, n
    assert float(tt["w"][ks].abs().max()) == 0.


def test_k1_ghost_mode_gives_the_padded_evisc(sull, monkeypatch):
    """K1 on ghost-filled dry fields, blocked and k-streaming, and the
    kcells array with repeated edge levels that K20 reads."""
    jm, tm, s, sfc, _ = sull
    jfz = JF.FusedLES2(jm.ctx, jm.diff, jm.thermo, True, interpret=True,
                       fold_ghosts=False)
    sj, st = jx(s), tx(s)
    ev = tm.fused.evisc(st["u"], st["v"], st["w"], st["th"])
    for stream in ("0", "1"):
        monkeypatch.setenv("MICROHH_STREAM", stream)
        assert rel(ev, jfz.evisc(sj["u"], sj["v"], sj["w"], sj["th"])) <= TOL
    e = F.generic_viscosity(tm.fused, tm.ctx, st, tx(sfc), {})["evisc"]
    ks, ke = tm.ctx.ks, tm.ctx.ke
    assert e.shape[0] == tm.ctx.kcells
    assert torch.equal(e[ks - 1], e[ks]) and torch.equal(e[ke], e[ke - 1])


def test_dry_tendencies_with_wall_rows_match(sull):
    """K20 with the MOST wall rows vs fused_tendencies on ghost-filled
    fields (the sponge and the Coriolis term folded on both sides)."""
    jm, tm, s, sfc, t = sull
    jfz = JF.FusedLES2(jm.ctx, jm.diff, jm.thermo, True, interpret=True,
                       buffer=jm.buffer, force=jm.force, fold_ghosts=False)
    auxj = JF.fused_exec_viscosity(jfz, jm.ctx, jx(s), jx(sfc), {})
    auxt = F.generic_viscosity(tm.fused, tm.ctx, tx(s), tx(sfc), {})
    ref = JF.fused_tendencies(jfz, jm.ctx, jx(s), jx(t), auxj, jx(sfc))
    tt = tx(t)
    F.tendencies(tm.fused, tm.ctx, tx(s), tt, auxt, tx(sfc))
    for n in tt:
        assert rel(tt[n], ref[n]) <= TOL, n


# --------------------------------------------------------------------------
#  K21 and the projection
# --------------------------------------------------------------------------

def test_k21_tdma_ri_matches_tpu_kernel(sull):
    """A seeded complex spectrum through the port's K21 (in place, dz^2
    from K3's table) against the same spectrum times dz^2, split, through
    the JAX package's Pres2._tdma_ri."""
    jm, tm, _, _, _ = sull
    kmax, jtot, nf = KT, N[1], N[0] // 2 + 1
    rng = np.random.RandomState(4)
    spec = rng.randn(kmax, jtot, nf) + 1j * rng.randn(kmax, jtot, nf)
    d = spec * np.asarray(jm.pres.dz2)
    jm.pres._tdma_interpret = True
    try:
        xr, xi = jm.pres._tdma_ri(jnp.array(d.real), jnp.array(d.imag),
                                  jm.pres_params["winv"], kmax)
    finally:
        jm.pres._tdma_interpret = False
    # the JAX package's own columns (pres_2.py:886-891) and rhs scale
    afcf = np.zeros((kmax, 2))
    afcf[1:, 0] = -np.asarray(jm.pres.a_k)[1:, 0, 0]
    afcf[:-1, 1] = -np.asarray(jm.pres.c_k)[:-1, 0, 0]
    assert rel(tm.pres.tab[:, :2], afcf) <= 1e-15
    assert rel(tm.pres.tab[:, 2], np.asarray(jm.pres.dz2)[:, 0, 0]) <= 1e-15
    assert rel(tm.pres.winv, jm.pres_params["winv"]) <= TOL
    x = torch.tensor(spec)
    y = tm.pres.tdma_ri(x)
    assert y is x                             # in place on the spectrum
    assert torch.equal(y, tdma_plain(torch.tensor(spec), tm.pres.winv,
                                     tm.pres.tab))
    for mine, ref in ((y.real, xr), (y.imag, xi)):
        ref = np.asarray(ref)
        num = np.abs(mine.numpy() - ref).max(axis=0)
        den = np.abs(ref).max(axis=0)
        assert (num / den).max() <= TOL       # every mode, Nyquist included
    assert float(y.real[:, :, -1].abs().max()) > 0.


@pytest.mark.parametrize("case", ["jaen", "sull"])
def test_pres_exec_matches(case, request):
    jm, tm, s, _, t = request.getfixturevalue(case)
    subdt = 0.7
    tj, auxj = jm.pres.exec(jm.ctx, jx(s), jx(t), {}, subdt, jm.pres_params)
    tt = tx(t)
    aux = tm.pres.exec(tm.ctx, tx(s), tt, {}, subdt)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ("u", "v", "w"):
        assert rel(tt[n], tj[n]) <= 1e-10, n
    assert rel(aux["p"], np.asarray(auxj["p"])[ks:ke]) <= 1e-10
    # solve_ri (K5, K21, K6) and solve (K5, K3, K6) are one solve
    rhs = tm.pres.input(tm.ctx, tx(s), tx(t), 1. / subdt)
    assert rel(rhs, jm.pres.input(jm.ctx, jx(s), jx(t), 1. / subdt)) <= TOL
    assert rel(tm.pres.solve_ri(rhs), tm.pres.solve(rhs)) <= 1e-12
    # t + s/dt is divergence-free afterwards (below the top level, whose
    # random w carry at the lid the projection does not touch)
    div = tm.pres.input(tm.ctx, tx(s), tt, 1. / subdt)[:-1]
    assert float(div.abs().max()) <= 1e-12


# --------------------------------------------------------------------------
#  source and open boundaries
# --------------------------------------------------------------------------

def test_source_matches_and_emits_its_rate(jaen):
    jm, tm, s, sfc, t = jaen
    tj = jm.source(jm.ctx, jx(s), jx(t), {}, jx(sfc))
    tt = tx(t)
    tm.source(tm.ctx, tx(s), tt, {})
    for n in tt:
        assert rel(tt[n], tj[n]) <= TOL, n
    # nine swvmr sources of 1.85 kmol/s: the mass-weighted integral of the
    # co2 tendency is their sum (tests/test_source.py measures it so)
    g = tm.grid
    ks, ke = g.kstart, g.kend
    from microhh_torch import constants as cst
    w = (tm.fields.rhoref[ks:ke] / cst.xmair * g.dz[ks:ke])[:, None, None]
    rate = float(np.sum((tt["co2"] - T(t["co2"]))[ks:ke].numpy() * w)
                 * g.dx * g.dy)
    assert abs(rate - 9 * 1.85) <= 1e-9


def test_outflow_correct_matches(jaen):
    jm, tm, s, sfc, t = jaen
    assert tm.outflow.direction == jm.outflow.direction
    assert tm.outflow.direction["west"] == "inflow"
    for n, prof in jm.outflow.inflow_profiles.items():
        assert np.array_equal(tm.outflow.inflow_profiles[n], prof)
    _, et = _viscosities(jm, tm, s, sfc)
    # a non-trivial inflow profile on both sides
    prof = np.zeros(tm.grid.kcells)
    prof[tm.ctx.ks:tm.ctx.ke] = np.linspace(0.2, 0.6, KT)
    for m in (jm, tm):
        m.outflow.inflow_profiles["co2"] = prof
    try:
        tj = jm.outflow.correct(jm.ctx, jx(s), jx(t), {"evisc": jnp.array(et)},
                                tPr=jm.diff.tPr, sviscs=jm.diff.viscs)
        tt = tx(t)
        tm.outflow.correct(tm.ctx, tx(s), tt, {"evisc": et}, tPr=tm.diff.tPr,
                           sviscs=tm.diff.viscs)
    finally:
        for m in (jm, tm):
            m.outflow.inflow_profiles["co2"] = np.zeros(tm.grid.kcells)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in tt:
        assert rel(tt[n][ks:ke], np.asarray(tj[n])[ks:ke]) <= TOL, n
        if n != "co2":
            assert torch.equal(tt[n], T(t[n])), n
    # only the four edge columns of co2 change, and no ghost level
    d = (tt["co2"] - T(t["co2"])).abs()
    assert float(d[ks:ke, 1:-1, 1:-1].max()) == 0.
    assert float(d[ks:ke, :, 0].min()) > 0. and float(d[ks:ke, -1, :].min()) > 0.
    assert float(d[:ks].max()) == float(d[ke:].max()) == 0.


def test_outflow_takes_out_the_advec_2_flux_under_any_scheme(jaen):
    """ROADMAP Queue 3: the correction subtracts advec_2's wrapped face flux
    u 0.5 (a_w + a_0) (microhh_tpu/ops/boundary_outflow.py:119) although
    jaenschwalde's advection is 2i5 with a flux limiter on co2, whose
    wrapped flux differs.  The port follows the JAX package; this pins it:
    on the east outflow edge the correction is that flux minus u a_e, with
    the zero-gradient diffusion, whatever the scheme."""
    _, tm, s, _, t = jaen
    assert tm.advec.scheme == "2i5" and "co2" in tm.advec.fluxlimit_list
    st, ctx = tx(s), tm.ctx
    ks, ke = ctx.ks, ctx.ke
    tt = tx(t)
    tm.outflow.correct(ctx, st, tt, {}, tPr=tm.diff.tPr, sviscs={"co2": 0.})
    u0 = st["u"][ks:ke, :, 0]
    ae, ag = st["co2"][ks:ke, :, -1], st["co2"][ks:ke, :, 0]
    want = (u0 * 0.5 * (ae + ag) - u0 * ae) * ctx.dxi
    got = (tt["co2"] - T(t["co2"]))[ks:ke, 1:-1, -1]
    assert rel(got, want[:, 1:-1]) <= 1e-10


def test_state_across_carries_co2_and_the_inflow_profile(jaen, tmp_path):
    """A JAX-package state, co2 included, goes into the port as numpy
    arrays through as_device_state; the inflow profile comes from the same
    input group."""
    jm, tm, _, _, _ = jaen
    state = unfolded_state(tm, seed=2)
    js, _, _ = jm.as_device_state({k: v.copy() for k, v in state.items()})
    ts, _ = tm.as_device_state({k: np.array(v) for k, v in js.items()})
    assert set(ts) == set(js) == {"u", "v", "w", "thl", "qt", "co2"}
    for n in ts:
        assert np.array_equal(ts[n].numpy(), np.asarray(js[n])), n
    init = tm.input_nc.groups["init"].variables
    ks, ke = tm.ctx.ks, tm.ctx.ke
    assert np.array_equal(tm.outflow.inflow_profiles["co2"][ks:ke],
                          np.asarray(init["co2_inflow"][:]))


# --------------------------------------------------------------------------
#  whole steps
# --------------------------------------------------------------------------

DIRICHLET_TOP = (DRYCBL_INI % {"n": 16, "k": 16}).replace(
    "sbctop=neumann", "sbctop=dirichlet").replace("stop=0.003", "stop=303.6")


def drycbl_state(m, seed=5):
    st = m.fields.create(None, dtype=np.float64)
    g = m.grid
    ks, ke = g.kstart, g.kend
    st["th"][ks:ke] += (300. + 0.003 * g.z[ks:ke])[:, None, None]
    rng = np.random.RandomState(seed)
    for n in ("u", "v"):
        st[n][ks:ke] += 0.5 * rng.randn(g.ktot, g.jtot, g.itot)
    st["w"][ks + 1:ke] += 0.1 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    return st


def build_dirichlet(torch_, n, k, dtype, device):
    m = Model(Ini(DIRICHLET_TOP), "run", "drycblles", dtype=dtype,
              device=device)
    m.finish_setup()
    m.ini_text = DIRICHLET_TOP
    return m


@pytest.mark.parametrize("case", ["jaenschwalde", "sullivan2011",
                                  "drycblles_dirichlet_top"])
def test_two_rk3_steps_match_jax(case, tmp_path):
    build, state_of = {
        "jaenschwalde": (build_jaen, lambda m: unfolded_state(m, 3)),
        "sullivan2011": (build_sull, lambda m: unfolded_state(m, 3)),
        "drycblles_dirichlet_top": (build_dirichlet, drycbl_state)}[case]
    tm = torch_model(build, unfolded=True)
    jm = jax_model(tm, str(tmp_path))
    assert tm.unfolded
    if case == "jaenschwalde":
        assert not jm._use_rkfold_generic      # the JAX package unfolds too
    elif case == "sullivan2011":
        # the JAX package folds the RK update and the Coriolis term into
        # its clamped kernel, as the port does by default; here the port
        # is forced onto its unfolded substep on ghost-filled fields
        assert jm._use_rkfold and jm._fused.fold_ghosts
    else:
        assert not jm._fused.fold_ghosts
    state = state_of(tm)
    js, _, jsfc = jm.as_device_state({k: v.copy() for k, v in state.items()})
    ts, tsfc = tm.as_device_state(state)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for dt in (2.0, 3.0):
        jlim = jm._limits_fn(js, jsfc)
        tlim = tm.limits(ts, tsfc)
        assert set(tlim) == set(jlim)
        for k in jlim:
            assert rel(float(tlim[k]), float(jlim[k])) <= 1e-10, k
        js, jsfc, jaux = jm._step_fn(js, jsfc, jm.pres_params, jnp.float64(dt),
                                     jnp.float64(0.))
        before = {n: a.clone() for n, a in ts.items()}
        ts_new, tsfc, taux = tm.step(ts, tsfc, dt)
        for n in ts:     # the caller's state is not written to
            assert torch.equal(ts[n], before[n]), n
        ts = ts_new
        for n in ts:
            assert rel(ts[n][ks:ke], np.asarray(js[n])[ks:ke]) <= 1e-10, n
        pj = np.asarray(jaux["p"])
        pj = pj[ks:ke] if pj.shape[0] == tm.ctx.kcells else pj
        assert rel(taux["p"], pj) <= 1e-10
        for k in tsfc:
            assert rel(tsfc[k], jsfc[k]) <= 1e-10, k
        # the carry restarts from zero every step
        assert all(float(a.abs().max()) == 0. for a in tm.t.values())
    if case == "jaenschwalde":
        assert float(ts["qt"][ks:ke].min()) >= 0.
    jd = jm._diag_fn(js, jsfc)
    td = tm.diagnostics(ts, tsfc)
    for k in ("mom", "tke", "mass"):
        assert rel(float(td[k]), float(jd[k])) <= 1e-10, k
    assert float(td["div"]) <= 1e-10


def _two_steps(m, state):
    s, sfc = m.as_device_state({k: v.copy() for k, v in state.items()})
    for dt in (2.0, 3.0):
        s, sfc, aux = m.step(s, sfc, dt)
    return s, sfc, aux


@pytest.mark.parametrize("case", ["drycblles", "rico", "rico_2i5"])
def test_unfolded_step_matches_the_rk_folded_step(case):
    """The port's own proof that the two orders of the substep are one
    step: the same case with build_step(unfolded=True) and on its RK-folded
    path (for rico the column fold against the buffer and force ops, and the
    limiter's tendency form against its clamp)."""
    def build():
        if case == "drycblles":
            m = Model(Ini(DRYCBL_INI % {"n": 16, "k": 16}), "run",
                      "drycblles", dtype=torch.float64, device="cpu")
        else:
            swadvec = "2i5" if case == "rico_2i5" else "2"
            m = Model(Ini(rico_ini(16, 24, swadvec)), "run", "rico",
                      dtype=torch.float64, device="cpu",
                      input_nc=rico_input(24, 4000.))
        m.finish_setup()
        return m
    folded, unfolded = build(), build()
    folded.build_step()
    unfolded.build_step(unfolded=True)
    assert unfolded.unfolded and not folded.unfolded
    names = {k.name for k in unfolded.kernels()}
    assert "tdma_ri" in names and "tdma" not in names
    assert ("tendencies" if case == "drycblles" else "tend_uvw_acc") in names
    state = drycbl_state(folded) if case == "drycblles" else rico_state(folded, 3)
    a, asfc, aaux = _two_steps(folded, state)
    b, bsfc, baux = _two_steps(unfolded, state)
    ks, ke = folded.ctx.ks, folded.ctx.ke
    for n in a:
        assert rel(b[n][ks:ke], a[n][ks:ke]) <= 1e-10, n
    assert rel(baux["p"], aaux["p"]) <= 1e-10
    for k in asfc:
        assert rel(bsfc[k], asfc[k]) <= 1e-10, k
    if case != "drycblles":
        # the tendency form leaves s - dt (s / dt): zero to rounding
        for n in ("qt", "qr", "nr"):
            assert float(a[n][ks:ke].min()) >= 0., n
            assert (float(b[n][ks:ke].min())
                    >= -1e-15 * float(b[n][ks:ke].max())), n


def test_limiter_two_forms_agree_on_qt(jaen):
    """max(t, -s/dt) followed by the RK update is the clamp of s* with its
    carry correction (ops/limiter.py)."""
    _, tm, s, _, t = jaen
    ctx = tm.ctx
    ks, ke = ctx.ks, ctx.ke
    lim = Limiter(tm.ini, tm.fields)
    assert lim.limitlist == ["qt"]
    subdt, can = 0.9, -5. / 9.
    st = tx(s)
    tt = {"qt": 10. * T(t["qt"])}       # strong enough to cross zero
    tt["qt"][:ks], tt["qt"][ke:] = 0., 0.
    # tendency form, then s += dt t and t *= cA
    t1 = lim(ctx, st, tt, {}, subdt)["qt"]
    s1 = st["qt"] + subdt * t1
    c1 = can * t1
    # the RK fold first, then the clamp
    s2 = {"qt": st["qt"] + subdt * tt["qt"]}
    c2 = {"qt": can * tt["qt"]}
    assert float(s2["qt"][ks:ke].min()) < 0.
    lim.clamp(ctx, s2, c2, subdt, can)
    assert float(s1[ks:ke].min()) >= -1e-18
    assert float((s1 - s2["qt"])[ks:ke].abs().max()) <= 1e-15
    assert rel(c1[ks:ke], c2["qt"][ks:ke]) <= 1e-12


# --------------------------------------------------------------------------
#  what stays outside the slice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case,change,item", [
    ("jaenschwalde", ("scalar_outflow=co2",
                      "scalar_outflow=co2\nswtimedep_outflow=true"), 14),
    ("jaenschwalde", ("swsource=1", "swsource=1\nswtimedep_strength=true"), 9),
    ("jaenschwalde", ("swsource=1", "swsource=1\nswtimedep_location=true"), 9),
    ("sullivan2011", ("swlspres=geo", "swlspres=uflux\nuflux=1."), 9),
    ("sullivan2011", ("swls=0", "swls=0\nswnudge=1"), 9),
    ("sullivan2011", ("swls=0", "swls=0\nswtimedep_geo=true"), 9),
    ("sullivan2011", ("[fields]", "[fields]\nslist=s1"), 9),
])
def test_options_outside_the_slice_raise(case, change, item):
    over = {"swstats": 0} if case == "sullivan2011" else {}
    text = case_ini(case, itot=N[0], jtot=N[1], ktot=KT, **over)
    assert change[0] in text
    mem = (cases.jaenschwalde_input(KT) if case == "jaenschwalde"
           else cases.sullivan2011_input(KT))
    with pytest.raises(NotImplementedError, match="item %d" % item):
        m = Model(Ini(text.replace(*change)), "run", case,
                  dtype=torch.float64, device="cpu", input_nc=mem)
        m.finish_setup()
        m.build_step()


@pytest.mark.parametrize("case", ["jaenschwalde", "sullivan2011"])
def test_cli_init_run(case, tmp_path):
    """python -m microhh_torch init|run on the case's ini and the input its
    script writes (here from the in-memory profiles), stats off."""
    from microhh_torch.__main__ import main
    over = {"swstats": 0} if case == "sullivan2011" else {}
    text = case_ini(case, itot=N[0], jtot=N[1], ktot=KT, endtime=8,
                    savetime=8, **over)
    (tmp_path / ("%s.ini" % case)).write_text(text)
    mem = (cases.jaenschwalde_input(KT) if case == "jaenschwalde"
           else cases.sullivan2011_input(KT))
    write_input(str(tmp_path), case, mem)
    argv = [case, "--dir", str(tmp_path), "--device", "cpu", "--precision",
            "double"]
    main(["init"] + argv)
    main(["run"] + argv)
    assert (tmp_path / "u.0000008").exists()
    rows = [line.split() for line in open(tmp_path / ("%s.out" % case))
            if line.split()[0].isdigit()]
    assert rows and all(np.isfinite(float(x)) for r in rows for x in r)
    assert float(rows[-1][6]) <= 1e-10      # DIV
