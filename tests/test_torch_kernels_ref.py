"""The plain-torch versions of the port's hand-written kernels against the
TPU kernels they replace, run in Pallas interpret mode on the CPU as
tests/test_rkfold.py and tests/test_pallas_fused.py run them, in float64:

* K1 evisc      vs FusedLES2(..., interpret=True, fold_ghosts=True).evisc
* K2 tend_rk    vs fused_tendencies_rk (wall patches included), carry x first
* K4 pres glue  vs PresGlue(ctx, True).rhs / .apply
* K7 limits     vs FusedLES2(...).limits_pass
  (all <= 1e-12 relative to the field maximum)
* K3 Thomas     through Pres2.solve vs the JAX fft + eigen path at 16^3 and
  vs the radix Pallas DFT + _tdma_pl path at 384x384x8 (<= 1e-10: the
  Thomas and eigen solves round differently)
* K5/K6 DFT     vs dft2_fwd / dft2_inv at 384^2 (radix 3) and 512^2
  (radix 4), their permuted modes mapped to the natural order (<= 1e-12)

On a CPU tensor each wrapper runs its plain version; the CUDA kernels are
held to these on the card by chip_smoke.py.  The wrapper contract (checks,
device dispatch) is tested here too."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops.pallas_fused import (FusedLES2, PresGlue as JPresGlue,
                                          fused_exec_viscosity,
                                          fused_tendencies_rk)
from microhh_torch import kernels
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops.fused import exec_viscosity, tendencies_rk

TOL = 1e-12
INI = graft._DRYCBL_INI % {"itot": 16, "jtot": 12, "ktot": 8}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def crel(a, b):
    """rel for complex arrays."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(a):
    # a copy: the port's kernels update some inputs in place, and JAX may
    # read a numpy array's memory after the call that was given it returns
    return torch.tensor(np.asarray(a, dtype=np.float64))


@pytest.fixture(scope="module")
def setup():
    jm = JModel(JIni(INI), "run", "k", dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(INI), "run", "k", dtype=torch.float64, device="cpu")
    tm.finish_setup()
    tm.build_step()
    fused = FusedLES2(jm.ctx, jm.diff, jm.thermo, True, interpret=True,
                      buffer=jm.buffer, fold_ghosts=True, top_grad_th=0.003)
    g = jm.grid
    rng = np.random.RandomState(21)
    s = {n: rng.randn(g.kcells, g.jtot, g.itot) for n in ("u", "v", "w")}
    s["th"] = 300. + 0.003 * g.z[:, None, None] + 0.3 * rng.randn(
        g.kcells, g.jtot, g.itot)
    s["w"][g.kstart] = s["w"][g.kend] = 0.
    sfc = jm.boundary.init_surface_state()
    for name in ("dudz_mo", "dvdz_mo", "u_fluxbot", "v_fluxbot"):
        sfc[name] = 0.1 * rng.randn(g.jtot, g.itot)
    sfc["dbdz_mo"] = 1e-4 * rng.rand(g.jtot, g.itot)
    t = {n: np.pad(0.1 * rng.randn(g.ktot, g.jtot, g.itot),
                   ((g.kstart, g.kcells - g.kend), (0, 0), (0, 0)))
         for n in s}
    return jm, tm, fused, s, sfc, t


def jax_in(d):
    return {k: jnp.array(v) for k, v in d.items()}


def torch_in(d):
    return {k: T(v) for k, v in d.items()}


def test_k1_evisc_matches_tpu_kernel(setup):
    jm, tm, fused, s, sfc, _ = setup
    sj, st = jax_in(s), torch_in(s)
    a = fused.evisc(sj["u"], sj["v"], sj["w"], sj["th"])
    b = tm.fused.evisc(st["u"], st["v"], st["w"], st["th"])
    assert rel(b, a) <= TOL
    # with the MOST bottom-row patch
    a = fused_exec_viscosity(fused, jm.ctx, sj, jax_in(sfc), {})["evisc_int"]
    b = exec_viscosity(tm.fused, tm.ctx, st, torch_in(sfc), {})["evisc_int"]
    assert rel(b, a) <= TOL


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("first", [False, True])
def test_k2_tendencies_rk_match_tpu_kernel(setup, carry, first):
    jm, tm, fused, s, sfc, t = setup
    sj, st, sfcj, sfct = jax_in(s), torch_in(s), jax_in(sfc), torch_in(sfc)
    cbdt, can = 0.7, (-5. / 9. if carry else 0.)
    auxj = fused_exec_viscosity(fused, jm.ctx, sj, sfcj, {})
    auxt = exec_viscosity(tm.fused, tm.ctx, st, sfct, {})
    s_j, t_j, rhs = fused_tendencies_rk(fused, jm.ctx, sj, jax_in(t), auxj,
                                        sfcj, cbdt, can, first=first)
    assert rhs is None
    t_t = torch_in(t)
    s_t = tendencies_rk(tm.fused, tm.ctx, st, t_t, auxt, sfct, cbdt, can,
                        first)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ("u", "v", "th"):
        assert rel(s_t[n][ks:ke], np.asarray(s_j[n])[ks:ke]) <= TOL, n
    assert rel(s_t["w"][ks:ke + 1], np.asarray(s_j["w"])[ks:ke + 1]) <= TOL
    assert float(s_t["w"][ke].abs().max()) == 0.
    for n in ("u", "v", "w", "th"):
        if carry:
            assert rel(t_t[n][ks:ke], np.asarray(t_j[n])[ks:ke]) <= TOL, n
        else:   # the last substep leaves the carry as it was
            assert torch.equal(t_t[n], T(t[n])), n


@pytest.mark.parametrize("carry", [True, False])
def test_k4_pres_glue_matches_tpu_kernels(setup, carry):
    jm, tm, _, s, _, t = setup
    glue = JPresGlue(jm.ctx, True)
    sj, st = jax_in(s), torch_in(s)
    a = glue.rhs(sj["u"], sj["v"], sj["w"], 1. / 0.7)
    b = tm.glue.rhs(st["u"], st["v"], st["w"], 1. / 0.7)
    assert rel(b, a) <= TOL
    p = np.random.RandomState(3).randn(tm.ctx.ktot, tm.ctx.jtot, tm.ctx.itot)
    can = -153. / 128. if carry else 0.
    t_t = torch_in(t)
    s_j, t_j = glue.apply(jnp.array(p), sj, jax_in(t), 0.7, can, carry)
    tm.glue.apply(T(p), st, t_t, 0.7, can, carry)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ("u", "v", "w"):
        assert rel(st[n][ks:ke], np.asarray(s_j[n])[ks:ke]) <= TOL, n
        if carry:
            assert rel(t_t[n][ks:ke], np.asarray(t_j[n])[ks:ke]) <= TOL, n


def test_k7_limits_match_tpu_kernel(setup):
    jm, tm, fused, s, _, _ = setup
    sj, st = jax_in(s), torch_in(s)
    cfl_j, ev_j = fused.limits_pass(sj["u"], sj["v"], sj["w"], sj["th"])
    cfl_t, ev_t = tm.fused.limits(st["u"], st["v"], st["w"], st["th"])
    assert cfl_t.shape == ev_t.shape == (tm.ctx.ktot,)
    assert rel(cfl_t, cfl_j) <= TOL
    assert rel(ev_t, ev_j) <= TOL


@pytest.mark.parametrize("n", [384, 512,
                               pytest.param((768, 384), id="768x384"),
                               pytest.param((384, 768), id="384x768"),
                               pytest.param((1024, 512), id="1024x512")])
def test_k5_k6_dft_match_tpu_kernels(n):
    """The port's DFT pair (natural rfft2 order) against the radix Pallas
    DFT kernels, whose mode p of each axis is true mode perm[p]; square and
    rectangular (itot, jtot) planes, radix 3 on either axis."""
    from microhh_tpu.ops import pallas_dft as D
    from microhh_torch.fields import Fields
    from microhh_torch.grid import Grid
    from microhh_torch.ops.pres_2 import Pres2

    itot, jtot = n if isinstance(n, tuple) else (n, n)
    text = ("[grid]\nitot=%d\njtot=%d\nktot=2\nxsize=1.\nysize=1.\n"
            "zsize=1.\nswspatialorder=2\n[fields]\nvisc=1e-5\n" % (itot, jtot))
    g = Grid(Ini(text))
    pres = Pres2(Ini(text), g, Fields(Ini(text), g))
    x = np.random.RandomState(itot + jtot).randn(2, jtot, itot)
    pp = {k: jnp.asarray(v) for k, v in
          D.build_pallas_dft_tables(itot, jtot, np.float64).items()}
    prec = jax.lax.Precision.HIGHEST
    yr, yi = D.dft2_fwd(jnp.asarray(x), pp, prec, interpret=True)
    yj = np.asarray(yr) + 1j * np.asarray(yi)
    pj, px = D.pallas_mode_perm_j(jtot), D.pallas_mode_perm_x(itot)
    yt = pres.rfft2(T(x)).numpy()
    # the full spectrum of a real field from its half: Y[j, f] for f >
    # itot/2 is conj(Y[-j, itot-f])
    full = np.concatenate(
        [yt, np.conj(yt[:, (-np.arange(jtot)) % jtot,
                        1:itot - itot // 2][..., ::-1])], axis=-1)
    assert full.shape == (2, jtot, itot)
    ref = full[:, pj][:, :, px]
    assert crel(yj, ref) <= TOL
    back = D.dft2_inv(yr, yi, pp, prec, itot, interpret=True)
    yt2 = pres.rfft2(T(x))
    assert rel(pres.irfft2(yt2, itot), back) <= TOL
    assert rel(back, x) <= TOL


def test_k3_thomas_solve_matches_fft_eigen_path():
    ini = graft._DRYCBL_INI % {"itot": 16, "jtot": 16, "ktot": 16}
    jm = JModel(JIni(ini), "run", "p", dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(ini), "run", "p", dtype=torch.float64, device="cpu")
    tm.finish_setup()
    rhs = np.random.RandomState(4).randn(16, 16, 16)
    a = jm.pres.solve(jm.ctx, jnp.asarray(rhs), jm.pres.device_params())
    assert jm.pres.solve_path == "fft"
    b = tm.pres.solve(T(rhs))
    assert rel(b, a) <= 1e-10


def test_k3_thomas_solve_matches_tpu_tdma_kernel(monkeypatch):
    """At 384x384 the JAX package's radix Pallas DFT engages and its Thomas
    kernel _tdma_pl solves the (permuted) modes; the port's natural-order
    Thomas solve must give the same pressure."""
    from microhh_tpu.fields import Fields as JFields
    from microhh_tpu.grid import Grid as JGrid
    from microhh_tpu.ops.pres_2 import Pres2 as JPres2
    from microhh_torch.fields import Fields
    from microhh_torch.grid import Grid
    from microhh_torch.model import Context
    from microhh_torch.ops.pres_2 import Pres2

    text = """
[grid]
itot=384
jtot=384
ktot=8
xsize=6.28
ysize=3.14
zsize=2.
swspatialorder=2
[fields]
visc=1e-5
[time]
endtime=1
savetime=1
dt=0.1
"""
    monkeypatch.setenv("MICROHH_DFT_POISSON", "1")
    monkeypatch.setenv("MICROHH_DFT_PALLAS", "1")
    calls = []
    orig = JPres2._tdma_pl

    def counted(self, *a):
        calls.append(1)
        return orig(self, *a)

    monkeypatch.setattr(JPres2, "_tdma_pl", counted)
    out = []
    for ini_cls, grid_cls, fields_cls in ((JIni, JGrid, JFields),
                                          (Ini, Grid, Fields)):
        g = grid_cls(ini_cls(text))
        dz = g.zsize / g.ktot
        g.set_z(np.linspace(0.5 * dz, g.zsize - 0.5 * dz, g.ktot))
        out.append((g, fields_cls(ini_cls(text), g)))
    (jg, jf), (tg, tf) = out
    jp2 = JPres2(JIni(text), jg, jf, dtype=np.float64)
    jp2.set_values()
    tp2 = Pres2(Ini(text), tg, tf)
    tp2.set_values(Context(tg, tf, torch.float64, "cpu"))
    rhs = np.random.RandomState(3).randn(8, 384, 384)

    class Ctx:
        pass

    a = jp2.solve(Ctx(), jnp.asarray(rhs), jp2.device_params())
    assert calls, "the Pallas Thomas kernel did not run"
    assert rel(tp2.solve(T(rhs)), a) <= 1e-10


def test_wrapper_contract():
    a = torch.zeros(2, 3, dtype=torch.float64)
    assert kernels.on_cpu(a)
    with pytest.raises(TypeError):
        kernels.on_cpu(torch.zeros(2, device="meta"))
    kernels.check([a], torch.float64, a.device, [(2, 3)])
    with pytest.raises(TypeError):
        kernels.check([a], torch.float32, a.device)
    with pytest.raises(TypeError):
        kernels.check([a.to(torch.float16)], torch.float16, a.device)
    with pytest.raises(ValueError):
        kernels.check([a.t()], torch.float64, a.device)
    with pytest.raises(ValueError):
        kernels.check([a], torch.float64, a.device, [(3, 2)])
    with pytest.raises(KeyError):
        kernels.Kernel("no_such_kernel", "", "")
    # K15 is counted under its own name through K10's entry
    with pytest.raises(KeyError):
        kernels.Kernel("tend_scalar_rk", "", "")
    k15 = kernels.Kernel("tend_scalar_rk", "", "", entry="tend_scalars")
    assert (k15.name, k15.entry, k15.launches) == ("tend_scalar_rk",
                                                   "tend_scalars", 0)
    assert set(kernels.SIGNATURES) == {"evisc", "tend_rk", "tdma",
                                       "pres_rhs", "pres_apply", "dft_fwd",
                                       "dft_inv", "limits", "tend_uvw",
                                       "tend_scalars", "micro2",
                                       "advec_mom", "advec_scalars",
                                       "evisc_n2", "o4_mom", "o4_scalars",
                                       "tend_uvw_acc", "tend_scalar_acc",
                                       "tendencies", "tdma_ri",
                                       "tend_rk_fold", "dft_fwd_split",
                                       "dft_inv_split"}
    assert kernels.library_path().startswith(kernels.BUILD_DIR)
