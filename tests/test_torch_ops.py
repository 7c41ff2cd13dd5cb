"""The PyTorch port's plain-torch ops against microhh_tpu's jnp op path and
the numpy oracles of tests/oracle_ref: stencils, ghost fills, MOST,
advec_2, smag2, dry thermo and the buffer, in float64 on the CPU.  The same
numpy inputs go to both packages.  Relative error is max|a - b| / max|b|,
held to 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops import most as jmost
from microhh_tpu.ops import stencil as jstencil
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import most as tmost
from microhh_torch.ops import stencil as tstencil

from oracle_ref import diff_smag2_ref as smag_ref
from oracle_ref import most_ref
from oracle_ref.interp import pad_xy

TOL = 1e-12

INI = """
[grid]
itot=16
jtot=12
ktot=10
xsize=3200.
ysize=2400.
zsize=1200.
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

[boundary]
mbcbot=noslip
mbctop=freeslip
sbcbot=flux
sbctop=neumann
sbot=0.1
stop=0.003
swboundary=surface
z0m=0.1
z0h=0.01

[fields]
visc=1.e-5
svisc=2.e-5

[buffer]
swbuffer=1
zstart=800.
sigma=0.00223
beta=2.

[time]
endtime=3600
savetime=3600
dt=6.
starttime=0
"""


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(a):
    # a copy: the port's kernels update some inputs in place, and JAX may
    # read a numpy array's memory after the call that was given it returns
    return torch.tensor(np.asarray(a, dtype=np.float64))


def N(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture(scope="module")
def models():
    jm = JModel(JIni(INI), "run", "ops", dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(INI), "run", "ops", dtype=torch.float64, device="cpu")
    tm.finish_setup()
    # a non-trivial density profile, so the anelastic weights are exercised
    kc = jm.grid.kcells
    z = np.linspace(-0.5, float(kc), kc)
    rho, rhoh = np.exp(-0.03 * z), np.exp(-0.03 * (z - 0.4))
    jm.ctx.rhoref, jm.ctx.rhorefh = jnp.asarray(rho), jnp.asarray(rhoh)
    tm.ctx.rhoref, tm.ctx.rhorefh = T(rho), T(rhoh)
    return jm, tm


def inputs(m, seed):
    g = m.grid
    rng = np.random.RandomState(seed)
    s = {n: rng.randn(g.kcells, g.jtot, g.itot) for n in ("u", "v", "w")}
    s["u"] += 2.
    s["th"] = 300. + 0.5 * rng.randn(g.kcells, g.jtot, g.itot)
    s["w"][g.kstart] = s["w"][g.kend] = 0.
    sfc = m.boundary.init_surface_state()
    shape = (g.jtot, g.itot)
    sfc["obuk"][:] = np.where(rng.rand(*shape) > 0.5, -30., 80.)
    for name in ("dudz_mo", "dvdz_mo", "u_fluxbot", "v_fluxbot", "th_gradbot"):
        sfc[name] = 0.1 * rng.randn(*shape)
    sfc["dbdz_mo"] = 1e-4 * rng.rand(*shape)
    sfc["th_fluxbot"] = 0.1 + 0.05 * rng.randn(*shape)
    return s, sfc


def both(s, sfc):
    return (({k: jnp.array(v) for k, v in s.items()},
             {k: jnp.array(v) for k, v in sfc.items()}),
            ({k: T(v) for k, v in s.items()}, {k: T(v) for k, v in sfc.items()}))


@pytest.mark.parametrize("name", ["im", "ip", "jm", "jp"])
def test_stencil_shifts(name):
    a = np.random.RandomState(0).randn(3, 5, 7)
    for n in (1, 2):
        ref = np.asarray(getattr(jstencil, name)(jnp.asarray(a), n))
        assert np.array_equal(N(getattr(tstencil, name)(T(a), n)), ref)
    assert np.array_equal(N(tstencil.i2(T(a), T(2 * a))),
                          np.asarray(jstencil.i2(jnp.asarray(a), jnp.asarray(2 * a))))


def test_ghost_fills(models):
    jm, tm = models
    s, sfc = inputs(jm, 1)
    (sj, sfcj), (st, sfct) = both(s, sfc)
    a = jm.boundary.set_ghost_cells(jm.ctx, sj, sfcj)
    b = tm.boundary.set_ghost_cells(tm.ctx, st, sfct)
    for n in ("u", "v", "w", "th"):
        assert rel(N(b[n]), a[n]) <= TOL, n


def test_most_functions_vs_oracle():
    L = np.concatenate([-np.logspace(-2, 8, 200), np.logspace(-2, 8, 200)])
    zeta = np.concatenate([-np.logspace(-4, 2, 100), np.logspace(-4, 2, 100)])
    zsl, z0m, z0h = 12.5, 0.1, 0.01
    assert rel(N(tmost.fm(zsl, z0m, T(L))), most_ref.fm(zsl, z0m, L)) <= TOL
    assert rel(N(tmost.fh(zsl, z0h, T(L))), most_ref.fh(zsl, z0h, L)) <= TOL
    assert rel(N(tmost.phim(T(zeta))), most_ref.phim(zeta)) <= TOL
    assert rel(N(tmost.phih(T(zeta))), most_ref.phih(zeta)) <= TOL
    assert rel(N(tmost.fm(zsl, z0m, T(L))),
               np.asarray(jmost.fm(zsl, z0m, jnp.asarray(L)))) <= TOL


def test_most_lut_matches_and_roundtrips():
    """The z/L table equals the JAX package's, and looking up Ri computed
    from the table inverts it (as tests/test_drycblles.py checks the JAX
    lookup)."""
    z0m, z0h, zsl = 0.1, 0.1, 25.
    a = jmost.prepare_lut(z0m, z0h, zsl, True, True)
    zL_sl, f_sl = tmost.prepare_lut(z0m, z0h, zsl, True, True)
    assert np.array_equal(a[0], zL_sl) and np.array_equal(a[1], f_sl)
    zL = np.array([-100., -5., -0.5, -0.01, 0.01, 0.5])
    Ri = np.interp(zL, zL_sl.astype(np.float64), f_sl.astype(np.float64))
    got = N(tmost.lookup_zL(torch.as_tensor(zL_sl), torch.as_tensor(f_sl),
                            T(Ri)))
    ref = np.asarray(jmost.lookup_zL(jnp.asarray(a[0]), jnp.asarray(a[1]),
                                     jnp.asarray(Ri)))
    assert np.array_equal(got, ref)
    assert np.allclose(got, zL, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("use_lut", [False, True])
def test_most_surface_exec(models, use_lut, monkeypatch):
    jm, tm = models
    monkeypatch.setattr(jm.boundary, "use_lut", use_lut)
    monkeypatch.setattr(tm.boundary, "use_lut", use_lut)
    s, sfc = inputs(jm, 2)
    (sj, sfcj), (st, sfct) = both(s, sfc)
    a = jm.boundary.exec(jm.ctx, sj, sfcj, {})
    b = tm.boundary.exec(tm.ctx, st, sfct, {})
    assert sorted(a) == sorted(b)
    for k in a:
        assert rel(N(b[k]), a[k]) <= TOL, k

    # downstream of obuk/ustar, against the reference transliteration
    g, ks, gc = tm.grid, tm.grid.kstart, 2
    zsl = float(g.z[ks])
    args = (gc, gc + g.itot, gc, gc + g.jtot)

    def pad2(x):
        return np.pad(np.asarray(x, np.float64), gc, mode="wrap")

    out = {k: N(v) for k, v in b.items()}
    u0, v0 = pad2(s["u"][ks]), pad2(s["v"][ks])
    ubot, vbot = pad2(sfc["u_bot"]), pad2(sfc["v_bot"])
    obuk, ustar = out["obuk"], out["ustar"]
    ufb, vfb, ugb, vgb = most_ref.surfm_dirichlet(
        u0, v0, ubot, vbot, pad2(ustar), pad2(obuk), tm.boundary.z0m, zsl, *args)
    for key, ref in (("u_fluxbot", ufb), ("v_fluxbot", vfb),
                     ("u_gradbot", ugb), ("v_gradbot", vgb)):
        assert rel(out[key], ref) <= TOL, key
    tb, grd = most_ref.surfs_flux(s["th"][ks], sfc["th_fluxbot"], ustar, obuk,
                                  tm.boundary.z0h, zsl)
    assert rel(out["th_bot"], tb) <= TOL
    assert rel(out["th_gradbot"], grd) <= TOL
    dudz, dvdz = most_ref.calc_duvdz_mo(u0, v0, ubot, vbot, pad2(ustar),
                                        pad2(obuk), tm.boundary.z0m, zsl, *args)
    assert rel(out["dudz_mo"], dudz) <= TOL
    assert rel(out["dvdz_mo"], dvdz) <= TOL


def test_advec2(models):
    jm, tm = models
    s, _ = inputs(jm, 3)
    (sj, _), (st, _) = both(s, {})
    zeros = {n: np.zeros_like(v) for n, v in s.items()}
    (tj, _), (tt, _) = both(zeros, {})
    a = jm.advec.exec(jm.ctx, sj, tj, {})
    b = tm.advec.exec(tm.ctx, st, tt, {})
    for n in ("u", "v", "w", "th"):
        assert rel(N(b[n]), a[n]) <= TOL, n
    assert rel(N(tm.advec.cfl_max(tm.ctx, st)),
               jm.advec.cfl_max(jm.ctx, sj)) <= TOL


def test_smag2_vs_jax(models):
    jm, tm = models
    s, sfc = inputs(jm, 4)
    (sj, sfcj), (st, sfct) = both(s, sfc)
    sj = jm.boundary.set_ghost_cells(jm.ctx, sj, sfcj)
    st = tm.boundary.set_ghost_cells(tm.ctx, st, sfct)
    assert rel(N(tm.diff.calc_strain2(tm.ctx, st, sfct)),
               jm.diff.calc_strain2(jm.ctx, sj, sfcj)) <= TOL
    auxj = jm.diff.exec_viscosity(jm.ctx, sj, sfcj, {})
    auxt = tm.diff.exec_viscosity(tm.ctx, st, sfct, {})
    assert rel(N(auxt["evisc"]), auxj["evisc"]) <= TOL
    zeros = {n: np.zeros(s["u"].shape) for n in s}
    (tj, _), (tt, _) = both(zeros, {})
    a = jm.diff.exec(jm.ctx, sj, tj, auxj, sfcj)
    b = tm.diff.exec(tm.ctx, st, tt, auxt, sfct)
    for n in ("u", "v", "w", "th"):
        assert rel(N(b[n]), a[n]) <= TOL, n
    assert rel(N(tm.diff.get_dn(tm.ctx, st, auxt)),
               jm.diff.get_dn(jm.ctx, sj, auxj)) <= TOL


def test_smag2_vs_oracle(models):
    """Strain^2, evisc and the diffusion stencils against the literal
    transliteration of diff_smag2.cxx (as tests/test_oracle_diff_smag2.py
    holds the JAX op path)."""
    _, tm = models
    g = tm.grid
    ks, ke, gc = g.kstart, g.kend, 3
    i0, i1, j0, j1 = gc, gc + g.itot, gc, gc + g.jtot
    s, sfc = inputs(tm, 5)
    n2 = np.random.RandomState(6).rand(g.ktot, g.jtot, g.itot) * 1e-4

    class FakeThermo:
        scalars = ("th",)

        def get_n2(self, ctx, s):
            return T(n2)

    diff = tm.diff
    saved = diff.thermo
    diff.thermo = FakeThermo()
    try:
        (_, _), (st, sfct) = both(s, sfc)
        mine_s2 = N(diff.calc_strain2(tm.ctx, st, sfct))
        aux = diff.exec_viscosity(tm.ctx, st, sfct, {})
    finally:
        diff.thermo = saved
    u, v, w = (pad_xy(s[n], gc) for n in ("u", "v", "w"))
    dzi, dzhi = N(tm.ctx.dzi), N(tm.ctx.dzhi)
    s2 = np.zeros_like(u)
    smag_ref.calc_strain2(s2, u, v, w, pad_xy(sfc["dudz_mo"][None], gc)[0],
                          pad_xy(sfc["dvdz_mo"][None], gc)[0], N(tm.ctx.z),
                          dzi, dzhi, g.dxi, g.dyi, i0, i1, j0, j1, ks, ke, True)
    assert rel(mine_s2, s2[ks:ke, j0:j1, i0:i1]) <= TOL
    ev = s2.copy()
    n2p = np.zeros_like(ev)
    n2p[ks:ke, j0:j1, i0:i1] = n2
    smag_ref.calc_evisc(ev, n2p, pad_xy(sfc["dbdz_mo"][None], gc)[0],
                        N(tm.ctx.z), g.dz, diff.z0m, g.dx, g.dy, diff.cs,
                        diff.tPr, i0, i1, j0, j1, ks, ke, True)
    mine_ev = N(aux["evisc"])
    assert rel(mine_ev[ks:ke], ev[ks:ke, j0:j1, i0:i1]) <= TOL

    t = {n: torch.zeros(s["u"].shape, dtype=torch.float64) for n in s}
    t = {k: N(a) for k, a in diff.exec(tm.ctx, st, t, aux, sfct).items()}
    evp = pad_xy(mine_ev, gc)
    rho, rhoh = N(tm.ctx.rhoref), N(tm.ctx.rhorefh)
    zero2d = np.zeros((g.jtot + 2 * gc, g.itot + 2 * gc))
    fb = {k: pad_xy(sfc[k][None], gc)[0]
          for k in ("u_fluxbot", "v_fluxbot", "th_fluxbot")}
    ut, vt, wt, tht = (np.zeros_like(u) for _ in range(4))
    smag_ref.diff_u(ut, u, v, w, dzi, dzhi, g.dxi, g.dyi, evp, fb["u_fluxbot"],
                    zero2d, rho, rhoh, diff.visc, i0, i1, j0, j1, ks, ke, True)
    smag_ref.diff_v(vt, u, v, w, dzi, dzhi, g.dxi, g.dyi, evp, fb["v_fluxbot"],
                    zero2d, rho, rhoh, diff.visc, i0, i1, j0, j1, ks, ke, True)
    smag_ref.diff_w(wt, u, v, w, dzi, dzhi, g.dxi, g.dyi, evp, rho, rhoh,
                    diff.visc, i0, i1, j0, j1, ks, ke)
    smag_ref.diff_c(tht, pad_xy(s["th"], gc), dzi, dzhi, g.dxi ** 2,
                    g.dyi ** 2, evp, fb["th_fluxbot"], zero2d, rho, rhoh,
                    diff.tPr, diff.viscs["th"], i0, i1, j0, j1, ks, ke, True)
    for name, orac in (("u", ut), ("v", vt), ("th", tht)):
        assert rel(t[name][ks:ke], orac[ks:ke, j0:j1, i0:i1]) <= TOL, name
    assert rel(t["w"][ks + 1:ke], wt[ks + 1:ke, j0:j1, i0:i1]) <= TOL


@pytest.mark.parametrize("basestate", ["boussinesq", "anelastic"])
def test_thermo_dry(basestate):
    class Var:
        def __init__(self, a):
            self.a = a

        def __getitem__(self, k):
            return self.a[k]

    class FakeNC:
        def __init__(self, th):
            self.groups = {"init": self}
            self.variables = {"th": Var(th)}

    ini = INI.replace("swbasestate=boussinesq", "swbasestate=%s" % basestate)
    jm = JModel(JIni(ini), "run", "thermo", dtype=np.float64)
    tm = Model(Ini(ini), "run", "thermo", dtype=torch.float64, device="cpu")
    jm.input_nc = tm.input_nc = FakeNC(
        300. + 0.003 * jm.grid.z[jm.grid.kstart:jm.grid.kend])
    jm.finish_setup()
    tm.finish_setup()
    for name in ("thref", "threfh", "pref", "prefh", "exnref", "exnrefh"):
        assert rel(getattr(tm.thermo, name), getattr(jm.thermo, name)) <= TOL
    assert rel(tm.fields.rhoref, jm.fields.rhoref) <= TOL
    assert rel(tm.fields.rhorefh, jm.fields.rhorefh) <= TOL
    s, sfc = inputs(jm, 7)
    (sj, sfcj), (st, sfct) = both(s, sfc)
    zeros = {n: np.zeros(s["u"].shape) for n in s}
    (tj, _), (tt, _) = both(zeros, {})
    assert rel(N(tm.thermo.exec(tm.ctx, st, tt, {})["w"]),
               jm.thermo.exec(jm.ctx, sj, tj, {})["w"]) <= TOL
    assert rel(N(tm.thermo.get_n2(tm.ctx, st)), jm.thermo.get_n2(jm.ctx, sj)) <= TOL
    assert rel(N(tm.thermo.get_buoyancy_fluxbot(tm.ctx, st, sfct)),
               jm.thermo.get_buoyancy_fluxbot(jm.ctx, sj, sfcj)) <= TOL


def test_buffer(models):
    jm, tm = models
    s, _ = inputs(jm, 8)
    (sj, _), (st, _) = both(s, {})
    zeros = {n: np.zeros(s["u"].shape) for n in s}
    (tj, _), (tt, _) = both(zeros, {})
    a = jm.buffer(jm.ctx, sj, tj, {})
    b = tm.buffer(tm.ctx, st, tt, {})
    for n in ("u", "v", "w", "th"):
        assert rel(N(b[n]), a[n]) <= TOL, n
    assert np.abs(N(b["w"])).max() > 0.


@pytest.mark.parametrize("change", [
    ("swadvec=2", "swadvec=4"),
    ("[time]", "[decay]\nswdecay[th]=exponential\n\n[time]"),
    ("swthermo=dry", "swthermo=vapor"),
    ("swboundary=surface", "swboundary=surface_bulk"),
    ("[time]", "[IB]\nsw_immersed_boundary=1\n\n[time]"),
    ("[time]", "[micro]\nswmicro=2mom_warm\n\n[time]"),
    ("[time]", "[stats]\nswstats=1\nswtendency=1\n\n[time]"),
    ("swspatialorder=2", "swspatialorder=4"),
])
def test_options_outside_the_slice_raise(change):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(Ini(INI.replace(*change)), "run", "x", dtype=torch.float64,
              device="cpu")
