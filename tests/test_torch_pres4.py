"""The port's 4th-order Poisson solver (ops/pres_4.py) against the JAX
package and the numpy oracle, in float64 on the CPU:

* the modified wavenumbers and the heptadiagonal bands vs
  ``oracle_ref/o4_ref.py`` ``pres4_bmat`` / ``pres4_bands``;
* the host tables (bands, LU factors, eigen tables), built by the port's own
  numpy copy, equal the JAX package's ``_mk_np``, ``_lu_np``, ``_eig_np``;
* ``input``, ``solve`` and ``exec`` vs the JAX package's on a uniform and a
  stretched grid, on the eigen path and on the substitution path
  (``MICROHH_EIGEN_POISSON=0``) (<= 1e-10);
* after ``exec`` the divergence of s + subdt t under conservation-type w
  ghosts is below 1e-10.

Inputs are made from a seed with numpy and copied to each side."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.utils import nc as jnc
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import pres_4 as P4
from microhh_torch.ops.boundary import w_cons
from microhh_torch.utils.nc import MemoryDataset
from oracle_ref import o4_ref as ref

INI = """
[grid]
itot=16
jtot=12
ktot=%d
xsize=2.
ysize=1.5
zsize=1.
swspatialorder=4

[thermo]
swthermo=0

[fields]
visc=1e-3
svisc=2e-3

[boundary]
mbcbot=noslip
mbctop=noslip

[time]
starttime=0
endtime=1.
savetime=1.
dt=0.01
"""


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def jx(d):
    return {k: jnp.array(v) for k, v in d.items()}


def tx(d):
    return {k: T(v) for k, v in d.items()}


def models(wd, ktot, stretched):
    text = INI % ktot
    mem = None
    if stretched:
        eta = -1. + 2. * (np.arange(ktot) + 0.5) / ktot
        z = 0.5 * (1. + np.tanh(1.5 * eta) / np.tanh(1.5))
        f = jnc.Dataset("%s/p4_input.nc" % wd, "w")
        f.createDimension("z", ktot)
        f.createVariable("z", "f8", ("z",))[:] = z
        f.close()
        mem = MemoryDataset({"z": z}, {})
    jm = JModel(JIni(text), "run", "p4", workdir=wd, dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(text), "run", "p4", workdir=wd, dtype=torch.float64,
               device="cpu", input_nc=mem)
    tm.finish_setup()
    assert type(tm.pres) is P4.Pres4
    return jm, tm


def fields(tm, seed):
    """Random velocities with conservation-type w ghosts, and carries whose
    ghost levels are zero, as in the step."""
    rng = np.random.default_rng(seed)
    shape = (tm.grid.kcells, tm.grid.jtot, tm.grid.itot)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    s = {n: rng.standard_normal(shape) for n in ("u", "v", "w")}
    s["w"][ks] = s["w"][ke] = 0.
    s["w"] = w_cons(tm.ctx, T(s["w"])).numpy()
    t = {n: np.zeros(shape) for n in s}
    for n in t:
        t[n][ks:ke] = rng.standard_normal((ke - ks,) + shape[1:])
    t["w"][ks] = 0.
    return s, t


@pytest.mark.parametrize("stretched", [False, True])
def test_bands_and_wavenumbers_match_the_oracle(tmp_path, stretched):
    _, tm = models(str(tmp_path), 12, stretched)
    g, p = tm.grid, tm.pres
    want = ref.pres4_bands(g.dzi4, g.dzhi4, g.ktot, g.kstart)
    assert np.array_equal(p._mk_np, want)
    assert np.array_equal(P4.hepta_bands(g), want)
    assert np.allclose(p._bmati_np, ref.pres4_bmat(g.itot, 1. / g.dx ** 2)[:g.itot // 2 + 1],
                       rtol=1e-14, atol=0.)
    assert np.allclose(p._bmatj_np, ref.pres4_bmat(g.jtot, 1. / g.dy ** 2),
                       rtol=1e-14, atol=0.)


@pytest.mark.parametrize("stretched", [False, True])
def test_host_tables_equal_the_jax_package(tmp_path, stretched):
    jm, tm = models(str(tmp_path), 12, stretched)
    jp, tp = jm.pres, tm.pres
    assert np.array_equal(tp._mk_np, jp._mk_np)
    assert np.array_equal(tp._bmati_np, jp._bmati_np)
    assert np.array_equal(tp._bmatj_np, jp._bmatj_np)
    assert tp._lu is None                     # built at first use only
    assert np.array_equal(tp.lu_factors(), jp._lu_np)
    assert tp._eig_ok and jp._eig_ok and tp.use_eigen()
    assert set(tp._eig_np) == set(jp._eig_np) == set(tp.eig)
    for k in jp._eig_np:
        assert np.array_equal(tp._eig_np[k], jp._eig_np[k]), k
        assert np.array_equal(tp.eig[k].numpy(), jp._eig_np[k]), k


@pytest.mark.parametrize("eigen", [True, False])
@pytest.mark.parametrize("stretched", [False, True])
def test_solve_matches_jax(tmp_path, monkeypatch, stretched, eigen):
    monkeypatch.setenv("MICROHH_EIGEN_POISSON", "1" if eigen else "0")
    monkeypatch.setenv("MICROHH_DFT_POISSON", "0")
    jm, tm = models(str(tmp_path), 12, stretched)
    assert tm.pres.use_eigen() == eigen and jm.pres._use_eigen() == eigen
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((12, 12, 16))
    want = np.asarray(jm.pres.solve(jm.ctx, jnp.array(rhs), None))
    got = tm.pres.solve(T(rhs))
    assert got.shape == rhs.shape and got.dtype == torch.float64
    assert rel(got, want) <= 1e-10
    # the two solve paths agree with each other
    monkeypatch.setenv("MICROHH_EIGEN_POISSON", "0" if eigen else "1")
    assert rel(tm.pres.solve(T(rhs)), want) <= 1e-10


@pytest.mark.parametrize("stretched", [False, True])
def test_input_and_exec_match_jax_and_project(tmp_path, stretched):
    jm, tm = models(str(tmp_path), 12, stretched)
    ctx = tm.ctx
    ks, ke = ctx.ks, ctx.ke
    s, t = fields(tm, 5)
    subdt = 0.013
    assert rel(tm.pres.input(ctx, tx(s), tx(t), 1. / subdt),
               jm.pres.input(jm.ctx, jx(s), jx(t), 1. / subdt)) <= 1e-12
    tt = tx(t)
    tm.pres.input(ctx, tx(s), tt, 1. / subdt)
    assert all(torch.equal(tt[n], T(t[n])) for n in t)   # input leaves t alone
    jt, jaux = jm.pres.exec(jm.ctx, jx(s), jx(t), {}, subdt, None)
    got, aux = tm.pres.exec(ctx, tx(s), tt, {}, subdt)
    for n in t:
        assert got[n] is tt[n]                           # updated in place
        assert rel(got[n], jt[n]) <= 1e-10, n
        assert float(got[n][:ks].abs().max()) == float(got[n][ke:].abs().max()) == 0.
    assert rel(aux["p"], jaux["p"]) <= 1e-10
    p = aux["p"]
    assert torch.equal(p[ks - 1], p[ks]) and torch.equal(p[ks - 2], p[ks + 1])
    assert torch.equal(p[ke], p[ke - 1]) and torch.equal(p[ke + 1], p[ke - 2])
    # the projected field is divergence free under conservation-type ghosts
    new = {n: T(s[n]) + subdt * got[n] for n in s}
    before = float(tm.pres.divergence_max(ctx, tx(s)))
    new["w"] = w_cons(ctx, new["w"])
    after = float(tm.pres.divergence_max(ctx, new))
    assert before > 1. and after <= 1e-10
    assert rel(after + 1., float(jm.pres.divergence_max(
        jm.ctx, {n: jnp.array(a.numpy()) for n, a in new.items()})) + 1.) <= 1e-12


def test_an_ill_conditioned_eigenbasis_takes_the_substitution_path(tmp_path):
    _, tm = models(str(tmp_path), 12, True)
    rng = np.random.default_rng(8)
    rhs = T(rng.standard_normal((12, 12, 16)))
    want = tm.pres.solve(rhs)
    tm.pres._eig_ok = False
    assert not tm.pres.use_eigen()
    assert rel(tm.pres.solve(rhs), want) <= 1e-10
