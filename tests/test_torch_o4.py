"""The port's 4th-order DNS slice (moser180, weakscaling: advec 4 / 4m, diff
4, the default boundary, thermo buoy or none, uflux forcing, sponge) against
the JAX package and the numpy oracle, in float64 on the CPU:

* ``fd4``, the 4th-order ghost fills and ``build_o4_tables`` vs the JAX
  package (the table bit for bit, the rest <= 1e-13), the fills also vs
  ``oracle_ref/o4_ref.py``;
* ``Advec4``, ``Advec4m``, ``Diff4`` (exec, cfl_max, dnmul) vs the JAX ops
  (<= 1e-12) on random fields with random ghosts at ktot 16 and 6, on a
  uniform and on a stretched grid, there also vs the oracle;
* the plain versions of K16 + K17 vs ``O4FusedPallas.exec`` in Pallas
  interpret mode with distinct w arrays for advection and diffusion
  (<= 1e-12);
* ``ThermoBuoy`` at 4th order, ``Force`` with uflux, ``DefaultBoundary`` vs
  the JAX ops (<= 1e-12);
* two RK3 steps of a 16^3 moser-like case and of a 16x8x32 weakscaling-like
  case, limits and diagnostics included, vs the JAX step with the fused
  producer in interpret mode (<= 1e-10); a bitwise restart chain; the CLI;
* the in-memory case inputs equal what the case scripts write; what still
  raises.

Inputs are made from a seed with numpy and copied to each side."""

import os
import re
import runpy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops import boundary as jbnd
from microhh_tpu.ops import fd4 as jfd4
from microhh_tpu.ops.o4_pallas import build_o4_tables as jbuild_o4_tables
from microhh_tpu.utils import nc as jnc
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import boundary as tbnd
from microhh_torch.ops import fd4 as tfd4
from microhh_torch.ops import o4_fused as O4
from microhh_torch.utils.nc import MemoryDataset
from oracle_ref import o4_ref as ref

TOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPS_INI = """
[grid]
itot=16
jtot=12
ktot=%(ktot)d
xsize=2.
ysize=1.5
zsize=%(zsize).17g
swspatialorder=4

[advec]
swadvec=%(swadvec)s
cflmax=1.

[diff]
swdiff=4

[thermo]
swthermo=buoy
%(thermo)s

[fields]
visc=1e-3
svisc=2e-3
slist=s1
svisc[s1]=3e-3

[boundary]
mbcbot=noslip
mbctop=noslip
sbcbot=flux
sbctop=neumann
sbot=0.005
stop=3.
sbcbot[s1]=dirichlet
sbctop[s1]=dirichlet
sbot[s1]=1.
stop[s1]=2.

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


def stretched_z(ktot, zsize=1.):
    """A tanh-stretched column, fine at both walls."""
    eta = -1. + 2. * (np.arange(ktot) + 0.5) / ktot
    return 0.5 * zsize * (1. + np.tanh(1.5 * eta) / np.tanh(1.5))


def write_input(wd, casename, z, profiles):
    f = jnc.Dataset(os.path.join(wd, "%s_input.nc" % casename), "w")
    f.createDimension("z", len(z))
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, prof in profiles.items():
        g.createVariable(name, "f8", ("z",))[:] = prof
    f.close()


def pair(wd, text, casename, z=None, profiles=None, fused=True):
    """The JAX model (with the fused o4 producer in interpret mode) and the
    port's model of one ini, on the same levels and profiles."""
    mem = None
    if z is not None:
        write_input(wd, casename, z, profiles or {})
        mem = MemoryDataset({"z": z}, {"init": dict(profiles or {})})
    jm = JModel(JIni(text), "run", casename, workdir=wd, dtype=np.float64)
    if fused:
        jm.force_fused = True
    jm.finish_setup()
    jm.build_step()
    tm = Model(Ini(text), "run", casename, workdir=wd, dtype=torch.float64,
               device="cpu", input_nc=mem)
    tm.finish_setup()
    tm.build_step()
    return jm, tm


def ops_pair(wd, ktot, swadvec, stretched, thermo="", fused=True):
    z = stretched_z(ktot) if stretched else None
    text = OPS_INI % {"ktot": ktot, "swadvec": swadvec, "zsize": 1.,
                      "thermo": thermo}
    return pair(wd, text, "o4", z, fused=fused)


def rand_state(m, seed):
    """Random fields, ghost levels included, and random carries."""
    rng = np.random.default_rng(seed)
    shape = (m.grid.kcells, m.grid.jtot, m.grid.itot)
    names = m.fields.prognostic_names
    s = {n: rng.standard_normal(shape) for n in names}
    t = {n: 0.1 * rng.standard_normal(shape) for n in names}
    return s, t


# --------------------------------------------------------------------------
#  stencils, ghost fills, tables
# --------------------------------------------------------------------------

def test_fd4_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((12, 6, 8))
    for name in ("ixh", "ixd", "jyh", "jyd"):
        assert rel(getattr(tfd4, name)(T(a)), getattr(jfd4, name)(jnp.array(a))) <= 1e-13, name
    ks, ke = 3, 9
    assert rel(tfd4.izh_mid(T(a), ks, ke), jfd4.izh_mid(jnp.array(a), ks, ke)) <= 1e-13
    assert rel(tfd4.izh_bot(T(a), ks), jfd4.izh_bot(jnp.array(a), ks)) <= 1e-13
    assert rel(tfd4.izh_top(T(a), ke), jfd4.izh_top(jnp.array(a), ke)) <= 1e-13
    col = rng.random(6) + 0.5
    assert rel(tfd4.izd(T(a[:9]), T(col)[:, None, None]),
               jfd4.izd(jnp.array(a[:9]), jnp.array(col)[:, None, None])) <= 1e-13


@pytest.mark.parametrize("bcbot,bctop", [
    ("dirichlet", "dirichlet"), ("neumann", "neumann"), ("flux", "neumann"),
    ("neumann", "flux"), ("dirichlet", "off")])
def test_ghost_fill_4th_matches_jax_and_oracle(tmp_path, bcbot, bctop):
    jm, tm = ops_pair(str(tmp_path), 8, "4", True, fused=False)
    rng = np.random.default_rng(4)
    a = rng.standard_normal((tm.grid.kcells, 12, 16))
    visc, offset = 0.21, 0.3
    bc = tbnd.BC(bcbot, 0.7, bctop, -0.4)
    want = np.asarray(jbnd.set_ghost_cells_field(jm.ctx, jnp.array(a), bc,
                                                 visc, offset))
    got = tbnd.set_ghost_cells_field_4th(tm.ctx, T(a), bc, visc, offset)
    assert rel(got, want) <= 1e-13
    ks, ke = tm.ctx.ks, tm.ctx.ke
    assert np.array_equal(got.numpy()[ks:ke], a[ks:ke])
    # the oracle takes the surface value or the gradient
    z = tm.grid.z
    orc = a
    if bcbot != "off":
        val = {"dirichlet": 0.7 - offset, "neumann": 0.7, "flux": -0.7 / visc}[bcbot]
        orc = ref.ghost4_bot(orc, z, "dirichlet" if bcbot == "dirichlet"
                             else "neumann", val, ks)
    if bctop != "off":
        val = {"dirichlet": -0.4 - offset, "neumann": -0.4, "flux": 0.4 / visc}[bctop]
        orc = ref.ghost4_top(orc, z, "dirichlet" if bctop == "dirichlet"
                             else "neumann", val, ke)
    assert rel(got, orc) <= 1e-13
    if bctop == "off":
        assert np.array_equal(got.numpy()[ke:], a[ke:])


@pytest.mark.parametrize("cons", [True, False])
def test_w_ghosts_4th_match_jax_and_oracle(tmp_path, cons):
    jm, tm = ops_pair(str(tmp_path), 8, "4", False, fused=False)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((tm.grid.kcells, 12, 16))
    want = np.asarray(jbnd.set_ghost_cells_w(jm.ctx, jnp.array(w),
                                             conservation=cons))
    got = tbnd.set_ghost_cells_w_4th(tm.ctx, T(w), conservation=cons).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref.ghost4_w(w, tm.ctx.ks, tm.ctx.ke, cons))
    if cons:
        src = T(w)
        assert np.array_equal(tbnd.w_cons(tm.ctx, src).numpy(), want)
        assert np.array_equal(src.numpy(), w)     # w_cons copies


def test_default_boundary_matches_jax(tmp_path):
    jm, tm = ops_pair(str(tmp_path), 8, "4m", True, fused=False)
    assert type(tm.boundary) is tbnd.DefaultBoundary
    s, _ = rand_state(tm, 6)
    want = jm.boundary.set_ghost_cells(jm.ctx, jx(s), {})
    st = tx(s)
    got = tm.boundary.set_ghost_cells(tm.ctx, st, {})
    assert got is st                                  # filled in place
    for n in s:
        assert rel(got[n], want[n]) <= 1e-13, n
        assert not np.array_equal(got[n].numpy(), s[n]), n
    assert tm.boundary.exec(tm.ctx, got, {}, {}) == {}
    assert tm.boundary.init_surface_state() == {}


@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("ktot", [16, 6])
def test_o4_tables_are_bitwise_the_jax_tables(tmp_path, ktot, stretched):
    jm, tm = ops_pair(str(tmp_path), ktot, "4", stretched, fused=False)
    ctx = tm.ctx
    got = O4.build_o4_tables(ctx.ks, ctx.ke, ctx.np_dzi4, ctx.np_dzhi4)
    want = jbuild_o4_tables(jm.ctx, np.float64)
    assert got.shape == (ktot + 3, O4.NC) and got.dtype == np.float64
    assert np.array_equal(got, want)
    assert np.array_equal(ctx.dzi4.numpy(), np.asarray(jm.ctx.dzi4))
    assert np.array_equal(ctx.dzhi4.numpy(), np.asarray(jm.ctx.dzhi4))


# --------------------------------------------------------------------------
#  the ops and the kernels' plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stretched", [False, True])
@pytest.mark.parametrize("swadvec", ["4", "4m"])
@pytest.mark.parametrize("ktot", [16, 6])
def test_advec_and_diff_match_jax(tmp_path, ktot, swadvec, stretched):
    jm, tm = ops_pair(str(tmp_path), ktot, swadvec, stretched, fused=False)
    assert tm.advec.scheme == swadvec
    s, t = rand_state(tm, ktot)
    for op in ("advec", "diff"):
        want = getattr(jm, op).exec(jm.ctx, jx(s), jx(t), {})
        tt = tx(t)
        got = getattr(tm, op).exec(tm.ctx, tx(s), tt, {})
        for n in t:
            assert got[n] is tt[n]                    # added in place
            assert rel(got[n], want[n]) <= TOL, (op, n)
            assert not np.array_equal(got[n].numpy(), t[n]), (op, n)
    assert rel(float(tm.advec.cfl_max(tm.ctx, tx(s))),
               float(jm.advec.cfl_max(jm.ctx, jx(s)))) <= TOL
    assert tm.diff.dnmul == jm.diff.dnmul
    assert float(tm.diff.get_dn(tm.ctx, None, {})) == float(jm.diff.get_dn(jm.ctx, None, {}))


@pytest.mark.parametrize("swadvec", ["4", "4m"])
def test_advec_and_diff_match_the_oracle_on_a_stretched_grid(tmp_path, swadvec):
    _, tm = ops_pair(str(tmp_path), 10, swadvec, True, fused=False)
    ctx, g = tm.ctx, tm.grid
    ks, ke = ctx.ks, ctx.ke
    s, _ = rand_state(tm, 21)
    u, v, w, a = s["u"], s["v"], s["w"], s["b"]
    m = "m" if swadvec == "4m" else ""
    cell = (g.dzi4, ctx.dxi, ctx.dyi, ks, ke)
    half = (g.dzhi4, ctx.dxi, ctx.dyi, ks, ke)
    tu, tv, tw = tm.advec.momentum(ctx, T(u), T(v), T(w))
    ts = tm.advec.scalar(ctx, T(a), T(u), T(v), T(w))
    for got, want, lo in (
            (tu, getattr(ref, "advec4%s_u" % m)(u, v, w, *cell), ks),
            (tv, getattr(ref, "advec4%s_v" % m)(u, v, w, *cell), ks),
            (tw, getattr(ref, "advec4%s_w" % m)(u, v, w, *half), ks + 1),
            (ts, getattr(ref, "advec4%s_s" % m)(a, u, v, w, *cell), ks)):
        assert rel(got, want[lo:ke]) <= TOL
    visc = tm.diff.visc
    du, dv, dw = tm.diff.momentum(ctx, T(u), T(v), T(w))
    metr = (ctx.dxi ** 2, ctx.dyi ** 2, g.dzi4, g.dzhi4, ks, ke)
    assert rel(du, ref.diff4_c(u, visc, *metr)[ks:ke]) <= TOL
    assert rel(dv, ref.diff4_c(v, visc, *metr)[ks:ke]) <= TOL
    assert rel(dw, ref.diff4_w(w, visc, *metr)[ks + 1:ke]) <= TOL
    assert rel(tm.diff.scalar(ctx, T(a), "s1"),
               ref.diff4_c(a, tm.diff.viscs["s1"], *metr)[ks:ke]) <= TOL


@pytest.mark.parametrize("swadvec", ["4", "4m"])
@pytest.mark.parametrize("ktot", [16, 6])
def test_k16_k17_plain_match_tpu_kernels(tmp_path, ktot, swadvec):
    """O4Fused.exec on the CPU against O4FusedPallas.exec in interpret mode
    on a stretched grid, with distinct w arrays under the two ghost types;
    the short column makes every ladder row a wall row."""
    jm, tm = ops_pair(str(tmp_path), ktot, swadvec, True)
    assert jm._o4_fused is not None and jm._o4_fused.scheme == swadvec
    assert tm.o4 is not None and tm.o4.scheme == swadvec
    assert [k.name for k in tm.kernels()] == ["o4_mom", "o4_scalars"]
    s, t = rand_state(tm, 100 + ktot)
    rng = np.random.default_rng(7)
    wc = rng.standard_normal(s["w"].shape)
    want = jm._o4_fused.exec(jm.ctx, jx(dict(s, w=wc)), jx(s), jx(t), {})
    tt = tx(t)
    got = tm.o4.exec(tm.ctx, tx(dict(s, w=wc)), tx(s), tt, {})
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in t:
        assert got[n] is tt[n]
        assert rel(got[n], want[n]) <= TOL, n
        # the ghost levels of the carry stay as they were
        assert np.array_equal(got[n].numpy()[:ks], t[n][:ks]), n
        assert np.array_equal(got[n].numpy()[ke:], t[n][ke:]), n
    # both w arrays matter
    other = tm.o4.exec(tm.ctx, tx(s), tx(s), tx(t), {})
    assert rel(other["w"], want["w"]) > 1e-6
    # the wrappers are the two ops, one after the other
    t2 = tx(t)
    tm.advec.exec(tm.ctx, tx(dict(s, w=wc)), t2, {})
    tm.diff.exec(tm.ctx, tx(s), t2, {})
    for n in t:
        assert rel(got[n], t2[n]) <= 1e-14, n


def test_o4_wrapper_contract(tmp_path):
    _, tm = ops_pair(str(tmp_path), 6, "4", False, fused=False)
    assert O4.max_scalars(torch.float32) == 4
    assert O4.max_scalars(torch.float64) == 4
    assert tm.o4.cc.shape == (9, O4.NC) and tm.o4.cc.dtype == torch.float64
    assert tm.o4.cz.shape == (6, O4.NZ) and tm.o4.cz.dtype == torch.float64
    assert tm.o4.k_mom.launches == tm.o4.k_scal.launches == 0
    with pytest.raises(TypeError):
        O4.O4Fused(tm.advec, object(), tm.ctx)
    meta = {n: torch.zeros(2, device="meta") for n in ("u", "v", "w")}
    with pytest.raises(TypeError, match="no kernel for device"):
        tm.o4.exec(tm.ctx, meta, meta, meta, {})


@pytest.mark.parametrize("thermo", ["", "alpha=0.05\nN2=0.3"])
def test_thermo_buoy_4th_matches_jax(tmp_path, thermo):
    jm, tm = ops_pair(str(tmp_path), 8, "4", True, thermo=thermo, fused=False)
    s, t = rand_state(tm, 9)
    want = jm.thermo.exec(jm.ctx, jx(s), jx(t), {})
    got = tm.thermo.exec(tm.ctx, tx(s), tx(t), {})
    for n in t:
        assert rel(got[n], want[n]) <= TOL, n
    changed = {n for n in t if not np.array_equal(got[n].numpy(), t[n])}
    assert changed == ({"u", "w", "b"} if thermo else {"w"})


def test_force_uflux_matches_jax_and_fixes_the_mean(tmp_path):
    text = (OPS_INI % {"ktot": 8, "swadvec": "4m", "zsize": 1., "thermo": ""}
            ).replace("[fields]", "[force]\nswlspres=uflux\nuflux=0.0282\n\n[fields]")
    jm, tm = pair(str(tmp_path), text, "o4", stretched_z(8), fused=False)
    s, t = rand_state(tm, 10)
    subdt = 0.013
    want = jm.force(jm.ctx, jx(s), jx(t), {"subdt": subdt})
    tt = tx(t)
    got = tm.force(tm.ctx, tx(s), tt, {"subdt": subdt})
    for n in t:
        assert rel(got[n], want[n]) <= TOL, n
    assert torch.equal(tt["u"], T(t["u"]))            # a new tensor
    ctx = tm.ctx
    ks, ke = ctx.ks, ctx.ke
    dzc = ctx.dz[ks:ke][:, None, None]
    mean = float(torch.sum((T(s["u"]) + subdt * got["u"])[ks:ke] * dzc)
                 / (ctx.itot * ctx.jtot * ctx.zsize))
    assert abs(mean - 0.0282) <= 1e-13


# --------------------------------------------------------------------------
#  the slice as a whole
# --------------------------------------------------------------------------

def case_ini(case, casename, **over):
    text = open(os.path.join(ROOT, "cases", case, "%s.ini" % casename)).read()
    for key, val in over.items():
        assert re.search(r"(?m)^%s=" % key, text), key
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    return text


def moser_like(wd, n=16):
    """cases/moser180/moser180.ini at n^3 with stats and budget off: 4m,
    uflux, the scalar s, no-slip walls, tanh z, vortex pairs."""
    text = case_ini("moser180", "moser180", itot=n, jtot=n, ktot=n,
                    swstats=0, swbudget=0)
    mem = cases.moser180_input(n, 2.)
    z = np.asarray(mem.variables["z"][:])
    prof = {k: np.asarray(v[:]) for k, v in mem.groups["init"].variables.items()}
    return text, z, prof


def weakscaling_like(wd):
    """cases/weakscaling/weakscaling.ini at 16x8x32 on the case's stretching
    scaled to 32 levels: advec 4, buoy, sponge, flux bottom BC."""
    mem, zsize = cases.weakscaling_input(32)
    text = case_ini("weakscaling", "weakscaling", itot=16, jtot=8, ktot=32,
                    zsize="%.17g" % zsize)
    z = np.asarray(mem.variables["z"][:])
    return text, z, {"b": np.asarray(mem.groups["init"].variables["b"][:])}


def seeded_state(m, seed, amp):
    st = m.fields.create(m.input_nc, dtype=np.float64)
    g = m.grid
    ks, ke = g.kstart, g.kend
    rng = np.random.RandomState(seed)
    for n in ("u", "v"):
        st[n][ks:ke] += amp * rng.randn(g.ktot, g.jtot, g.itot)
    st["w"][ks + 1:ke] += 0.3 * amp * rng.randn(g.ktot - 1, g.jtot, g.itot)
    return st


def two_steps_match(jm, tm, state, dts):
    ks, ke = tm.ctx.ks, tm.ctx.ke
    js, _, jsfc = jm.as_device_state({k: v.copy() for k, v in state.items()})
    ts, tsfc = tm.as_device_state(state)
    assert tsfc == {} and jsfc == {}
    for dt in dts:
        jlim = jm._limits_fn(js, jsfc)
        tlim = tm.limits(ts, tsfc)
        assert set(tlim) == set(jlim) == {"cfl_rate", "dn_rate"}
        for k in jlim:
            assert rel(float(tlim[k]), float(jlim[k])) <= 1e-12, k
        js, jsfc, jaux = jm._step_raw(js, jsfc, jm.pres_params, dt, 0.)
        held = dict(ts)
        ts, tsfc, taux = tm.step(ts, tsfc, dt)
        for n in ts:
            assert ts[n] is held[n]                   # updated in place
            assert rel(ts[n][ks:ke], np.asarray(js[n])[ks:ke]) <= 1e-10, n
        assert rel(taux["p"], jaux["p"]) <= 1e-10
        assert taux["subdt"] == jaux["subdt"]
        assert all(float(a.abs().max()) == 0. for a in tm.t.values())
    jd = jm._diag_fn(js, jsfc)
    td = tm.diagnostics(ts, tsfc)
    for k in ("mom", "tke", "mass"):
        assert rel(float(td[k]), float(jd[k])) <= 1e-12, k
    scale = float(ts["u"].abs().max()) * tm.ctx.dxi
    assert abs(float(td["div"]) - float(jd["div"])) <= 1e-10 * scale
    assert float(td["div"]) <= 1e-10 * scale
    return ts


def test_two_rk3_steps_moser_like_match_jax(tmp_path):
    text, z, prof = moser_like(str(tmp_path))
    jm, tm = pair(str(tmp_path), text, "moser180", z, prof)
    assert jm._o4_fused is not None and jm._o4_fused.scheme == "4m"
    assert tm.o4.scheme == "4m" and tm.ctx.scalar_names == ("s",)
    assert tm.force.swlspres == "uflux" and tm.buffer is None
    state = seeded_state(tm, 3, 0.01)
    assert np.abs(state["v"]).max() > 0.                # vortexaxis=x
    ts = two_steps_match(jm, tm, state, (0.5, 0.25))
    # uflux holds the mean of u
    ctx = tm.ctx
    dzc = ctx.dz[ctx.ks:ctx.ke][:, None, None]
    mean = float(torch.sum(ts["u"][ctx.ks:ctx.ke] * dzc)
                 / (ctx.itot * ctx.jtot * ctx.zsize))
    assert abs(mean - 0.0282) <= 1e-12


def test_two_rk3_steps_weakscaling_like_match_jax(tmp_path):
    text, z, prof = weakscaling_like(str(tmp_path))
    jm, tm = pair(str(tmp_path), text, "weakscaling", z, prof)
    assert jm._o4_fused is not None and jm._o4_fused.scheme == "4"
    assert tm.o4.scheme == "4" and tm.ctx.scalar_names == ("b",)
    assert tm.buffer is not None
    assert float(np.abs(tm.buffer.fac_z).max()) > 0.    # the sponge is active
    two_steps_match(jm, tm, seeded_state(tm, 4, 0.02), (0.002, 0.001))


def test_vortex_pairs_about_x_match_jax(tmp_path):
    text, z, prof = moser_like(str(tmp_path), 8)
    jm, tm = pair(str(tmp_path), text, "moser180", z, prof, fused=False)
    assert tm.fields.vortexaxis == "x" and tm.fields.vortexnpair == 2
    a = jm.fields.create(jm.input_nc, dtype=np.float64)
    b = tm.fields.create(tm.input_nc, dtype=np.float64)
    assert set(a) == set(b) == {"u", "v", "w", "s"}
    for n in a:
        assert np.array_equal(a[n], b[n]), n
    noise = text.replace("vortexnpair=2", "vortexnpair=0")
    m0 = Model(Ini(noise), "run", "moser180", dtype=torch.float64,
               device="cpu", input_nc=cases.moser180_input(8, 2.))
    c = m0.fields.create(m0.input_nc, dtype=np.float64)
    assert np.abs(b["v"] - c["v"]).max() > 1e-3         # the pairs are there
    assert np.array_equal(b["u"], c["u"])


RESTART = dict(endtime=0.004, savetime=0.002, dt=0.001, adaptivestep="false",
               iotimeprec=-3)


def test_run_loop_restart_chain_is_bitwise(tmp_path):
    """Init, 4 steps in one run, and the same as 2 + a restart + 2: the
    restart files of the two chains are identical."""
    mem, zsize = cases.weakscaling_input(32)

    def model(sub, mode, starttime=0):
        text = case_ini("weakscaling", "weakscaling", itot=16, jtot=8, ktot=32,
                        zsize="%.17g" % zsize, starttime=starttime, **RESTART)
        m = Model(Ini(text), mode, "weakscaling", workdir=str(tmp_path / sub),
                  dtype=torch.float64, device="cpu", input_nc=mem)
        m.finish_setup()
        return m

    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        init = model(sub, "init")
        init.save_initial_state(seeded_state(init, 5, 0.02))
    a = model("a", "run")
    s_a = a.run()
    model("b", "run").run(max_iters=2)
    b2 = model("b", "run", starttime=0.002)
    s_b = b2.run()
    assert a.timeloop.iteration == b2.timeloop.iteration == 4
    ks, ke = a.ctx.ks, a.ctx.ke
    for n in s_a:
        assert torch.equal(s_a[n][ks:ke], s_b[n][ks:ke]), n
    names = sorted(f for f in os.listdir(tmp_path / "a") if f.endswith("0000004"))
    assert names == ["b.0000004", "time.0000004", "u.0000004", "v.0000004",
                     "w.0000004"]
    for f in names:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes(), f
    rows = [line.split() for line in open(tmp_path / "a" / "weakscaling.out")
            if line.split()[0].isdigit()]
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(float(x)) for r in rows for x in r)
    assert max(float(r[6]) for r in rows[1:]) <= 1e-10   # DIV


def test_cli_init_run_moser180(tmp_path):
    """python -m microhh_torch init|run on a copy of cases/moser180 with
    stats and budget off, reduced to 16^3 and four steps."""
    from microhh_torch.__main__ import main
    text = case_ini("moser180", "moser180", itot=16, jtot=16, ktot=16,
                    swstats=0, swbudget=0, endtime=80., savetime=40.,
                    outputiter=1)
    (tmp_path / "moser180.ini").write_text(text)
    mem = cases.moser180_input(16, 2.)
    write_input(str(tmp_path), "moser180", np.asarray(mem.variables["z"][:]),
                {k: np.asarray(v[:]) for k, v in
                 mem.groups["init"].variables.items()})
    argv = ["moser180", "--dir", str(tmp_path), "--device", "cpu",
            "--precision", "double"]
    main(["init"] + argv)
    assert (tmp_path / "s.0000000").exists()
    main(["run"] + argv)
    assert (tmp_path / "s.0000080").exists()
    rows = [line.split() for line in open(tmp_path / "moser180.out")
            if line.split()[0].isdigit()]
    assert len(rows) >= 4 and all(np.isfinite(float(x)) for r in rows for x in r)
    assert max(float(r[6]) for r in rows[1:]) <= 1e-12   # DIV
    # the verbatim ini, with its stats and its budget on, builds too
    from microhh_torch.stats import Stats
    for key in ("swstats", "swbudget"):
        verbatim = case_ini("moser180", "moser180", itot=16, jtot=16, ktot=16,
                            **{k: 0 for k in ("swstats", "swbudget") if k != key})
        m = Model(Ini(verbatim), "run", "moser180", workdir=str(tmp_path),
                  dtype=torch.float64, device="cpu", input_nc=mem)
        if key == "swstats":
            st = Stats(m)
            assert "u_2" in st.vars and not st.budget.sw
            st.close()


@pytest.mark.parametrize("case", ["moser180", "weakscaling"])
def test_case_inputs_equal_the_case_scripts(tmp_path, monkeypatch, case):
    text = open(os.path.join(ROOT, "cases", case, "%s.ini" % case)).read()
    (tmp_path / ("%s.ini" % case)).write_text(text)
    monkeypatch.chdir(tmp_path)
    runpy.run_path(os.path.join(ROOT, "cases", case, "%s_input.py" % case))
    f = jnc.Dataset(str(tmp_path / ("%s_input.nc" % case)), "r")
    if case == "moser180":
        mem = cases.moser180_input(128, 2.)
    else:
        mem, zsize = cases.weakscaling_input()
        ini_zsize = float(re.search(r"(?m)^zsize=(.*)$", text).group(1))
        assert abs(zsize - ini_zsize) <= 1e-14       # the ini's own height
    assert np.array_equal(np.asarray(f.variables["z"][:]),
                          np.asarray(mem.variables["z"][:]))
    init = f.groups["init"]
    assert set(init.variables) == set(mem.groups["init"].variables)
    for name in init.variables:
        assert np.array_equal(np.asarray(init.variables[name][:]),
                              np.asarray(mem.groups["init"].variables[name][:])), name


@pytest.mark.parametrize("change,item", [
    (("[time]", "[IB]\nsw_immersed_boundary=1\n\n[time]"), 14),
    (("[diff]\nswdiff=4", "[diff]\nswdiff=4\n\n[pres]\nswpres=0"), 11),
    (("swdiff=4", "swdiff=smag2"), 11),                   # mixed orders
    (("swadvec=4", "swadvec=2i5"), 11),
    (("swthermo=buoy", "swthermo=dry"), 11),
    (("[time]", "[radiation]\nswradiation=gcss\n\n[time]"), 13),
    (("mbcbot=noslip", "swboundary=surface\nmbcbot=noslip"), 11),
    (("[time]", "[buffer]\nswupdate=1\n\n[time]"), 9),
])
def test_fourth_order_options_outside_the_slice_raise(change, item):
    text = OPS_INI % {"ktot": 8, "swadvec": "4", "zsize": 1., "thermo": ""}
    assert change[0] in text
    with pytest.raises(NotImplementedError, match="item %d" % item):
        m = Model(Ini(text.replace(*change)), "run", "o4",
                  dtype=torch.float64, device="cpu",
                  input_nc=MemoryDataset({}, {"init": {
                      "u_geo": np.zeros(8), "v_geo": np.zeros(8)}}))
        m.finish_setup()
        m.build_step()
