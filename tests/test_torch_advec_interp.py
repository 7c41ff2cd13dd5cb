"""The port's interpolated advection (2i4 / 2i5 / 2i53 / 2i62) against the JAX
package, in float64 on the CPU:

* ``build_interp_tables``: the port's numpy copy bitwise equal to the JAX
  package's, four schemes, stretched grid, non-uniform density, kt = 16 and
  the small-kt guards kt = 6, 4, 3;
* ``AdvecInterp.exec``, ``cfl_max`` and the Koren-limited scalar vs the JAX op
  path (<= 1e-12), 2i5 also against the reference transliteration
  tests/oracle_ref/advec_interp_ref.py;
* the plain versions of K12/K13 vs ``AdvecInterpPallas(interpret=True)``
  (<= 1e-12), one scalar in ``fluxlimit_list`` included;
* the plain versions of K8/K9 and K10 with advection off vs the JAX kernels
  with ``no_advec = True`` (<= 1e-12);
* two RK3 steps of a 16^2 x 24 rico case with ``swadvec=2i5``, limits and
  diagnostics included, vs the JAX model (<= 1e-10);
* the table follows a change of the base state's density;
* ``python -m microhh_torch`` runs ``cases/rico/rico.ini`` as written, with
  stats off.

Inputs are made from a seed with numpy and copied to each side."""

import os
import re
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import rico_state
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops import pallas_fused as JF
from microhh_tpu.ops.advec_interp_pallas import (AdvecInterpPallas,
                                                 build_interp_tables as j_tables)
from microhh_tpu.utils import nc as jnc
from microhh_torch.cases import rico_input, rico_profiles
from microhh_torch.config import Ini
from microhh_torch.model import Context, Model
from microhh_torch.ops import fused as F
from microhh_torch.ops.advec_interp import CLASSES, SCHEMES
from microhh_torch.ops.advec_interp_fused import (AdvecInterpFused,
                                                  build_interp_tables)
from oracle_ref import advec_interp_ref as ref
from oracle_ref.interp import pad_xy

TOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZSIZE = 4000.

ADV_INI = """
[grid]
itot=12
jtot=10
ktot=%(ktot)d
xsize=2.7
ysize=1.9
zsize=3.1
swspatialorder=2

[advec]
swadvec=%(swadvec)s
cflmax=1.
%(extra)s

[diff]
swdiff=0

[pres]
swpres=0

[fields]
visc=0.
slist=s1,s2

[boundary]
mbcbot=noslip
mbctop=freeslip
sbcbot=neumann
sbctop=neumann
sbot=0.
stop=0.

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


class Ctx(Context):
    """The part of the port's Context the advection reads, filled from the
    JAX package's."""

    def __init__(self, jctx):
        self.dtype = torch.float64
        self.device = torch.device("cpu")
        for name in ("ks", "ke", "itot", "jtot", "ktot", "kcells"):
            setattr(self, name, int(getattr(jctx, name)))
        self.dxi, self.dyi = float(jctx.dxi), float(jctx.dyi)
        self.dzi, self.dzhi = T(jctx.dzi), T(jctx.dzhi)
        self.np_dzi = np.array(jctx.dzi, dtype=np.float64)
        self.np_dzhi = np.array(jctx.dzhi, dtype=np.float64)
        self.scalar_names = tuple(jctx.scalar_names)
        self.basestate_version = 0
        self.refresh_basestate(types.SimpleNamespace(
            rhoref=np.array(jctx.rhoref), rhorefh=np.array(jctx.rhorefh)))


def build(scheme, ktot=16, extra=""):
    """A JAX model of the scheme on a stretched grid with a non-uniform
    density, and the port's scheme instance with a context of equal values."""
    text = ADV_INI % {"swadvec": scheme, "ktot": ktot, "extra": extra}
    jm = JModel(JIni(text), "run", "adv", dtype=np.float64)
    jm.finish_setup()
    jc = jm.ctx
    zfull = np.linspace(-0.5, float(jc.kcells), jc.kcells)
    stretch = 1. + 0.3 * np.sin(0.7 * zfull)
    for name, fac in (("rhoref", np.exp(-0.03 * zfull)),
                      ("rhorefh", np.exp(-0.03 * (zfull - 0.4))),
                      ("dzi", np.asarray(jc.dzi) * stretch),
                      ("dzhi", np.asarray(jc.dzhi) / stretch)):
        setattr(jc, name, jnp.array(fac))
        setattr(jc, "np_" + name, np.array(fac))
    advec = CLASSES[scheme](Ini(text), None)
    return jm, advec, Ctx(jc)


def rand_state(jm, seed):
    g = jm.grid
    rng = np.random.RandomState(seed)
    shape = (g.kcells, g.jtot, g.itot)
    s = {n: rng.randn(*shape) for n in jm.fields.prognostic_names}
    s["w"][g.kstart] = 0.
    s["w"][g.kend] = 0.
    t = {n: 0.1 * rng.randn(*shape) for n in s}
    return s, t


@pytest.mark.parametrize("scheme", SCHEMES)
def test_build_interp_tables_bitwise(scheme):
    for ktot in (16, 6, 4, 3):
        jm, _, ctx = build(scheme, ktot)
        a = j_tables(scheme, jm.ctx, np.float64)
        b = build_interp_tables(scheme, ctx.ks, ctx.ke, ctx.np_rhoref,
                                ctx.np_rhorefh, ctx.np_dzi, ctx.np_dzhi)
        assert a.shape == b.shape == (ktot + 1, 27)
        assert np.array_equal(a, b), (scheme, ktot)
    with pytest.raises(ValueError):
        build_interp_tables("2i7", ctx.ks, ctx.ke, ctx.np_rhoref,
                            ctx.np_rhorefh, ctx.np_dzi, ctx.np_dzhi)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("ktot", [16, 6])
def test_op_path_matches_jax(scheme, ktot):
    jm, advec, ctx = build(scheme, ktot)
    s, t = rand_state(jm, seed=ktot + len(scheme))
    a = jm.advec.exec(jm.ctx, jx(s), jx(t), {})
    b = advec.exec(ctx, tx(s), tx(t), {})
    for n in t:
        assert rel(b[n], a[n]) <= TOL, n
        assert np.abs(np.asarray(a[n]) - t[n]).max() > 0.1, n
    assert rel(advec.cfl_max(ctx, tx(s)), jm.advec.cfl_max(jm.ctx, jx(s))) <= TOL


def test_koren_limited_scalar_matches_jax_and_oracle():
    jm, advec, ctx = build("2i5", 16, extra="fluxlimit_list=s1")
    assert advec.fluxlimit_list == jm.advec.fluxlimit_list == ["s1"]
    s, t = rand_state(jm, seed=1234)
    # the limiter is branchy: keep the values away from exact ties
    s["s1"] = s["s1"] + 0.01 * np.arange(ctx.itot)[None, None, :]
    a = jm.advec.exec(jm.ctx, jx(s), jx(t), {})
    b = advec.exec(ctx, tx(s), tx(t), {})
    for n in t:
        assert rel(b[n], a[n]) <= TOL, n
    g, GC = jm.grid, 3
    i0, i1, j0, j1 = GC, GC + g.itot, GC, GC + g.jtot
    u, v, w, s1 = (pad_xy(s[n], GC) for n in ("u", "v", "w", "s1"))
    st = np.zeros_like(s1)
    ref.advec_s_lim(st, s1, u, v, w, ctx.np_dzi, g.dx, g.dy, ctx.np_rhoref,
                    ctx.np_rhorefh, i0, i1, j0, j1, ctx.ks, ctx.ke)
    mine = (b["s1"] - T(t["s1"]))[ctx.ks:ctx.ke]
    assert rel(mine, st[ctx.ks:ctx.ke, j0:j1, i0:i1]) <= 1e-11


@pytest.mark.parametrize("ktot", [8, 16])
def test_2i5_matches_reference_transliteration(ktot):
    jm, advec, ctx = build("2i5", ktot)
    s, _ = rand_state(jm, seed=ktot)
    zero = {n: torch.zeros_like(T(a)) for n, a in s.items()}
    mine = advec.exec(ctx, tx(s), zero, {})
    g, GC = jm.grid, 3
    ks, ke = ctx.ks, ctx.ke
    i0, i1, j0, j1 = GC, GC + g.itot, GC, GC + g.jtot
    u, v, w, s1 = (pad_xy(s[n], GC) for n in ("u", "v", "w", "s1"))
    args = (ctx.np_dzi, g.dx, g.dy, ctx.np_rhoref, ctx.np_rhorefh, i0, i1,
            j0, j1, ks, ke)
    t = {n: np.zeros_like(u) for n in ("u", "v", "w", "s1")}
    ref.advec_cell("2i5", t["u"], u, u, v, w, *args, da=(-1, 0, 0))
    ref.advec_cell("2i5", t["v"], v, u, v, w, *args, da=(0, -1, 0))
    ref.advec_cell("2i5", t["s1"], s1, u, v, w, *args, da=None)
    ref.advec_w("2i5", t["w"], u, v, w, ctx.np_dzhi, g.dx, g.dy,
                ctx.np_rhoref, ctx.np_rhorefh, i0, i1, j0, j1, ks, ke)
    for n in ("u", "v", "s1"):
        assert rel(mine[n][ks:ke], t[n][ks:ke, j0:j1, i0:i1]) <= 1e-11, n
    assert rel(mine["w"][ks + 1:ke], t["w"][ks + 1:ke, j0:j1, i0:i1]) <= 1e-11
    assert float(mine["w"][ks].abs().max()) == float(mine["w"][ke].abs().max()) == 0.


@pytest.mark.parametrize("scheme,ktot,extra", [
    ("2i4", 16, ""), ("2i5", 16, ""), ("2i53", 16, ""), ("2i62", 16, ""),
    ("2i4", 6, ""), ("2i5", 6, ""), ("2i53", 6, ""), ("2i62", 6, ""),
    ("2i5", 4, ""), ("2i5", 3, ""), ("2i53", 3, ""),
    ("2i5", 16, "fluxlimit_list=s2"),
])
def test_k12_k13_plain_match_tpu_kernels(scheme, ktot, extra):
    jm, advec, ctx = build(scheme, ktot, extra)
    s, t = rand_state(jm, seed=3 * ktot + len(scheme))
    ap = AdvecInterpPallas(jm.advec, jm.ctx, np.float64, interpret=True)
    a = ap.exec(jm.ctx, jx(s), jx(t), {})
    fz = AdvecInterpFused(advec, ctx)
    assert np.array_equal(fz.table().numpy(), np.asarray(ap.cc))
    b = fz.exec(ctx, tx(s), tx(t), {})
    for n in t:
        assert rel(b[n], a[n]) <= TOL, n
        assert torch.equal(b[n][:ctx.ks], T(t[n])[:ctx.ks]), n
        assert torch.equal(b[n][ctx.ke:], T(t[n])[ctx.ke:]), n
    # and the op path the kernels replace
    c = advec.exec(ctx, tx(s), tx(t), {})
    for n in t:
        assert rel(b[n], c[n]) <= TOL, n


def test_table_follows_the_base_state():
    """The weights bake the density in: after refresh_basestate K12's plain
    version gives the op path's answer for the new density."""
    jm, advec, ctx = build("2i5", 8)
    s, t = rand_state(jm, seed=11)
    fz = AdvecInterpFused(advec, ctx)
    before = fz.table().clone()
    ctx.refresh_basestate(types.SimpleNamespace(
        rhoref=1.5 * ctx.np_rhoref ** 2, rhorefh=0.5 + ctx.np_rhorefh))
    assert not torch.equal(fz.table(), before)
    assert fz.table() is fz.table()
    b = fz.exec(ctx, tx(s), tx(t), {})
    c = advec.exec(ctx, tx(s), tx(t), {})
    for n in t:
        assert rel(b[n], c[n]) <= TOL, n


# --------------------------------------------------------------------------
#  the rico case as its ini is written (swadvec=2i5)
# --------------------------------------------------------------------------

KT = 24


def rico_2i5_ini(n=16, k=KT):
    text = open(os.path.join(ROOT, "cases", "rico", "rico.ini")).read()
    assert "swadvec=2i5" in text
    for key, val in (("itot", n), ("jtot", n), ("ktot", k)):
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    return text


def write_rico_input(wd, ktot=KT):
    dz = ZSIZE / ktot
    z = np.linspace(0.5 * dz, ZSIZE - 0.5 * dz, ktot)
    f = jnc.Dataset(os.path.join(wd, "rico_input.nc"), "w")
    f.createDimension("z", ktot)
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, prof in rico_profiles(z).items():
        g.createVariable(name, "f8", ("z",))[:] = prof
    f.close()


@pytest.fixture(scope="module")
def rico(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("rico2i5"))
    write_rico_input(wd)
    ini = rico_2i5_ini()
    jm = JModel(JIni(ini), "run", "rico", workdir=wd, dtype=np.float64)
    jm.force_fused = True
    jm.micro.force_fused = True
    jm.finish_setup()
    jm.build_step()
    assert jm._fused.generic and jm._use_rkfold_generic and jm._col_fold
    assert jm._fused.no_advec and jm._fused.advec_pallas is not None
    tm = Model(Ini(ini), "run", "rico", dtype=torch.float64, device="cpu",
               input_nc=rico_input(KT, ZSIZE))
    tm.finish_setup()
    tm.build_step()
    assert tm.generic and tm.advec_fused is not None and not tm.fused.advec
    return jm, tm


def test_k8_k9_k10_without_advection_match_tpu_kernels(rico):
    jm, tm = rico
    jfz, tfz = jm._fused, tm.fused
    state = rico_state(tm, seed=5)
    sfc = tm.boundary.init_surface_state()
    rng = np.random.RandomState(8)
    for name in ("dudz_mo", "dvdz_mo", "u_fluxbot", "v_fluxbot"):
        sfc[name] = 0.1 * rng.randn(*sfc[name].shape)
    sfc["dbdz_mo"] = 1e-4 * rng.rand(*sfc["dbdz_mo"].shape)
    sj = jm.boundary.set_ghost_cells(jm.ctx, jx(state), jx(sfc))
    s = {k: np.array(v) for k, v in sj.items()}
    st = tx(s)
    t = {n: 1e-3 * rng.randn(*s[n].shape) for n in s}
    cj_uvw, cj_s = JF.generic_col_tables(jfz, jm.ctx, sj, jx(sfc), {},
                                         jm.force, jm.buffer, jm.decay)
    ct, cts = F.generic_col_tables(tfz, tm.ctx, st, tm.force, tm.buffer)
    ej = JF.fused_generic_viscosity(jfz, jm.ctx, sj, jx(sfc), {},
                                    jm.thermo)["evisc"]
    et = F.generic_viscosity(tfz, tm.ctx, st, tx(sfc), {})["evisc"]
    assert rel(et, ej) <= TOL
    ks, ke = tm.ctx.ks, tm.ctx.ke
    names = list(tfz.names)
    sviscs = [jm.diff.viscs.get(n, jm.diff.visc) for n in names]
    for carry in (True, False):
        cbdt, can = 0.7, (-153. / 128. if carry else 0.)
        tj = jx(t)
        ouv = jfz.tend_uv_rk(sj["u"], sj["v"], sj["w"], ej, tj["u"], tj["v"],
                             cbdt, can, carry=carry, cc_in=cj_uvw,
                             fold_add=True)
        ow = jfz.tend_w_rk(sj["u"], sj["v"], sj["w"], ej, tj["w"], cbdt, can,
                           carry=carry, cc_in=cj_uvw)
        ss_j, tc_j = jfz.tend_scalars_rk(names, sj, sj["u"], sj["v"], sj["w"],
                                         ej, sviscs, tj, cbdt, can,
                                         carry=carry, cc_in=cj_s, fold_add=True)
        star = {"u": ouv[0], "v": ouv[1], "w": ow[0], **ss_j}
        tt = tx(t)
        out = tfz.tend_uvw(st, tt, et, ct, cbdt, can, carry)
        out.update(tfz.tend_scalars(st, tt, et, cts, cbdt, can, carry))
        for n in out:
            assert rel(out[n][ks:ke], np.asarray(star[n])[ks:ke]) <= TOL, n
        if carry:
            cj = {"u": ouv[2], "v": ouv[3], "w": ow[1], **tc_j}
            for n in out:
                assert rel(tt[n][ks:ke], np.asarray(cj[n])[ks:ke]) <= TOL, n
        # with advection the sweep gives another answer
        with_adv = F.tend_uvw_plain(
            st, et, tx(t), ct, ks, tm.ctx.dxi, tm.ctx.dyi, tfz.visc, tfz.fc,
            tm.ctx.utrans, tm.ctx.vtrans, cbdt, can, tfz.coriolis, carry)
        assert rel(with_adv["u"][ks:ke], out["u"][ks:ke]) > 1e-3


def test_two_rk3_steps_rico_2i5_match_jax(rico):
    jm, tm = rico
    ks, ke = tm.ctx.ks, tm.ctx.ke
    state = rico_state(tm, seed=3)
    js, _, jsfc = jm.as_device_state({k: v.copy() for k, v in state.items()})
    ts, tsfc = tm.as_device_state(state)
    for dt in (2.0, 3.0):
        jlim = jm._limits_fn(js, jsfc)
        tlim = tm.limits(ts, tsfc)
        assert set(tlim) == set(jlim) == {"cfl_rate", "dn_rate", "micro_rate"}
        for k in jlim:
            assert rel(float(tlim[k]), float(jlim[k])) <= 1e-10, k
        js, jsfc, jaux = jm._step_fn(js, jsfc, jm.pres_params, jnp.float64(dt),
                                     jnp.float64(0.))
        ts, tsfc, taux = tm.step(ts, tsfc, dt)
        for n in ts:
            assert rel(ts[n][ks:ke], np.asarray(js[n])[ks:ke]) <= 1e-10, n
        assert rel(taux["p"], np.asarray(jaux["p"])[ks:ke]) <= 1e-10
        for k in tsfc:
            assert rel(tsfc[k], jsfc[k]) <= 1e-10, k
    # the scheme's CFL is not the 2nd-order one
    adv2 = float(F.limits_plain(ts["u"], ts["v"], ts["w"], ts["thl"],
                                tm.fused.ce, ks, tm.ctx.dxi, tm.ctx.dyi,
                                tm.fused.tPr, True, True)[0].max())
    assert abs(adv2 - float(tm.limits(ts, tsfc)["cfl_rate"])) > 1e-6 * adv2
    jd = jm._diag_fn(js, jsfc)
    td = tm.diagnostics(ts, tsfc)
    for k in ("mom", "tke", "mass"):
        assert rel(float(td[k]), float(jd[k])) <= 1e-10, k


def test_cli_runs_the_rico_ini_as_written(tmp_path):
    """cases/rico/rico.ini verbatim (swadvec=2i5, 64^2 x 100) with the input
    file of rico_input.py; it has no [stats] section, so nothing is cut but
    the end time."""
    from microhh_torch.__main__ import main
    text = open(os.path.join(ROOT, "cases", "rico", "rico.ini")).read()
    text = text.replace("endtime=21600.", "endtime=8.").replace(
        "savetime=3600.", "savetime=8.")
    (tmp_path / "rico.ini").write_text(text)
    write_rico_input(str(tmp_path), ktot=100)
    argv = ["rico", "--dir", str(tmp_path), "--device", "cpu",
            "--precision", "double"]
    main(["init"] + argv)
    main(["run"] + argv)
    assert (tmp_path / "qr.0000008").exists()
    rows = [line.split() for line in open(tmp_path / "rico.out")
            if line.split()[0].isdigit()]
    assert rows and all(np.isfinite(float(x)) for r in rows for x in r)
