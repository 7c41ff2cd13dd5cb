"""The port's buoyancy slice (SBL_Smag: thermo buoy, geostrophic forcing, the
stable MOST branch, sponge) against the JAX package, in float64 on the CPU:

* ``ThermoBuoy.exec`` and ``get_n2`` (plain, tilted slope with background
  N2, baroclinic) vs the JAX op (<= 1e-12);
* K14 plain vs ``FusedLES2.evisc_n2`` in Pallas interpret mode, and the
  viscosity with its MOST row vs ``fused_generic_viscosity`` (<= 1e-12);
* K15 plain vs ``FusedLES2.tend_scalar_rk`` with the carry, the column fold
  and the advection each on and off (<= 1e-12);
* two RK3 steps of a 16^2 x 24 SBL_Smag case, limits and diagnostics
  included, vs the JAX generic fused path (<= 1e-10); the same for thermo dry
  with ``swadvec=2i5``, which takes the same generic branches;
* ``cases.sbl_input`` equals what ``cases/SBL_Smag/SBL_input.py`` writes; the
  CLI runs the case on the CPU.

Inputs are made from a seed with numpy and copied to each side."""

import os
import re
import runpy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import DRYCBL_INI, initial_state, sbl_state
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops import pallas_fused as JF
from microhh_tpu.utils import nc as jnc
from microhh_torch.cases import sbl_input, sbl_profiles
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import fused as F

TOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = os.path.join(ROOT, "cases", "SBL_Smag")
KT = 24
ZSIZE = 18.074844397670482


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


def sbl_ini(n=16, k=KT, extra_thermo=""):
    text = open(os.path.join(CASE, "SBL.ini")).read()
    for key, val in (("itot", n), ("jtot", n), ("ktot", k), ("swstats", 0),
                     ("swdump", 0)):
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    return text.replace("swthermo=buoy", "swthermo=buoy\n" + extra_thermo)


def write_sbl_input(wd, ktot=KT):
    dz = ZSIZE / ktot
    z = np.linspace(0.5 * dz, ZSIZE - 0.5 * dz, ktot)
    f = jnc.Dataset(os.path.join(wd, "SBL_input.nc"), "w")
    f.createDimension("z", ktot)
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, prof in sbl_profiles(z, ZSIZE).items():
        g.createVariable(name, "f8", ("z",))[:] = prof
    f.close()


def models(wd, ini, fused=True):
    write_sbl_input(wd)
    jm = JModel(JIni(ini), "run", "SBL", workdir=wd, dtype=np.float64)
    if fused:
        jm.force_fused = True
    jm.finish_setup()
    jm.build_step()
    tm = Model(Ini(ini), "run", "SBL", dtype=torch.float64, device="cpu",
               input_nc=sbl_input(KT, ZSIZE))
    tm.finish_setup()
    tm.build_step()
    return jm, tm


@pytest.fixture(scope="module")
def sbl(tmp_path_factory):
    jm, tm = models(str(tmp_path_factory.mktemp("sbl")), sbl_ini())
    assert jm._fused.generic and jm._use_rkfold_generic and jm._col_fold
    assert jm._fused.n2_scalar is None
    assert tm.generic and tm.fused.stratified == 2 and tm.fused.names == ("b",)
    assert [k.name for k in tm.kernels()][:3] == ["evisc_n2", "tend_uvw",
                                                  "tend_scalar_rk"]
    state = sbl_state(tm, seed=5)
    sfc = tm.boundary.init_surface_state()
    rng = np.random.RandomState(8)
    for name in ("dudz_mo", "dvdz_mo", "u_fluxbot", "v_fluxbot"):
        sfc[name] = 0.01 * rng.randn(*sfc[name].shape)
    sfc["dbdz_mo"] = 1e-4 * rng.rand(*sfc["dbdz_mo"].shape)
    sj = jm.boundary.set_ghost_cells(jm.ctx, jx(state), jx(sfc))
    st = tm.boundary.set_ghost_cells(tm.ctx, tx(state), tx(sfc))
    for n in st:
        assert rel(st[n], sj[n]) <= TOL, n
    s = {k: np.array(v) for k, v in sj.items()}
    t = {n: 1e-4 * rng.randn(*s[n].shape) for n in s}
    return jm, tm, s, sfc, t


@pytest.mark.parametrize("extra", [
    "", "alpha=0.05\nN2=0.0003", "N2=0.0002\nswbaroclinic=true\ndbdy_ls=1e-5"])
def test_thermo_buoy_matches_jax(tmp_path, extra):
    jm, tm = models(str(tmp_path), sbl_ini(extra_thermo=extra), fused=False)
    state = sbl_state(tm, seed=2)
    rng = np.random.RandomState(3)
    t = {n: 1e-4 * rng.randn(*state[n].shape) for n in state}
    a = jm.thermo.exec(jm.ctx, jx(state), jx(t), {})
    b = tm.thermo.exec(tm.ctx, tx(state), tx(t), {})
    for n in t:
        assert rel(b[n], a[n]) <= TOL, n
    changed = {n for n in t if not np.array_equal(np.asarray(a[n]), t[n])}
    assert changed == ({"w"} if not extra else
                       {"u", "w", "b"} if "alpha" in extra else {"w", "b"})
    assert rel(tm.thermo.get_n2(tm.ctx, tx(state)),
               jm.thermo.get_n2(jm.ctx, jx(state))) <= TOL
    sfc = tm.boundary.init_surface_state()
    for f in ("get_buoyancy_surf", "get_buoyancy_fluxbot"):
        a = getattr(jm.thermo, f)(jm.ctx, jx(state), jx(sfc))
        b = getattr(tm.thermo, f)(tm.ctx, tx(state), tx(sfc))
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert np.array_equal(np.asarray(x), y.numpy()), f
    assert tm.thermo.get_db_ref() == jm.thermo.get_db_ref() == 0.


def test_k14_evisc_n2_matches_tpu_kernel(sbl):
    jm, tm, s, sfc, _ = sbl
    jfz, tfz = jm._fused, tm.fused
    sj, st = jx(s), tx(s)
    n2j = jm.thermo.get_n2(jm.ctx, sj)
    n2t = tm.thermo.get_n2(tm.ctx, st)
    assert rel(n2t, n2j) <= TOL
    a = jfz.evisc_n2(sj["u"], sj["v"], sj["w"], n2j)
    b = tfz.evisc_n2(st["u"], st["v"], st["w"], n2t)
    assert rel(b, a) <= TOL
    # the stability term matters: the unstratified form differs
    plain = F.evisc_plain(st["u"], st["v"], st["w"], None, tfz.ce, tm.ctx.ks,
                          tm.ctx.dxi, tm.ctx.dyi, tfz.tPr, False, True)
    assert rel(plain, a) > 1e-3
    a = JF.fused_generic_viscosity(jfz, jm.ctx, sj, jx(sfc), {},
                                   jm.thermo)["evisc"]
    b = F.generic_viscosity(tfz, tm.ctx, st, tx(sfc), {})["evisc"]
    assert rel(b, a) <= TOL
    # K7 in the same mode gives the maxima of K14's field
    _, evk = tfz.limits(st["u"], st["v"], st["w"], n2t)
    assert torch.equal(evk, tfz.evisc_n2(st["u"], st["v"], st["w"],
                                         n2t).amax(dim=(1, 2)))


@pytest.mark.parametrize("advec", [True, False])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("carry", [True, False])
def test_k15_tend_scalar_rk_matches_tpu_kernel(sbl, carry, fold, advec):
    jm, tm, s, sfc, t = sbl
    jfz, tfz = jm._fused, tm.fused
    sj, st = jx(s), tx(s)
    _, cj_s = JF.generic_col_tables(jfz, jm.ctx, sj, jx(sfc), {}, jm.force,
                                    jm.buffer, jm.decay)
    _, cts = F.generic_col_tables(tfz, tm.ctx, st, tm.force, tm.buffer)
    assert float(cts[0, :, F.T_FACZ].abs().max()) > 0.     # the sponge
    ej = JF.fused_generic_viscosity(jfz, jm.ctx, sj, jx(sfc), {},
                                    jm.thermo)["evisc"]
    et = F.generic_viscosity(tfz, tm.ctx, st, tx(sfc), {})["evisc"]
    cbdt, can = 0.7, (-5. / 9. if carry else 0.)
    svisc = jm.diff.viscs.get("b", jm.diff.visc)
    saved = jfz.no_advec, tfz.advec
    jfz.no_advec, tfz.advec = (not advec), advec
    try:
        outs = jfz.tend_scalar_rk(sj["b"], sj["u"], sj["v"], sj["w"], ej,
                                  svisc, jnp.array(t["b"]), cbdt, can,
                                  carry=carry,
                                  cc_in=cj_s["b"] if fold else None,
                                  fold_add=fold)
        tt = tx(t)
        out = tfz.tend_scalars(st, tt, et, cts, cbdt, can, carry, fold)
    finally:
        jfz.no_advec, tfz.advec = saved
    ks, ke = tm.ctx.ks, tm.ctx.ke
    assert list(out) == ["b"]
    assert rel(out["b"][ks:ke], np.asarray(outs[0])[ks:ke]) <= TOL
    assert float(out["b"][:ks].abs().max()) == float(out["b"][ke:].abs().max()) == 0.
    if carry:
        assert rel(tt["b"][ks:ke], np.asarray(outs[1])[ks:ke]) <= TOL
    else:
        assert torch.equal(tt["b"], T(t["b"]))
    # K15's plain version is K10's for one scalar
    k10 = F.tend_scalars_plain(st, ("b",), et, tx(t), cts, tfz.sviscs, ks,
                               tm.ctx.dxi, tm.ctx.dyi, tfz.tPr, cbdt, can,
                               carry, advec, fold)
    assert torch.equal(k10["b"], out["b"])


def _two_steps_match(jm, tm, state, dts, keys):
    ks, ke = tm.ctx.ks, tm.ctx.ke
    js, _, jsfc = jm.as_device_state({k: v.copy() for k, v in state.items()})
    ts, tsfc = tm.as_device_state(state)
    for dt in dts:
        jlim = jm._limits_fn(js, jsfc)
        tlim = tm.limits(ts, tsfc)
        assert set(tlim) == set(jlim) == keys
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
    jd = jm._diag_fn(js, jsfc)
    td = tm.diagnostics(ts, tsfc)
    for k in ("mom", "tke", "mass"):
        assert rel(float(td[k]), float(jd[k])) <= 1e-10, k
    assert float(td["div"]) <= 1e-12
    return ts, tsfc


def test_two_rk3_steps_sbl_match_jax(sbl):
    jm, tm, _, _, _ = sbl
    ts, tsfc = _two_steps_match(jm, tm, sbl_state(tm, seed=3), (1.0, 0.5),
                                {"cfl_rate", "dn_rate"})
    # the stable branch: a negative surface flux and a positive Obukhov length
    assert float(tsfc["b_fluxbot"].max()) < 0. < float(tsfc["obuk"].min())


def test_two_rk3_steps_dry_2i5_match_jax(tmp_path):
    """Thermo dry with an interpolated scheme takes the generic branches of
    the buoyancy slice: get_n2 + K14, K15, K12/K13."""
    ini = (DRYCBL_INI % {"n": 16, "k": 24}).replace("swadvec=2", "swadvec=2i5")
    jm = JModel(JIni(ini), "run", "drycblles", workdir=str(tmp_path),
                dtype=np.float64)
    jm.force_fused = True
    jm.finish_setup()
    jm.build_step()
    assert jm._fused.generic and jm._fused.no_advec and jm._use_rkfold_generic
    tm = Model(Ini(ini), "run", "drycblles", dtype=torch.float64, device="cpu")
    tm.finish_setup()
    tm.build_step()
    assert [k.name for k in tm.kernels()][:5] == [
        "evisc_n2", "advec_mom", "advec_scalars", "tend_uvw", "tend_scalar_rk"]
    _two_steps_match(jm, tm, initial_state(tm, seed=7), (2.0, 3.0),
                     {"cfl_rate", "dn_rate"})


def test_sbl_input_equals_the_case_script(tmp_path, monkeypatch):
    text = open(os.path.join(CASE, "SBL.ini")).read()
    (tmp_path / "SBL.ini").write_text(text)
    monkeypatch.chdir(tmp_path)
    runpy.run_path(os.path.join(CASE, "SBL_input.py"))
    f = jnc.Dataset(str(tmp_path / "SBL_input.nc"), "r")
    mem = sbl_input(64, ZSIZE)
    assert np.array_equal(np.asarray(f.variables["z"][:]),
                          np.asarray(mem.variables["z"][:]))
    init = f.groups["init"]
    assert set(init.variables) == set(mem.groups["init"].variables)
    for name in init.variables:
        assert np.array_equal(np.asarray(init.variables[name][:]),
                              np.asarray(mem.groups["init"].variables[name][:])), name


def test_cli_init_run_sbl(tmp_path):
    from microhh_torch.__main__ import main
    text = sbl_ini().replace("endtime=1400.", "endtime=4.").replace(
        "savetime=100.", "savetime=2.")
    (tmp_path / "SBL.ini").write_text(text)
    write_sbl_input(str(tmp_path))
    argv = ["SBL", "--dir", str(tmp_path), "--device", "cpu",
            "--precision", "double"]
    main(["init"] + argv)
    assert (tmp_path / "b.0000000").exists()
    main(["run"] + argv)
    rows = [line.split() for line in open(tmp_path / "SBL.out")
            if line.split()[0].isdigit()]
    assert len(rows) >= 4 and all(np.isfinite(float(x)) for r in rows for x in r)
    assert any(name.startswith("b.") and name != "b.0000000"
               for name in os.listdir(tmp_path))


def test_buoy_at_fourth_order_raises_item_11():
    """SBL_Smag's own schemes (smag2, the MOST surface) do not go with a
    4th-order grid, so its ini with swspatialorder=4 raises; thermo buoy
    itself builds at 4th order with the 4th-order stack."""
    text = sbl_ini().replace("swspatialorder=2", "swspatialorder=4")
    with pytest.raises(NotImplementedError, match="item 11"):
        Model(Ini(text), "run", "SBL", dtype=torch.float64, device="cpu",
              input_nc=sbl_input(KT, ZSIZE))
    text = text.replace("swdiff=smag2", "swdiff=4").replace(
        "swboundary=surface", "swboundary=default").replace(
        "swlspres=geo", "swlspres=0")
    m = Model(Ini(text), "run", "SBL", dtype=torch.float64, device="cpu",
              input_nc=sbl_input(KT, ZSIZE))
    m.finish_setup()
    m.build_step()
    assert m.ctx.spatial_order == 4 and m.ctx.scalar_names == ("b",)
    assert [k.name for k in m.kernels()] == ["o4_mom", "o4_scalars"]
