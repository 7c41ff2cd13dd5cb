"""The port's generic path (the moist bomex/rico slice) against the JAX
package's generic fused path, in float64 on the CPU:

* K1 on ghost-filled fields with the moist N2 (thl against thvref) vs
  FusedLES2.evisc of the generic build, and the viscosity with its MOST row
  vs fused_generic_viscosity;
* the column tables vs generic_col_tables (mean and local subsidence);
* K8/K9 plain vs tend_uv_rk + tend_w_rk, K10 plain vs tend_scalars_rk, in
  Pallas interpret mode, with and without the carry, and the wall-patched
  generic_tendencies_rk vs fused_generic_tendencies_rk (all <= 1e-12 of
  each output's maximum);
* two RK3 steps of a 16^2x24 rico case (swadvec 2) vs the JAX generic
  fused path with force_fused=True, limits and diagnostics included, and
  one bomex step (<= 1e-10);
* the verbatim rico ini (swadvec 2i5) builds, and the options outside the
  slice raise NotImplementedError naming their ROADMAP item; the kernels' C
  signatures match their ctypes declarations; the CLI runs rico."""

import os
import re
import runpy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import rico_ini, rico_state
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops import pallas_fused as JF
from microhh_tpu.utils import nc as jnc
from microhh_torch import kernels
from microhh_torch.cases import rico_input, rico_profiles
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import fused as F

TOL = 1e-12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KT, ZSIZE = 24, 4000.
INI = rico_ini(16, KT)

# the port's generic table columns and the JAX package's C_* slots
COLS = {F.T_DZI: JF.C_DZI, F.T_DZHI: JF.C_DZHI, F.T_DZHI1: JF.C_DZHI1,
        F.T_DZI_M1: JF.C_DZI_M1, F.T_RHO: JF.C_RHO, F.T_RHOH: JF.C_RHOH,
        F.T_RHOH1: JF.C_RHOH1, F.T_RHO_M1: JF.C_Z, F.T_FACZ: JF.C_FACZ,
        F.T_FACZH: JF.C_FACZH, F.T_UG: JF.C_UG, F.T_VG: JF.C_VG,
        F.T_ADDU: JF.C_ADDU, F.T_ADDV: JF.C_ADDV, F.T_ADDS: JF.C_ADDS,
        F.T_WLSDN: JF.C_WLSDN, F.T_WLSUP: JF.C_WLSUP}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def write_rico_input(wd, ktot=KT):
    """rico_input.nc as cases/rico/rico_input.py writes it, at ktot."""
    dz = ZSIZE / ktot
    z = np.linspace(0.5 * dz, ZSIZE - 0.5 * dz, ktot)
    f = jnc.Dataset(os.path.join(wd, "rico_input.nc"), "w")
    f.createDimension("z", ktot)
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, prof in rico_profiles(z).items():
        g.createVariable(name, "f8", ("z",))[:] = prof
    f.close()


def jax_model(ini, wd, casename):
    jm = JModel(JIni(ini), "run", casename, workdir=wd, dtype=np.float64)
    jm.force_fused = True
    jm.micro.force_fused = True
    jm.finish_setup()
    jm.build_step()
    assert jm._fused.generic and jm._use_rkfold_generic and jm._col_fold
    return jm


@pytest.fixture(scope="module")
def rico(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("rico"))
    write_rico_input(wd)
    jm = jax_model(INI, wd, "rico")
    tm = Model(Ini(INI), "run", "rico", dtype=torch.float64, device="cpu",
               input_nc=rico_input(KT, ZSIZE))
    tm.finish_setup()
    tm.build_step()
    state = rico_state(tm, seed=5)
    sfc = tm.boundary.init_surface_state()
    rng = np.random.RandomState(8)
    for name in ("dudz_mo", "dvdz_mo", "u_fluxbot", "v_fluxbot"):
        sfc[name] = 0.1 * rng.randn(*sfc[name].shape)
    sfc["dbdz_mo"] = 1e-4 * rng.rand(*sfc["dbdz_mo"].shape)
    sj = jm.boundary.set_ghost_cells(
        jm.ctx, {k: jnp.array(v) for k, v in state.items()},
        {k: jnp.array(v) for k, v in sfc.items()})
    st = tm.boundary.set_ghost_cells(tm.ctx, {k: T(v) for k, v in state.items()},
                                     {k: T(v) for k, v in sfc.items()})
    for n in st:
        assert rel(st[n], sj[n]) <= TOL, n
    s = {k: np.asarray(v) for k, v in sj.items()}
    t = {n: 1e-3 * rng.randn(*s[n].shape) for n in s}
    return jm, tm, s, sfc, t


def jx(d):
    return {k: jnp.array(v) for k, v in d.items()}


def tx(d):
    return {k: T(v) for k, v in d.items()}


def test_k1_evisc_ghost_moist_matches_tpu_kernel(rico):
    jm, tm, s, sfc, _ = rico
    jfz, tfz = jm._fused, tm.fused
    assert jfz.n2_scalar == tfz.n2_scalar == "thl" and tfz.ghosts
    sj, st = jx(s), tx(s)
    a = jfz.evisc(sj["u"], sj["v"], sj["w"], sj["thl"], stratified=True)
    b = tfz.evisc(st["u"], st["v"], st["w"], st["thl"])
    assert rel(b, a) <= TOL
    # the op path it replaces: strain from the fields, N2 from get_n2
    n2 = tm.thermo.get_n2(tm.ctx, st)
    assert rel(n2, jm.thermo.get_n2(jm.ctx, sj)) <= TOL
    a = JF.fused_generic_viscosity(jfz, jm.ctx, sj, jx(sfc), {},
                                   jm.thermo)["evisc"]
    b = F.generic_viscosity(tfz, tm.ctx, st, tx(sfc), {})["evisc"]
    assert rel(b, a) <= TOL


@pytest.mark.parametrize("swwls", ["mean", "local"])
def test_generic_col_tables_match(rico, swwls):
    jm, tm, s, sfc, _ = rico
    sj, st = jx(s), tx(s)
    saved = jm.force.swwls, tm.force.swwls
    jm.force.swwls = tm.force.swwls = swwls
    try:
        cj_uvw, cj_s = JF.generic_col_tables(jm._fused, jm.ctx, sj, jx(sfc),
                                             {}, jm.force, jm.buffer,
                                             jm.decay)
        ct, cts = F.generic_col_tables(tm.fused, tm.ctx, st, tm.force,
                                       tm.buffer)
    finally:
        jm.force.swwls, tm.force.swwls = saved
    cj_uvw = np.asarray(cj_uvw)
    for tc, jc in COLS.items():
        if jc in (JF.C_ADDS,):
            continue
        assert rel(ct[:, tc], cj_uvw[:, jc]) <= TOL or (
            np.abs(cj_uvw[:, jc]).max() == 0. == float(ct[:, tc].abs().max())), tc
    for i, n in enumerate(tm.fused.names):
        cj = np.asarray(cj_s[n])
        for tc in (F.T_FACZ, F.T_ADDS, F.T_WLSDN, F.T_WLSUP):
            jc = COLS[tc]
            assert (np.abs(cj[:, jc]).max() == 0. == float(cts[i, :, tc].abs().max())
                    or rel(cts[i, :, tc], cj[:, jc]) <= TOL), (n, tc)
    if swwls == "local":   # subsidence (w_ls < 0) takes the upper difference
        assert float(cts[:, :, F.T_WLSUP].abs().max()) > 0.


def _tables(rico):
    jm, tm, s, sfc, _ = rico
    cj = JF.generic_col_tables(jm._fused, jm.ctx, jx(s), jx(sfc), {},
                               jm.force, jm.buffer, jm.decay)
    ct = F.generic_col_tables(tm.fused, tm.ctx, tx(s), tm.force, tm.buffer)
    return cj, ct


@pytest.mark.parametrize("carry", [True, False])
def test_k8_k9_tend_uvw_match_tpu_kernels(rico, carry):
    jm, tm, s, sfc, t = rico
    jfz, tfz = jm._fused, tm.fused
    assert jfz.fold_coriolis and tfz.coriolis and tfz.fc == jfz.fc
    (cj_uvw, _), (ct, _) = _tables(rico)
    sj, st = jx(s), tx(s)
    ej = JF.fused_generic_viscosity(jfz, jm.ctx, sj, jx(sfc), {},
                                    jm.thermo)["evisc"]
    et = F.generic_viscosity(tfz, tm.ctx, st, tx(sfc), {})["evisc"]
    cbdt, can = 0.7, (-153. / 128. if carry else 0.)
    tj = jx(t)
    ouv = jfz.tend_uv_rk(sj["u"], sj["v"], sj["w"], ej, tj["u"], tj["v"],
                         cbdt, can, carry=carry, cc_in=cj_uvw, fold_add=True)
    ow = jfz.tend_w_rk(sj["u"], sj["v"], sj["w"], ej, tj["w"], cbdt, can,
                       carry=carry, cc_in=cj_uvw)
    tt = tx(t)
    out = tfz.tend_uvw(st, tt, et, ct, cbdt, can, carry)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    star = {"u": ouv[0], "v": ouv[1], "w": ow[0]}
    for n in ("u", "v", "w"):
        assert rel(out[n][ks:ke], np.asarray(star[n])[ks:ke]) <= TOL, n
        assert float(out[n][:ks].abs().max()) == float(out[n][ke:].abs().max()) == 0.
    if carry:
        cj = {"u": ouv[2], "v": ouv[3], "w": ow[1]}
        for n in ("u", "v", "w"):
            assert rel(tt[n][ks:ke], np.asarray(cj[n])[ks:ke]) <= TOL, n
    else:
        for n in ("u", "v", "w"):
            assert torch.equal(tt[n], T(t[n])), n


@pytest.mark.parametrize("carry", [True, False])
def test_k10_tend_scalars_match_tpu_kernel(rico, carry):
    jm, tm, s, sfc, t = rico
    jfz, tfz = jm._fused, tm.fused
    names = list(tfz.names)
    assert names == ["thl", "qt", "qr", "nr"]
    (_, cj_s), (_, cts) = _tables(rico)
    sj, st = jx(s), tx(s)
    ej = JF.fused_generic_viscosity(jfz, jm.ctx, sj, jx(sfc), {},
                                    jm.thermo)["evisc"]
    et = F.generic_viscosity(tfz, tm.ctx, st, tx(sfc), {})["evisc"]
    cbdt, can = 0.7, (-5. / 9. if carry else 0.)
    sviscs = [jm.diff.viscs.get(n, jm.diff.visc) for n in names]
    ss_j, tc_j = jfz.tend_scalars_rk(names, sj, sj["u"], sj["v"], sj["w"], ej,
                                     sviscs, jx(t), cbdt, can, carry=carry,
                                     cc_in=cj_s, fold_add=True)
    tt = tx(t)
    out = tfz.tend_scalars(st, tt, et, cts, cbdt, can, carry)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in names:
        assert rel(out[n][ks:ke], np.asarray(ss_j[n])[ks:ke]) <= TOL, n
        if carry:
            assert rel(tt[n][ks:ke], np.asarray(tc_j[n])[ks:ke]) <= TOL, n
        else:
            assert torch.equal(tt[n], T(t[n])), n


@pytest.mark.parametrize("carry", [True, False])
def test_generic_tendencies_rk_match(rico, carry):
    """K8-K10 with the MOST wall rows patched in, as one substep uses them."""
    jm, tm, s, sfc, t = rico
    cj, ct = _tables(rico)
    sj, st = jx(s), tx(s)
    auxj = JF.fused_generic_viscosity(jm._fused, jm.ctx, sj, jx(sfc), {},
                                      jm.thermo)
    auxt = F.generic_viscosity(tm.fused, tm.ctx, st, tx(sfc), {})
    cbdt, can = 0.7, (-5. / 9. if carry else 0.)
    s_j, t_j = JF.fused_generic_tendencies_rk(
        jm._fused, jm.ctx, sj, jx(t), auxj, jx(sfc), cbdt, can, carry=carry,
        cols=cj)
    tt = tx(t)
    s_t = F.generic_tendencies_rk(tm.fused, tm.ctx, st, tt, auxt, tx(sfc),
                                  cbdt, can, ct)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in s_t:
        assert rel(s_t[n][ks:ke], np.asarray(s_j[n])[ks:ke]) <= TOL, n
        if carry:
            assert rel(tt[n][ks:ke], np.asarray(t_j[n])[ks:ke]) <= TOL, n


def test_two_rk3_steps_rico_match_jax(rico):
    jm, tm, _, _, _ = rico
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
        # one jitted step: the eager step re-traces every Pallas call
        js, jsfc, jaux = jm._step_fn(js, jsfc, jm.pres_params, jnp.float64(dt),
                                     jnp.float64(0.))
        ts, tsfc, taux = tm.step(ts, tsfc, dt)
        for n in ts:
            assert rel(ts[n][ks:ke], np.asarray(js[n])[ks:ke]) <= 1e-10, n
        assert rel(taux["p"], np.asarray(jaux["p"])[ks:ke]) <= 1e-10
        assert rel(taux["rr_bot"], np.asarray(jaux["rr_bot"])) <= 1e-10
        assert float(taux["rr_bot"].abs().max()) > 0.
        for k in tsfc:
            assert rel(tsfc[k], jsfc[k]) <= 1e-10, k
    for n in ("qt", "qr", "nr"):
        assert float(ts[n][ks:ke].min()) >= 0., n
    jd = jm._diag_fn(js, jsfc)
    td = tm.diagnostics(ts, tsfc)
    for k in ("mom", "tke", "mass"):
        assert rel(float(td[k]), float(jd[k])) <= 1e-10, k


def test_bomex_step_matches_jax(tmp_path, monkeypatch):
    text = open(os.path.join(ROOT, "cases", "bomex", "bomex.ini")).read()
    for key, val in (("itot", 16), ("jtot", 16), ("ktot", 24),
                     ("swstats", 0)):
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    (tmp_path / "bomex.ini").write_text(text)
    monkeypatch.chdir(tmp_path)
    runpy.run_path(os.path.join(ROOT, "cases", "bomex", "bomex_input.py"))
    jm = jax_model(text, str(tmp_path), "bomex")
    tm = Model(Ini(text), "run", "bomex", workdir=str(tmp_path),
               dtype=torch.float64, device="cpu")
    tm.finish_setup()
    tm.build_step()
    assert tm.generic and tm.fused.names == ("thl", "qt")
    st = tm.fields.create(tm.input_nc)
    rng = np.random.RandomState(2)
    g = tm.grid
    st["w"][g.kstart + 1:g.kend] += 0.1 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    js, _, jsfc = jm.as_device_state({k: v.copy() for k, v in st.items()})
    ts, tsfc = tm.as_device_state(st)
    js, jsfc, _ = jm._step_raw(js, jsfc, jm.pres_params, 3.0, 0.)
    ts, tsfc, _ = tm.step(ts, tsfc, 3.0)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ts:
        assert rel(ts[n][ks:ke], np.asarray(js[n])[ks:ke]) <= 1e-10, n
    for k in tsfc:
        assert rel(tsfc[k], jsfc[k]) <= 1e-10, k


def test_rico_verbatim_ini_raises_item_10():
    """The rico ini as written (swadvec=2i5, ROADMAP Queue 1 item 10) builds
    with the interpolated scheme as a producer before tendency kernels
    without advection; a 4th-order scheme on this 2nd-order grid raises."""
    text = open(os.path.join(ROOT, "cases", "rico", "rico.ini")).read()
    m = Model(Ini(text), "run", "rico", dtype=torch.float64, device="cpu",
              input_nc=rico_input(100, ZSIZE))
    m.finish_setup()
    m.build_step()
    assert m.advec.scheme == "2i5" and not m.fused.advec
    assert [k.name for k in m.kernels()][2:4] == ["advec_mom", "advec_scalars"]
    with pytest.raises(NotImplementedError, match="item 11"):
        Model(Ini(text.replace("swadvec=2i5", "swadvec=4")), "run", "rico",
              dtype=torch.float64, device="cpu",
              input_nc=rico_input(100, ZSIZE))


def test_rico_with_uflux_runs_unfolded_and_matches_jax(tmp_path):
    """swlspres=uflux at order 2 reads the tendency, so the JAX package
    keeps its generic kernels without the RK fold; the port takes K18/K19
    with the forcing as an op after them: two steps against the JAX
    package's op path, limits and diagnostics."""
    text = INI.replace("swlspres=geo", "swlspres=uflux\nuflux=1.")
    write_rico_input(str(tmp_path))
    models = []
    for fused in (True, False):
        jm = JModel(JIni(text), "run", "rico", workdir=str(tmp_path),
                    dtype=np.float64)
        jm.force_fused = fused
        jm.finish_setup()
        jm.build_step()
        models.append(jm)
    gate, jm = models
    assert gate._fused.generic and not gate._use_rkfold_generic
    assert jm._fused is None
    tm = Model(Ini(text), "run", "rico", dtype=torch.float64, device="cpu",
               input_nc=rico_input(KT, ZSIZE))
    tm.finish_setup()
    tm.build_step()
    assert tm.generic and tm.unfolded and not tm.skip_force
    assert [k.name for k in tm.kernels()] == [
        "evisc", "micro2", "tend_uvw_acc", "tend_scalar_acc", "dft_fwd",
        "tdma_ri", "dft_inv", "limits"]
    ks, ke = tm.ctx.ks, tm.ctx.ke
    state = rico_state(tm, seed=3)
    js, _, jsfc = jm.as_device_state({k: v.copy() for k, v in state.items()})
    ts, tsfc = tm.as_device_state(state)
    for dt in (2.0, 3.0):
        jlim = jm._limits_fn(js, jsfc)
        tlim = tm.limits(ts, tsfc)
        assert set(tlim) == set(jlim)
        for k in jlim:
            assert rel(float(tlim[k]), float(jlim[k])) <= 1e-10, k
        js, jsfc, jaux = jm._step_fn(js, jsfc, jm.pres_params, jnp.float64(dt),
                                     jnp.float64(0.))
        ts, tsfc, taux = tm.step(ts, tsfc, dt)
        for n in ts:
            assert rel(ts[n][ks:ke], np.asarray(js[n])[ks:ke]) <= 1e-10, n
        for k in tsfc:
            assert rel(tsfc[k], jsfc[k]) <= 1e-10, k
    # the forcing holds the domain mean of u + utrans at uflux
    dz = tm.ctx.dz[ks:ke][:, None, None]
    umean = float((ts["u"][ks:ke] * dz).sum()) / (
        tm.ctx.itot * tm.ctx.jtot * tm.ctx.zsize)
    assert abs(umean + tm.ctx.utrans - 1.) <= 1e-10
    jd = jm._diag_fn(js, jsfc)
    td = tm.diagnostics(ts, tsfc)
    for k in ("mom", "tke", "mass"):
        assert rel(float(td[k]), float(jd[k])) <= 1e-10, k


@pytest.mark.parametrize("change,item", [
    (("[force]", "[force]\nswnudge=1"), 9),
    (("[force]", "[force]\nswtimedep_nudge=true"), 9),
    (("[grid]", "[grid]\nswtimedep=true"), 14),
    (("swthermo=moist", "swthermo=vapor"), 9),
    (("swmicro=2mom_warm", "swmicro=nsw6"), 14),
    (("[buffer]", "[buffer]\nswupdate=1"), 9),
    (("[limiter]", "[decay]\nswdecay[qr]=exponential\n\n[limiter]"), 9),
])
def test_generic_options_outside_the_slice_raise(change, item):
    with pytest.raises(NotImplementedError, match="item %d" % item):
        m = Model(Ini(INI.replace(*change)), "run", "rico",
                  dtype=torch.float64, device="cpu",
                  input_nc=rico_input(KT, ZSIZE))
        m.finish_setup()
        m.build_step()


def test_kernel_c_signatures_match_ctypes():
    """Every C entry takes the arguments kernels.SIGNATURES declares, plus
    the stream: a mismatch would pass wrong values on the card."""
    src = ""
    for path in kernels._sources():
        with open(path) as f:
            src += f.read()
    for name, args in kernels.SIGNATURES.items():
        m = re.search(r"int mhh_%s_##SUF\(([^)]*)\)" % name, src)
        assert m, name
        params = [p for p in m.group(1).replace("\\", " ").split(",")
                  if p.strip()]
        assert len(params) == len(args) + 1, (name, len(params), len(args))
        assert params[-1].split()[-1] == "stream", name


def test_cli_init_run_rico(tmp_path):
    from microhh_torch.__main__ import main
    text = INI.replace("endtime=21600.", "endtime=12.").replace(
        "savetime=3600.", "savetime=6.")
    (tmp_path / "rico.ini").write_text(text)
    write_rico_input(str(tmp_path))
    argv = ["rico", "--dir", str(tmp_path), "--device", "cpu",
            "--precision", "double"]
    main(["init"] + argv)
    assert (tmp_path / "thl.0000000").exists()
    main(["run"] + argv)
    assert (tmp_path / "qr.0000012").exists()
    rows = [line.split() for line in open(tmp_path / "rico.out")
            if line.split()[0].isdigit()]
    assert rows and all(np.isfinite(float(x)) for r in rows for x in r)


def test_coriolis_stencil_follows_the_jax_package(rico):
    """ROADMAP Queue 3: the JAX package's 2nd-order Coriolis term
    (ops/force.py:149-150, pallas_fused.py:458-459) averages v over the
    four faces around (i+1/2, j-1), not around the u point (i-1/2, j) that
    its 4th-order branch and budget.py use.  The port follows the JAX
    package (K8/K9 and Force); this pins the offset: the term is the
    centred average taken one cell east and one cell south."""
    from microhh_torch.ops.stencil import im, ip, jm, jp
    _, tm, s, _, _ = rico
    st = tx(s)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    f = tm.force
    out = f(tm.ctx, st, {n: torch.zeros_like(st[n]) for n in st}, {})
    v = st["v"][ks:ke]
    centred = 0.25 * (im(v) + v + im(jp(v)) + jp(v))
    vg = torch.tensor(f.vg)

    def term(v_at_u):
        return f.fc * (v_at_u + tm.ctx.vtrans - vg)

    assert rel(out["u"][ks:ke], term(ip(jm(centred)))) <= TOL
    assert rel(out["u"][ks:ke], term(centred)) > 1e-3
