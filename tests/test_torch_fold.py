"""The folded form of the port's dry RK sweep (K22 ``tend_rk_fold``: eddy
viscosity, tendencies, RK update and Poisson right-hand side in one k-march)
and the flags that came with it, against the JAX package in float64 on the
CPU.  The TPU kernels run in Pallas interpret mode in their tiled form
(``tiled=True, tj=8, fold_ghosts=True``, as tests/test_rkfold.py runs them);
the port runs its plain versions.

* K22 plain vs ``fused_tendencies_rk`` with the evisc and rhs folds: s*,
  carries, e and rhs <= 1e-12 of each output's maximum, first x carry, with
  and without the surface model, the sponge and the Coriolis fold, on a
  stretched grid; the carries random and non-zero at every tile edge; the
  same rhs against K4 rhs's plain version on the patched s*;
* K22 with the evisc fold off (``MICROHH_EVFOLD=0``: the TPU kernel that
  reads the eddy viscosity and emits the rhs);
* K2 plain with the Coriolis flag vs the full-plane TPU kernels with
  ``force=`` and vs the port's own force op, utrans and vtrans not zero;
* the neutral set (``has_thermo=False``): K1, K7, K2, K20 and K22 plain vs
  the TPU kernels, on the andren1994 case less its passive scalar;
* the K22 tables against ``cc_tend`` and ``cc_evisc`` of FusedLES2.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import andren_ini, case_ini
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.ops import pallas_fused as JF
from microhh_tpu.utils import nc as jnc
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import fused as F
from microhh_torch.utils.nc import MemoryDataset

TOL = 1e-12
N, KT = (16, 16), 12
TRANS = "swspatialorder=2\nutrans=3.\nvtrans=-2."


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


def stretched_z(ktot, zsize):
    """Full levels that grow with height and fill [0, zsize]."""
    dz = 1. + 1.5 * np.arange(ktot) / ktot
    zh = np.concatenate([[0.], np.cumsum(dz)]) * zsize / dz.sum()
    return 0.5 * (zh[1:] + zh[:-1])


def model_pair(wd, case, text, mem):
    """The JAX and the port's Model of one ini on one input dataset."""
    z = np.asarray(mem.variables["z"][:])
    f = jnc.Dataset(os.path.join(wd, "%s_input.nc" % case), "w")
    f.createDimension("z", len(z))
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, var in mem.groups["init"].variables.items():
        g.createVariable(name, "f8", ("z",))[:] = np.asarray(var[:])
    f.close()
    jm = JModel(JIni(text), "run", case, workdir=wd, dtype=np.float64)
    jm.finish_setup()
    tm = Model(Ini(text), "run", case, dtype=torch.float64, device="cpu",
               input_nc=mem)
    tm.finish_setup()
    tm.build_step()
    return jm, tm


def random_inputs(tm, seed):
    """Seeded fields (no ghost fill: the clamped kernels read none), surface
    planes and carries that are non-zero everywhere on the interior."""
    g = tm.grid
    ks, ke = g.kstart, g.kend
    rng = np.random.RandomState(seed)
    s = tm.fields.create(tm.input_nc, dtype=np.float64)
    for n in ("u", "v"):
        s[n][ks:ke] += 0.5 * rng.randn(g.ktot, g.jtot, g.itot)
    s["w"][ks + 1:ke] += 0.2 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    if "th" in s:
        s["th"][ks:ke] += 0.2 * rng.randn(g.ktot, g.jtot, g.itot)
    sfc = tm.boundary.init_surface_state()
    for name in ("dudz_mo", "dvdz_mo", "u_fluxbot", "v_fluxbot"):
        sfc[name] = 0.1 * rng.randn(g.jtot, g.itot)
    sfc["dbdz_mo"] = 1e-4 * rng.rand(g.jtot, g.itot)
    if "th" in s:
        sfc["th_fluxbot"] = 0.1 * rng.rand(g.jtot, g.itot)
    t = {n: np.zeros_like(a) for n, a in s.items()}
    for n in t:
        t[n][ks:ke] = 1e-2 * (1. + rng.rand(g.ktot, g.jtot, g.itot))
    return s, sfc, t


def sullivan_pair(wd, z):
    """sullivan2011 (thermo dry, sponge, geostrophic wind, MOST) at 16x16x12
    with a translation velocity, on the full levels z."""
    text = case_ini("sullivan2011", itot=N[0], jtot=N[1], ktot=KT,
                    swstats=0).replace("swspatialorder=2", TRANS)
    mem = MemoryDataset({"z": z}, {"init": cases.sullivan2011_profiles(z)})
    jm, tm = model_pair(wd, "sullivan2011", text, mem)
    assert tm.fold and tm.fused.coriolis and tm.skip_buffer and tm.skip_force
    assert [k.name for k in tm.kernels()][0] == "tend_rk_fold"
    return (jm, tm) + random_inputs(tm, 11)


@pytest.fixture(scope="module")
def sull(tmp_path_factory):
    return sullivan_pair(str(tmp_path_factory.mktemp("sull")),
                         cases.uniform_z(KT, 2048.))


@pytest.fixture(scope="module")
def andren(tmp_path_factory):
    """andren1994 less its passive scalar: thermo 0, no scalar."""
    wd = str(tmp_path_factory.mktemp("andren"))
    jm, tm = model_pair(wd, "andren1994", andren_ini(N, KT),
                        cases.andren1994_input(KT))
    assert tm.fold and not tm.fused.has_thermo and tm.fused.coriolis
    assert tm.ctx.scalar_names == () and tm.fused.prognostic == ("u", "v", "w")
    return (jm, tm) + random_inputs(tm, 13)


def fused_pair(jm, tm, thermo=True, sponge=True, coriolis=True, tiled=True):
    jfz = JF.FusedLES2(jm.ctx, jm.diff, jm.thermo, thermo, interpret=True,
                       tiled=tiled, tj=8,
                       buffer=jm.buffer if sponge and tm.buffer else None,
                       force=jm.force if coriolis else None, fold_ghosts=True,
                       top_grad_th=0.003 if thermo else 0.)
    tfz = F.Fused(tm.ctx, tm.diff, tm.thermo, tm.buffer if sponge else None,
                  0.003 if thermo else 0.,
                  force=tm.force if coriolis else None, has_thermo=thermo)
    return jfz, tfz


def run_both(jm, tm, jfz, tfz, s, sfc, t, first, carry, evisc_fold=True):
    """fused_tendencies_rk with the rhs fold and the port's
    tendencies_rk_fold on the same inputs; every output compared."""
    cbdt, can = 0.7, (-5. / 9. if carry else 0.)
    seen = []
    orig = jfz.tendencies_rk
    jfz.tendencies_rk = lambda *a, **k: seen.append(orig(*a, **k)) or seen[-1]
    auxj, auxt = {}, {}
    if not evisc_fold:
        auxj = JF.fused_exec_viscosity(jfz, jm.ctx, jx(s), jx(sfc), {})
        auxt = F.exec_viscosity(tfz, tm.ctx, tx(s), tx(sfc), {})
    s_j, t_j, rhs_j = JF.fused_tendencies_rk(
        jfz, jm.ctx, jx(s), jx(t), auxj, jx(sfc), cbdt, can, first=first,
        rhs_dti=1. / cbdt)
    assert rhs_j is not None
    t_t = tx(t)
    s_t, aux, rhs_t = F.tendencies_rk_fold(
        tfz, tm.ctx, tx(s), t_t, auxt, tx(sfc), cbdt, can, first,
        evisc_fold=evisc_fold)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in tfz.prognostic:
        assert rel(s_t[n][ks:ke], np.asarray(s_j[n])[ks:ke]) <= TOL, n
        if carry:
            assert rel(t_t[n][ks:ke], np.asarray(t_j[n])[ks:ke]) <= TOL, n
        else:       # the last substep leaves the carry as it was
            assert torch.equal(t_t[n], T(t[n])), n
        # ghost levels of s* and the carries stay zero
        for a in (s_t[n], t_t[n]):
            assert float(a[:ks].abs().max()) == 0., n
            if n != "w":
                assert float(a[ke:].abs().max()) == 0., n
    assert float(s_t["w"][ke].abs().max()) == 0.
    # the wall half level ks gets no tendency, only the carry it is given
    wall = torch.zeros_like(s_t["w"][ks]) if first else cbdt * T(t["w"][ks])
    assert rel(s_t["w"][ks] - T(s["w"][ks]), wall) <= TOL
    assert rel(rhs_t, rhs_j) <= TOL
    if evisc_fold:
        assert rel(aux["evisc_int"], seen[0][-1]) <= TOL
        if tfz.smag.surface:
            row = F.surface_evisc_row(tfz.smag, tm.ctx, tx(s), tx(sfc),
                                      tfz.has_thermo)
            assert torch.equal(aux["evisc_int"][0], row)
    # the port's own two forms: K4 rhs's plain version on the patched s*
    rhs_glue = F.pres_rhs_plain(s_t["u"], s_t["v"], s_t["w"], tm.glue.pc, ks,
                                tm.ctx.dxi, tm.ctx.dyi, 1. / cbdt)
    assert rel(rhs_t, rhs_glue) <= 1e-11
    return s_t, t_t, aux, rhs_t


@pytest.mark.parametrize("first,carry", [(False, True), (False, False),
                                         (True, True), (True, False)])
def test_k22_matches_tpu_kernel(sull, first, carry):
    jm, tm, s, sfc, t = sull
    jfz, tfz = fused_pair(jm, tm)
    assert jfz.fold_evisc and jfz.fold_coriolis and jfz.fold_buffer
    t_before = tx(t)
    _, t_t, _, _ = run_both(jm, tm, jfz, tfz, s, sfc, t, first, carry)
    if carry and not first:
        # the carries of u and v that were read are not written to
        assert all(torch.equal(t_before[n], T(t[n])) for n in ("u", "v"))


def test_k22_matches_tpu_kernel_on_a_stretched_grid(tmp_path):
    jm, tm, s, sfc, t = sullivan_pair(str(tmp_path), stretched_z(KT, 2048.))
    assert np.ptp(np.diff(tm.grid.z[tm.grid.kstart:tm.grid.kend])) > 50.
    jfz, tfz = fused_pair(jm, tm)
    run_both(jm, tm, jfz, tfz, s, sfc, t, False, True)


@pytest.mark.parametrize("variant", ["no_surface", "no_sponge", "no_coriolis",
                                     "bare"])
def test_k22_folds_on_and_off(sull, monkeypatch, variant):
    jm, tm, s, sfc, t = sull
    bare = variant == "bare"
    if bare or variant == "no_surface":
        monkeypatch.setattr(jm.diff, "surface", False)
        monkeypatch.setattr(tm.diff, "surface", False)
    jfz, tfz = fused_pair(jm, tm, sponge=not (bare or variant == "no_sponge"),
                          coriolis=not (bare or variant == "no_coriolis"))
    run_both(jm, tm, jfz, tfz, s, sfc, t, False, True)


@pytest.mark.parametrize("first", [False, True])
def test_k22_without_the_evisc_fold_matches(sull, monkeypatch, first):
    """MICROHH_EVFOLD=0: the TPU sweep reads the eddy viscosity of the
    standalone pass and still emits the rhs (call :2108); K22 takes it as
    its e argument."""
    jm, tm, s, sfc, t = sull
    monkeypatch.setenv("MICROHH_EVFOLD", "0")
    jfz, tfz = fused_pair(jm, tm)
    assert not jfz.fold_evisc
    run_both(jm, tm, jfz, tfz, s, sfc, t, first, True, evisc_fold=False)


def test_k22_tables_match_the_tpu_tables(sull, andren):
    for (jm, tm, _, _, _), thermo in ((sull, True), (andren, False)):
        jfz, tfz = fused_pair(jm, tm, thermo=thermo)
        ct, ce = tfz.ct.numpy(), tfz.ce.numpy()
        for mine, theirs in ((F.T_DZI, JF.C_DZI), (F.T_DZHI, JF.C_DZHI),
                             (F.T_DZHI1, JF.C_DZHI1),
                             (F.T_DZI_M1, JF.C_DZI_M1), (F.T_RHO, JF.C_RHO),
                             (F.T_RHOH, JF.C_RHOH), (F.T_RHOH1, JF.C_RHOH1),
                             (F.T_RHO_M1, JF.C_Z), (F.T_THREFH, JF.C_THREFH),
                             (F.T_FACZ, JF.C_FACZ), (F.T_FACZH, JF.C_FACZH),
                             (F.T_UREF, JF.C_UREF), (F.T_VREF, JF.C_VREF),
                             (F.T_SREF, JF.C_SREF), (F.T_UG, JF.C_UG),
                             (F.T_VG, JF.C_VG)):
            assert np.array_equal(ct[:, mine], jfz.cc_tend[:, theirs]), mine
        for mine, theirs in ((F.E_DZI, JF.C_DZI), (F.E_DZHI, JF.C_DZHI),
                             (F.E_DZHI1, JF.C_DZHI1), (F.E_MLEN2, JF.C_MLEN2),
                             (F.E_THREF, JF.C_THREFH), (F.E_TOPS, JF.C_TOPS)):
            assert np.array_equal(ce[:, mine], jfz.cc_evisc[:, theirs]), mine
        assert ct.shape == (KT, F.NTG)
        if not thermo:      # no reference profile: the columns stay zero
            assert not ct[:, F.T_THREFH].any() and not ce[:, F.E_THREF].any()


@pytest.mark.parametrize("first,carry", [(False, True), (True, False)])
def test_k2_coriolis_flag_matches_tpu_kernels(sull, first, carry):
    """The full-plane TPU bodies with fold_coriolis (_tend_uv_rk_body with
    _extra_uv) against K2's plain version with its flag."""
    jm, tm, s, sfc, t = sull
    jfz, tfz = fused_pair(jm, tm, tiled=False)
    assert jfz.fold_coriolis and not jfz.tiled and tfz.fc == 1e-4
    cbdt, can = 0.7, (-5. / 9. if carry else 0.)
    auxj = JF.fused_exec_viscosity(jfz, jm.ctx, jx(s), jx(sfc), {})
    auxt = F.exec_viscosity(tfz, tm.ctx, tx(s), tx(sfc), {})
    assert rel(auxt["evisc_int"], auxj["evisc_int"]) <= TOL
    s_j, t_j, rhs = JF.fused_tendencies_rk(jfz, jm.ctx, jx(s), jx(t), auxj,
                                           jx(sfc), cbdt, can, first=first)
    assert rhs is None
    t_t = tx(t)
    s_t = F.tendencies_rk(tfz, tm.ctx, tx(s), t_t, auxt, tx(sfc), cbdt, can,
                          first)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in F.PROGNOSTIC:
        assert rel(s_t[n][ks:ke], np.asarray(s_j[n])[ks:ke]) <= TOL, n
        if carry:
            assert rel(t_t[n][ks:ke], np.asarray(t_j[n])[ks:ke]) <= TOL, n


def test_k2_coriolis_flag_is_the_force_op(sull):
    """K2 with the flag minus K2 without it is the port's force op (the
    offset stencil of the JAX package, with utrans and vtrans)."""
    jm, tm, s, sfc, t = sull
    assert tm.ctx.utrans == 3. and tm.ctx.vtrans == -2.
    _, on = fused_pair(jm, tm)
    _, off = fused_pair(jm, tm, coriolis=False)
    e = F.exec_viscosity(on, tm.ctx, tx(s), tx(sfc), {})["evisc_int"]
    t_on, t_off = tx(t), tx(t)
    on.tend_rk(tx(s), t_on, e, 0.7, 1., False, True)
    off.tend_rk(tx(s), t_off, e, 0.7, 1., False, True)
    zero = {n: torch.zeros_like(a) for n, a in t_on.items()}
    op = tm.force(tm.ctx, tx(s), zero, {})
    opj = jm.force(jm.ctx, jx(s), jx({n: np.zeros_like(a) for n, a in t.items()}),
                   {}, jx(sfc))
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ("u", "v"):
        assert float(op[n][ks:ke].abs().max()) > 0.
        assert rel(op[n], opj[n]) <= TOL
        assert rel((t_on[n] - t_off[n])[ks:ke], op[n][ks:ke]) <= 1e-9, n
    for n in ("w", "th"):
        assert torch.equal(t_on[n], t_off[n])


# --------------------------------------------------------------------------
#  the neutral set: has_thermo=False
# --------------------------------------------------------------------------

def test_neutral_k1_k7_match_tpu_kernels(andren):
    jm, tm, s, sfc, _ = andren
    jfz, tfz = fused_pair(jm, tm, thermo=False)
    sj, st = jx(s), tx(s)
    assert tfz.stratified == 0
    a = jfz.evisc(sj["u"], sj["v"], sj["w"], None)
    b = tfz.evisc(st["u"], st["v"], st["w"], st["u"])
    assert rel(b, a) <= TOL
    a = JF.fused_exec_viscosity(jfz, jm.ctx, sj, jx(sfc), {})["evisc_int"]
    b = F.exec_viscosity(tfz, tm.ctx, st, tx(sfc), {})["evisc_int"]
    assert rel(b, a) <= TOL
    cfl_j, ev_j = jfz.limits_pass(sj["u"], sj["v"], sj["w"], None)
    cfl_t, ev_t = tfz.limits(st["u"], st["v"], st["w"], st["u"])
    assert rel(cfl_t, cfl_j) <= TOL and rel(ev_t, ev_j) <= TOL


@pytest.mark.parametrize("first,carry", [(False, True), (True, True),
                                         (False, False)])
def test_neutral_k22_matches_tpu_kernel(andren, first, carry):
    jm, tm, s, sfc, t = andren
    jfz, tfz = fused_pair(jm, tm, thermo=False)
    assert not jfz.has_thermo and jfz.fold_evisc and jfz.fold_coriolis
    s_t, t_t, _, _ = run_both(jm, tm, jfz, tfz, s, sfc, t, first, carry)
    assert set(s_t) == set(t_t) == {"u", "v", "w"}


def test_neutral_k2_matches_tpu_kernels(andren):
    jm, tm, s, sfc, t = andren
    jfz, tfz = fused_pair(jm, tm, thermo=False, tiled=False)
    auxj = JF.fused_exec_viscosity(jfz, jm.ctx, jx(s), jx(sfc), {})
    auxt = F.exec_viscosity(tfz, tm.ctx, tx(s), tx(sfc), {})
    s_j, t_j, _ = JF.fused_tendencies_rk(jfz, jm.ctx, jx(s), jx(t), auxj,
                                         jx(sfc), 0.7, -5. / 9.)
    t_t = tx(t)
    s_t = F.tendencies_rk(tfz, tm.ctx, tx(s), t_t, auxt, tx(sfc), 0.7,
                          -5. / 9., False)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    assert set(s_t) == {"u", "v", "w"}
    for n in s_t:
        assert rel(s_t[n][ks:ke], np.asarray(s_j[n])[ks:ke]) <= TOL, n
        assert rel(t_t[n][ks:ke], np.asarray(t_j[n])[ks:ke]) <= TOL, n


def test_neutral_k20_matches_tpu_kernels(andren):
    """K20 without thermo on ghost-filled fields vs fused_tendencies."""
    jm, tm, s, sfc, t = andren
    jfz = JF.FusedLES2(jm.ctx, jm.diff, jm.thermo, False, interpret=True,
                       force=jm.force, fold_ghosts=False)
    tfz = F.Fused(tm.ctx, tm.diff, tm.thermo, None, 0., ghosts=True,
                  force=tm.force, has_thermo=False)
    sj = jm.boundary.set_ghost_cells(jm.ctx, jx(s), jx(sfc))
    st = tm.boundary.set_ghost_cells(tm.ctx, tx(s), tx(sfc))
    auxj = JF.fused_exec_viscosity(jfz, jm.ctx, sj, jx(sfc), {})
    auxt = F.generic_viscosity(tfz, tm.ctx, st, tx(sfc), {})
    assert rel(auxt["evisc"], auxj["evisc"]) <= TOL
    ref = JF.fused_tendencies(jfz, jm.ctx, sj, jx(t), auxj, jx(sfc))
    tt = tx(t)
    F.tendencies(tfz, tm.ctx, st, tt, auxt, tx(sfc))
    for n in tt:
        assert rel(tt[n], ref[n]) <= TOL, n
