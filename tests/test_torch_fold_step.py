"""Whole RK3 steps of the three cases that take the folded dry sweep (K22),
the port's Model against the JAX Model in float64 on the CPU:

* A drycblles, B sullivan2011 (stats off) and C the neutral Ekman LES
  (andren1994 less its passive scalar: thermo 0, no scalar), each with
  ``build_step(fold=True)`` and ``fold=False``, two steps <= 1e-10 against the
  JAX package's tiled kernels with the evisc and rhs folds
  (``force_fused = True``, ``MICROHH_FUSED_VARIANT=tiled``, Pallas interpret
  mode, as tests/test_rkfold.py runs them), limits and diagnostics included;
  B also against its own substep without the RK fold;
* C against the JAX op path (``force_fused = False``) too: no test of the JAX
  package runs ``has_thermo=False`` through its kernels, so the op path is
  the first reference and the kernel path the second;
* ``Model.kernels()`` names K22 on A, B and C and neither K1 nor K4 rhs;
* thermo 0 with a scalar (andren1994 as written), ``swdiff=2`` or
  ``swadvec=2i5``: the path of the JAX package's gate, two steps against
  its op path.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import (DRYCBL_INI, andren_ini, build_andren, build_model,
                        build_sullivan, case_ini, initial_state,
                        unfolded_state)
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.utils import nc as jnc
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.model import Model
from test_torch_plain_o2 import initial_files
from test_torch_timedep import jax_run, port_run

N, KT = 16, 16

CASES = {
    "drycblles": (lambda: build_model(torch, N, KT, torch.float64, "cpu"),
                  DRYCBL_INI % {"n": N, "k": KT},
                  lambda m: initial_state(m, seed=5)),
    "sullivan2011": (lambda: build_sullivan(torch, (N, N), KT, torch.float64,
                                            "cpu"),
                     case_ini("sullivan2011", itot=N, jtot=N, ktot=KT,
                              swstats=0),
                     lambda m: unfolded_state(m, 3)),
    "andren1994": (lambda: build_andren(torch, (N, N), KT, torch.float64,
                                        "cpu"),
                   andren_ini((N, N), KT),
                   lambda m: unfolded_state(m, 3)),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def jax_model(tm, text, wd, fused):
    """The JAX Model of the same ini on the port model's input."""
    if tm.input_nc is not None:
        z = np.asarray(tm.input_nc.variables["z"][:])
        f = jnc.Dataset(os.path.join(wd, "%s_input.nc" % tm.casename), "w")
        f.createDimension("z", len(z))
        f.createVariable("z", "f8", ("z",))[:] = z
        g = f.createGroup("init")
        for name, var in tm.input_nc.groups["init"].variables.items():
            g.createVariable(name, "f8", ("z",))[:] = np.asarray(var[:])
        f.close()
    jm = JModel(JIni(text), "run", tm.casename, workdir=wd, dtype=np.float64)
    jm.force_fused = fused
    jm.finish_setup()
    jm.build_step()
    return jm


def jax_steps(jm, state, dts):
    """The JAX model's limits before, and fields, pressure and surface
    planes after, each step; then its diagnostics."""
    js, _, jsfc = jm.as_device_state({k: v.copy() for k, v in state.items()})
    out = []
    for dt in dts:
        lim = {k: float(v) for k, v in jm._limits_fn(js, jsfc).items()}
        js, jsfc, jaux = jm._step_fn(js, jsfc, jm.pres_params,
                                     jnp.float64(dt), jnp.float64(0.))
        out.append((lim, {n: np.asarray(a) for n, a in js.items()},
                    np.asarray(jaux["p"]),
                    {k: np.asarray(v) for k, v in jsfc.items()}))
    diag = {k: float(v) for k, v in jm._diag_fn(js, jsfc).items()}
    return out, diag


def hold_port_to(tm, state, dts, ref, diag):
    ts, tsfc = tm.as_device_state(state)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for dt, (lim, js, pj, jsfc) in zip(dts, ref):
        tlim = tm.limits(ts, tsfc)
        assert set(tlim) == set(lim)
        for k in lim:
            assert rel(float(tlim[k]), lim[k]) <= 1e-10, k
        ts, tsfc, taux = tm.step(ts, tsfc, dt)
        assert set(ts) == set(js)
        for n in ts:
            assert rel(ts[n][ks:ke], js[n][ks:ke]) <= 1e-10, n
        pj = pj[ks:ke] if pj.shape[0] == tm.ctx.kcells else pj
        assert rel(taux["p"], pj) <= 1e-10
        for k in tsfc:
            assert rel(tsfc[k], jsfc[k]) <= 1e-10, k
    td = tm.diagnostics(ts, tsfc)
    for k in ("mom", "tke", "mass"):
        assert rel(float(td[k]), diag[k]) <= 1e-10, k
    scale = float(ts["u"].abs().max()) * tm.ctx.dxi
    assert float(td["div"]) <= 1e-12 * scale
    return ts


@pytest.mark.parametrize("case", list(CASES))
def test_two_rk3_steps_match_jax_fold_on_and_off(case, tmp_path, monkeypatch):
    build, text, state_of = CASES[case]
    monkeypatch.setenv("MICROHH_FUSED_VARIANT", "tiled")
    dts = (2.0, 3.0)
    models = {}
    for fold in (True, False):
        tm = build()
        tm.build_step(fold=fold)
        assert tm.fold == fold and not tm.unfolded and not tm.generic
        names = [k.name for k in tm.kernels()]
        if fold:
            assert names[0] == "tend_rk_fold"
            assert not {"evisc", "tend_rk", "pres_rhs"} & set(names)
        else:
            assert names[:3] == ["evisc", "tend_rk", "pres_rhs"]
        models[fold] = tm
    tm = models[True]
    state = state_of(tm)
    jm = jax_model(tm, text, str(tmp_path), True)
    fz = jm._fused
    assert jm._use_rkfold and fz.tiled and fz.fold_ghosts and fz.fold_evisc
    assert fz.has_thermo == (case != "andren1994") == tm.fused.has_thermo
    assert fz.fold_coriolis == (case != "drycblles") == tm.fused.coriolis
    ref, diag = jax_steps(jm, state, dts)
    ends = {fold: hold_port_to(m, state, dts, ref, diag)
            for fold, m in models.items()}
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ends[True]:        # the port's two forms against each other
        assert rel(ends[True][n][ks:ke], ends[False][n][ks:ke]) <= 1e-12, n
    if case == "sullivan2011":
        # and against its own substep without the RK fold (K20)
        um = build()
        um.build_step(unfolded=True)
        assert um.unfolded and "tendencies" in [k.name for k in um.kernels()]
        hold_port_to(um, state, dts, ref, diag)


def test_neutral_les_matches_the_jax_op_path(tmp_path):
    """C against the JAX package without its kernels, all three of the
    port's forms: K22, K1 -> K2 -> K4 rhs, and the unfolded substep (K20)."""
    build, text, state_of = CASES["andren1994"]
    dts = (2.0, 3.0)
    forms = []
    for kw in ({}, {"fold": False}, {"unfolded": True}):
        tm = build()
        tm.build_step(**kw)
        forms.append(tm)
    state = state_of(forms[0])
    jm = jax_model(forms[0], text, str(tmp_path), False)
    assert jm._fused is None
    ref, diag = jax_steps(jm, state, dts)
    assert float(np.abs(ref[-1][1]["v"]).max()) > 0.
    for tm in forms:
        hold_port_to(tm, state, dts, ref, diag)


def test_check_slice_for_thermo_0(tmp_path):
    """Thermo 0 at order 2 with a scalar, another diffusion or another
    advection: each builds, takes the path of the JAX package's gate and
    matches its op path over two steps.  andren1994 as written (with
    slist=s) takes the generic kernels (K1 unstratified, K8/K9, K15: the
    JAX package's thermo 0 has a get_n2), swdiff=2 the plain substep,
    swadvec=2i5 the generic kernels after K12/K13.  Without any of these
    the neutral LES keeps K22."""
    written = case_ini("andren1994", itot=8, jtot=8, ktot=8)
    assert "slist=s" in written
    neutral = andren_ini((8, 8), 8)
    assert "slist" not in neutral and "[s]" not in neutral
    for label, text, plain, names in (
            ("as_written", written, False,
             ["evisc", "tend_uvw", "tend_scalar_rk", "pres_rhs", "dft_fwd",
              "tdma", "dft_inv", "pres_apply", "limits"]),
            ("swdiff_2", neutral.replace("swdiff=smag2", "swdiff=2"), True,
             ["dft_fwd", "tdma_ri", "dft_inv"]),
            ("swadvec_2i5", neutral.replace("swadvec=2", "swadvec=2i5"),
             False, ["evisc", "advec_mom", "tend_uvw", "pres_rhs", "dft_fwd",
                     "tdma", "dft_inv", "pres_apply", "limits"])):
        mem = cases.andren1994_input(8)
        jdir, tdir = initial_files(tmp_path / label, "andren1994", text, mem)
        jm, js = jax_run(jdir, "andren1994", text, 2)
        tm, ts = port_run(tdir, "andren1994", text, mem, 2)
        assert jm._fused is None
        assert tm.plain == plain and tm.generic
        assert [k.name for k in tm.kernels()] == names, label
        ks, ke = tm.ctx.ks, tm.ctx.ke
        for n in tm.fields.prognostic_names:
            assert rel(ts[n][ks:ke], js[n][ks:ke]) <= 1e-10, (label, n)
    m = Model(Ini(neutral), "run", "andren1994", dtype=torch.float64,
              device="cpu", input_nc=cases.andren1994_input(8))
    m.finish_setup()
    m.build_step()
    assert m.fold and m.skip_force and not m.fused.has_thermo
    assert [k.name for k in m.kernels()] == [
        "tend_rk_fold", "dft_fwd", "tdma", "dft_inv", "pres_apply", "limits"]
