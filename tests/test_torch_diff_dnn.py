"""The port's DNN subgrid closure (``microhh_torch/models/dnn.py``,
``ops/diff_dnn.py``, ``ops/diff_2.py``) and the plain 2nd-order substep it
runs on, against the JAX package, float64 on the CPU:

* ``TauDNN`` against the JAX ``TauDNN`` and against the torch convolution
  form of the reference network (<= 1e-12); the weights carried across by
  ``from_arrays`` and drawn by ``random`` bit for bit, float32 numbers in a
  float64 run as in the JAX package; the TorchScript, plain-convolution and
  ``.npz`` loaders; a missing ``dnnpath`` is an error;
* the stresses ``Tau`` of the three variants with ``swdeviatoric`` on and
  off against ``DiffDNN._calc_tau`` and (dnn_local) the loop oracle of
  ``test_oracle_dnn_tau.py`` (<= 1e-12); blocked against one block (<=
  1e-14);
* ``DiffDNN.exec_viscosity`` and ``exec`` (the eddy viscosity, Tau and the
  tendencies) on a seeded state (<= 1e-12);
* two RK3 steps of SBL_DNN, SBL_DNNglobalScales and SBL_DNNstatsScales at
  16^2 x 32, limits and diagnostics included, against the JAX ``Model``
  (<= 1e-10);
* ``diff_c``, ``diff_w`` and ``Diff2`` against ``microhh_tpu/ops/diff_2.py``;
* SBL_DNN as written (statistics and dumps on) at 16^2 x 32 through both
  packages' ``run_case``: the same statistics file, without an ``evisc``
  profile, and the same dumps; the CLI with a TorchScript ``dnnpath``.

Inputs are made from a seed with numpy and copied to each side."""

import os
import re
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import SBL_ZSIZE, case_ini, read_stats, sbl_state, stats_agree
from test_oracle_dnn_tau import calc_tau_ref
from test_torch_buoy import _two_steps_match, write_sbl_input
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.models.dnn import TauDNN as JTauDNN
from microhh_tpu.ops import diff_2 as J2
from microhh_torch.cases import sbl_input
from microhh_torch.config import Ini
from microhh_torch.model import Model, run_case
from microhh_torch.models.dnn import (PINV, TauDNN, export_torchscript,
                                      random_filters)
from microhh_torch.ops import diff_2 as T2
from microhh_torch.ops.diff_dnn import DiffDNN

CASES = {"dnn_local": "SBL_DNN", "dnn_global": "SBL_DNNglobalScales",
         "dnn_stats": "SBL_DNNstatsScales"}
N, KT = 16, 32
DIMS = [108, 64, 64, 64, 64, 6]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def T(a):
    return torch.tensor(np.array(a, dtype=np.float64))


def sbl_dnn_ini(variant, n=N, k=KT, deviatoric=None, **over):
    """cases/<SBL_DNN case>/SBL.ini at n^2 x k with statistics and dumps
    off unless given."""
    over = dict(dict(itot=n, jtot=n, ktot=k, swstats=0, swdump=0), **over)
    text = case_ini(CASES[variant], "SBL", **over)
    if deviatoric is not None:
        text = text.replace("[diff]", "[diff]\nswdeviatoric=%d"
                            % int(deviatoric))
    return text


def models(wd, text, k=KT):
    """The JAX and the port's Model of one ini, float64; the port's with its
    step built (the closure's kernels bound)."""
    write_sbl_input(wd, k)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = JModel(JIni(text), "run", "SBL", workdir=wd, dtype=np.float64)
        tm = Model(Ini(text), "run", "SBL", dtype=torch.float64,
                   device="cpu", input_nc=sbl_input(k, SBL_ZSIZE))
    jm.finish_setup()
    tm.finish_setup()
    tm.build_step()
    return jm, tm


def seeded_sfc(tm, seed):
    """Surface planes with seeded MO gradients and fluxes (stable: dbdz_mo
    > 0)."""
    sfc = tm.boundary.init_surface_state()
    rng = np.random.RandomState(seed)
    for name in ("dudz_mo", "dvdz_mo", "u_fluxbot", "v_fluxbot",
                 "b_fluxbot"):
        sfc[name] = 0.01 * rng.randn(*sfc[name].shape)
    sfc["dbdz_mo"] = 1e-4 * rng.rand(*sfc["dbdz_mo"].shape)
    return sfc


# --------------------------------------------------------------------------
#  the network
# --------------------------------------------------------------------------

def test_taudnn_matches_jax_and_the_conv_form():
    """The matmul chain against the JAX TauDNN on the same weights, and
    against torch's Conv2d(3x3 valid) + 1x1 convolutions on 3x3 patches,
    which checks the patch's flattening order."""
    jnet = JTauDNN.random(seed=4)
    ws = [np.asarray(w) for w in jnet.weights]
    net = TauDNN.from_arrays(ws, np.asarray(jnet.change_basis),
                             dtype=torch.float64)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 108)
    out = net(T(x)).numpy()
    assert out.shape == (64, 6)
    assert rel(out, np.asarray(jnet(jnp.asarray(x)))) <= 1e-12

    layers = []
    for i, w in enumerate(ws):
        kh = 3 if i == 0 else 1
        conv = torch.nn.Conv2d(DIMS[i] if i else 12, DIMS[i + 1], kh,
                               bias=False).double()
        with torch.no_grad():
            conv.weight.copy_(T(w).reshape(conv.weight.shape))
        layers += [conv, torch.nn.ReLU()]
    seq = torch.nn.Sequential(*layers[:-1])
    with torch.no_grad():
        ref = seq(T(x).reshape(64, 12, 3, 3))[:, :, 0, 0] @ T(PINV).T
    assert rel(out, ref.numpy()) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_weights_carried_across_bit_for_bit(dtype):
    """random() draws the JAX package's weights, from_arrays carries its
    arrays, and both hold float32 numbers in the run's dtype: a float64 run
    rounds the float64 draws to float32, as the JAX closure does."""
    jnet = JTauDNN.random(seed=7)
    for net in (TauDNN.random(seed=7, dtype=dtype),
                TauDNN.from_arrays([np.asarray(w) for w in jnet.weights],
                                   dtype=dtype)):
        assert len(net.weights) == len(jnet.weights) == 5
        for a, b in zip(net.weights, jnet.weights):
            assert a.dtype == dtype and a.shape == b.shape
            assert np.array_equal(a.double().numpy(),
                                  np.asarray(b, dtype=np.float64))
        assert np.array_equal(net.change_basis.double().numpy(),
                              np.asarray(jnet.change_basis, np.float64))
    # the draws themselves are float64: the port keeps their float32 values
    rng = np.random.RandomState(7)
    w0 = rng.randn(64, 108) * np.sqrt(2. / 108) * 0.1
    got = TauDNN.random(seed=7, dtype=dtype).weights[0].double().numpy()
    assert not np.array_equal(got, w0)
    assert np.array_equal(got, w0.astype(np.float32).astype(np.float64))


def export(path, seed):
    """Seeded float32 filters and change of basis saved as a CNDNNExport."""
    filts = random_filters(seed, scale=0.3)
    cb = np.random.RandomState(seed + 100).randn(6, 6).astype(np.float32)
    export_torchscript(path, filts, cb)
    return filts, cb


def test_torchscript_round_trip(tmp_path):
    """from_torchscript (and load, and an .npz of the same arrays) take the
    export's filters and change of basis as the JAX loader takes them, bit
    for bit; the float32 network agrees with the export's own forward."""
    pt = str(tmp_path / "cndnn.pt")
    filts, cb = export(pt, 3)
    jnet = JTauDNN.from_torchscript(pt)
    np.savez(str(tmp_path / "cndnn.npz"), change_basis=cb,
             **{"w%d" % i: f.reshape(f.shape[0], -1)
                for i, f in enumerate(filts)})
    for net in (TauDNN.from_torchscript(pt, dtype=torch.float64),
                TauDNN.load(pt, dtype=torch.float64),
                TauDNN.load(str(tmp_path / "cndnn.npz"),
                            dtype=torch.float64)):
        for a, b in zip(net.weights, jnet.weights):
            assert np.array_equal(a.numpy(), np.asarray(b, np.float64))
        assert np.array_equal(net.change_basis.numpy(),
                              np.asarray(cb, np.float64))
    rng = np.random.RandomState(1)
    x = rng.randn(64, 12, 3, 3).astype(np.float32)
    with torch.no_grad():
        ref = torch.jit.load(pt)(torch.from_numpy(x)).numpy()
    out = TauDNN.from_torchscript(pt)(torch.from_numpy(x.reshape(64, -1)))
    assert rel(out.numpy(), ref) <= 1e-5
    x64 = x.reshape(64, -1).astype(np.float64)
    assert rel(net(T(x64)).numpy(), np.asarray(jnet(jnp.asarray(x64)))) \
        <= 1e-12


def test_torchscript_plain_conv_fallback(tmp_path):
    """A plain torch.nn Conv2d export (no 'filter' buffers) loads through
    the 4-D weight parameters, with P^-1 as its change of basis."""
    rng = np.random.RandomState(5)
    tmodel = torch.nn.Sequential(
        torch.nn.Conv2d(12, 10, 3, bias=False), torch.nn.ReLU(),
        torch.nn.Conv2d(10, 6, 1, bias=False)).eval()
    with torch.no_grad():
        for mod in tmodel.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.weight.copy_(torch.from_numpy(
                    rng.randn(*mod.weight.shape).astype(np.float32) * 0.3))
    pt = str(tmp_path / "plain.pt")
    torch.jit.script(tmodel).save(pt)
    net = TauDNN.from_torchscript(pt, dtype=torch.float64)
    jnet = JTauDNN.from_torchscript(pt)
    for a, b in zip(net.weights, jnet.weights):
        assert np.array_equal(a.numpy(), np.asarray(b, np.float64))
    x = rng.randn(16, 12, 3, 3)
    with torch.no_grad():
        ref = tmodel.double()(T(x))[:, :, 0, 0] @ T(PINV).T
    assert rel(net(T(x.reshape(16, -1))).numpy(), ref.numpy()) <= 1e-12


def test_missing_dnnpath_is_an_error(tmp_path):
    """A missing dnnpath raises unless swdnnrandom=1, which warns and takes
    the JAX package's seeded random weights."""
    with pytest.raises(ValueError, match="dnnpath"):
        TauDNN.load(str(tmp_path / "absent.pt"))
    with pytest.raises(ValueError, match="dnnpath"):
        TauDNN.load("")
    with pytest.warns(UserWarning, match="RANDOM"):
        net = TauDNN.load("", allow_random=True)
    for a, b in zip(net.weights, JTauDNN.random().weights):
        assert np.array_equal(a.numpy(), np.asarray(b))
    text = sbl_dnn_ini("dnn_local").replace("swdnnrandom=1", "swdnnrandom=0")
    with pytest.raises(ValueError, match="dnnpath"):
        Model(Ini(text), "run", "SBL", dtype=torch.float64, device="cpu",
              input_nc=sbl_input(KT, SBL_ZSIZE))


# --------------------------------------------------------------------------
#  the closure
# --------------------------------------------------------------------------

def tau_inputs(tm, seed):
    """Seeded filtered fields and energies (kcells, jtot, itot), the
    energies positive."""
    g = tm.grid
    shape = (g.kcells, g.jtot, g.itot)
    rng = np.random.RandomState(seed)

    def fld(scale, positive=False):
        a = rng.randn(*shape) * scale
        return np.abs(a) + 0.05 * scale if positive else a

    return ([fld(0.1), fld(0.1), fld(0.05), fld(0.01)]
            + [fld(1e-3, True) for _ in range(4)] + [fld(1e-4, True)])


@pytest.mark.parametrize("deviatoric", [True, False])
@pytest.mark.parametrize("variant", sorted(CASES))
def test_calc_tau_matches_jax_and_oracle(variant, deviatoric, tmp_path):
    """Tau of one seeded input against DiffDNN._calc_tau and, for
    dnn_local, the point-by-point transliteration of calc_Tau."""
    jm, tm = models(str(tmp_path),
                    sbl_dnn_ini(variant, 8, 16, deviatoric=deviatoric), 16)
    assert tm.diff.swdeviatoric == deviatoric == jm.diff.swdeviatoric
    arrs = tau_inputs(tm, 7)
    tau = tm.diff._calc_tau(tm.ctx, *[T(a) for a in arrs]).numpy()
    ref = np.asarray(jm.diff._calc_tau(jm.ctx, *[jnp.asarray(a)
                                                 for a in arrs]))
    kBL = tm.diff.kendBL(tm.ctx)
    assert tau.shape == ref.shape == (6, kBL - tm.ctx.ks - 2, 8, 8)
    assert rel(tau, ref) <= 1e-12
    if variant == "dnn_local":
        g = tm.grid
        oracle = calc_tau_ref(tm.diff.net, *arrs, deviatoric, g.dz,
                              g.kstart, kBL, g.jtot, g.itot)
        assert rel(tau, oracle) <= 1e-12


@pytest.mark.parametrize("variant", sorted(CASES))
def test_blocked_tau_matches_one_block(variant, tmp_path):
    """The network over blocks of 1, 3 and 7 levels (the last block short)
    gives the stresses of one block of all levels."""
    _, tm = models(str(tmp_path), sbl_dnn_ini(variant, 8, 24), 24)
    args = [T(a) for a in tau_inputs(tm, 11)]
    whole = tm.diff._calc_tau(tm.ctx, *args)
    assert whole.shape[1] == 16
    for block in (1, 3, 7):
        assert rel(tm.diff._calc_tau(tm.ctx, *args, block=block), whole) \
            <= 1e-14


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    jm, tm = models(str(tmp_path_factory.mktemp("dnn")),
                    sbl_dnn_ini(request.param))
    return request.param, jm, tm


def test_exec_matches_jax(pair):
    """exec_viscosity (K14's plain version with its MOST row, Tau) and exec
    (the stress divergence, the scalar's Smagorinsky diffusion, molecular
    momentum) on a seeded ghost-filled state; the closure's share of the
    momentum tendencies is not negligible."""
    variant, jm, tm = pair
    assert isinstance(tm.diff, DiffDNN) and tm.diff.variant == variant
    assert tm.plain and tm.diff.fused is tm.fused
    assert not hasattr(tm.diff, "cs")
    state = sbl_state(tm, 5)
    sfc = seeded_sfc(tm, 8)
    sj = jm.boundary.set_ghost_cells(
        jm.ctx, {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in sfc.items()})
    st = tm.boundary.set_ghost_cells(tm.ctx, {k: T(v) for k, v in
                                              state.items()},
                                     {k: T(v) for k, v in sfc.items()})
    sfcj = {k: jnp.asarray(v) for k, v in sfc.items()}
    sfct = {k: T(v) for k, v in sfc.items()}
    aj = jm.diff.exec_viscosity(jm.ctx, sj, sfcj, {})
    at = tm.diff.exec_viscosity(tm.ctx, st, sfct, {})
    assert rel(at["evisc"], aj["evisc"]) <= 1e-12
    assert rel(at["Tau"], aj["Tau"]) <= 1e-12
    rng = np.random.RandomState(9)
    t = {n: 1e-4 * rng.randn(*state[n].shape) for n in state}
    # the closure's stresses, and seeded ones of a size that makes their
    # divergence the larger part of the momentum tendencies (dnn_global's
    # random network gives stresses of its stress scale, Ug^2/Re ~ 1e-6)
    tau = 1e-2 * rng.randn(*at["Tau"].shape)
    for taus in ((aj["Tau"], at["Tau"]), (jnp.asarray(tau), T(tau))):
        tj = jm.diff.exec(jm.ctx, sj, {k: jnp.asarray(v) for k, v in
                                       t.items()}, dict(aj, Tau=taus[0]), sfcj)
        tt = tm.diff.exec(tm.ctx, st, {k: T(v) for k, v in t.items()},
                          dict(at, Tau=taus[1]), sfct)
        for n in t:
            assert rel(tt[n], tj[n]) <= 1e-12, n
    t0 = tm.diff.exec(tm.ctx, st, {k: T(v) for k, v in t.items()},
                      dict(at, Tau=torch.zeros_like(at["Tau"])), sfct)
    for n in ("u", "v", "w"):
        assert rel(t0[n], tt[n]) > 0.5, n


def test_two_rk3_steps_match_jax(pair):
    """Two RK3 steps on the plain substep (K14, the closure, advec_2, the
    sponge and the geostrophic forcing, K5 -> K21 -> K6) against the JAX
    Model's plain substep, the limits from K7 against its cfl_max +
    exec_viscosity + get_dn."""
    _, jm, tm = pair
    jm.build_step()
    assert jm._fused is None
    assert [k.name for k in tm.kernels()] == [
        "evisc_n2", "dft_fwd", "tdma_ri", "dft_inv", "limits"]
    assert not tm.device_dt()
    _two_steps_match(jm, tm, sbl_state(tm, 3), (1.0, 0.5),
                     {"cfl_rate", "dn_rate"})


# --------------------------------------------------------------------------
#  diff_2
# --------------------------------------------------------------------------

def test_diff_2_matches_jax(pair):
    """diff_c, diff_w and Diff2's exec and diffusion number against
    microhh_tpu/ops/diff_2.py."""
    _, jm, tm = pair
    state = sbl_state(tm, 4)
    sj = {k: jnp.asarray(v) for k, v in state.items()}
    st = {k: T(v) for k, v in state.items()}
    for name in ("u", "b"):
        assert rel(T2.diff_c(tm.ctx, st[name], 1.5e-5),
                   J2.diff_c(jm.ctx, sj[name], 1.5e-5)) <= 1e-12
    assert rel(T2.diff_w(tm.ctx, st["w"], 1.5e-5),
               J2.diff_w(jm.ctx, sj["w"], 1.5e-5)) <= 1e-12
    jd = J2.Diff2(JIni(sbl_dnn_ini("dnn_local")), jm.grid, jm.fields)
    td = T2.Diff2(Ini(sbl_dnn_ini("dnn_local")), tm.grid, tm.fields)
    assert td.dnmul == jd.dnmul and td.dnmax == jd.dnmax
    assert float(td.get_dn(tm.ctx, st, {})) == float(jd.get_dn(jm.ctx, sj,
                                                               {}))
    assert td.exec_viscosity(tm.ctx, st, None, {"x": 1}) == {"x": 1}
    rng = np.random.RandomState(2)
    t = {n: 1e-4 * rng.randn(*state[n].shape) for n in state}
    a = jd.exec(jm.ctx, sj, {k: jnp.asarray(v) for k, v in t.items()}, {})
    b = td.exec(tm.ctx, st, {k: T(v) for k, v in t.items()}, {})
    for n in t:
        assert rel(b[n], a[n]) <= 1e-12, n


# --------------------------------------------------------------------------
#  SBL_DNN as written
# --------------------------------------------------------------------------

def sbl_dnn_dir(path):
    """SBL_DNN as written (statistics and the u, v, w, b dumps on) at
    16^2 x 32, to 2 s with a sample every second."""
    os.makedirs(path)
    text = case_ini("SBL_DNN", "SBL", itot=N, jtot=N, ktot=KT, endtime=2,
                    savetime=2, sampletime=1)
    with open(os.path.join(path, "SBL.ini"), "w") as f:
        f.write(text)
    return path


def test_sbl_dnn_run_matches_jax(tmp_path):
    """Both packages' run_case of SBL_DNN as written at 16^2 x 32: the same
    statistics (no evisc profile: the closure has no Smagorinsky
    coefficient) <= 1e-10 of their scale, and the same dumps and
    restarts."""
    twd = sbl_dnn_dir(str(tmp_path / "t"))
    jwd = sbl_dnn_dir(str(tmp_path / "j"))
    write_sbl_input(jwd, KT)
    from microhh_tpu.model import run_case as jrun_case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for mode in ("init", "run"):
            run_case(twd, "SBL", mode, dtype=torch.float64, device="cpu",
                     input_nc=sbl_input(KT, SBL_ZSIZE))
        for mode in ("init", "run"):
            jrun_case(jwd, "SBL", mode, dtype=np.float64)
    name = "SBL.default.0000000.nc"
    a = read_stats(os.path.join(twd, name))
    b = read_stats(os.path.join(jwd, name))
    assert list(b["time"]) == [0., 1., 2.]
    assert ("default", "b") in b and ("default", "evisc") not in b
    errs = stats_agree(a, b, "SBL_DNN")
    assert max(errs.values()) <= 1e-10, max(errs.items(), key=lambda kv: kv[1])
    pattern = re.compile(r"^[uvwb]\.\d{7}$")
    files = sorted(f for f in os.listdir(jwd) if pattern.match(f))
    assert sorted(f for f in os.listdir(twd) if pattern.match(f)) == files
    assert "b.0000010" in files and "u.0000020" in files
    for fname in files:
        x = np.fromfile(os.path.join(twd, fname))
        y = np.fromfile(os.path.join(jwd, fname))
        assert x.shape == y.shape
        assert np.abs(x - y).max() <= 1e-10 * np.abs(y).max(), fname


def test_cli_sbl_dnn_with_torchscript_weights(tmp_path):
    """python -m microhh_torch init/run of SBL_DNN on the CPU with its
    dnnpath set to a TorchScript export and swdnnrandom=0."""
    from microhh_torch.__main__ import main
    pt = str(tmp_path / "weights.pt")
    export(pt, 2)
    text = case_ini("SBL_DNN", "SBL", itot=8, jtot=8, ktot=16, swstats=0,
                    swdump=0, endtime=2, savetime=2, dnnpath=pt,
                    swdnnrandom=0)
    (tmp_path / "SBL.ini").write_text(text)
    write_sbl_input(str(tmp_path), 16)
    argv = ["SBL", "--dir", str(tmp_path), "--device", "cpu",
            "--precision", "double"]
    main(["init"] + argv)
    main(["run"] + argv)
    rows = [line.split() for line in open(tmp_path / "SBL.out")
            if line.split()[0].isdigit()]
    assert [int(r[0]) for r in rows] == [0, 1, 2]
    assert all(np.isfinite(float(x)) for r in rows for x in r)
    assert (tmp_path / "b.0000020").exists()


def test_random_filters_are_the_validation_draw():
    """random_filters(7) draws what cases/run_validation.py's sbl_dnn leg
    exports (its loop, repeated here)."""
    rng = np.random.RandomState(7)
    want = []
    for i in range(len(DIMS) - 1):
        scale = np.sqrt(2. / DIMS[i]) * 0.1
        kh = 3 if i == 0 else 1
        cin = 12 if i == 0 else DIMS[i]
        want.append((rng.randn(DIMS[i + 1], cin, kh, kh)
                     * scale).astype(np.float32))
    got = random_filters(7)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_sbl_input_serves_the_dnn_cases():
    """The three DNN cases ship SBL_Smag's SBL_input.py byte for byte, so
    cases.case_input("SBL", ...) (sbl_input, held against that script in
    test_torch_buoy.py) is their input."""
    from microhh_torch.cases import case_input
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cases")

    def script(case):
        with open(os.path.join(root, case, "SBL_input.py"), "rb") as f:
            return f.read()
    for case in CASES.values():
        assert script(case) == script("SBL_Smag"), case
    a, b = case_input("SBL", KT, SBL_ZSIZE), sbl_input(KT, SBL_ZSIZE)
    assert np.array_equal(np.asarray(a.variables["z"][:]),
                          np.asarray(b.variables["z"][:]))
    for name, v in b.groups["init"].variables.items():
        assert np.array_equal(np.asarray(a.groups["init"].variables[name][:]),
                              np.asarray(v[:])), name
