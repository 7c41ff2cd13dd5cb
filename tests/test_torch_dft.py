"""The DFT pair K5/K6 of ``microhh_torch.ops.pres_2`` (``csrc/dft.cu``) and
the choice of its form.

* ``dft_form`` picks the cluster form, with the expected C and F, at every
  plane of the cells that take ``pres_2`` in float32, and the split form
  for a float64 512^2 plane; its shared-memory estimate (the launcher's
  formula) stays within the 227 KB a block can have wherever it picks the
  cluster form;
* on the CPU ``rfft2``/``irfft2`` run their plain versions: against
  ``numpy.fft`` at odd, prime and rectangular planes (float64, <= 1e-12 of
  the output's maximum), and ``irfft2`` leaves its argument as it was;
* the wrappers' checks and dispatch, with the kernels replaced by
  recorders: each form gets its own entry with its own arguments (C and F
  for the cluster form, a fresh scratch spectrum for the split form), and
  a wrong dtype, shape or mode count raises;
* on a card (marked ``gpu``; skipped without one): both forms against
  ``torch.fft`` and K6's input unchanged.
"""

import numpy as np
import pytest
import torch

from microhh_torch.dft_timing import make_pres
from microhh_torch.ops import pres_2
from microhh_torch.ops.pres_2 import SMEM_MAX, cluster_smem, dft_form

TOL = 1e-12

# (itot, jtot) of the pres_2 cells in float32 -> (C, F)
MAIN_PLANES = [((512, 512), (8, 8)),     # drycblles, sullivan2011
               ((384, 384), (4, 8)),     # rico (both schemes)
               ((768, 384), (8, 8)),     # neutral Ekman LES
               ((1024, 256), (8, 16)),   # jaenschwalde
               ((256, 256), (2, 16))]    # SBL_Smag, drycblles fold=False

ODD_PLANES = [(17, 13, 2), (13, 17, 1), (30, 18, 2), (48, 45, 3),
              (45, 48, 3), (100, 36, 1), (2, 9, 2), (64, 7, 2)]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("plane, want", MAIN_PLANES,
                         ids=["%dx%d" % p for p, _ in MAIN_PLANES])
def test_dft_form_of_main_planes(plane, want):
    itot, jtot = plane
    form = dft_form(jtot, itot, torch.float32)
    assert form.form == "cluster"
    assert (form.C, form.F) == want
    assert form.smem == cluster_smem(jtot, itot, form.C, form.F, 4)
    assert form.smem <= SMEM_MAX


def test_dft_form_splits_large_f64_planes():
    assert dft_form(512, 512, torch.float64).form == "split"
    assert dft_form(256, 1024, torch.float64).form == "split"
    assert dft_form(384, 768, torch.float64).form == "split"
    # the small planes of the float64 step checks stay on one CTA
    for jtot, itot in ((32, 32), (24, 48), (45, 45), (48, 48), (64, 64)):
        form = dft_form(jtot, itot, torch.float64)
        assert (form.form, form.C) == ("cluster", 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dft_form_fits_whenever_it_clusters(dtype):
    """Never more shared memory than a block can have; the smallest C that
    holds the plane with chunks of 8 modes, or where none does, the
    smallest C that holds it at all."""
    rb = torch.empty((), dtype=dtype).element_size()
    for jtot in (7, 64, 128, 250, 384, 511, 512, 768, 1024):
        for itot in (16, 63, 256, 510, 512, 768, 1024):
            form = dft_form(jtot, itot, dtype)
            if form.form == "split":
                assert all(cluster_smem(jtot, itot, C, 1, rb) > SMEM_MAX
                           for C in (1, 2, 4, 8))
                continue
            assert form.smem == cluster_smem(jtot, itot, form.C, form.F, rb)
            assert form.smem <= SMEM_MAX
            smaller = [C for C in (1, 2, 4, 8) if C < form.C]
            if form.F >= 8:
                assert all(cluster_smem(jtot, itot, C, 8, rb) > SMEM_MAX
                           for C in smaller)
            else:
                assert all(cluster_smem(jtot, itot, C, 8, rb) > SMEM_MAX
                           for C in (1, 2, 4, 8))
                assert all(cluster_smem(jtot, itot, C, 1, rb) > SMEM_MAX
                           for C in smaller)


@pytest.mark.parametrize("itot, jtot, kt", ODD_PLANES,
                         ids=["%dx%dx%d" % p for p in ODD_PLANES])
def test_plain_dft_matches_numpy(itot, jtot, kt):
    pr = make_pres(itot, jtot, kt)
    rng = np.random.RandomState(itot * jtot)
    x = rng.randn(kt, jtot, itot)
    y = pr.rfft2(torch.as_tensor(x))
    assert rel(y.numpy(), np.fft.rfft2(x)) <= TOL
    spec = np.fft.rfft2(rng.randn(kt, jtot, itot))
    back = pr.irfft2(torch.as_tensor(spec), itot)
    assert rel(back.numpy(), np.fft.irfft2(spec, s=(jtot, itot))) <= TOL
    assert rel(pr.irfft2(y, itot).numpy(), x) <= TOL


def test_plain_irfft2_leaves_its_argument():
    pr = make_pres(48, 45, 3)
    spec = torch.as_tensor(np.fft.rfft2(np.random.RandomState(3).randn(
        3, 45, 48)))
    before = spec.clone()
    pr.irfft2(spec, 48)
    assert torch.equal(spec, before)


class Recorder:
    """Stands in for a Kernel: records each call's dtype and arguments."""

    def __init__(self, name):
        self.name = name
        self.calls = []

    def __call__(self, dtype, *args):
        self.calls.append((dtype, args))


@pytest.fixture
def dispatch(monkeypatch):
    """A Pres2 whose wrappers take their kernel path on CPU tensors, with
    recorders in place of the four DFT kernels."""
    monkeypatch.setattr(pres_2, "on_cpu", lambda t: False)

    def make(itot, jtot, kt):
        pr = make_pres(itot, jtot, kt)
        for attr in ("k_dft_fwd", "k_dft_inv", "k_dft_fwd_split",
                     "k_dft_inv_split"):
            setattr(pr, attr, Recorder(getattr(pr, attr).name))
        return pr
    return make


def test_cluster_form_dispatch(dispatch):
    pr = dispatch(48, 45, 3)
    x = torch.zeros(3, 45, 48, dtype=torch.float32)
    y = pr.rfft2(x)
    assert y.shape == (3, 45, 25) and y.dtype == torch.complex64
    form = dft_form(45, 48, torch.float32)
    ((dtype, args),) = pr.k_dft_fwd.calls
    assert dtype == torch.float32 and args[0] is x and args[1] is y
    assert args[2:] == (3, 45, 48, form.C, form.F)
    out = pr.irfft2(y, 48)
    ((dtype, args),) = pr.k_dft_inv.calls
    assert args[0] is y and args[1] is out
    assert args[2:] == (3, 45, 48, form.C, form.F)
    assert out.shape == (3, 45, 48) and out.dtype == torch.float32
    assert not pr.k_dft_fwd_split.calls and not pr.k_dft_inv_split.calls
    assert pr.dft_kernels(torch.float32) == [pr.k_dft_fwd, pr.k_dft_inv]


def test_split_form_dispatch(dispatch):
    pr = dispatch(512, 512, 1)
    x = torch.zeros(1, 512, 512, dtype=torch.float64)
    y = pr.rfft2(x)
    ((_, args),) = pr.k_dft_fwd_split.calls
    assert args[0] is x and args[1] is y and args[2:] == (1, 512, 512)
    out = pr.irfft2(y, 512)
    ((_, args),) = pr.k_dft_inv_split.calls
    # y is read; the j pass writes a scratch spectrum of its own
    assert args[0] is y and args[2] is out and args[1] is not y
    assert args[1].shape == y.shape and args[1].dtype == y.dtype
    assert args[3:] == (1, 512, 512)
    assert not pr.k_dft_fwd.calls and not pr.k_dft_inv.calls
    assert pr.dft_kernels(torch.float64) == [pr.k_dft_fwd_split,
                                             pr.k_dft_inv_split]


def test_wrapper_checks_raise(dispatch):
    pr = dispatch(16, 12, 2)
    with pytest.raises(TypeError):
        pr.rfft2(torch.zeros(2, 12, 16, dtype=torch.float16))
    with pytest.raises(ValueError):
        pr.rfft2(torch.zeros(2, 16, 12, dtype=torch.float64).transpose(1, 2))
    y = torch.zeros(2, 12, 9, dtype=torch.complex128)
    with pytest.raises(ValueError):
        pr.irfft2(y, 15)
    with pytest.raises(TypeError):
        pr.irfft2(torch.zeros(2, 12, 9, dtype=torch.float64), 16)
    with pytest.raises(ValueError):
        pr.irfft2(torch.zeros(2, 9, 12, dtype=torch.complex128)
                  .transpose(1, 2), 16)
    assert not any(getattr(pr, a).calls for a in (
        "k_dft_fwd", "k_dft_inv", "k_dft_fwd_split", "k_dft_inv_split"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_torch_fft_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tol = 1e-5 if dtype == torch.float32 else TOL
    for itot, jtot, kt in ODD_PLANES + [(512, 512, 2)]:
        pr = make_pres(itot, jtot, kt)
        x = torch.as_tensor(np.random.RandomState(kt).randn(kt, jtot, itot),
                            dtype=dtype, device="cuda")
        y = pr.rfft2(x)
        assert rel(torch.view_as_real(y).cpu(),
                   torch.view_as_real(torch.fft.rfft2(x)).cpu()) <= tol
        before = y.clone()
        out = pr.irfft2(y, itot)
        assert torch.equal(y, before)
        assert rel(out.cpu(), torch.fft.irfft2(
            before, s=(jtot, itot)).cpu()) <= tol
