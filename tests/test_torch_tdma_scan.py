"""K3, the Thomas solve of pres_2 (``Pres2.tdma``, ``csrc/tdma.cu``), on the
CPU: the scan form that keeps a mode's column on chip.

* the constants of ``ops/pres_2.py`` for K3 are the ones in
  ``csrc/tdma.cu``, read from the source; every launch the plan can make
  fits a block and the SM in float32 and float64;
* the plan (``tdma_form``) at the main shapes, one chunk length a dtype,
  the sweep form where no TD_NCMAX chunks hold the column or where it is
  forced;
* ``scan``, a torch emulation of the kernel block by block with its own
  geometry (TD_MT modes by ceil(kmax / L) chunks of L levels, device memory
  flat and followed by NaN), equals ``tdma_plain`` to 1e-12 of each mode's
  maximum in float64 at kmax 6, 16, 24 and 100, on planes of 1035 modes
  (a partial tile) and of 144, at the chunk length of each dtype, and at
  TD_NCMAX chunks with the last one partial; each of its edge rules broken
  on its own (``broken=``) fails;
* the wrapper, with a recorder in place of the kernel: the plan's form or
  the forced sweep form;
* ``chip_smoke.py``'s K3 cases (every form) on the CPU.

The Thomas solve against the JAX package's Pallas kernel is
tests/test_torch_kernels_ref.py::test_k3_thomas_solve_matches_tpu_tdma_kernel.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import build_model, build_rico, mode_rel_err, tdma_cases
from microhh_torch import kernels
from microhh_torch.ops import pres_2 as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "microhh_torch", "csrc", "tdma.cu")
BROKEN = ("carry", "order", "last", "tile")


def source():
    with open(SRC) as f:
        return f.read()


def test_python_constants_are_the_source():
    src = source()
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (c["TD_MT"], c["TD_NCMAX"], c["TD_SWEEP_NT"]) == (
        P.TD_MT, P.TD_NCMAX, P.TD_SWEEP_NT)
    assert (c["TD_L_F32"], c["TD_L_F64"]) == (
        P.TD_L[torch.float32], P.TD_L[torch.float64])
    # six composite arrays of [TD_NCMAX][TD_MT] values and the table rows
    # of TD_NCMAX chunks, the smem of a form
    assert len(re.findall(r"\w\w\[TD_NCMAX\]\[TD_MT\]", src)) == 6
    assert "__shared__ T tb[3 * TD_NCMAX * L];" in src
    assert "__launch_bounds__(TD_MT * TD_NCMAX)\ntdma_scan_kernel" in src
    # one chunk length a type: the launch and the info take td_l<T>()
    assert "return sizeof(T) == 4 ? TD_L_F32 : TD_L_F64;" in src
    assert src.count("tdma_scan_kernel<T, td_l<T>()>") == 2
    # the loads before the first use: one read of x and winv a level, the
    # table through shared memory; a barrier after the copies and after
    # each sweep's composites
    body = src[src.index("tdma_scan_kernel(typename"):
               src.index("// sweep != 0: the sweep form")]
    assert body.count("x[") == 2 and body.count("winv") == 2
    assert len(re.findall(r"\btab\b", body)) == 2     # its name, one copy
    assert body.count("tb[") == 6                        # and five reads
    assert body.count("__syncthreads();") == 3
    # the entries: the sweep flag last; an info entry a form
    assert "int kmax, long long nmodes, int sweep," in src
    assert "mhh_tdma_info_##SUF(int sweep, int chunks, int* out)" in src
    assert "tdma" in kernels.INFO
    assert kernels.SIGNATURES["tdma"][-1] is ctypes.c_int


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_launch_fits(dtype):
    words = torch.empty((), dtype=dtype).element_size() // 4
    L = P.TD_L[dtype]
    for kmax in range(1, P.TD_NCMAX * L + 1):
        f = P.tdma_form(kmax, dtype)
        assert f.form == "scan" and f.L == L and f.chunks == -(-kmax // L)
        assert f.threads == P.TD_MT * f.chunks <= P.TD_MT * P.TD_NCMAX
        assert f.threads <= 1024 and f.smem <= 48 * 1024
        assert P.tdma_form(kmax, dtype, True) == ("sweep", 0, 1,
                                                  P.TD_SWEEP_NT, 0)
    # the column in registers (y and the pivot a level) within the 128 that
    # the launch bounds leave a thread, and a full block of those within an
    # SM's 65536
    assert 3 * L * words <= 96
    assert P.TD_MT * P.TD_NCMAX * 128 <= 65536
    # past TD_NCMAX chunks the plan takes the sweep form
    assert P.tdma_form(P.TD_NCMAX * L + 1, dtype).form == "sweep"


def test_plan_at_the_main_shapes():
    f32, f64 = torch.float32, torch.float64
    for kmax, chunks in ((512, 16), (384, 12), (288, 9), (256, 8), (24, 1)):
        f = P.tdma_form(kmax, f32)
        assert (f.form, f.L, f.chunks, f.threads) == ("scan", 32, chunks,
                                                      16 * chunks)
        assert f.smem == (6 * 16 + 3 * 32) * 32 * 4
    f = P.tdma_form(512, f64)
    assert (f.form, f.L, f.chunks) == ("scan", 16, 32)
    assert f.smem == (6 * 16 + 3 * 16) * 32 * 8
    assert P.tdma_form(1024, f32).form == "scan"
    for kmax, dtype in ((1025, f32), (513, f64)):
        f = P.tdma_form(kmax, dtype)
        assert (f.form, f.L, f.threads) == ("sweep", 0, P.TD_SWEEP_NT)
    assert P.tdma_form(24, f32, True).form == "sweep"
    assert P.tdma_form(100, f64).chunks == 7


# --------------------------------------------------------------------------
#  the scan form, emulated block by block
# --------------------------------------------------------------------------

def scan(x, winv, tab, L, broken=None):
    """K3's scan form on the spectrum x (kmax, jtot, nf), as
    tdma_scan_kernel<T, L> computes it: returns the solved spectrum.
    Device memory is flat, (k, mode), followed by NaN; a block is TD_MT
    modes by ceil(kmax / L) chunks, each thread its L levels in registers.
    broken: one edge rule left out, "carry" (every chunk's carry-in zero),
    "order" (the composites folded in the wrong order), "last" (a partial
    last chunk's levels past kmax read and written) or "tile" (a partial
    tile's modes past nmodes read and written)."""
    kmax, nm = x.shape[0], x.shape[1] * x.shape[2]
    n, pad = kmax * nm, (P.TD_MT + 1) * L * nm
    nan = float("nan")
    xr = torch.cat([x.real.reshape(-1), torch.full((pad,), nan,
                                                   dtype=winv.dtype)])
    xi = torch.cat([x.imag.reshape(-1), torch.full((pad,), nan,
                                                   dtype=winv.dtype)])
    wf = torch.cat([winv.reshape(-1), torch.full((pad,), nan,
                                                 dtype=winv.dtype)])
    nc = -(-kmax // L)
    lane = torch.arange(P.TD_MT)[:, None]              # (MT, 1)
    chunk = torch.arange(nc)[None, :]                  # (1, nc)
    tab0, tab1, tab2 = (torch.cat([tab[:, c], torch.full((L * nc,), nan,
                                                         dtype=tab.dtype)])
                        for c in range(3))
    zero = torch.zeros(P.TD_MT, nc, dtype=winv.dtype)
    for b in range(-(-nm // P.TD_MT)):
        m = b * P.TD_MT + lane
        live = (m < nm) | (broken == "tile")
        ks = [chunk * L + j for j in range(L)]          # (1, nc) each
        ok = [(k < kmax) | (broken == "last") for k in ks]
        yr, yi, w = [], [], []
        for k, o in zip(ks, ok):
            take = live & o
            off = torch.where(take, k * nm + m, 0)
            yr.append(torch.where(take, xr[off], zero))
            yi.append(torch.where(take, xi[off], zero))
            w.append(torch.where(take, wf[off], zero))
        # 1. the forward composites; beta in place of x
        a, r, i = zero + 1, zero.clone(), zero.clone()
        for j, (k, o) in enumerate(zip(ks, ok)):
            al = tab0[k] * w[j]
            yr[j] = torch.where(o, (yr[j] * tab2[k]) * w[j], yr[j])
            yi[j] = torch.where(o, (yi[j] * tab2[k]) * w[j], yi[j])
            r = torch.where(o, al * r + yr[j], r)
            i = torch.where(o, al * i + yi[j], i)
            a = torch.where(o, a * al, a)
        fa, fr, fi = a, r, i
        # 2. the carry-in from the chunks below, then y in place
        r, i = zero.clone(), zero.clone()
        for bb in (range(nc) if broken != "order" else range(nc - 1, -1, -1)):
            below = chunk > bb
            r = torch.where(below, fa[:, bb:bb + 1] * r + fr[:, bb:bb + 1], r)
            i = torch.where(below, fa[:, bb:bb + 1] * i + fi[:, bb:bb + 1], i)
        if broken == "carry":
            r, i = zero.clone(), zero.clone()
        for j, (k, o) in enumerate(zip(ks, ok)):
            al = tab0[k] * w[j]
            r = torch.where(o, al * r + yr[j], r)
            i = torch.where(o, al * i + yi[j], i)
            yr[j] = torch.where(o, r, yr[j])
            yi[j] = torch.where(o, i, yi[j])
        # 3. the backward composites
        a, r, i = zero + 1, zero.clone(), zero.clone()
        for j in range(L - 1, -1, -1):
            k, o = ks[j], ok[j]
            ga = tab1[k] * w[j]
            r = torch.where(o, yr[j] + ga * r, r)
            i = torch.where(o, yi[j] + ga * i, i)
            a = torch.where(o, a * ga, a)
        ba, br, bi = a, r, i
        # 4. the carry-in from the chunks above, then x written once
        r, i = zero.clone(), zero.clone()
        for bb in (range(nc - 1, -1, -1) if broken != "order" else range(nc)):
            above = chunk < bb
            r = torch.where(above, ba[:, bb:bb + 1] * r + br[:, bb:bb + 1], r)
            i = torch.where(above, ba[:, bb:bb + 1] * i + bi[:, bb:bb + 1], i)
        if broken == "carry":
            r, i = zero.clone(), zero.clone()
        for j in range(L - 1, -1, -1):
            k, o = ks[j], ok[j]
            ga = tab1[k] * w[j]
            r = torch.where(o, yr[j] + ga * r, r)
            i = torch.where(o, yi[j] + ga * i, i)
            put = (live & o).expand(P.TD_MT, nc)
            off = (k * nm + m).expand(P.TD_MT, nc)[put]
            xr[off] = r[put]
            xi[off] = i[put]
    return torch.complex(xr[:n], xi[:n]).reshape(x.shape)


def pivots(plane, kmax):
    """The pivots and table of a float64 Pres2 on the CPU: drycblles on a
    45^2 plane (1035 modes, a partial tile), rico's stretched grid and
    density on 16^2 (144 modes)."""
    if plane == 45:
        m = build_model(torch, 45, kmax, torch.float64, "cpu")
    else:
        m = build_rico(torch, 16, kmax, torch.float64, "cpu")
    m.build_step()
    return m.pres


@pytest.fixture(scope="module")
def solved():
    """(pres, spectrum, tdma_plain's solution) at each (plane, kmax)."""
    out = {}
    for plane in (45, 16):
        for kmax in (6, 16, 24, 100):
            pr = pivots(plane, kmax)
            rng = np.random.default_rng(plane + kmax)
            x = torch.fft.rfft2(torch.tensor(
                rng.standard_normal((kmax, plane, plane))), dim=(-2, -1))
            out[plane, kmax] = (pr, x, P.tdma_plain(x.clone(), pr.winv,
                                                    pr.tab))
    return out


def err(a, b):
    return mode_rel_err(torch.view_as_real(a), torch.view_as_real(b))


@pytest.mark.parametrize("kmax", [6, 16, 24, 100])
@pytest.mark.parametrize("plane", [45, 16])
def test_scan_is_the_thomas_solve(solved, plane, kmax):
    pr, x, want = solved[plane, kmax]
    for L in sorted(set(P.TD_L.values())):
        assert err(scan(x, pr.winv, pr.tab, L), want) <= 1e-12, L


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_at_the_most_chunks(dtype):
    # TD_NCMAX chunks of the dtype's length, the last holding L - 3 levels
    L = P.TD_L[dtype]
    kmax = P.TD_NCMAX * L - 3
    assert P.tdma_form(kmax, dtype).chunks == P.TD_NCMAX
    pr = pivots(16, kmax)
    rng = np.random.default_rng(kmax)
    x = torch.fft.rfft2(torch.tensor(rng.standard_normal((kmax, 16, 16))),
                        dim=(-2, -1))
    want = P.tdma_plain(x.clone(), pr.winv, pr.tab)
    assert err(scan(x, pr.winv, pr.tab, L), want) <= 1e-12


@pytest.mark.parametrize("broken", BROKEN)
def test_scan_needs_each_edge_rule(solved, broken):
    # 1035 modes: the last tile holds 11 of 16; 100 levels in seven chunks
    # of 16: the last holds 4
    pr, x, want = solved[45, 100]
    assert err(scan(x, pr.winv, pr.tab, 16), want) <= 1e-12
    bad = scan(x, pr.winv, pr.tab, 16, broken)
    assert not err(bad, want) <= 1e-6


# --------------------------------------------------------------------------
#  the wrapper, with a recorder in place of the kernel
# --------------------------------------------------------------------------

class Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, dtype, *args):
        self.calls.append((dtype, args))


def test_wrapper_launches_the_plans_form(solved, monkeypatch):
    pr, x, _ = solved[45, 100]
    monkeypatch.setattr(P, "on_cpu", lambda t: False)
    rec = Recorder()
    monkeypatch.setattr(pr, "k_tdma", rec)
    spec = x.clone()
    assert pr.tdma(spec) is spec
    assert pr.tdma(spec, True) is spec
    with pytest.raises(TypeError):
        pr.tdma(spec.to(torch.complex64))
    assert len(rec.calls) == 2
    for (dtype, a), sweep in zip(rec.calls, (0, 1)):
        assert dtype == torch.float64
        assert a[0] is spec and a[1] is pr.winv and a[2] is pr.tab
        assert a[3:] == (100, 45 * 23, sweep)


def test_chip_smoke_cases_run_on_the_cpu(solved):
    pr, x, want = solved[16, 100]
    cases = tdma_cases(torch, pr, x)
    # the plan's form (the scan form) and the sweep form
    assert len(cases) == 2
    for name, kern, plain, kind in cases:
        assert name == "tdma" and kind == "mode"
        assert err(torch.view_as_complex(kern()[0].contiguous()), want) == 0.
