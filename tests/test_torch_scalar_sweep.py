"""The scalar sweep K10 (``FusedGeneric.tend_scalars``, with the RK fold) and
K19 (``FusedGeneric.tend_scalars_acc``, without): one k-marching kernel,
``scalar_sweep_kernel`` in ``csrc/tend_generic.cu``, on the CPU.

* the constants and the shared-memory formula of ``ops/kmarch.py`` for the
  sweep are the ones in ``csrc/tend_generic.cu``, ``csrc/kmarch.cuh`` and
  ``csrc/les_math.cuh``, read from the sources; every launch of up to
  SW_MAXS scalars fits a block, and as many blocks as its launch bounds
  ask fit an SM, in float32 and float64, both forms, advection on and off;
* the plan at the main shapes (rico 384^3 with four scalars, jaenschwalde
  1024x256x256 with three);
* a torch emulation of the chunked march equals the plain versions bit for
  bit in float64 at ktot 6 and 16, for every chunk count, both forms and
  advection on and off: each chunk runs the plain version on the planes
  and table rows the chunk's blocks load (the scalars and evisc at
  ks+k0-1 .. ks+k1, u and v at the chunk's levels, w at its levels and
  one above, the carries at its levels), everything else NaN, and without
  advection u, v and w NaN everywhere;
* the wrappers, with recorders in place of the kernels: one launch for up
  to four scalars and two for six, each with its plan's chunk count and
  its share of the tables, null u, v, w pointers without advection, and
  one scalar launch a substep in ``generic_tendencies``.

The all-scalars K19 call against the JAX package's ``tend_scalar`` in
interpret mode is in tests/test_torch_unfolded.py (its jaenschwalde
fixture).
"""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import build_jaenschwalde, build_rico
from microhh_torch.ops import fused as F
from microhh_torch.ops import kmarch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "microhh_torch", "csrc")
KINDS = ("tend_scalars", "tend_scalar_acc")


def source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def constants(src):
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_python_constants_are_the_sources():
    src = source("tend_generic.cu")
    c = constants(src)
    assert (c["SW_TJ"], c["SW_HALO"], c["SW_R"], c["SW_MAXS"], c["NTGP"]) == (
        kmarch.SW_TJ, kmarch.SW_HALO, kmarch.SW_R, kmarch.SW_MAXS,
        kmarch.NTGP)
    assert re.search(r"SW_NT = km::TI \* SW_TJ;", src)
    # the table width: the T_* enum of les_math.cuh and ops/fused.py
    enum = re.search(r"enum \{\s*(T_DZI[^}]*)\}", source("les_math.cuh"))
    cols = [x.split("=")[0].strip() for x in enum.group(1).split(",")]
    assert cols[-1] == "NTG"
    ntg = len([x for x in cols if x not in ("NT", "NTG")])
    assert ntg == kmarch.NTG == F.NTG <= kmarch.NTGP
    # the shared-memory formula and the slot with its halo
    flat = re.sub(r"\s+", " ", src)
    assert ("((size_t)(S + 1 + (ADV ? 2 : 0)) * SW_R * km::Slot<SW_TJ, "
            "SW_HALO>::SIZE + (size_t)SW_R * (RK ? S : 1) * NTGP) * sizeof(T)"
            in flat)
    km = source("kmarch.cuh")
    assert "template <int TJ, int HALO = H>\nstruct Slot {" in km
    assert "static constexpr int ROWS = TJ + 2 * HALO;" in km
    assert "template <typename T, int TJ, int NT, int HALO = H>" in km
    assert kmarch.slot_size(8, 1) == 10 * kmarch.RS
    assert kmarch.slot_size(8) == kmarch.slot_size(8, kmarch.H)
    # the launch bounds the blocks an SM below assume
    assert "sizeof(T) == 4 ? (S <= 2 ? 4 : 3) : 2)\nscalar_sweep_kernel" in src


def blocks_asked(S, dtype):
    """Blocks an SM the kernel's launch bounds ask for."""
    if dtype == torch.float64:
        return 2
    return 4 if S <= 2 else 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("advec", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_every_launch_fits(kind, advec, dtype):
    for S in range(1, kmarch.SW_MAXS + 1):
        smem = kmarch.SMEM[kind](S, dtype, advec)
        assert smem == kmarch.sweep_smem(S, dtype, kind == "tend_scalars",
                                         advec)
        assert smem <= kmarch.SMEM_MAX
        # an SM's 228 KB, 1 KB of it reserved a block
        assert blocks_asked(S, dtype) * (smem + 1024) <= 233472
    # the rings of six fields at most: S scalars, e, u and v
    assert kmarch.sweep_smem(4, torch.float32, True, True) == (
        7 * 3 * 10 * 40 + 3 * 4 * 24) * 4
    assert kmarch.sweep_smem(1, torch.float64, False, False) == (
        2 * 3 * 10 * 40 + 3 * 24) * 8


def test_plan_at_the_main_shapes():
    f32 = torch.float32
    for kind in KINDS:
        p = kmarch.plan(kind, 384, 384, 384, 4, f32, 396, advec=False)
        assert (p.tiles_i, p.tiles_j, p.chunks, p.waves) == (12, 48, 2, 3)
    p = kmarch.plan("tend_scalar_acc", 1024, 256, 256, 3, f32, 396,
                    advec=False)
    assert (p.tiles_i * p.tiles_j, p.chunks, p.waves) == (1024, 5, 13)
    assert p.smem == kmarch.sweep_smem(3, f32, False, False)
    assert kmarch.plan("tend_scalars", 48, 20, 6, 2, f32, 528,
                       chunks=6).chunks == 6
    for bad in (0, 7):
        with pytest.raises(ValueError):
            kmarch.plan("tend_scalar_acc", 48, 20, 6, 2, f32, 528,
                        chunks=bad)


# --------------------------------------------------------------------------
#  the chunked march, emulated with the plain versions
# --------------------------------------------------------------------------

def sweep_inputs(ktot, S, rng):
    """Ghost-filled fields, a positive eddy viscosity, carries and tables
    (a random stretched base, noise in every column) for the plain
    versions: ks = 1, kcells = ktot + 2."""
    ks, shape = 1, (ktot + 2, 10, 12)
    names = tuple("s%d" % n for n in range(S))

    def field(scale=1.):
        return torch.tensor(scale * rng.standard_normal(shape))

    s = {"u": field(), "v": field(), "w": field(0.3)}
    s.update({n: field() for n in names})
    e = torch.tensor(np.abs(rng.standard_normal(shape)))
    t = {n: field(1e-3) for n in names}
    cts = 1e-3 * rng.standard_normal((S, ktot, F.NTG))
    cts[:, :, [F.T_DZI, F.T_DZHI, F.T_DZHI1]] += 1. / (0.5 + rng.random(3))
    cts[:, :, [F.T_RHO, F.T_RHOH, F.T_RHOH1]] += 1.
    sviscs = [1e-5 * (n + 1) for n in range(S)]
    return ks, names, s, e, t, torch.tensor(cts), sviscs


def run_plain(kind, ks, names, s, e, t, cts, sviscs, advec):
    """The plain version of one form; returns its outputs (s* then the
    carries for K10, the carries for K19)."""
    args = (ks, 0.7, 1.3, 0.33)
    if kind == "tend_scalars":
        out = F.tend_scalars_plain(s, names, e, t, cts, sviscs, *args, 0.6,
                                   -0.8, True, advec)
        return [out[n] for n in names] + [t[n] for n in names]
    F.tend_scalars_acc_plain(s, names, e, t, cts[0], sviscs, *args, advec)
    return [t[n] for n in names]


def window(x, lo, hi):
    """x with everything outside the levels [lo, hi) set to NaN."""
    y = torch.full_like(x, float("nan"))
    y[lo:hi] = x[lo:hi]
    return y


@pytest.mark.parametrize("advec", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ktot", [6, 16])
def test_chunked_march_is_the_plain_version(ktot, kind, advec):
    rng = np.random.default_rng(ktot + 2 * advec)
    S = 3
    ks, names, s, e, t0, cts, sviscs = sweep_inputs(ktot, S, rng)
    want = run_plain(kind, ks, names, s, e, {n: x.clone() for n, x in
                                              t0.items()}, cts, sviscs,
                     advec)
    for chunks in range(1, ktot + 1):
        got = [torch.zeros_like(x) for x in want]
        for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
            lo, hi = ks + k0, ks + k1
            seen = {n: window(s[n], lo - 1, hi + 1) for n in names}
            if advec:
                seen.update(u=window(s["u"], lo, hi), v=window(s["v"], lo, hi),
                            w=window(s["w"], lo, hi + 1))
            else:
                seen.update({n: torch.full_like(s[n], float("nan"))
                             for n in ("u", "v", "w")})
            rows = torch.full_like(cts, float("nan"))
            rows[:, k0:k1] = cts[:, k0:k1]
            t = {n: window(t0[n], lo, hi) for n in names}
            part = run_plain(kind, ks, names, seen, window(e, lo - 1, hi + 1),
                             t, rows, sviscs, advec)
            for g, p in zip(got, part):
                g[lo:hi] = p[lo:hi]
        for g, w in zip(got, want):
            assert torch.equal(g[ks:ks + ktot], w[ks:ks + ktot]), chunks


# --------------------------------------------------------------------------
#  the wrappers, with recorders in place of the kernels
# --------------------------------------------------------------------------

class Recorder:
    """A kernel stand-in: records its launches; reports 3 blocks an SM on
    132 SMs."""

    def __init__(self, name):
        self.name = name
        self.calls = []

    def __call__(self, dtype, *args):
        self.calls.append((dtype, args))

    def info(self, dtype, scheme, S=0):
        return {"registers": 64, "local_bytes": 0, "smem": 0,
                "blocks_per_sm": 3, "sms": 132}


@pytest.fixture(scope="module")
def rico():
    """A small rico as its ini is written (2i5: the sweep runs without
    advection), four scalars, float32 on the CPU."""
    m = build_rico(torch, (40, 24), 16, torch.float32, "cpu",
                   swadvec="2i5")
    m.build_step()
    return m


def fields(m, names):
    ctx = m.ctx
    shape = (ctx.kcells, ctx.jtot, ctx.itot)

    def zeros():
        return torch.zeros(shape, dtype=ctx.dtype)

    s = {n: zeros() for n in ("u", "v", "w") + tuple(names)}
    t = {n: zeros() for n in names}
    return s, zeros(), t


def ptrs(array):
    return [int(p) for p in array]


def same(args, want):
    """The launch's arguments are these very objects (None: a null
    pointer)."""
    return len(args) == len(want) and all(a is w for a, w in zip(args, want))


@pytest.mark.parametrize("advec", [False, True])
@pytest.mark.parametrize("S", [1, 4, 6])
def test_k10_wrapper_launches(rico, monkeypatch, S, advec):
    fz, ctx = rico.fused, rico.ctx
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    names = tuple("s%d" % n for n in range(S))
    monkeypatch.setattr(fz, "names", names)
    monkeypatch.setattr(fz, "sviscs", [0.1 * (n + 1) for n in range(S)])
    monkeypatch.setattr(fz, "advec", advec)
    rec = Recorder("tend_scalars")
    monkeypatch.setattr(fz, "k_scalars", rec)
    s, e, t = fields(rico, names)
    cts = torch.zeros(S, ctx.ktot, F.NTG, dtype=ctx.dtype)
    out = fz.tend_scalars(s, t, e, cts, 0.5, -0.6, True)
    assert list(out) == list(names)
    groups = [names[i:i + 4] for i in range(0, S, 4)]
    assert len(rec.calls) == len(groups) == (1 if S <= 4 else 2)
    for (dtype, a), grp in zip(rec.calls, groups):
        n = len(grp)
        i0 = names.index(grp[0])
        assert dtype == torch.float32
        assert same(a[:4], [s["u"], s["v"], s["w"], e] if advec
                    else [None, None, None, e])
        assert ptrs(a[4]) == [s[x].data_ptr() for x in grp]
        assert ptrs(a[5]) == [out[x].data_ptr() for x in grp]
        assert ptrs(a[6]) == [t[x].data_ptr() for x in grp]
        assert list(a[7]) == fz.sviscs[i0:i0 + n]
        assert a[8] == n
        assert a[9].data_ptr() == cts[i0].data_ptr()
        assert a[9].shape == (n, ctx.ktot, F.NTG)
        assert a[10:14] == (ctx.itot, ctx.jtot, ctx.ktot, ctx.ks)
        assert a[-5:-2] == (0.5, -0.6, 1) and a[-2] == int(advec)
        assert a[-1] == kmarch.plan("tend_scalars", ctx.itot, ctx.jtot,
                                    ctx.ktot, n, torch.float32, 396,
                                    advec=advec).chunks
    rec.calls.clear()
    fz.tend_scalars(s, t, e, cts, 0.5, -0.6, True, chunks=5)
    assert all(a[-1] == 5 for _, a in rec.calls)


@pytest.mark.parametrize("advec", [False, True])
@pytest.mark.parametrize("S", [1, 3, 6])
def test_k19_wrapper_launches(rico, monkeypatch, S, advec):
    fz, ctx = rico.fused, rico.ctx
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    names = tuple("s%d" % n for n in range(S))
    monkeypatch.setattr(fz, "names", names)
    monkeypatch.setattr(fz, "sviscs", [0.1 * (n + 1) for n in range(S)])
    monkeypatch.setattr(fz, "advec", advec)
    rec = Recorder("tend_scalar_acc")
    monkeypatch.setattr(fz, "k_scalar_acc", rec)
    s, e, t = fields(rico, names)
    fz.tend_scalars_acc(s, t, e)
    assert len(rec.calls) == (1 if S <= 4 else 2)
    done = []
    for _, a in rec.calls:
        n = a[7]
        assert same(a[:4], [s["u"], s["v"], s["w"], e] if advec
                    else [None, None, None, e])
        assert ptrs(a[5]) == [t[x].data_ptr() for x in
                              names[len(done):len(done) + n]]
        assert a[8] is fz.ct_static
        assert a[-2] == int(advec)
        assert a[-1] == kmarch.plan("tend_scalar_acc", ctx.itot, ctx.jtot,
                                    ctx.ktot, n, torch.float32, 396,
                                    advec=advec).chunks
        done += [x for x in names if s[x].data_ptr() in ptrs(a[4])]
    assert done == list(names)
    # the one-name call is the same kernel at S = 1
    rec.calls.clear()
    fz.tend_scalar_acc(s, t, e, names[-1])
    ((_, a),) = rec.calls
    assert a[7] == 1 and ptrs(a[5]) == [t[names[-1]].data_ptr()]
    assert list(a[6]) == [fz.sviscs[-1]]


def test_generic_tendencies_launches_one_scalar_sweep(monkeypatch):
    """jaenschwalde's substep without the RK fold: K18 once and K19 once
    for its three scalars (thl, qt, co2), no u, v, w for K19 (2i5 has added
    the advection)."""
    m = build_jaenschwalde(torch, (16, 8), 24, torch.float32, "cpu")
    m.build_step()
    fz, ctx = m.fused, m.ctx
    assert m.unfolded and not fz.advec and len(fz.names) == 3
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    monkeypatch.setattr(fz.smag, "surface", False)
    uvw, acc = Recorder("tend_uvw_acc"), Recorder("tend_scalar_acc")
    monkeypatch.setattr(fz, "k_uvw_acc", uvw)
    monkeypatch.setattr(fz, "k_scalar_acc", acc)
    s, e, t = fields(m, fz.names)
    t.update({n: torch.zeros_like(e) for n in ("u", "v", "w")})
    for _ in range(3):
        F.generic_tendencies(fz, ctx, s, t, {"evisc": e}, None)
    assert len(uvw.calls) == 3 and len(acc.calls) == 3
    for _, a in acc.calls:
        assert same(a[:4], [None, None, None, e]) and a[7] == 3
        assert ptrs(a[4]) == [s[n].data_ptr() for n in fz.names]
