"""The k-march of the redesigned ring kernels K13 (``advec_scalars``) and
K16 (``o4_mom``): ``ops/kmarch.py`` and the wrappers around it, on the CPU.

* ``chunk_bounds`` and ``plan`` cover [0, ktot) exactly once, every chunk
  non-empty, for ktot 1-40, 128, 384 and 1024; ``plan`` fills the card in
  whole waves at the main paths' shapes; the shared memory of every K13
  launch up to ``max_scalars`` and of K16 fits a block, in float32 and
  float64;
* the constants and shared-memory formulas of ``ops/kmarch.py`` are the
  ones in ``csrc/kmarch.cuh``, ``csrc/advec_interp.cu`` and ``csrc/o4.cu``,
  read from the sources;
* a torch emulation of the chunked march equals the plain versions bit for
  bit in float64 on stretched grids at ktot 6 and 16, for every chunk count
  1..ktot: each chunk runs the plain version on the planes and table rows
  the chunk's blocks load, everything else set to NaN, and the chunks'
  levels are stitched together (K13: planes clamped to the interior and
  rows k0..k1; K16: the ghost levels ks+k0-3..ks+k1+2 as they are);
* the wrappers, with recorders in place of the kernels: the chunk count
  ``plan`` picks from the card's resident blocks (or the one forced), the
  scalars max_scalars a launch.
"""

import os
import re

import numpy as np
import pytest
import torch

from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import advec_interp_fused as A
from microhh_torch.ops import kmarch
from microhh_torch.ops import o4_fused as O4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "microhh_torch", "csrc")
KTOTS = list(range(1, 41)) + [128, 384, 1024]


def constants(name):
    """{name: value} of the `constexpr int` lines of a source, evaluated in
    order (later lines may use earlier names)."""
    with open(os.path.join(CSRC, name)) as f:
        src = f.read()
    out = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        expr = re.sub(r"//.*", "", expr).replace("km::", "")
        try:
            out[key] = eval(expr, {}, dict(out))
        except (NameError, SyntaxError):
            pass    # not a plain integer expression
    return out, src


def covers_once(bounds, ktot):
    levels = [k for k0, k1 in bounds for k in range(k0, k1)]
    return levels == list(range(ktot)) and all(k1 > k0 for k0, k1 in bounds)


@pytest.mark.parametrize("ktot", KTOTS)
def test_chunks_cover_the_levels_once(ktot):
    for chunks in range(1, ktot + 1):
        assert covers_once(kmarch.chunk_bounds(chunks, ktot), ktot)
    for kernel in ("advec_scalars", "o4_mom"):
        for itot, jtot in ((45, 24), (384, 384), (1024, 256)):
            for slots in (132, 264, 396):
                p = kmarch.plan(kernel, itot, jtot, ktot, 2, torch.float32,
                                slots)
                assert 1 <= p.chunks <= ktot
                assert covers_once(kmarch.chunk_bounds(p.chunks, ktot), ktot)
                blocks = p.tiles_i * p.tiles_j * p.chunks
                assert p.waves == -(-blocks // slots)


def test_plan_at_the_main_shapes():
    """The chunk counts the cost model gives at the four shapes with two
    and three resident blocks an SM on 132 SMs, and whole waves."""
    f32 = torch.float32
    p = kmarch.plan("o4_mom", 512, 256, 1024, 0, f32, 264)
    assert (p.tiles_i, p.tiles_j, p.chunks, p.waves) == (16, 32, 1, 2)
    p = kmarch.plan("o4_mom", 512, 256, 1024, 0, f32, 396)
    assert (p.chunks, p.waves) == (3, 4)
    p = kmarch.plan("advec_scalars", 384, 384, 384, 4, f32, 396)
    assert (p.tiles_i, p.tiles_j, p.chunks, p.waves) == (12, 48, 2, 3)
    p = kmarch.plan("advec_scalars", 1024, 256, 256, 2, f32, 396)
    assert (p.chunks, p.waves) == (3, 8)
    p = kmarch.plan("o4_mom", 256, 192, 128, 0, torch.float64, 264)
    assert (p.tiles_i * p.tiles_j, p.chunks, p.waves) == (192, 4, 3)
    # a forced count is taken as it is, and must lie in [1, ktot]
    assert kmarch.plan("o4_mom", 48, 20, 6, 0, f32, 264, chunks=4).chunks == 4
    for bad in (0, 7):
        with pytest.raises(ValueError):
            kmarch.plan("o4_mom", 48, 20, 6, 0, f32, 264, chunks=bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k22_blocks_fit_an_sm(dtype):
    """As many K22 blocks as its launch bounds ask (three in float32, two in
    float64) fit an SM's 228 KB, 1 KB of it reserved a block."""
    blocks = 3 if dtype == torch.float32 else 2
    assert blocks * (kmarch.fold_smem(dtype) + 1024) <= 233472
    assert kmarch.SMEM["tend_rk_fold"](0, dtype, True) == kmarch.fold_smem(
        dtype)
    p = kmarch.plan("tend_rk_fold", 512, 512, 512, 0, dtype, 132 * blocks)
    assert (p.tiles_i, p.tiles_j) == (16, 64)
    assert p.waves == -(-p.tiles_i * p.tiles_j * p.chunks // (132 * blocks))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shared_memory_fits(dtype):
    assert A.max_scalars(dtype) == kmarch.K13_MAXS == 4
    for S in range(1, A.max_scalars(dtype) + 1):
        assert kmarch.k13_smem(S, dtype) <= kmarch.SMEM_MAX
    assert kmarch.k16_smem(dtype) <= kmarch.SMEM_MAX
    # two K16 blocks fit an SM's 228 KB (1 KB of it reserved a block)
    assert 2 * (kmarch.k16_smem(dtype) + 1024) <= 233472


def test_python_constants_are_the_sources():
    km, _ = constants("kmarch.cuh")
    assert (km["TI"], km["H"], km["C0"], km["RS"], km["NCP"]) == (
        kmarch.TI, kmarch.H, kmarch.C0, kmarch.RS, kmarch.NCP)
    # the interior starts on a 16-byte boundary and the rows keep it there
    assert km["C0"] * 4 % 16 == 0 and km["RS"] * 4 % 16 == 0
    assert km["RS"] >= km["C0"] + km["TI"] + km["H"]
    adv, _ = constants("advec_interp.cu")
    assert (adv["K13_TJ"], adv["K13_R"], adv["K13_RR"], adv["MAXA"]) == (
        kmarch.K13_TJ, kmarch.K13_R, kmarch.K13_RR, kmarch.K13_MAXS)
    o4, src = constants("o4.cu")
    assert o4["K16_TJ"] == kmarch.K16_TJ
    assert re.search(r"enum \{ IXU = 0, JYU, IXV, JYV, IXW, JYW, UZ, VZ, NI \}",
                     src) and kmarch.K16_NI == 8
    # the K16<T> ring depths and the prefetch distance
    body = src[src.index("struct K16 {"):src.index("};", src.index("struct K16 {"))]
    want = {"D": "sizeof(T) == 4 ? 2 : 1", "RU": "4 + D", "RW": "3 + D",
            "RD": "1 + D", "RR": "8", "IR": "K16_TJ + 3", "IC": "km::TI + 4"}
    for key, expr in want.items():
        assert re.search(r"static constexpr int %s = %s;" % (key, re.escape(expr)),
                         body), key
    for dtype in (torch.float32, torch.float64):
        g = kmarch.k16_geom(dtype)
        D = 2 if dtype == torch.float32 else 1
        assert (g["D"], g["RU"], g["RW"], g["RD"], g["RR"], g["IR"],
                g["IC"]) == (D, 4 + D, 3 + D, 1 + D, 8, kmarch.K16_TJ + 3,
                             kmarch.TI + 4)
    assert "PLANES = 2 * RU + RW + RD" in body
    assert ("((size_t)PLANES * SIZE + NI * IR * IC + RR * km::NCP) * sizeof(T)"
            in body)
    _, adv_src = constants("advec_interp.cu")
    assert ("((size_t)S * K13_R * km::Slot<K13_TJ>::SIZE + K13_RR * km::NCP)"
            in adv_src)
    # K22: its tile, halo, ring depths, e's row and the staged table row,
    # and its shared-memory formula
    fold, fold_src = constants("tend_rk_fold.cu")
    assert (fold["K22_TJ"], fold["K22_HALO"], fold["K22_R"], fold["K22_ER"],
            fold["K22_NTC"]) == (kmarch.K22_TJ, kmarch.K22_HALO, kmarch.K22_R,
                                 kmarch.K22_ER, kmarch.K22_NTC)
    assert "K22_EW = km::TI + 2;" in fold_src and kmarch.K22_EW == kmarch.TI + 2
    assert "K22_NT = km::TI * K22_TJ;" in fold_src
    assert "using FoldSlot = km::Slot<K22_TJ, K22_HALO>;" in fold_src
    flat = re.sub(r"\s+", " ", fold_src)
    assert ("((size_t)K22_R * 4 * FoldSlot::SIZE + K22_ER * K22_ESZ + 2 * "
            "K22_TJ * (km::TI + 1) + 2 * (K22_TJ + 1) * km::TI + K22_R * "
            "K22_NTC) * sizeof(T)" in flat)
    assert "K22_ESZ = (K22_TJ + 2) * K22_EW;" in fold_src
    # the staged row holds ct (NTG columns) and then ce (NE) at K22_CE
    assert fold["K22_CE"] >= kmarch.NTG and fold["K22_CE"] + 6 <= fold["K22_NTC"]
    assert kmarch.fold_smem(torch.float32) == (
        6 * 4 * 12 * 40 + 4 * 10 * 34 + 2 * 8 * 33 + 2 * 9 * 32 + 6 * 32) * 4
    assert "__launch_bounds__(K22_NT, sizeof(T) == 4 ? 3 : 2)" in fold_src
    # chunk_bounds: the same integer formula on both sides
    _, km_src = constants("kmarch.cuh")
    assert "k0 = (int)((long long)z * ktot / chunks);" in km_src
    assert "k1 = (int)((long long)(z + 1) * ktot / chunks);" in km_src


# --------------------------------------------------------------------------
#  the chunked march, emulated with the plain versions
# --------------------------------------------------------------------------

def stretched_table(scheme, ktot, rng):
    """build_interp_tables on random stretched levels and density."""
    ks = 3
    kc = ktot + 2 * ks
    dz = 0.5 + rng.random(kc)
    rho = 1. + 0.2 * rng.random(kc)
    return ks, A.build_interp_tables(scheme, ks, ks + ktot, rho,
                                      1. + 0.2 * rng.random(kc), 1. / dz,
                                      1. / (0.5 + rng.random(kc)))


@pytest.mark.parametrize("scheme", ["2i4", "2i5", "2i53", "2i62"])
@pytest.mark.parametrize("ktot", [6, 16])
def test_k13_chunked_march_is_the_plain_version(scheme, ktot):
    rng = np.random.default_rng(ktot)
    ks, cc = stretched_table(scheme, ktot, rng)
    ke = ks + ktot
    shape = (ktot + 2 * ks, 10, 12)
    u, v, w = (torch.tensor(rng.standard_normal(shape)) for _ in range(3))
    a = [torch.tensor(rng.standard_normal(shape)) for _ in range(2)]
    t0 = [torch.tensor(rng.standard_normal(shape)) for _ in range(2)]
    cct = torch.tensor(cc)
    want = [t.clone() for t in t0]
    A.scalars_plain(scheme, u, v, w, a, want, cct, ks, 0.7, 1.3)
    for chunks in range(1, ktot + 1):
        got = [t.clone() for t in t0]
        for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
            # what the chunk's blocks load: planes ks+k0-3..ks+k1+2 of the
            # scalars clamped to the interior, u and v at its levels, w at
            # its faces, table rows k0..k1
            lo, hi = max(ks + k0 - 3, ks), min(ks + k1 + 2, ke - 1)
            keep = [(x, lo, hi + 1) for x in a]
            keep += [(u, ks + k0, ks + k1), (v, ks + k0, ks + k1),
                     (w, ks + k0, ks + k1 + 1)]
            seen = []
            for x, l0, l1 in keep:
                y = torch.full_like(x, float("nan"))
                y[l0:l1] = x[l0:l1]
                seen.append(y)
            rows = torch.full_like(cct, float("nan"))
            rows[k0:k1 + 1] = cct[k0:k1 + 1]
            part = [t.clone() for t in t0]
            A.scalars_plain(scheme, *seen[2:], seen[:2], part, rows, ks, 0.7,
                            1.3)
            for g, p in zip(got, part):
                g[ks + k0:ks + k1] = p[ks + k0:ks + k1]
        for g, want_n in zip(got, want):
            assert torch.equal(g, want_n), chunks


def o4_model(ktot, swadvec):
    """A small moser180 (advec 4m) or the same with advec 4, on the tanh
    levels of moser180_input.py, on the CPU in float64."""
    with open(os.path.join(ROOT, "cases", "moser180", "moser180.ini")) as f:
        text = f.read()
    for key, val in (("itot", 12), ("jtot", 10), ("ktot", ktot),
                     ("swstats", 0), ("swbudget", 0), ("swadvec", swadvec)):
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    m = Model(Ini(text), "run", "moser180", workdir=".", dtype=torch.float64,
              device="cpu", input_nc=cases.moser180_input(ktot, 2.))
    m.finish_setup()
    m.build_step()
    return m


@pytest.mark.parametrize("swadvec", ["4", "4m"])
@pytest.mark.parametrize("ktot", [6, 16])
def test_k16_chunked_march_is_the_plain_version(swadvec, ktot):
    m = o4_model(ktot, swadvec)
    ctx, o4 = m.ctx, m.o4
    assert o4.scheme == swadvec
    ks = ctx.ks
    rng = np.random.default_rng(ktot + len(swadvec))
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    fields = [torch.tensor(rng.standard_normal(shape)) for _ in range(4)]
    t0 = [torch.tensor(rng.standard_normal(shape)) for _ in range(3)]
    want = [t.clone() for t in t0]
    o4.momentum_plain(*fields, *want)
    for chunks in range(1, ktot + 1):
        got = [t.clone() for t in t0]
        for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
            # the ghost levels as they are: planes ks+k0-3..ks+k1+2
            seen = []
            for x in fields:
                y = torch.full_like(x, float("nan"))
                y[ks + k0 - 3:ks + k1 + 3] = x[ks + k0 - 3:ks + k1 + 3]
                seen.append(y)
            part = [t.clone() for t in t0]
            o4.momentum_plain(*seen, *part)
            for g, p in zip(got, part):
                g[ks + k0:ks + k1] = p[ks + k0:ks + k1]
        for g, want_n in zip(got, want):
            assert torch.equal(g, want_n), chunks


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


def test_k13_wrapper_plans_and_splits(monkeypatch):
    monkeypatch.setattr(A, "on_cpu", lambda t: False)
    with open(os.path.join(ROOT, "cases", "rico", "rico.ini")) as f:
        text = f.read()
    for key, val in (("itot", 40), ("jtot", 24), ("ktot", 16),
                     ("swadvec", "2i5")):
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    m = Model(Ini(text), "run", "rico", workdir=".", dtype=torch.float32,
              device="cpu", input_nc=cases.rico_input(16, 4000.))
    m.finish_setup()
    m.build_step()
    adv, ctx = m.advec_fused, m.ctx
    adv.k_scal = Recorder("advec_scalars")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    f = [torch.zeros(shape) for _ in range(6)]
    t = [torch.zeros(shape) for _ in range(6)]
    adv.scalars(f[0], f[1], f[2], f, t)
    want = kmarch.plan("advec_scalars", 40, 24, 16, 4, torch.float32, 396)
    (d1, a1), (d2, a2) = adv.k_scal.calls
    assert d1 == d2 == torch.float32
    # six scalars: one launch of four, one of two, each with its plan
    assert a1[5] == 4 and a2[5] == 2
    assert a1[-1] == want.chunks
    assert a2[-1] == kmarch.plan("advec_scalars", 40, 24, 16, 2,
                                 torch.float32, 396).chunks
    assert list(a1[3]) == [x.data_ptr() for x in f[:4]]
    assert list(a2[4]) == [x.data_ptr() for x in t[4:]]
    adv.k_scal.calls.clear()
    adv.scalars(f[0], f[1], f[2], f[:2], t[:2], chunks=5)
    ((_, a),) = adv.k_scal.calls
    assert a[5] == 2 and a[-1] == 5
    with pytest.raises(ValueError):
        adv.scalars(f[0], f[1], f[2], f[:2], t[:2], chunks=17)


def test_k16_wrapper_plans(monkeypatch):
    monkeypatch.setattr(O4, "on_cpu", lambda t: False)
    m = o4_model(16, "4")
    o4, ctx = m.o4, m.ctx
    o4.k_mom = Recorder("o4_mom")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    x = [torch.zeros(shape, dtype=torch.float64) for _ in range(7)]
    o4.momentum(*x)
    o4.momentum(*x, chunks=3)
    (_, a1), (_, a2) = o4.k_mom.calls
    assert a1[-1] == kmarch.plan("o4_mom", 12, 10, 16, 0, torch.float64,
                                 396).chunks
    assert a2[-1] == 3
    assert a1[:8] == tuple(x) + (o4.cc,)


def test_k22_wrapper_plans_and_splits_the_carries(monkeypatch):
    """K22's wrapper: the chunk count of the plan (or the one forced), and
    the carries of u, v and w read from the old tensors and written to new
    ones when both happen (not first, carry), in place otherwise."""
    import chip_smoke
    from microhh_torch.ops import fused as F
    monkeypatch.setattr(F, "on_cpu", lambda t: False)
    m = chip_smoke.build_model(torch, 40, 16, torch.float32, "cpu")
    m.build_step()
    fz, ctx = m.fused, m.ctx
    fz.k_tend_fold = Recorder("tend_rk_fold")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    s = {n: torch.zeros(shape) for n in F.PROGNOSTIC}
    want = kmarch.plan("tend_rk_fold", 40, 40, 16, 0, torch.float32,
                       396).chunks
    for first, carry, chunks in ((True, True, None), (False, True, None),
                                 (False, False, 5), (False, True, 16)):
        t = {n: torch.zeros(shape) for n in F.PROGNOSTIC}
        old = dict(t)
        fz.tend_rk_fold(s, t, None, 0.5, -0.6, 2., first, carry,
                        chunks=chunks)
        _, a = fz.k_tend_fold.calls[-1]
        t_in, t_out, tth = a[10:13], a[13:16], a[16]
        assert a[-1] == (want if chunks is None else chunks)
        assert tth is t["th"] is old["th"]
        for n, x_in, x_out in zip(("u", "v", "w"), t_in, t_out):
            assert x_in is (None if first else old[n])
            assert x_out is (t[n] if carry else None)
            # new tensors exactly when the carry is read and written
            assert (t[n] is old[n]) == (first or not carry)
    with pytest.raises(ValueError):
        fz.tend_rk_fold(s, t, None, 0.5, -0.6, 2., False, True, chunks=17)
