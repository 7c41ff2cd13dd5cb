"""The k-march of the redesigned ring kernels K12 (``advec_mom``), K13
(``advec_scalars``), K16 (``o4_mom``), K17 (``o4_scalars``) and K22
(``tend_rk_fold``): ``ops/kmarch.py`` and the wrappers around it, on the
CPU; and of K1/K14 (``evisc``) and K7 (``limits``) their constants, shared
memory and plans at the main shapes (the rest in
``test_torch_evisc_march.py`` and ``test_torch_limits_march.py``).

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
  scalars max_scalars a launch;
* K17: its constants, shared memory and launch bounds read from
  ``csrc/o4.cu``, its plan at the weakscaling and moser180 shapes, its
  wrapper (the split, pointers, viscosities and chunks it passes), its
  per-level rows (``build_k17_rows``) against the plain vertical parts,
  and ``k17_march``, a torch emulation of the kernel called with the C
  entry's arguments, against ``scalars_plain`` to 1e-12 at every chunk
  count with 1, 2, 3 and 5 scalars in both schemes; each of its edge rules
  broken on its own (``broken=``) fails;
* K12: its constants, shared memory and launch bounds read from
  ``csrc/advec_interp.cu``, its plan at the rico 384^3 and jaenschwalde
  shapes, its wrapper (the plan's chunk count or the one forced); the
  plain version run on what each chunk's blocks read (the rest NaN) equals
  the whole plain version bit for bit in every scheme at every chunk count;
  ``k12_march``, a torch emulation of the kernel called with the C entry's
  arguments, equals ``momentum_plain`` to 1e-12 at every chunk count with
  NaN ghost levels, and each of its edge rules broken on its own
  (``broken=``) fails; ``chip_smoke.py``'s K12 cases run on the CPU.
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
    # K1/K14 with five resident blocks an SM in float32 (three in float64):
    # rico 384^3, jaenschwalde 1024x256x256, SBL_Smag 256^3 (K14), the
    # clamped drycblles 512^3, sullivan2011 512x512x64
    p = kmarch.plan("evisc", 384, 384, 384, 0, f32, 660)
    assert (p.tiles_i, p.tiles_j, p.chunks, p.waves, p.smem) == (
        12, 48, 8, 7, 24160)
    for shape, chunks, waves in (((1024, 256, 256), 7, 11),
                                 ((256, 256, 256), 5, 2),
                                 ((512, 512, 512), 9, 14),
                                 ((512, 512, 64), 3, 5)):
        p = kmarch.plan("evisc", *shape, 0, f32, 660)
        assert (p.chunks, p.waves) == (chunks, waves), shape
    p = kmarch.plan("evisc", 384, 384, 384, 0, torch.float64, 396)
    assert (p.chunks, p.waves, p.smem) == (2, 3, 48320)
    # K7, K1's march with its maxima, as many blocks an SM: the same plans
    # and the neutral LES 768x384x288; its shared memory holds two levels'
    # rates of each thread more
    for shape, chunks, waves in (((384, 384, 384), 8, 7),
                                 ((1024, 256, 256), 7, 11),
                                 ((256, 256, 256), 5, 2),
                                 ((512, 512, 512), 9, 14),
                                 ((512, 512, 64), 3, 5),
                                 ((768, 384, 288), 4, 7)):
        p = kmarch.plan("limits", *shape, 0, f32, 660)
        assert (p.chunks, p.waves, p.smem) == (chunks, waves, 28256), shape
    p = kmarch.plan("limits", 768, 384, 288, 0, f32, 660)
    assert (p.tiles_i, p.tiles_j) == (24, 48)
    p = kmarch.plan("limits", 384, 384, 384, 0, torch.float64, 396)
    assert (p.chunks, p.waves, p.smem) == (2, 3, 56512)
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
    # K1/K14: five slots of u's, v's and w's planes (halo 1) and five
    # staged rows; its launch bounds' five blocks (three in float64) fit
    nb = torch.finfo(dtype).bits // 8
    assert kmarch.evisc_smem(dtype) == (5 * 3 * 10 * 40 + 5 * 8) * nb
    assert kmarch.SMEM["evisc"](0, dtype, True) == kmarch.evisc_smem(dtype)
    assert kmarch.TILE_J["evisc"] == kmarch.EV_TJ
    assert kmarch.WARM["evisc"] == 2
    blocks = 5 if dtype == torch.float32 else 3
    assert blocks * (kmarch.evisc_smem(dtype) + 1024) <= 233472
    # K7: K1's and two levels' rates of each of its 256 threads, at as many
    # blocks an SM
    assert kmarch.limits_smem(dtype) == kmarch.evisc_smem(dtype) + 2 * 2 * 256 * nb
    assert kmarch.SMEM["limits"](0, dtype, True) == kmarch.limits_smem(dtype)
    assert kmarch.TILE_J["limits"] == kmarch.EV_TJ
    assert kmarch.WARM["limits"] == 2
    assert blocks * (kmarch.limits_smem(dtype) + 1024) <= 233472


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
    # K1/K14: its tile, halo, fields a group, slots and staged row, and its
    # shared-memory formula
    ev, ev_src = constants("evisc.cu")
    assert (ev["EV_TJ"], ev["EV_HALO"], ev["EV_NF"], ev["EV_R"],
            ev["EV_NCP"]) == (kmarch.EV_TJ, kmarch.EV_HALO, kmarch.EV_NF,
                              kmarch.EV_R, kmarch.EV_NCP)
    assert "EV_NT = km::TI * EV_TJ;" in ev_src
    flat = re.sub(r"\s+", " ", ev_src)
    assert ("((size_t)EV_R * EV_NF * km::Slot<EV_TJ, EV_HALO>::SIZE + "
            "(size_t)EV_R * EV_NCP) * sizeof(T)" in flat)
    # K7: its shared-memory formula
    assert ("return evisc_smem<T>() + (size_t)2 * 2 * EV_NT * sizeof(T);"
            in flat)
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


def o4_model(ktot, swadvec, jtot=10):
    """A small moser180 (advec 4m) or the same with advec 4, on the tanh
    levels of moser180_input.py, on the CPU in float64 (jtot = 1: the
    kernels' 2-D form)."""
    with open(os.path.join(ROOT, "cases", "moser180", "moser180.ini")) as f:
        text = f.read()
    for key, val in (("itot", 12), ("jtot", jtot), ("ktot", ktot),
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


# --------------------------------------------------------------------------
#  K17: its constants, plan, wrapper and chunked march
# --------------------------------------------------------------------------

def test_k17_constants_are_the_sources():
    o4, src = constants("o4.cu")
    assert (o4["K17_TJ"], o4["K17_R"], o4["K17_RR"], o4["K17_MAXS"],
            o4["K17_NCP"]) == (kmarch.K17_TJ, kmarch.K17_R, kmarch.K17_RR,
                               kmarch.K17_MAXS, kmarch.K17_NCP)
    assert (o4["K17_ZA"], o4["K17_ZD"], o4["K17_NCP"]) == (O4.ZA, O4.ZD,
                                                           O4.NZ)
    assert "K17_NT = km::TI * K17_TJ;" in src
    flat = re.sub(r"\s+", " ", src)
    assert ("((size_t)(S + 2) * K17_R * km::Slot<K17_TJ>::SIZE + K17_RR * "
            "K17_NCP) * sizeof(T)" in flat)
    # four weight groups of eight (seven and a pad) before the diffusion's,
    # each 16-byte aligned for load8, and the staged row 16-byte aligned
    assert O4.ZD == O4.ZA + 4 * 8 and O4.NZ >= O4.ZD + 7
    assert O4.ZA % 4 == O4.ZD % 4 == O4.NZ % 4 == 0
    # K17_D levels in flight in K17_D + 1 slots: the slot written at level
    # k is the one plane k - 1 left, not the one read there
    assert o4["K17_R"] == o4["K17_RR"] == o4["K17_D"] + 1
    assert "km::wait_pending<K17_D - 1>();" in src
    assert ("issue(k + K17_D, sl == 0 ? K17_R - 1 : sl - 1, lk + K17_D * "
            "plane);" in flat)
    assert ("__launch_bounds__( K17_NT, sizeof(T) == 4 ? (S == 1 ? 4 : (S "
            "== 2 ? 3 : 2)) : (S <= 2 ? 2 : 1))" in flat)
    for dtype in (torch.float32, torch.float64):
        assert O4.max_scalars(dtype) == kmarch.K17_MAXS == 4
        for S in range(1, 5):
            assert kmarch.k17_smem(S, dtype) == (
                ((S + 2) * 3 * 14 * 40 + 3 * 40) * torch.finfo(dtype).bits // 8)
            assert kmarch.SMEM["o4_scalars"](S, dtype, True) == kmarch.k17_smem(
                S, dtype)
            # as many blocks as the launch bounds ask fit an SM's 228 KB
            blocks = ({1: 4, 2: 3}.get(S, 2) if dtype == torch.float32
                      else (2 if S <= 2 else 1))
            assert blocks * (kmarch.k17_smem(S, dtype) + 1024) <= 233472


def test_k17_plan_at_the_main_shapes():
    """weakscaling 512x256x1024 float32 and moser180 256x192x128 float64,
    one scalar, at four and two resident blocks an SM on 132 SMs: the 512
    tiles of weakscaling fill the 528 slots in one chunk."""
    p = kmarch.plan("o4_scalars", 512, 256, 1024, 1, torch.float32, 528)
    assert (p.tiles_i, p.tiles_j, p.chunks, p.waves, p.smem) == (
        16, 32, 1, 1, 20640)
    p = kmarch.plan("o4_scalars", 256, 192, 128, 1, torch.float64, 264)
    assert (p.tiles_i, p.tiles_j, p.chunks, p.waves, p.smem) == (
        8, 24, 4, 3, 41280)
    for ktot in (6, 16, 1024):
        p = kmarch.plan("o4_scalars", 45, 40, ktot, 2, torch.float32, 396)
        assert covers_once(kmarch.chunk_bounds(p.chunks, ktot), ktot)


def test_k17_wrapper_plans_forces_and_splits(monkeypatch):
    """Six scalars go as one launch of four and one of two, each with its
    plan's chunk count (or the one forced), its pointers, viscosities and
    the per-level rows."""
    monkeypatch.setattr(O4, "on_cpu", lambda t: False)
    m = o4_model(16, "4m")
    o4, ctx = m.o4, m.ctx
    o4.k_scal = Recorder("o4_scalars")
    names = ["s%d" % n for n in range(6)]
    monkeypatch.setattr(o4.diff, "viscs",
                        {nm: 1e-3 * (n + 1) for n, nm in enumerate(names)})
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    x = [torch.zeros(shape, dtype=torch.float64) for _ in range(15)]
    u, v, wc, f, t = x[0], x[1], x[2], x[3:9], x[9:]
    o4.scalars(u, v, wc, names, f, t)
    (d1, a1), (d2, a2) = o4.k_scal.calls
    assert d1 == d2 == torch.float64
    assert a1[6] == 4 and a2[6] == 2
    assert a1[:3] == (u, v, wc) and a1[7] is a2[7] is o4.cz
    assert list(a1[3]) == [y.data_ptr() for y in f[:4]]
    assert list(a2[4]) == [y.data_ptr() for y in t[4:]]
    assert list(a1[5]) == [1e-3, 2e-3, 3e-3, 4e-3]
    assert list(a2[5]) == [5e-3, 6e-3]
    assert a1[-1] == kmarch.plan("o4_scalars", 12, 10, 16, 4, torch.float64,
                                 396).chunks
    assert a2[-1] == kmarch.plan("o4_scalars", 12, 10, 16, 2, torch.float64,
                                 396).chunks
    assert a1[8:13] == (12, 10, 16, ctx.ks, O4.SCHEME_ID["4m"])
    o4.k_scal.calls.clear()
    o4.scalars(u, v, wc, names[:2], f[:2], t[:2], chunks=5)
    ((_, a),) = o4.k_scal.calls
    assert a[6] == 2 and a[-1] == 5
    with pytest.raises(ValueError):
        o4.scalars(u, v, wc, names[:2], f[:2], t[:2], chunks=17)


def k17_march(u, v, wc, a, ta, sviscs, cz, ktot, ks, M, dxi, dyi, chunks,
              broken=None, d3=True):
    """A torch emulation of csrc/o4.cu o4_scalars_kernel, every point of a
    plane at once (the periodic halo makes a tile's points see what the
    plane's do): each chunk warms its register columns up from the ghost
    levels as they are (planes k0-3..k0+3 of the scalars, w at half levels
    k0-1..k0+2), then marches its levels with plane k of the scalars, u
    and v from K17_R ring slots filled two levels ahead and table row k
    from K17_RR staged rows, and shifts the columns by the planes k+4 and
    k+3 loaded one level ahead (the plane index clamped at ktot + 2).
    broken names one rule to break: "local_rows" (the table row of the
    chunk's own level), "interior_warmup" (the warm-up planes clamped to
    the interior, K13's rule), "w_from_k0" (w's column one half level
    high), "ring2" (two ring slots, so the copy two levels ahead lands in
    the slot being read) or "no_clamp" (the planes past the top ghost
    level).  d3 False is the 2-D form (jtot = 1): v's plane is not copied
    and no y line is read."""
    R = 2 if broken == "ring2" else kmarch.K17_R
    RR = 2 if broken == "ring2" else kmarch.K17_RR
    g = (1. / 24., -27. / 24., 27. / 24., -1. / 24.)
    ci = (-1. / 16., 9. / 16., 9. / 16., -1. / 16.)
    cdg = (-1460. / 576., 783. / 576., -54. / 576., 1. / 576.)

    def lev(p):
        return ks + (p if broken == "no_clamp" else min(p, ktot + 2))

    def line(P, d, dim):
        return torch.roll(P, -d, dims=dim)

    def hadv(vel, q):
        if M:
            h, q0 = 0.5, q[3]
            fa = vel[0] * h * (q[0] + q0)
            fb = vel[1] * h * (q[2] + q0)
            fc = vel[2] * h * (q0 + q[4])
            fd = vel[3] * h * (q0 + q[6])
            return g[0] * (fd - fa) + g[1] * (fc - fb)
        f = [vel[n] * sum(ci[m] * q[n + m] for m in range(4))
             for n in range(4)]
        return -sum(g[n] * f[n] for n in range(4))

    S = len(a)
    for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
        if broken == "interior_warmup":
            warm = [ks + min(max(k0 - 3 + m, 0), ktot - 1) for m in range(7)]
        else:
            warm = [lev(k0 - 3 + m) for m in range(7)]
        q = [[x[p] for p in warm] for x in a]
        w0 = k0 if broken == "w_from_k0" else k0 - 1
        wv = [wc[lev(w0 + e)] for e in range(4)]
        ring = [[None] * R for _ in range(S + 2)]
        rows = [None] * RR

        def issue(p):
            for n, x in enumerate(list(a) + [u, v if d3 else None]):
                ring[n][p % R] = None if x is None else x[lev(p)]
            rows[p % RR] = cz[min(p, ktot - 1) - (k0 if broken == "local_rows"
                                                  else 0)]

        issue(k0)
        issue(k0 + 1)
        for k in range(k0, k1):
            issue(k + 2)
            qn = [x[lev(k + 4)] for x in a]
            wn = wc[lev(k + 3)]
            zr = rows[k % RR]
            cv = [sum(wv[e] * zr[O4.ZA + 8 * e + m] for e in range(4))
                  for m in range(7)]
            cd = [zr[O4.ZD + m] for m in range(7)]
            U, V = ring[S][k % R], ring[S + 1][k % R]
            ux = [line(U, d, -1) for d in (-1, 0, 1, 2)]
            if d3:
                vy = [line(V, d, -2) for d in (-1, 0, 1, 2)]
            for n in range(S):
                P = ring[n][k % R]
                x = [q[n][3] if d == 0 else line(P, d, -1)
                     for d in range(-3, 4)]
                va = sum(cv[m] * q[n][m] for m in range(7))
                vd = sum(cd[m] * q[n][m] for m in range(7))
                lap = (cdg[3] * (x[0] + x[6]) + cdg[2] * (x[1] + x[5])
                       + cdg[1] * (x[2] + x[4]) + cdg[0] * x[3]) * dxi * dxi
                t = hadv(ux, x) * dxi
                if d3:
                    y = [q[n][3] if d == 0 else line(P, d, -2)
                         for d in range(-3, 4)]
                    lap = lap + (cdg[3] * (y[0] + y[6]) + cdg[2] * (y[1] + y[5])
                                 + cdg[1] * (y[2] + y[4])
                                 + cdg[0] * y[3]) * dyi * dyi
                    t = t + hadv(vy, y) * dyi
                t = t + va + sviscs[n] * (lap + vd)
                ta[n][ks + k] += t
            for n in range(S):
                q[n] = q[n][1:] + [qn[n]]
            wv = wv[1:] + [wn]


class K17Emulator(Recorder):
    """K17's stand-in: called with the C entry's arguments (pointers
    resolved to the tensors given), it checks what the entry checks and
    runs k17_march."""

    def __init__(self, tensors, broken=None):
        super().__init__("o4_scalars")
        self.by_ptr = {x.data_ptr(): x for x in tensors}
        self.broken = broken

    def __call__(self, dtype, u, v, wc, a, ta, sviscs, S, cz, itot, jtot,
                 ktot, ks, scheme, dxi, dyi, chunks):
        super().__call__(dtype, S, chunks)
        assert 1 <= S <= kmarch.K17_MAXS and 1 <= chunks <= ktot
        assert ks >= 3 and cz.shape == (ktot, O4.NZ)
        assert u.shape == (ktot + 2 * ks, jtot, itot)
        k17_march(u, v, wc, [self.by_ptr[p] for p in a],
                  [self.by_ptr[p] for p in ta], list(sviscs), cz, ktot, ks,
                  scheme == 1, dxi, dyi, chunks, self.broken, d3=jtot > 1)


def k17_inputs(m, S, seed):
    """Seeded u, v, w, S scalars and carries (ghost levels included) and S
    distinct viscosities."""
    rng = np.random.default_rng(seed)
    ctx = m.ctx
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    f = [torch.tensor(rng.standard_normal(shape)) for _ in range(3 + 2 * S)]
    viscs = {"s%d" % n: 10. ** rng.uniform(-3., -1.) for n in range(S)}
    return f[0], f[1], 0.3 * f[2], list(viscs), f[3:3 + S], f[3 + S:], viscs


def k17_rel_err(got, want):
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("S", [1, 2, 3, 5])
@pytest.mark.parametrize("swadvec", ["4", "4m"])
@pytest.mark.parametrize("ktot", [6, 16])
def test_k17_chunked_march_is_the_plain_version(ktot, swadvec, S,
                                                monkeypatch):
    """The emulated march through the wrapper (five scalars: a launch of
    four and one of one) equals scalars_plain to 1e-12 at every chunk count
    on the stretched moser180 levels."""
    monkeypatch.setattr(O4, "on_cpu", lambda t: False)
    m = o4_model(ktot, swadvec)
    o4 = m.o4
    u, v, wc, names, f, t0, viscs = k17_inputs(m, S, 10 * ktot + S)
    monkeypatch.setattr(o4.diff, "viscs", viscs)
    want = [x.clone() for x in t0]
    o4.scalars_plain(u, v, wc, names, f, want)
    assert k17_rel_err(t0, want) > 1e-3
    for chunks in range(1, ktot + 1):
        got = [x.clone() for x in t0]
        o4.k_scal = K17Emulator([u, v, wc] + f + got)
        o4.scalars(u, v, wc, names, f, got, chunks=chunks)
        assert [c[1][0] for c in o4.k_scal.calls] == (
            [4, 1] if S == 5 else [S])
        assert k17_rel_err(got, want) <= 1e-12, chunks
        # the ghost levels of the carries stay as they were
        for g, x in zip(got, t0):
            assert torch.equal(g[:m.ctx.ks], x[:m.ctx.ks])
            assert torch.equal(g[m.ctx.ke:], x[m.ctx.ke:])


@pytest.mark.parametrize("S", [2, 5])
@pytest.mark.parametrize("swadvec", ["4", "4m"])
@pytest.mark.parametrize("ktot", [6, 16])
def test_k17_2d_chunked_march_is_the_plain_version(ktot, swadvec, S,
                                                   monkeypatch):
    """K17's 2-D form (jtot = 1: no y line, v not read), emulated through
    the wrapper at every chunk count, equals scalars_plain (the ops' 2-D
    form) to 1e-12."""
    monkeypatch.setattr(O4, "on_cpu", lambda t: False)
    m = o4_model(ktot, swadvec, jtot=1)
    o4 = m.o4
    assert not o4.dim3 and o4.k_scal.name == "o4_scalars_2d"
    u, v, wc, names, f, t0, viscs = k17_inputs(m, S, 7 * ktot + S)
    monkeypatch.setattr(o4.diff, "viscs", viscs)
    want = [x.clone() for x in t0]
    o4.scalars_plain(u, v, wc, names, f, want)
    for chunks in range(1, ktot + 1):
        got = [x.clone() for x in t0]
        o4.k_scal = K17Emulator([u, v, wc] + f + got)
        o4.scalars(u, v, wc, names, f, got, chunks=chunks)
        assert [c[1][0] for c in o4.k_scal.calls] == (
            [4, 1] if S == 5 else [S])
        assert k17_rel_err(got, want) <= 1e-12, chunks


@pytest.mark.parametrize("broken", ["local_rows", "interior_warmup",
                                    "w_from_k0", "ring2", "no_clamp"])
def test_k17_march_needs_each_edge_rule(broken, monkeypatch):
    """Each rule of the march, broken on its own, breaks the result (or
    reads past the field) at some chunk count, in both schemes."""
    monkeypatch.setattr(O4, "on_cpu", lambda t: False)
    for swadvec in ("4", "4m"):
        m = o4_model(6, swadvec)
        o4 = m.o4
        u, v, wc, names, f, t0, viscs = k17_inputs(m, 2, 3)
        monkeypatch.setattr(o4.diff, "viscs", viscs)
        want = [x.clone() for x in t0]
        o4.scalars_plain(u, v, wc, names, f, want)
        worst = 0.
        for chunks in range(1, 7):
            got = [x.clone() for x in t0]
            o4.k_scal = K17Emulator([u, v, wc] + f + got, broken)
            try:
                o4.scalars(u, v, wc, names, f, got, chunks=chunks)
            except IndexError:
                assert broken == "no_clamp"
                worst = float("inf")
                continue
            worst = max(worst, k17_rel_err(got, want))
        assert worst > 1e-6, (broken, swadvec)


@pytest.mark.parametrize("swadvec", ["4", "4m"])
def test_k17_rows_are_the_plain_vertical_parts(swadvec):
    """build_k17_rows: the seven weights of a level applied to the column
    give the plain version's vertical advection per unit w at each half
    level, and its vertical diffusion, at every level of 1..8-level
    columns (where every row is a wall row); the 4m rows' wall fluxes sit
    at the global levels 0 and ktot - 1 only."""
    for ktot in (2, 3, 8):
        m = o4_model(ktot, swadvec)
        ctx, o4 = m.ctx, m.o4
        ks, ke = ctx.ks, ctx.ke
        cz = o4.cz.numpy()
        rng = np.random.default_rng(ktot)
        a = torch.tensor(rng.standard_normal((ctx.kcells, ctx.jtot,
                                              ctx.itot)))
        zero = torch.zeros_like(a)
        # the plain vertical diffusion: diff_c less its horizontal part
        # (the field constant in each plane)
        flat = a[:, :1, :1].expand_as(a).contiguous()
        dif = o4.diff.scalar(ctx, flat, "s") / o4.diff.viscs["s"]
        for k in range(ktot):
            col = flat[ks + k - 3:ks + k + 4, 0, 0].numpy()
            assert np.allclose(cz[k, O4.ZD:O4.ZD + 7] @ col,
                               dif[k, 0, 0].item(), rtol=1e-12, atol=0.)
        for e in range(4):
            # w one at half level k-1+e of each level k: the advection of
            # a horizontally constant field is the vertical part alone
            for k in range(ktot):
                w = zero.clone()
                w[ks + k - 1 + e] = 1.
                adv = o4.advec.scalar(ctx, flat, zero, zero, w)[k, 0, 0]
                col = flat[ks + k - 3:ks + k + 4, 0, 0].numpy()
                got = cz[k, O4.ZA + 8 * e:O4.ZA + 8 * e + 7] @ col
                assert np.isclose(got, adv.item(), rtol=1e-12,
                                  atol=1e-12 * abs(adv.item())), (k, e)


# --------------------------------------------------------------------------
#  K12: its constants, plan, wrapper and chunked march
# --------------------------------------------------------------------------

def test_k12_constants_are_the_sources():
    adv, src = constants("advec_interp.cu")
    assert (adv["K12_TJ"], adv["K12_R"], adv["K12_RR"]) == (
        kmarch.K12_TJ, kmarch.K12_R, kmarch.K12_RR)
    assert "K12_NT = km::TI * K12_TJ;" in src
    flat = re.sub(r"\s+", " ", src)
    assert ("((size_t)K12_R * 3 * km::Slot<K12_TJ>::SIZE + K12_RR * km::NCP) "
            "* sizeof(T)" in flat)
    assert "__launch_bounds__(K12_NT, sizeof(T) == 4 ? 3 : 2)" in flat
    # two groups read at a level, one in flight and one being filled; rows
    # k-1..k+1 read, k+2 in flight, k+3 being filled; slots taken modulo a
    # power of two
    assert kmarch.K12_R == 4 and kmarch.K12_RR >= 5
    assert kmarch.K12_RR & (kmarch.K12_RR - 1) == 0
    assert "issue(k + 2, (z + 3) & (K12_R - 1));" in flat
    assert "km::wait_pending<1>();" in src
    for dtype in (torch.float32, torch.float64):
        nb = torch.finfo(dtype).bits // 8
        assert kmarch.k12_smem(dtype) == (4 * 3 * 14 * 40 + 8 * 28) * nb
        assert kmarch.SMEM["advec_mom"](0, dtype, True) == kmarch.k12_smem(
            dtype)
        # as many blocks as the launch bounds ask fit an SM's 228 KB (1 KB
        # of it reserved a block)
        blocks = 3 if dtype == torch.float32 else 2
        assert blocks * (kmarch.k12_smem(dtype) + 1024) <= 233472
    # the rows' six-tap groups are 16-byte aligned for load6 in both types
    assert A.WXF % 2 == A.WUF % 2 == A.WXC % 2 == A.WUC % 2 == 0
    assert kmarch.NCP % 4 == 0


def test_k12_plan_at_the_main_shapes():
    """rico 384^3 and jaenschwalde 1024x256x256 at three and four resident
    blocks an SM on 132 SMs, and rico 384^3 float64 at two."""
    f32 = torch.float32
    p = kmarch.plan("advec_mom", 384, 384, 384, 0, f32, 396)
    assert (p.tiles_i, p.tiles_j, p.chunks, p.waves, p.smem) == (
        12, 48, 2, 3, 27776)
    p = kmarch.plan("advec_mom", 384, 384, 384, 0, f32, 528)
    assert (p.chunks, p.waves) == (8, 9)
    p = kmarch.plan("advec_mom", 1024, 256, 256, 0, f32, 396)
    assert (p.tiles_i, p.tiles_j, p.chunks, p.waves) == (32, 32, 3, 8)
    p = kmarch.plan("advec_mom", 1024, 256, 256, 0, f32, 528)
    assert (p.chunks, p.waves) == (1, 2)
    p = kmarch.plan("advec_mom", 384, 384, 384, 0, torch.float64, 264)
    assert (p.chunks, p.waves, p.smem) == (5, 11, 55552)
    for ktot in (6, 16, 384):
        p = kmarch.plan("advec_mom", 45, 20, ktot, 0, f32, 396)
        assert covers_once(kmarch.chunk_bounds(p.chunks, ktot), ktot)


def rico_model(ktot, scheme, dtype=torch.float64, itot=40, jtot=24):
    """A small rico with an interpolated scheme on the CPU."""
    with open(os.path.join(ROOT, "cases", "rico", "rico.ini")) as f:
        text = f.read()
    for key, val in (("itot", itot), ("jtot", jtot), ("ktot", ktot),
                     ("swadvec", scheme)):
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    m = Model(Ini(text), "run", "rico", workdir=".", dtype=dtype,
              device="cpu", input_nc=cases.rico_input(ktot, 4000.))
    m.finish_setup()
    m.build_step()
    return m


def test_k12_wrapper_plans_and_forces(monkeypatch):
    """K12's wrapper passes the plan's chunk count (from the card's resident
    blocks) or the one forced, after the scheme and the grid."""
    monkeypatch.setattr(A, "on_cpu", lambda t: False)
    m = rico_model(16, "2i53", torch.float32)
    adv, ctx = m.advec_fused, m.ctx
    adv.k_mom = Recorder("advec_mom")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    x = [torch.zeros(shape) for _ in range(6)]
    adv.momentum(*x)
    adv.momentum(*x, chunks=5)
    (d1, a1), (_, a2) = adv.k_mom.calls
    assert d1 == torch.float32
    assert a1[-1] == kmarch.plan("advec_mom", 40, 24, 16, 0, torch.float32,
                                 396).chunks
    assert a2[-1] == 5
    assert a1[:7] == tuple(x) + (adv.table(),)
    assert a1[7:12] == (40, 24, 16, ctx.ks, A.SCHEME_ID["2i53"])
    assert a1[12:14] == (ctx.dxi, ctx.dyi)
    assert adv.mom_plan(torch.float32, 16).chunks == 16
    with pytest.raises(ValueError):
        adv.momentum(*x, chunks=17)


def k12_inputs(ktot, seed, ks=3):
    """Seeded u, v, w (w scaled by 0.3) and three carries on a 12 x 10 plane
    with ks ghost levels; the ghost levels of u, v and w, which the kernel
    never reads (u, v clamped to [ks, ke-1], w to [ks, ke]), NaN."""
    rng = np.random.default_rng(seed)
    shape = (ktot + 2 * ks, 10, 12)
    u, v, w = (torch.tensor(rng.standard_normal(shape)) for _ in range(3))
    w *= 0.3
    t0 = [torch.tensor(1e-3 * rng.standard_normal(shape)) for _ in range(3)]
    for x, top in ((u, ks + ktot), (v, ks + ktot), (w, ks + ktot + 1)):
        x[:ks] = float("nan")
        x[top:] = float("nan")
    return u, v, w, t0


@pytest.mark.parametrize("scheme", ["2i4", "2i5", "2i53", "2i62"])
@pytest.mark.parametrize("ktot", [6, 16])
def test_k12_chunked_march_is_the_plain_version(scheme, ktot):
    """Each chunk runs momentum_plain on what its blocks read, everything
    else NaN (u, v and w at planes ks+k0-3..ks+k1+2, clamped to [ks, ke-1]
    for u and v and to [ks, ke] for w; table rows k0-1..k1); the chunks'
    levels stitched together equal the whole plain version bit for bit, at
    every chunk count."""
    rng = np.random.default_rng(ktot + 7)
    ks, cc = stretched_table(scheme, ktot, rng)
    ke = ks + ktot
    u, v, w, t0 = k12_inputs(ktot, ktot, ks)
    cct = torch.tensor(cc)
    want = [t.clone() for t in t0]
    A.momentum_plain(scheme, u, v, w, *want, cct, ks, 0.7, 1.3)
    assert all(bool(torch.isfinite(x).all()) for x in want)
    for chunks in range(1, ktot + 1):
        got = [t.clone() for t in t0]
        for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
            seen = []
            for x, top in ((u, ke - 1), (v, ke - 1), (w, ke)):
                lo, hi = max(ks + k0 - 3, ks), min(ks + k1 + 2, top)
                y = torch.full_like(x, float("nan"))
                y[lo:hi + 1] = x[lo:hi + 1]
                seen.append(y)
            rows = torch.full_like(cct, float("nan"))
            rows[max(k0 - 1, 0):k1 + 1] = cct[max(k0 - 1, 0):k1 + 1]
            part = [t.clone() for t in t0]
            A.momentum_plain(scheme, *seen, *part, rows, ks, 0.7, 1.3)
            for g, p in zip(got, part):
                g[ks + k0:ks + k1] = p[ks + k0:ks + k1]
        for g, want_n in zip(got, want):
            assert torch.equal(g, want_n), chunks


def k12_march(scheme, u, v, w, tu, tv, tw, cc, ktot, ks, dxi, dyi, chunks,
              broken=None):
    """A torch emulation of csrc/advec_interp.cu advec_mom_kernel, every
    point of a plane at once (the periodic halo makes a tile's points see
    what the plane's do): each chunk warms its register columns up (planes
    k0-3..k0+3, u and v clamped to [ks, ke-1], w to [ks, ke]) and reads w at
    face k0 of u and of v from plane k0; it issues group k0-1 (u, v plane
    k0-1, w plane k0), k0 and k0+1 into K12_R slots and table row k0-1 and
    each group's row p+1 into K12_RR staged rows; level k reads groups k
    and k-1 and rows k-1..k+1, issues group k+2 into the slot group k-2
    left, shifts the columns by the planes k+4 loaded one level ahead and
    carries face k+1's w; the w update is skipped at the global level 0.
    Slots and rows start as NaN (shared memory holds no copy yet).  broken
    names one rule to break: "rows_from_k0" (row k0-1 not staged),
    "no_group_km1" (group k0-1 not issued), "w_clamp_ke1" (w clamped to
    ke-1 as u and v), "uv_clamp_ke" (u and v clamped to ke as w), "ring3"
    (three slots: group k+2 lands in the slot of group k-1) or
    "local_wall" (w skipped at the chunk's first level)."""
    C4, UP = scheme == "2i4", scheme in ("2i5", "2i53")
    R = 3 if broken == "ring3" else kmarch.K12_R
    RR = kmarch.K12_RR
    top_uv = ktot if broken == "uv_clamp_ke" else ktot - 1
    top_w = ktot - 1 if broken == "w_clamp_ke1" else ktot

    def lev_uv(p):
        return ks + min(max(p, 0), top_uv)

    def lev_w(p):
        return ks + min(max(p, 0), top_w)

    def line(P, d, dim):
        return torch.roll(P, -d, dims=dim)

    def hdiv(q, vR, vL):
        qm3, qm2, qm1, q0, qp1, qp2, qp3 = q
        if C4:
            cR = -qm1 / 16. + 9. / 16. * q0 + 9. / 16. * qp1 - qp2 / 16.
            cL = -qm2 / 16. + 9. / 16. * qm1 + 9. / 16. * q0 - qp1 / 16.
        else:
            a, b, c = 37. / 60., 8. / 60., 1. / 60.
            cR = a * (q0 + qp1) - b * (qm1 + qp2) + c * (qm2 + qp3)
            cL = a * (qm1 + q0) - b * (qm2 + qp1) + c * (qm3 + qp2)
        out = -(vR * cR - vL * cL)
        if UP:
            a, b, c = 10. / 60., 5. / 60., 1. / 60.
            uR = a * (qp1 - q0) - b * (qp2 - qm1) + c * (qp3 - qm2)
            uL = a * (q0 - qm1) - b * (qp1 - qm2) + c * (qp2 - qm3)
            out = out + (vR.abs() * uR - vL.abs() * uL)
        return out

    def ladder(row, col, q, o):
        return sum(row[col + m] * q[o + m] for m in range(6))

    def vdiv(r0, r1, X, U, q, w0, w1):
        out = w0 * ladder(r0, X, q, 0) - w1 * ladder(r1, X, q, 1)
        if UP:
            out = out + (w1.abs() * ladder(r1, U, q, 1)
                         - w0.abs() * ladder(r0, U, q, 0))
        return out

    def lines(P, q0):
        return ([q0 if d == 0 else line(P, d, -1) for d in range(-3, 4)],
                [q0 if d == 0 else line(P, d, -2) for d in range(-3, 4)])

    nan_plane = torch.full_like(u[0], float("nan"))
    for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
        ring = [(nan_plane,) * 3] * R
        rows = [torch.full_like(cc[0], float("nan"))] * RR

        def row_in(r):
            rows[r % RR] = cc[min(max(r, 0), ktot)]

        def issue(p, sl):
            ring[sl] = (u[lev_uv(p)], v[lev_uv(p)], w[lev_w(p + 1)])
            row_in(p + 1)

        uq = [u[lev_uv(k0 - 3 + m)] for m in range(7)]
        vq = [v[lev_uv(k0 - 3 + m)] for m in range(7)]
        wq = [w[lev_w(k0 - 3 + m)] for m in range(7)]
        wfu = 0.5 * (line(w[ks + k0], -1, -1) + wq[3])
        wfv = 0.5 * (line(w[ks + k0], -1, -2) + wq[3])
        if broken != "rows_from_k0":
            row_in(k0 - 1)
        if broken != "no_group_km1":
            issue(k0 - 1, 0)
        issue(k0, 1)
        issue(k0 + 1, 2)
        for k in range(k0, k1):
            z = k - k0
            issue(k + 2, (z + 3) % R)
            un, vn, wn = u[lev_uv(k + 4)], v[lev_uv(k + 4)], w[lev_w(k + 4)]
            U, V, W1 = ring[(z + 1) % R]
            Um, Vm, W = ring[z % R]
            rm, r0, r1 = rows[(k - 1) % RR], rows[k % RR], rows[(k + 1) % RR]
            wfu1 = 0.5 * (line(W1, -1, -1) + wq[4])
            wfv1 = 0.5 * (line(W1, -1, -2) + wq[4])
            fz = r0[A.RCDZI]
            x, y = lines(U, uq[3])
            t = hdiv(x, 0.5 * (uq[3] + line(U, 1, -1)),
                     0.5 * (line(U, -1, -1) + uq[3])) * dxi
            Vj = line(V, 1, -2)
            t = t + hdiv(y, 0.5 * (line(Vj, -1, -1) + Vj),
                         0.5 * (line(V, -1, -1) + vq[3])) * dyi
            tu[ks + k] += t + vdiv(r0, r1, A.WXF, A.WUF, uq, wfu, wfu1) * fz
            x, y = lines(V, vq[3])
            Ui = line(U, 1, -1)
            t = hdiv(x, 0.5 * (line(Ui, -1, -2) + Ui),
                     0.5 * (line(U, -1, -2) + uq[3])) * dxi
            t = t + hdiv(y, 0.5 * (vq[3] + line(V, 1, -2)),
                         0.5 * (line(V, -1, -2) + vq[3])) * dyi
            tv[ks + k] += t + vdiv(r0, r1, A.WXF, A.WUF, vq, wfv, wfv1) * fz
            if k > (k0 if broken == "local_wall" else 0):
                x, y = lines(W, wq[3])
                t = hdiv(x, 0.5 * (line(Um, 1, -1) + Ui),
                         0.5 * (uq[2] + uq[3])) * dxi
                t = t + hdiv(y, 0.5 * (line(Vm, 1, -2) + Vj),
                             0.5 * (vq[2] + vq[3])) * dyi
                t = t + vdiv(rm, r0, A.WXC, A.WUC, wq, 0.5 * (wq[2] + wq[3]),
                             0.5 * (wq[3] + wq[4])) * r0[A.RHDZHI]
                tw[ks + k] += t
            uq, vq, wq = uq[1:] + [un], vq[1:] + [vn], wq[1:] + [wn]
            wfu, wfv = wfu1, wfv1


class K12Emulator(Recorder):
    """K12's stand-in: called with the C entry's arguments, it checks what
    the entry checks and runs k12_march."""

    def __init__(self, scheme, broken=None):
        super().__init__("advec_mom")
        self.scheme = scheme
        self.broken = broken

    def __call__(self, dtype, u, v, w, tu, tv, tw, cc, itot, jtot, ktot, ks,
                 scheme, dxi, dyi, chunks):
        super().__call__(dtype, chunks)
        assert 1 <= chunks <= ktot and scheme == A.SCHEME_ID[self.scheme]
        assert cc.shape == (ktot + 1, A.NC)
        assert u.shape == (ktot + 2 * ks, jtot, itot)
        k12_march(self.scheme, u, v, w, tu, tv, tw, cc, ktot, ks, dxi, dyi,
                  chunks, self.broken)


def k12_rel_err(got, want):
    return max(float((g - w).abs().max() / w.abs().max())
               if bool(torch.isfinite(g).all()) else float("inf")
               for g, w in zip(got, want))


@pytest.mark.parametrize("scheme", ["2i4", "2i5", "2i53", "2i62"])
@pytest.mark.parametrize("ktot", [6, 16])
def test_k12_march_is_the_plain_version(scheme, ktot, monkeypatch):
    """The emulated march through the wrapper equals momentum_plain to
    1e-12 at every chunk count on rico's stretched levels and density, the
    ghost levels of u, v and w NaN (never read) and those of the carries
    unchanged."""
    monkeypatch.setattr(A, "on_cpu", lambda t: False)
    m = rico_model(ktot, scheme, itot=12, jtot=10)
    adv, ctx = m.advec_fused, m.ctx
    ks = ctx.ks
    u, v, w, t0 = k12_inputs(ktot, 3 * ktot + len(scheme), ks)
    want = [x.clone() for x in t0]
    A.momentum_plain(scheme, u, v, w, *want, adv.table(), ks, ctx.dxi,
                     ctx.dyi)
    assert k12_rel_err(t0, want) > 1e-3
    for chunks in range(1, ktot + 1):
        got = [x.clone() for x in t0]
        adv.k_mom = K12Emulator(scheme)
        adv.momentum(u, v, w, *got, chunks=chunks)
        assert [c[1][0] for c in adv.k_mom.calls] == [chunks]
        assert k12_rel_err(got, want) <= 1e-12, chunks
        for g, x in zip(got, t0):
            assert torch.equal(g[:ks], x[:ks])
            assert torch.equal(g[ctx.ke:], x[ctx.ke:])


@pytest.mark.parametrize("broken", ["rows_from_k0", "no_group_km1",
                                    "w_clamp_ke1", "uv_clamp_ke", "ring3",
                                    "local_wall"])
def test_k12_march_needs_each_edge_rule(broken, monkeypatch):
    """Each rule of the march, broken on its own, breaks the result at some
    chunk count, in a scheme with and one without the upwind parts."""
    monkeypatch.setattr(A, "on_cpu", lambda t: False)
    for scheme in ("2i5", "2i62"):
        m = rico_model(6, scheme, itot=12, jtot=10)
        adv, ctx = m.advec_fused, m.ctx
        ks = ctx.ks
        u, v, w, t0 = k12_inputs(6, 5, ks)
        want = [x.clone() for x in t0]
        A.momentum_plain(scheme, u, v, w, *want, adv.table(), ks, ctx.dxi,
                         ctx.dyi)
        worst = 0.
        for chunks in range(1, 7):
            got = [x.clone() for x in t0]
            adv.k_mom = K12Emulator(scheme, broken)
            adv.momentum(u, v, w, *got, chunks=chunks)
            worst = max(worst, k12_rel_err(got, want))
        assert worst > 1e-6, (broken, scheme)


def test_k12_chip_cases_on_the_cpu(monkeypatch):
    """chip_smoke.py's K12 cases on a small rico in 2i5, on the CPU (both
    calls take the plain version here): the forced counts and the plan's,
    each aligned and shifted past a 16-byte boundary, with NaN ghost levels
    that the plain version never reads."""
    import chip_smoke
    monkeypatch.setattr(A.AdvecInterpFused, "mom_plan",
                        lambda self, dtype, chunks=None: kmarch.plan(
                            "advec_mom", self.ctx.itot, self.ctx.jtot,
                            self.ctx.ktot, 0, dtype, 396, chunks))
    m = rico_model(6, "2i5", itot=20, jtot=12)
    counts = chip_smoke.mom_chunks(m, torch.float64)
    assert counts == sorted({1, 2, 3, 6, kmarch.plan(
        "advec_mom", 20, 12, 6, 0, torch.float64, 396).chunks})
    cases = chip_smoke.advec_mom_cases(torch, m, 5, counts)
    assert len(cases) == 2 * len(counts)
    seen = []
    real = m.advec_fused.momentum

    def momentum(*a, chunks=None):
        seen.append((chunks, tuple(x.data_ptr() % 16 for x in a[:3])))
        return real(*a, chunks=chunks)

    m.advec_fused.momentum = momentum
    for name, kern, plain, kind in cases:
        assert name == "advec_mom" and kind == "field"
        got, want = kern(), plain()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(bool(torch.isfinite(g).all()) for g in got)
    assert [c for c, _ in seen] == [c for c in counts for _ in range(2)]
    assert [a for _, a in seen[:2]] == [(0, 0, 0), (8, 8, 8)]
