"""The eddy viscosity K1 (``Fused.evisc``) and K14
(``FusedGeneric.evisc_n2``): one k-march, ``evisc_kernel<T, ST>`` in
``csrc/evisc.cu``, on the CPU.

* its launch bounds, ring and entries read from the source; its wrappers,
  with recorders in place of the kernels: the plan's chunk count (from the
  card's resident blocks, asked in the call's stratified mode) or the one
  forced, after the C entries' other arguments;
* ``evisc_march``, a torch emulation of the kernel's chunked march tile by
  tile (five slots of a group, u's, v's and w's plane p gathered with a
  halo of one, each field's plane index clamped by its own rule; the
  staged rows; th's column or N2 at the thread's own point only; wrapped
  virtual points whose stores are guarded), equals ``evisc_plain`` to
  1e-12 in float64 at every chunk count for ktot 16 and 6, on a 45 x 20
  plane (partial tiles in i and j), in both modes (clamped and ghost
  planes) and every stratified mode (0, 1: N2 from th, 2: N2 read); the
  fields' levels that the kernel never reads are NaN, and so are the
  slots and rows before a copy lands and th's halo;
* each edge rule of the march, broken on its own (``broken=``), changes
  the result: group k0-1 issued first, plane k1 read at a chunk's top,
  w's planes clamped to [lo, ke] and u's and v's to [lo, hic], th's
  planes clamped, the staged row of level k, the halo wrapped, a partial
  tile's virtual points storing nothing;
* the emulation called with the C entries' arguments through the wrappers
  (an interior view of a kcells tensor as ``out``, as generic_viscosity
  passes it) equals the plain versions, and ``chip_smoke.py``'s K1/K14
  cases and forced checks run on the CPU.
"""

import os
import re

import numpy as np
import pytest
import torch

from microhh_torch import kernels
from microhh_torch.ops import fused as F
from microhh_torch.ops import kmarch

from test_torch_kmarch import Recorder, rico_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "microhh_torch", "csrc", "evisc.cu")
RULES = ("no_group_km1", "no_plane_k1", "w_as_uv", "uv_as_w", "th_unclamped",
         "row_next", "halo_clamp", "unguarded")
ARGS = dict(dxi=0.7, dyi=1.3, tPr=1. / 3.)
NAN = float("nan")


def flat_source():
    """evisc.cu with its macros' line continuations and its runs of white
    space each taken as one blank."""
    with open(SRC) as f:
        return re.sub(r"\s+", " ", f.read().replace("\\\n", " "))


def test_kernel_structure_is_the_source():
    """One body for K1 and K14, templated on the stratified mode, launched
    with its dynamic shared memory; a group of three fields a slot, five
    slots, one commit group and one barrier a level; K7 on the same march."""
    flat = flat_source()
    assert ("__launch_bounds__(EV_NT, sizeof(T) == 4 ? 5 : 3) "
            "evisc_kernel(const EviscArgs<T> a)" in flat)
    assert flat.count("evisc_kernel(") == 1
    assert "kernel<<<grid, block, smem, stream>>>(a);" in flat
    assert "issue(k + 3, sm == 0 ? EV_R - 1 : sm - 1);" in flat
    assert "km::wait_pending<1>(); // group k+1 has landed" in flat
    assert "km::wait_pending<2>(); // groups k0-1 and k0 have landed" in flat
    # th and N2 only at the thread's own point, a level ahead
    assert "if (ST == 1) an = th_at(min(k + 2, k1));" in flat
    assert "if (ST == 2) n2n = n2_at(min(k + 1, k1 - 1));" in flat
    assert "const KV<T, km::RS> A{nullptr, nullptr, nullptr, a0, a1, a2};" \
        in flat
    # the per-field clamps
    assert "clampi(a.ks + p, lo, hic) * plane" in flat
    assert "clampi(a.ks + p, lo, ke) * plane" in flat
    # three kernels: K1/K14, K7 and K7's reduction; K7 is the same march
    # with its maxima (test_torch_limits_march.py), no ring is left
    assert flat.count("__global__") == 3
    assert "evisc_march<T, ST, false>(a);" in flat
    assert "evisc_march<T, ST, true>(a);" in flat
    assert "Ring<T>" not in flat and "load_tile" not in flat
    # the entries take the chunk count last and report their occupancy
    for entry in ("int stratified, int ghosts, int chunks, void* stream",
                  "double tPr, int chunks, void* stream",
                  "mhh_evisc_info_##SUF(int scheme, int S, int* out)"):
        assert entry in flat
    assert kernels.SIGNATURES["evisc"][-1] is kernels._I
    assert len(kernels.SIGNATURES["evisc"]) == 16
    assert len(kernels.SIGNATURES["evisc_n2"]) == 14
    assert "evisc" in kernels.INFO
    # the staged row holds ce and the quotient the kernel reads
    assert F.NE + 1 <= kmarch.EV_NCP


def test_wrappers_plan_and_force(monkeypatch):
    """K1 and K14 pass the plan's chunk count (the occupancy asked in the
    call's stratified mode) or the one forced, after the C entries' other
    arguments."""
    monkeypatch.setattr(F, "on_cpu", lambda t: False)
    m = rico_model(16, "2", torch.float32)
    fz, ctx = m.fused, m.ctx
    asked = []

    class Rec(Recorder):
        def info(self, dtype, scheme, S=0):
            asked.append((dtype, scheme, S))
            return super().info(dtype, scheme, S)

    fz.k_evisc, fz.k_evisc_n2 = Rec("evisc"), Rec("evisc_n2")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    interior = (ctx.ktot, ctx.jtot, ctx.itot)
    u, v, w, th = (torch.zeros(shape) for _ in range(4))
    n2 = torch.zeros(interior)
    want = kmarch.plan("evisc", 40, 24, 16, 0, torch.float32, 396).chunks
    out = fz.evisc(u, v, w, th)
    buf = torch.zeros(shape)
    fz.evisc(u, v, w, th, out=buf[ctx.ks:ctx.ke], chunks=5)
    (d1, a1), (_, a2) = fz.k_evisc.calls
    assert d1 == torch.float32
    assert [x is y for x, y in zip(a1[:6], (u, v, w, th, out, fz.ce))] \
        == [True] * 6
    assert a2[4].data_ptr() == buf[ctx.ks].data_ptr()
    assert a1[6:13] == (40, 24, 16, ctx.ks, ctx.dxi, ctx.dyi, fz.tPr)
    assert a1[13:] == (fz.stratified, 1, want)
    assert a2[-1] == 5
    fz.evisc_n2(u, v, w, n2)
    fz.evisc_n2(u, v, w, n2, chunks=16)
    (_, b1), (_, b2) = fz.k_evisc_n2.calls
    assert [x is y for x, y in zip(b1[:4], (u, v, w, n2))] == [True] * 4
    assert b1[6:13] == (40, 24, 16, ctx.ks, ctx.dxi, ctx.dyi, fz.tPr)
    assert b1[13:] == (want,) and b2[13:] == (16,)
    # the occupancy of the form launched: K1's mode, then K14's
    assert {a[1] for a in asked} == {fz.stratified, 2}
    assert fz.evisc_plan(torch.float32, 2, 3).chunks == 3
    with pytest.raises(ValueError):
        fz.evisc(u, v, w, th, chunks=17)


# --------------------------------------------------------------------------
#  the chunked march, emulated
# --------------------------------------------------------------------------

def evisc_march(u, v, w, th, out, ce, ks, dxi, dyi, tPr, stratified, ghosts,
                chunks, broken=None):
    """A torch emulation of csrc/evisc.cu evisc_kernel<T, stratified>: every
    chunk [k0, k1) of every (EV_TJ, 32) tile (the tile's virtual points wrap
    around the plane) issues group k0-1 (planes k0-1 of u, v and w,
    gathered with a halo of one, wrapped) into slot 0 and groups k0 ..
    k0+2 into slots 1-3, the table row of a level of the chunk beside its
    group; a plane index is clamped to [lo, hic] for u and v (and th) and
    to [lo, ke] for w (lo = ks, hic = ke-1 when ghosts is 0; lo = ks-1, hic
    = ke when 1).  Level k reads groups k-1, k, k+1 and row k, issues group
    k+3 (none past plane k1) into the slot of group k-2, and takes th
    (stratified 1: planes k-1 .. k+1) or N2 (2: level k) at the thread's
    own point only, loaded a level ahead; only the tile's own points store
    into out (ktot, jtot, itot).  Slots, rows and th's halo start as NaN.
    broken names one rule to break: "no_group_km1" (group k0-1 not issued),
    "no_plane_k1" (no plane past k1-1), "w_as_uv" (w clamped to [lo, hic]),
    "uv_as_w" (u and v clamped to [lo, ke]), "th_unclamped" (th's planes
    not clamped), "row_next" (row k+1 read at level k), "halo_clamp" (the
    halo clamped to the plane, not wrapped), "unguarded" (a partial tile's
    virtual points store too, at their own offsets j*itot + i)."""
    kcells, jtot, itot = u.shape
    ktot = ce.shape[0]
    TI, TJ, R = kmarch.TI, kmarch.EV_TJ, kmarch.EV_R
    ke = ks + ktot
    lo, hic = (ks - 1, ke) if ghosts else (ks, ke - 1)
    hi_uv = ke if broken == "uv_as_w" else hic
    hi_w = hic if broken == "w_as_uv" else ke
    th_lo, th_hi = (-kcells, 2 * kcells) if broken == "th_unclamped" else (
        lo, hic)
    flat = out.view(-1)

    def clamp(x, a, b):
        return min(max(x, a), b)

    for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
        top = k1 - 1 if broken == "no_plane_k1" else k1
        for j0 in range(0, jtot, TJ):
            for i0 in range(0, itot, TI):
                def index(x0, n, size):
                    ix = torch.arange(x0 - 1, x0 + n + 1)
                    return (ix.clamp(0, size - 1) if broken == "halo_clamp"
                            else ix % size)
                rj, ci = index(j0, TJ, jtot), index(i0, TI, itot)
                jin, iin = torch.meshgrid(torch.arange(j0, j0 + TJ),
                                          torch.arange(i0, i0 + TI),
                                          indexing="ij")
                mask = (jin < jtot) & (iin < itot)
                if broken == "unguarded":
                    store = jin * itot + iin
                else:
                    store = (jin % jtot) * itot + iin % itot
                    store = store[mask]
                # the own points, wrapped
                oj, oi = rj[1:-1] % jtot, ci[1:-1] % itot
                ring = [torch.full((3, TJ + 2, TI + 2), NAN,
                                   dtype=u.dtype)] * R
                rows = [torch.full((ce.shape[1],), NAN, dtype=u.dtype)] * R

                def issue(p, sl):
                    if p <= top:
                        lc = clamp(ks + p, lo, hi_uv)
                        lw = clamp(ks + p, lo, hi_w)
                        ring[sl] = torch.stack([f[lev][rj][:, ci] for f, lev
                                                in ((u, lc), (v, lc),
                                                    (w, lw))])
                        if k0 <= p < k1:
                            rows[sl] = ce[p]

                def own(a, lev):
                    """a's plane lev at the tile's own points, NaN around."""
                    x = torch.full((TJ + 2, TI + 2), NAN, dtype=u.dtype)
                    x[1:-1, 1:-1] = a[lev][oj][:, oi]
                    return x

                def th_at(p):
                    return own(th, clamp(ks + p, th_lo, th_hi))

                if broken != "no_group_km1":
                    issue(k0 - 1, 0)
                for p in range(k0, k0 + 3):
                    issue(p, p - k0 + 1)
                if stratified == 1:
                    col = [th_at(k0 - 1), th_at(k0), th_at(k0 + 1)]
                n2 = own(th, k0) if stratified == 2 else None
                sm = 0
                for k in range(k0, k1):
                    sc, sp = (sm + 1) % R, (sm + 2) % R
                    issue(k + 3, (sm - 1) % R)
                    if stratified == 1:
                        nxt = th_at(min(k + 2, k1))
                    if stratified == 2:
                        n2n = own(th, min(k + 1, k1 - 1))
                    uvw = [torch.stack([ring[s][n] for s in (sm, sc, sp)])
                           for n in range(3)]
                    row = rows[sp if broken == "row_next" else sc][None]
                    a3 = torch.stack(col) if stratified == 1 else None
                    ev = F.evisc_plain(*uvw, a3, row, 1, dxi, dyi, tPr,
                                       bool(stratified), True,
                                       None if n2 is None else n2[None])
                    ev = ev[0, 1:-1, 1:-1]
                    if broken == "unguarded":
                        offs = k * jtot * itot + store.flatten()
                        keep = offs < flat.numel()
                        flat[offs[keep]] = ev.flatten()[keep]
                    else:
                        out[k].view(-1)[store] = ev[mask]
                    if stratified == 1:
                        col = col[1:] + [nxt]
                    if stratified == 2:
                        n2 = n2n
                    sm = sc


def inputs(ktot, seed, ghosts, ks=3, jtot=20, itot=45):
    """Seeded u, v, w (w scaled by 0.3), th around 300 K and an N2 field on
    a (jtot, itot) plane with ks ghost levels, scaled so that the stability
    term takes both branches, and a random stretched (ktot, NE) table with
    noise in every column; the levels the kernel never reads (u, v and th
    outside [lo, hic], w outside [ks, ke]) are NaN."""
    rng = np.random.default_rng(seed)
    shape = (ktot + 2 * ks, jtot, itot)

    def field(scale=1.):
        return torch.tensor(scale * rng.standard_normal(shape))

    u, v, w, th = field(), field(), field(0.3), 300. + field(200.)
    n2 = torch.tensor(10. * rng.standard_normal((ktot, jtot, itot)))
    ke = ks + ktot
    lo, hic = (ks - 1, ke) if ghosts else (ks, ke - 1)
    for x, a, b in ((u, lo, hic), (v, lo, hic), (th, lo, hic), (w, ks, ke)):
        x[:a] = NAN
        x[b + 1:] = NAN
    ce = 1e-2 * rng.standard_normal((ktot, F.NE))
    ce[:, [F.E_DZI, F.E_DZHI, F.E_DZHI1]] += 1. / (0.5 + rng.random((ktot, 3)))
    ce[:, F.E_MLEN2] += 1. + rng.random(ktot)
    ce[:, F.E_THREF] += 300. + rng.random(ktot)
    ce[:, F.E_TOPS] = rng.standard_normal(ktot)
    return u, v, w, th, n2, torch.tensor(ce)


def plain(u, v, w, th, n2, ce, ks, stratified, ghosts):
    a = ARGS
    return F.evisc_plain(u, v, w, th, ce, ks, a["dxi"], a["dyi"], a["tPr"],
                         bool(stratified), bool(ghosts),
                         n2 if stratified == 2 else None)


def march(u, v, w, th, n2, ce, ks, stratified, ghosts, chunks, broken=None):
    """evisc_march with the test's numbers into a NaN output."""
    a = ARGS
    out = torch.full((ce.shape[0],) + tuple(u.shape[1:]), NAN,
                     dtype=u.dtype)
    evisc_march(u, v, w, n2 if stratified == 2 else th, out, ce, ks,
                a["dxi"], a["dyi"], a["tPr"], stratified, ghosts, chunks,
                broken)
    return out


def rel_err(got, want):
    """max |got - want| / max |want|, infinite where got is not finite."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("stratified", [0, 1, 2])
@pytest.mark.parametrize("ghosts", [0, 1])
@pytest.mark.parametrize("ktot", [6, 16])
def test_evisc_march_is_the_plain_version(ktot, ghosts, stratified):
    """The emulated march equals the plain version to 1e-12 at every chunk
    count, on partial tiles, with NaN on the levels the kernel never
    reads."""
    ks = 3
    x = inputs(ktot, ktot + 3 * ghosts + stratified, ghosts, ks)
    want = plain(*x, ks, stratified, ghosts)
    assert bool(torch.isfinite(want).all())
    if stratified:
        # both branches of the stability term are taken
        neutral = plain(*x, ks, 0, ghosts)
        assert bool((want < neutral).any()) and bool((want > 0.).all())
        floor = neutral * np.sqrt(F.cst.dsmall)
        assert bool(torch.isclose(want, floor, rtol=1e-9).any())
    for chunks in range(1, ktot + 1):
        got = march(*x, ks, stratified, ghosts, chunks)
        assert rel_err(got, want) <= 1e-12, chunks


@pytest.mark.parametrize("broken", RULES)
def test_evisc_march_needs_each_edge_rule(broken):
    """Each rule of the march, broken on its own, breaks the result at some
    chunk count in some mode (clamped and ghost planes, N2 from th)."""
    ks, ktot = 3, 6
    worst = 0.
    for ghosts in (0, 1):
        x = inputs(ktot, 11 + ghosts, ghosts, ks)
        want = plain(*x, ks, 1, ghosts)
        for chunks in range(1, ktot + 1):
            got = march(*x, ks, 1, ghosts, chunks, broken)
            worst = max(worst, rel_err(got, want))
    assert worst > 1e-6, broken


class EviscEmulator(Recorder):
    """K1's or K14's stand-in: called with the C entry's arguments, it
    checks what the entry checks and runs evisc_march."""

    def __call__(self, dtype, *args):
        if self.name == "evisc":
            (u, v, w, th, out, ce, itot, jtot, ktot, ks, dxi, dyi, tPr,
             stratified, ghosts, chunks) = args
        else:
            (u, v, w, th, out, ce, itot, jtot, ktot, ks, dxi, dyi, tPr,
             chunks) = args
            stratified, ghosts = 2, 1
        super().__call__(dtype, chunks)
        assert 1 <= chunks <= ktot and ce.shape == (ktot, F.NE)
        assert u.shape == (ktot + 2 * ks, jtot, itot)
        assert out.shape == (ktot, jtot, itot) and out.is_contiguous()
        evisc_march(u, v, w, th, out, ce, ks, dxi, dyi, tPr, stratified,
                    ghosts, chunks)


def test_evisc_march_through_the_wrappers(monkeypatch):
    """The emulation called with the C entries' arguments through the
    wrappers equals the plain versions at every chunk count: K1 on a rico
    (ghost planes, the moist N2 and unstratified), into an interior view
    of a kcells tensor, and K14 with an N2 field."""
    m = rico_model(6, "2", itot=45, jtot=20)
    fz, ctx = m.fused, m.ctx
    ks, ke = ctx.ks, ctx.ke
    u, v, w, th, n2, _ = inputs(6, 21, 1, ks)
    assert fz.stratified == 1
    want = {1: fz.evisc(u, v, w, th)}
    fz.stratified = 0
    want[0] = fz.evisc(u, v, w, th)
    with_n2 = fz.evisc_n2(u, v, w, n2)
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    for chunks in range(1, 7):
        fz.k_evisc = EviscEmulator("evisc")
        fz.k_evisc_n2 = EviscEmulator("evisc_n2")
        for st in (0, 1):
            fz.stratified = st
            buf = torch.full((ctx.kcells, ctx.jtot, ctx.itot), NAN,
                             dtype=u.dtype)
            fz.evisc(u, v, w, th, out=buf[ks:ke], chunks=chunks)
            assert rel_err(buf[ks:ke], want[st]) <= 1e-12, (st, chunks)
            assert bool(torch.isnan(buf[:ks]).all())
            assert bool(torch.isnan(buf[ke:]).all())
        got = fz.evisc_n2(u, v, w, n2, chunks=chunks)
        assert rel_err(got, with_n2) <= 1e-12, chunks
        assert [c[1][0] for c in fz.k_evisc.calls] == [chunks] * 2
        assert [c[1][0] for c in fz.k_evisc_n2.calls] == [chunks]


@pytest.mark.parametrize("case", ["rico", "SBL", "sullivan2011",
                                  "drycblles"])
def test_evisc_chip_cases_on_the_cpu(case, monkeypatch):
    """chip_smoke.py's K1/K14 cases on a small model of each case it checks
    them on, on the CPU (both calls take the plain version here): the
    forced counts and the plan's, aligned and shifted past a 16-byte
    boundary, the model's stratified mode in both regimes (unstable: the
    viscosity above the neutral one everywhere; strongly stable: the floor
    everywhere) and unstratified, NaN levels that the plain version never
    reads, an untouched NaN around the output; and the forced check of a
    run in the path's own mode."""
    import chip_smoke
    monkeypatch.setattr(F.Fused, "evisc_plan",
                        lambda self, dtype, st, chunks=None:
                        kmarch.plan("evisc", self.ctx.itot, self.ctx.jtot,
                                    self.ctx.ktot, 0, dtype, 528, chunks))
    n, k = (20, 12), 6
    f64 = torch.float64
    if case == "rico":
        m = chip_smoke.build_rico(torch, n, k, f64, "cpu")
        m.build_step()
    elif case == "SBL":
        m = chip_smoke.build_sbl(torch, 20, k, f64, "cpu")
        m.build_step()
    elif case == "sullivan2011":
        m = chip_smoke.build_sullivan(torch, n, k, f64, "cpu")
        m.build_step(unfolded=True)
    else:
        m = chip_smoke.build_model(torch, 20, k, f64, "cpu")
        m.build_step(fold=False)
    fz = m.fused
    own = {"rico": 1, "SBL": 2, "sullivan2011": 1, "drycblles": 1}[case]
    assert fz.stratified == own
    assert fz.ghosts == (case != "drycblles")
    counts = chip_smoke.evisc_chunks(m, f64)
    assert counts == sorted({1, 2, 3, 6, kmarch.plan(
        "evisc", m.ctx.itot, m.ctx.jtot, 6, 0, f64, 528).chunks})
    cases = chip_smoke.evisc_cases(torch, m, 5, counts)
    assert len(cases) == 2 * 3 * len(counts)
    seen = []
    real, real_n2 = fz.evisc, fz.evisc_n2 if own == 2 else None

    def evisc(u, v, w, th, out=None, chunks=None):
        seen.append(("K1", chunks, u.data_ptr() % 16, fz.stratified))
        return real(u, v, w, th, out=out, chunks=chunks)

    def evisc_n2(u, v, w, n2, out=None, chunks=None):
        seen.append(("K14", chunks, u.data_ptr() % 16, 2))
        return real_n2(u, v, w, n2, out=out, chunks=chunks)

    fz.evisc, fz.evisc_n2 = evisc, evisc_n2
    outs = []
    for name, kern, plain_call, kind in cases:
        assert kind == "field"
        got, want = kern(), plain_call()
        assert name == ("evisc_n2" if seen[-1][0] == "K14" else "evisc")
        assert torch.equal(got[0], want[0])
        assert bool(torch.isfinite(got[0]).all())
        outs.append(got[0])
    assert [c[1] for c in seen] == [c for c in counts for _ in range(6)]
    assert {c[2] for c in seen} == {0, 8}
    assert [c[3] for c in seen[:3]] == [own, own, 0]
    # unstable: the viscosity above the neutral one; stable: the floor
    unstable, stable, neutral = outs[:3]
    assert bool((unstable > 1.01 * neutral).all())
    assert torch.allclose(stable, neutral * np.sqrt(F.cst.dsmall),
                          rtol=1e-12, atol=0.)
    # the forced check of a run's path: its own mode in both regimes,
    # aligned and shifted
    monkeypatch.setattr(chip_smoke, "compare",
                        lambda torch_, name, kern, plain_call, kind, dtype,
                        where: seen.append(name) or 0.)
    del seen[:]
    chip_smoke.check_evisc_forced(torch, m)
    name = "evisc_n2" if own == 2 else "evisc"
    assert seen == [name] * 2 * 2 * len(counts)
