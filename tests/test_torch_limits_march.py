"""The adaptive-dt limits pass K7 (``Fused.limits``): K1's k-march with the
per-level maxima as its epilogue, ``limits_kernel<T, ST>`` in
``csrc/evisc.cu``, on the CPU.

* its structure read from the source: one march body with K1/K14
  (``evisc_march<T, ST, LIM>``), one barrier a level and one after the
  chunk's last level, th read only under ST 1 and N2 only under ST 2, the
  common.cuh ring gone; its entries (the chunk count last, an info entry);
  its wrapper, with a recorder in place of the kernel: the (2, ktot, tiles)
  partials and the plan's chunk count (asked in the call's stratified mode)
  or the one forced;
* ``limits_march``, a torch emulation of the kernel's chunked march tile by
  tile (five slots of a group, u's, v's and w's plane p with a halo of one,
  each field's own clamp; the staged rows; th's column or N2 at the
  thread's own point; the CFL rate from slot k's u(i+1), v(j+1) and the
  column's w(k+1); a partial tile's wrapped virtual points entering the
  maxima; every thread's two rates in a buffer of the level's parity,
  folded after the next level's barrier, and the last level after one of
  its own, by two warps (a lane eight neighbouring threads' rates, then the
  lanes) into the tile's column of the (2, ktot, tiles) partials; the
  maximum over the tiles), equals ``limits_plain`` to 1e-12 in float64 at 1-5
  chunks and a level a chunk for ktot 16 and 6 on a 45 x 20 plane, in both
  modes (clamped and ghost planes) and every stratified mode (0, 1: N2
  from th, 2: N2 read); its partials and lane maxima are the plain fields'
  maxima over each tile and each run of eight points of a tile row; the
  levels the kernel never reads are
  NaN, and so are the slots, rows and partials before they are written;
* one NaN planted in u (or in N2) shows in the maximum of its level alone
  (the CFL rate's; the eddy viscosity's where the plain version has it);
* each edge rule, broken on its own (``broken=``), changes the result;
* the emulation called with the C entry's arguments through the wrapper
  equals the plain version, and ``chip_smoke.py``'s K7 cases and forced
  checks run on the CPU.
"""

import pytest
import torch

from microhh_torch import kernels
from microhh_torch.ops import fused as F
from microhh_torch.ops import kmarch

from test_torch_evisc_march import ARGS, NAN, flat_source, inputs
from test_torch_kmarch import Recorder, rico_model

RULES = ("no_group_km1", "no_plane_k1", "no_last_fold", "part_by_block",
         "w_as_uv", "th_unclamped", "row_next", "halo_clamp")


def march_body(flat):
    """evisc_march's body in the flattened source."""
    a = flat.index("__device__ __forceinline__ void evisc_march(")
    return flat[a:flat.index("km::wait_all(); }", a)]


def test_limits_kernel_structure_is_the_source():
    """K7 is K1's march with its maxima as the epilogue: one barrier a
    level (and one after the chunk's last level), no th read without
    stratification, no ring of common.cuh left; its entry takes the chunk
    count last and it reports its occupancy."""
    flat = flat_source()
    body = march_body(flat)
    assert ("__launch_bounds__(EV_NT, sizeof(T) == 4 ? 5 : 3) "
            "limits_kernel(const EviscArgs<T> a) { "
            "evisc_march<T, ST, true>(a); }" in flat)
    assert "evisc_kernel(const EviscArgs<T> a) { evisc_march<T, ST, false>(a); }" \
        in flat
    # by value: the march on a reference to the parameter gave K1 other SASS
    assert "void evisc_march(const EviscArgs<T> a) {" in flat
    # barriers: the warm-up's, one a level, and K7's after the last level
    loop = body[body.index("for (int k = k0; k < k1; ++k) {"):]
    assert body.count("__syncthreads();") == 3
    assert loop.count("__syncthreads();") == 2
    assert ("if constexpr (LIM) { // the chunk's last level, after a barrier "
            "of its own __syncthreads(); fold(k1 - 1); }" in loop)
    assert "if (LIM && k > k0) fold(k - 1);" in loop
    # th only under ST 1, N2 only under ST 2: none read when ST is 0
    assert ("if (ST == 1) { a0 = th_at(k0 - 1); a1 = th_at(k0); "
            "a2 = th_at(k0 + 1); }" in body)
    assert "if (ST == 1) an = th_at(min(k + 2, k1));" in body
    assert "if (ST == 2) n2 = n2_at(k0);" in body
    assert "if (ST == 2) n2n = n2_at(min(k + 1, k1 - 1));" in body
    assert body.count("th_at(") == 4 and body.count("n2_at(") == 2
    assert body.count("a.th") == 2      # the two loaders' own reads
    # every thread's two rates, two levels of them; warps 0 and 1 fold one
    # rate each (a lane eight threads' rates, then the lanes) into the
    # tile's partial
    assert "red[(k & 1) * 2 * EV_NT + tid] = cfl;" in body
    assert "red[((k & 1) * 2 + 1) * EV_NT + tid] = ev;" in body
    assert ("if (ty < 2) { const T m = warp_max(max8(red + ((k & 1) * 2 + ty) "
            "* EV_NT + 8 * tx));" in body)
    assert ("if (tx == 0) a.out[((long long)ty * a.ktot + k) * tiles + tile] "
            "= m;" in body)
    assert "return evisc_smem<T>() + (size_t)2 * 2 * EV_NT * sizeof(T);" \
        in flat
    # the old ring is gone
    for gone in ("load_tile", "Ring<", "load_ring", "evisc_point",
                 "cfl_point", "common.cuh"):
        assert gone not in flat, gone
    assert flat.count("__global__") == 3
    # the entry takes the chunk count last; an info entry
    assert ("int stratified, int ghosts, int chunks, void* stream) { "
            "return mhh::launch_limits<T>" in flat)
    assert "mhh_limits_info_##SUF(int scheme, int S, int* out)" in flat
    assert len(kernels.SIGNATURES["limits"]) == 17
    assert kernels.SIGNATURES["limits"][-1] is kernels._I
    assert "limits" in kernels.INFO


def test_limits_wrapper_plans_and_forces(monkeypatch):
    """K7's wrapper passes (2, ktot, tiles) partials, its mode and the plan's
    chunk count (the occupancy asked in its stratified mode) or the one
    forced, last."""
    monkeypatch.setattr(F, "on_cpu", lambda t: False)
    m = rico_model(16, "2", torch.float32)
    fz, ctx = m.fused, m.ctx
    asked = []

    class Rec(Recorder):
        def info(self, dtype, scheme, S=0):
            asked.append(scheme)
            return super().info(dtype, scheme, S)

    fz.k_limits = Rec("limits")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    u, v, w, th = (torch.zeros(shape) for _ in range(4))
    want = kmarch.plan("limits", 40, 24, 16, 0, torch.float32, 396)
    assert (want.tiles_i, want.tiles_j) == (2, 3)
    fz.limits(u, v, w, th)
    fz.limits(u, v, w, th, chunks=5)
    fz.stratified = 2
    fz.limits(u, v, w, torch.zeros(ctx.ktot, ctx.jtot, ctx.itot), chunks=16)
    (d1, a1), (_, a2), (_, a3) = fz.k_limits.calls
    assert d1 == torch.float32
    assert [x is y for x, y in zip(a1[:4], (u, v, w, th))] == [True] * 4
    assert a1[4].shape == (2, 16, 6) and a1[5].shape == (2, 16)
    assert a1[6] is fz.ce
    assert a1[7:14] == (40, 24, 16, ctx.ks, ctx.dxi, ctx.dyi, fz.tPr)
    assert a1[14:] == (1, 1, want.chunks)
    assert a2[14:] == (1, 1, 5) and a3[14:] == (2, 1, 16)
    assert asked == [1, 1, 2]
    assert fz.limits_plan(torch.float32, 0, 3).chunks == 3
    with pytest.raises(ValueError):
        fz.limits(u, v, w, th, chunks=17)


# --------------------------------------------------------------------------
#  the chunked march, emulated
# --------------------------------------------------------------------------

def limits_march(u, v, w, th, part, out, ce, ks, dxi, dyi, tPr, stratified,
                 ghosts, chunks, broken=None, lanes=None):
    """A torch emulation of csrc/evisc.cu limits_kernel<T, stratified> and
    limits_reduce: every chunk [k0, k1) of every (EV_TJ, 32) tile (block
    (tile, z); the tile's virtual points wrap around the plane) issues
    group k0-1 (planes k0-1 of u, v and w, gathered with a halo of one) into
    slot 0 and groups k0 .. k0+2 into slots 1-3, the table row of a level of
    the chunk beside its group; a plane index is clamped to [lo, hic] for u
    and v (and th) and to [lo, ke] for w (lo = ks, hic = ke-1 when ghosts is
    0; lo = ks-1, hic = ke when 1).  Level k reads groups k-1, k, k+1 and row
    k, issues group k+3 (none past plane k1) into the slot of group k-2,
    takes th (stratified 1: planes k-1 .. k+1) or N2 (2: level k) at the
    thread's own point, folds level k-1's rates (after its barrier),
    computes the eddy viscosity and the CFL rate at every point of the tile
    and writes them into red[k & 1] in thread order (tid = 32 row + column);
    the chunk's last level is folded after the loop.  A fold of a rate takes
    the maximum of each lane's eight threads (lane l: threads 8l .. 8l+7),
    then of the 32 lanes, into part[rate, k, tile] (part: (2, ktot,
    tiles)); then out[rate, k] is the maximum over the tiles and 0.  Slots,
    rows, red and th's halo start as NaN.  lanes, when a dict, gets
    (k, tile) -> the (2, 32) lane maxima.  broken names one rule to
    break: "no_group_km1" (group k0-1 not issued), "no_plane_k1" (no plane
    past k1-1), "no_last_fold" (the chunk's last level not folded),
    "part_by_block" (the partial at the block's index, tile + z * tiles,
    in the flat array, dropped past its end), "w_as_uv" (w clamped to [lo,
    hic], so w(k+1) as u's plane), "th_unclamped" (th's planes not
    clamped), "row_next" (row k+1 read at level k), "halo_clamp" (the halo
    clamped to the plane, not wrapped)."""
    kcells, jtot, itot = u.shape
    ktot = ce.shape[0]
    TI, TJ, R = kmarch.TI, kmarch.EV_TJ, kmarch.EV_R
    tiles_i, tiles_j = -(-itot // TI), -(-jtot // TJ)
    tiles = tiles_i * tiles_j
    ke = ks + ktot
    lo, hic = (ks - 1, ke) if ghosts else (ks, ke - 1)
    hi_w = hic if broken == "w_as_uv" else ke
    th_lo, th_hi = (-kcells, 2 * kcells) if broken == "th_unclamped" else (
        lo, hic)
    flat = part.view(-1)

    def clamp(x, a, b):
        return min(max(x, a), b)

    for z, (k0, k1) in enumerate(kmarch.chunk_bounds(chunks, ktot)):
        top = k1 - 1 if broken == "no_plane_k1" else k1
        for tj in range(tiles_j):
            for ti in range(tiles_i):
                j0, i0 = tj * TJ, ti * TI
                tile = tj * tiles_i + ti
                index = tile + z * tiles if broken == "part_by_block" else tile

                def grid(x0, n, size):
                    ix = torch.arange(x0 - 1, x0 + n + 1)
                    return (ix.clamp(0, size - 1) if broken == "halo_clamp"
                            else ix % size)
                rj, ci = grid(j0, TJ, jtot), grid(i0, TI, itot)
                oj, oi = rj[1:-1] % jtot, ci[1:-1] % itot
                ring = [torch.full((3, TJ + 2, TI + 2), NAN,
                                   dtype=u.dtype)] * R
                rows = [torch.full((ce.shape[1],), NAN, dtype=u.dtype)] * R
                red = [torch.full((2, TJ * TI), NAN, dtype=u.dtype)] * 2

                def issue(p, sl):
                    if p <= top:
                        lc = clamp(ks + p, lo, hic)
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

                def fold(k):
                    by_lane = red[k & 1].reshape(2, 32, 8).amax(dim=2)
                    if lanes is not None:
                        lanes[(k, tile)] = by_lane
                    m = by_lane.amax(dim=1)
                    for rate in (0, 1):
                        at = (rate * ktot + k) * tiles + index
                        if at < flat.numel():
                            flat[at] = m[rate]

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
                    if k > k0:
                        fold(k - 1)
                    uvw = [torch.stack([ring[s][n] for s in (sm, sc, sp)])
                           for n in range(3)]
                    row = rows[sp if broken == "row_next" else sc]
                    a3 = torch.stack(col) if stratified == 1 else None
                    ev = F.evisc_plain(*uvw, a3, row[None], 1, dxi, dyi, tPr,
                                       bool(stratified), True,
                                       None if n2 is None else n2[None])
                    ev = ev[0, 1:-1, 1:-1]
                    uc, vc, wc, w1 = uvw[0][1], uvw[1][1], uvw[2][1], uvw[2][2]
                    cfl = (torch.abs(0.5 * (uc[1:-1, 1:-1] + uc[1:-1, 2:]))
                           * dxi
                           + torch.abs(0.5 * (vc[1:-1, 1:-1] + vc[2:, 1:-1]))
                           * dyi
                           + torch.abs(0.5 * (wc[1:-1, 1:-1] + w1[1:-1, 1:-1]))
                           * row[F.E_DZI])
                    red[k & 1] = torch.stack([cfl.reshape(-1),
                                              ev.reshape(-1)])
                    if stratified == 1:
                        col = col[1:] + [nxt]
                    if stratified == 2:
                        n2 = n2n
                    sm = sc
                if broken != "no_last_fold":
                    fold(k1 - 1)
    # limits_reduce: the maximum over the tiles and 0, NaN kept
    out.copy_(torch.maximum(part.amax(dim=2), torch.zeros_like(out)))


def plain(u, v, w, th, n2, ce, ks, stratified, ghosts):
    a = ARGS
    return F.limits_plain(u, v, w, th, ce, ks, a["dxi"], a["dyi"], a["tPr"],
                          bool(stratified), bool(ghosts),
                          n2 if stratified == 2 else None)


def march(u, v, w, th, n2, ce, ks, stratified, ghosts, chunks, broken=None,
          lanes=None):
    """limits_march with the test's numbers; returns out and the partials."""
    a = ARGS
    tiles = -(-u.shape[2] // kmarch.TI) * -(-u.shape[1] // kmarch.EV_TJ)
    part = torch.full((2, ce.shape[0], tiles), NAN, dtype=u.dtype)
    out = torch.full((2, ce.shape[0]), NAN, dtype=u.dtype)
    limits_march(u, v, w, n2 if stratified == 2 else th, part, out, ce, ks,
                 a["dxi"], a["dyi"], a["tPr"], stratified, ghosts, chunks,
                 broken, lanes)
    return out, part


def point_rates(u, v, w, th, n2, ce, ks, stratified, ghosts):
    """The two rates at every interior point, in plain torch."""
    a = ARGS
    ev = F.evisc_plain(u, v, w, th, ce, ks, a["dxi"], a["dyi"], a["tPr"],
                       bool(stratified), bool(ghosts),
                       n2 if stratified == 2 else None)
    ke = ks + ce.shape[0]
    uc, vc, wc, w1 = u[ks:ke], v[ks:ke], w[ks:ke], w[ks + 1:ke + 1]
    cfl = (torch.abs(0.5 * (uc + uc.roll(-1, 2))) * a["dxi"]
           + torch.abs(0.5 * (vc + vc.roll(-1, 1))) * a["dyi"]
           + torch.abs(0.5 * (wc + w1)) * ce[:, F.E_DZI][:, None, None])
    return torch.stack([cfl, ev])


def rel_err(got, want):
    """max |got - want| / max |want|, infinite where got is not finite."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


def chunk_counts(ktot):
    return sorted({1, 2, 3, 4, 5, ktot})


@pytest.mark.parametrize("stratified", [0, 1, 2])
@pytest.mark.parametrize("ghosts", [0, 1])
@pytest.mark.parametrize("ktot", [6, 16])
def test_limits_march_is_the_plain_version(ktot, ghosts, stratified):
    """The emulated march equals the plain version to 1e-12 at 1-5 chunks
    and a level a chunk on partial tiles, with NaN on the levels the kernel
    never reads; every partial is written, and is the tile's maximum of
    the plain rates (a partial tile's virtual points wrap); the lane maxima
    are those of the runs of eight points of the tile's rows."""
    ks = 3
    x = inputs(ktot, ktot + 3 * ghosts + stratified, ghosts, ks)
    want = torch.stack(plain(*x, ks, stratified, ghosts))
    assert bool(torch.isfinite(want).all())
    rates = point_rates(*x, ks, stratified, ghosts)
    jtot, itot = rates.shape[2:]
    # the tiles' maxima, and the tile rows', of the wrapped plain rates
    TJ, TI = kmarch.EV_TJ, kmarch.TI
    jw = torch.arange(-(-jtot // TJ) * TJ) % jtot
    iw = torch.arange(-(-itot // TI) * TI) % itot
    wrapped = rates[:, :, jw][:, :, :, iw]
    tiles_i = iw.numel() // TI
    by_run = wrapped.reshape(2, ktot, -1, TJ, tiles_i, TI // 8, 8).amax(-1)
    by_tile = by_run.amax((3, 5)).reshape(2, ktot, -1)
    for chunks in chunk_counts(ktot):
        lanes = {}
        got, part = march(*x, ks, stratified, ghosts, chunks, lanes=lanes)
        assert rel_err(got, want) <= 1e-12, chunks
        assert rel_err(part, by_tile) <= 1e-12, chunks
        for (k, tile), lm in lanes.items():
            tj, ti = divmod(tile, tiles_i)
            run = by_run[:, k, tj, :, ti].reshape(2, 32)
            assert torch.allclose(lm, run, rtol=1e-12, atol=0.)
        assert len(lanes) == ktot * part.shape[2]


@pytest.mark.parametrize("stratified", [0, 1, 2])
def test_limits_march_keeps_a_planted_nan(stratified):
    """One NaN in u shows in the CFL rate's maximum of its level and no
    other, and in the eddy viscosity's where the plain version has it; one
    NaN in the N2 field (ST 2) in the eddy viscosity's maximum of its level
    alone.  The finite maxima stay the plain version's."""
    ks, ktot, kp = 3, 6, 3
    for ghosts in (0, 1):
        u, v, w, th, n2, ce = inputs(ktot, 31 + ghosts, ghosts, ks)
        u = u.clone()
        u[ks + kp, 17, 40] = NAN        # in the last, partial, tile
        plants = [(u, n2, 0)]
        if stratified == 2:
            u0 = inputs(ktot, 31 + ghosts, ghosts, ks)[0]
            n2 = n2.clone()
            n2[kp, 5, 44] = NAN
            plants.append((u0, n2, 1))
        for uu, nn, rate in plants:
            want = torch.stack(plain(uu, v, w, th, nn, ce, ks, stratified,
                                     ghosts))
            one = torch.zeros(ktot, dtype=torch.bool)
            one[kp] = True
            assert torch.equal(torch.isnan(want[rate]), one)
            for chunks in (1, 2, 4, ktot):
                got, _ = march(uu, v, w, th, nn, ce, ks, stratified, ghosts,
                               chunks)
                assert torch.equal(torch.isnan(got), torch.isnan(want))
                fin = ~torch.isnan(want)
                assert float((got[fin] - want[fin]).abs().max()
                             / want[fin].abs().max()) <= 1e-12


@pytest.mark.parametrize("broken", RULES)
def test_limits_march_needs_each_edge_rule(broken):
    """Each rule of the march, broken on its own, breaks the result at some
    chunk count in some mode (clamped and ghost planes, N2 from th)."""
    ks, ktot = 3, 6
    worst = 0.
    for ghosts in (0, 1):
        x = inputs(ktot, 11 + ghosts, ghosts, ks)
        want = torch.stack(plain(*x, ks, 1, ghosts))
        for chunks in (1, 2, 3, ktot):
            got, _ = march(*x, ks, 1, ghosts, chunks, broken)
            worst = max(worst, rel_err(got, want))
    assert worst > 1e-6, broken


class LimitsEmulator(Recorder):
    """K7's stand-in: called with the C entry's arguments, it checks what
    the entry checks and runs limits_march."""

    def __call__(self, dtype, *args):
        (u, v, w, th, part, out, ce, itot, jtot, ktot, ks, dxi, dyi, tPr,
         stratified, ghosts, chunks) = args
        super().__call__(dtype, chunks)
        assert 1 <= chunks <= ktot and ce.shape == (ktot, F.NE)
        assert u.shape == (ktot + 2 * ks, jtot, itot)
        assert out.shape == (2, ktot)
        part.fill_(NAN)
        limits_march(u, v, w, th, part, out, ce, ks, dxi, dyi, tPr,
                     stratified, ghosts, chunks)


def test_limits_march_through_the_wrapper(monkeypatch):
    """The emulation called with the C entry's arguments through the
    wrapper equals the plain version at every chunk count on a rico (ghost
    planes): the moist N2, unstratified and an N2 field."""
    m = rico_model(6, "2", itot=45, jtot=20)
    fz, ctx = m.fused, m.ctx
    u, v, w, th, n2, _ = inputs(6, 21, 1, ctx.ks)
    want = {}
    for st in (0, 1, 2):
        fz.stratified = st
        want[st] = torch.stack(fz.limits(u, v, w, n2 if st == 2 else th))
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    fz.k_limits = LimitsEmulator("limits")
    for chunks in (1, 4, 6):
        for st in (0, 1, 2):
            fz.stratified = st
            got = torch.stack(fz.limits(u, v, w, n2 if st == 2 else th,
                                        chunks=chunks))
            assert rel_err(got, want[st]) <= 1e-12, (st, chunks)
    assert [c[1][0] for c in fz.k_limits.calls] == [1] * 3 + [4] * 3 + [6] * 3


@pytest.mark.parametrize("case", ["rico", "SBL", "sullivan2011",
                                  "drycblles", "andren1994"])
def test_limits_chip_cases_on_the_cpu(case, monkeypatch):
    """chip_smoke.py's K7 cases on a small model of each case phase 3b
    checks them on, on the CPU (both calls take the plain version here):
    the forced counts and the plan's, aligned and shifted past a 16-byte
    boundary, the model's stratified mode in both regimes and unstratified,
    and the planted NaN a count; and the forced check of a run in the
    path's own mode."""
    import chip_smoke
    monkeypatch.setattr(F.Fused, "limits_plan",
                        lambda self, dtype, st, chunks=None:
                        kmarch.plan("limits", self.ctx.itot, self.ctx.jtot,
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
    elif case == "andren1994":
        m = chip_smoke.build_andren(torch, n, k, f64, "cpu")
        m.build_step()
    else:
        m = chip_smoke.build_model(torch, 20, k, f64, "cpu")
        m.build_step(fold=False)
    fz = m.fused
    own = {"rico": 1, "SBL": 2, "sullivan2011": 1, "drycblles": 1,
           "andren1994": 0}[case]
    assert fz.stratified == own
    assert fz.ghosts == (case in ("rico", "SBL", "sullivan2011"))
    counts = chip_smoke.limits_chunks(m, f64)
    assert counts == sorted({1, 2, 3, 6, kmarch.plan(
        "limits", m.ctx.itot, m.ctx.jtot, 6, 0, f64, 528).chunks})
    cases = chip_smoke.limits_cases(torch, m, 5, counts)
    forms = 3 if own else 1
    assert len(cases) == (2 * forms + 1) * len(counts)
    seen = []
    real = fz.limits

    def limits(u, v, w, th, chunks=None):
        seen.append((chunks, u.data_ptr() % 16, fz.stratified,
                     bool(torch.isnan(u).sum() > torch.isnan(v).sum())))
        return real(u, v, w, th, chunks=chunks)

    fz.limits = limits
    for name, kern, plain_call, kind in cases:
        assert name == "limits" and kind == "field"
        got, want = kern(), plain_call()
        assert len(got) == (4 if seen[-1][3] else 2)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if seen[-1][3]:
            # the planted NaN: -1 at its level of the CFL rate's maxima
            assert got[2].tolist() == [float(i == 3) for i in range(k)]
        else:
            assert all(bool(torch.isfinite(x).all()) for x in got)
    per = 2 * forms + 1
    assert [c[0] for c in seen] == [c for c in counts for _ in range(per)]
    assert {c[1] for c in seen} == {0, 8}
    assert [c[2] for c in seen[:forms]] == ([own, own, 0] if own else [0])
    assert [c[3] for c in seen] == [i % per == per - 1
                                    for i in range(len(seen))]
    # the forced check of a run's path: its own mode in both regimes,
    # aligned and shifted, and the planted NaN
    monkeypatch.setattr(chip_smoke, "compare",
                        lambda torch_, name, kern, plain_call, kind, dtype,
                        where: seen.append(name) or 0.)
    del seen[:]
    chip_smoke.check_limits_forced(torch, m)
    assert seen == ["limits"] * (2 * (2 if own else 1) + 1) * len(counts)
