"""K4 apply (``pres_apply``), the projection's gradient update s -= dt
grad p (and t -= can grad p with the carry), redesigned as a k-split march
without shared memory (``pres_apply_kernel<T, CARRY>`` in
``csrc/pres_glue.cu``), on the CPU.

* its constants, entries and tile read from the source, and
  ``ops/kmarch.py`` agreeing with them; its plan at its shapes;
* the wrapper, with a recorder in place of the kernel: the plan's chunk
  count (from the card's resident blocks, asked in its carry form) or the
  one forced, after the C entry's other arguments; null carries without
  the carry; six different arrays or a raise;
* ``apply_march``, a torch emulation of the kernel's chunked march tile by
  tile (a warp a row of 32 x VW values, p of the level below carried, the
  chunk's first read of p at k0-1, p at i-1 from the lane to the left and
  lane 0's own read, p at j-1 from the row below, every value of a level
  read one level ahead, guarded stores), equals ``pres_apply_plain`` to
  1e-12 in float64 at every chunk count for ktot 6 and 16 on planes with
  partial tiles, with the carry and without, with the ghost levels of s
  and t NaN (never read);
* each edge rule, broken on its own (``broken=``), changes the result;
* the emulation called with the C entry's arguments through the wrapper
  equals the plain version, and ``chip_smoke.py``'s K4 apply cases run on
  the CPU.
"""

import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from microhh_torch import kernels
from microhh_torch.ops import fused as F
from microhh_torch.ops import kmarch

from test_torch_kmarch import Recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "microhh_torch", "csrc", "pres_glue.cu")
RULES = ("chunk_start", "local_wall", "wrap_i", "wrap_j", "dzhi_next",
         "lane_left")
NAN = float("nan")


def flat_source():
    with open(SRC) as f:
        return re.sub(r"\s+", " ", f.read())


def test_constants_are_the_source():
    flat = flat_source()
    tj = int(re.search(r"constexpr int PA_TJ = (\d+);", flat).group(1))
    assert tj == kmarch.PA_TJ
    assert "constexpr int PA_NT = km::TI * PA_TJ;" in flat
    # two blocks an SM; one 16-byte piece a thread and array
    assert ("template <typename T, bool CARRY> __global__ void "
            "__launch_bounds__(PA_NT, 2) pres_apply_kernel(const "
            "ApplyArgs<T> a)" in flat)
    assert "static constexpr int VW = 16 / (int)sizeof(T);" in flat
    for dtype, values in ((torch.float32, 128), (torch.float64, 64)):
        assert kmarch.TILE_I["pres_apply"](dtype) == values
        assert kmarch.SMEM["pres_apply"](0, dtype, True) == 0
    assert ("const dim3 grid((a.itot + km::TI * VW - 1) / (km::TI * VW), "
            "(a.jtot + PA_TJ - 1) / PA_TJ, a.chunks);" in flat)
    assert kmarch.TILE_J["pres_apply"] == kmarch.PA_TJ
    assert kmarch.WARM["pres_apply"] == 1
    body = flat[flat.index("pres_apply_kernel(const ApplyArgs<T> a) {"):]
    body = body[:body.index("template <typename T> ApplyArgs<T> apply_args")]
    # no shared memory, no barrier; the chunk bounds of kmarch.cuh
    assert "__shared__" not in body and "__syncthreads" not in body
    assert "km::chunk_bounds(blockIdx.z, a.chunks, a.ktot, k0, k1);" in body
    # the chunk's first gradient from p at k0-1; zero at the wall
    assert "if (k0 > 0 && n > 0) load_vals<T, true>(pdn, a.p + (k0 - 1) * " \
           "plane + me," in body
    assert "g[2].v[e] = k == 0 ? T(0) : (pc_ - pdn.v[e]) * cur.dzhi;" in body
    # p at i-1 from the lane to the left, lane 0 its own read
    assert "__shfl_up_sync(0xffffffffu, cur.p.v[VW - 1], 1)" in body
    assert "if (tx == 0) L.pl = __ldg(pk + left);" in body
    # a level's values read one level ahead, before the stores
    assert body.index("if (k + 1 < k1) fetch(k + 1, nxt);") < body.index(
        "store_vals(s[c] + o, r, vec, n);")
    # the six arrays are not restrict-qualified (updated in place)
    args = flat[flat.index("struct ApplyArgs {"):]
    args = args[:args.index("};")]
    assert "__restrict__" not in args
    assert "T *su, *sv, *sw;" in args and "T *tu, *tv, *tw;" in args
    # the entry: the chunk count last, an info entry in the carry form
    assert len(kernels.SIGNATURES["pres_apply"]) == 18
    assert kernels.SIGNATURES["pres_apply"][-2:] == [kernels._I] * 2
    assert "pres_apply" in kernels.INFO
    assert "mhh_pres_apply_info_##SUF(int scheme, int S, int* out)" in flat
    assert "return mhh::pres_apply_info<T>(scheme, out);" in flat
    assert "if (!carry != !a.tu || !carry != !a.tv || !carry != !a.tw)" \
        in flat
    # the per-level table's columns (ops/fused.py P_*)
    enum = re.search(r"enum \{ (P_RHO[^}]*)\}", flat).group(1)
    assert [c.strip() for c in enum.split(",")] == [
        "P_RHO", "P_RHOH", "P_RHOH1", "P_DZI", "P_DZHI", "NP"]
    assert (F.P_DZHI, F.NP) == (4, 5)


def test_plan_at_its_shapes():
    """At two resident blocks an SM on 132 SMs: drycblles 512^3 and rico
    384^3 in float32 (128-value rows), float64 (64-value rows); whole
    waves, every level once."""
    f32 = torch.float32
    p = kmarch.plan("pres_apply", 512, 512, 512, 0, f32, 264)
    assert (p.tiles_i, p.tiles_j, p.smem) == (4, 64, 0)
    assert p.chunks == kmarch.choose_chunks(256, 512, 264, 1)
    p = kmarch.plan("pres_apply", 384, 384, 384, 0, f32, 264)
    assert (p.tiles_i, p.tiles_j) == (3, 48)
    assert p.waves == -(-144 * p.chunks // 264)
    p = kmarch.plan("pres_apply", 512, 512, 512, 0, torch.float64, 264)
    assert (p.tiles_i, p.tiles_j) == (8, 64)
    for ktot in (6, 16, 384):
        p = kmarch.plan("pres_apply", 45, 45, ktot, 0, f32, 264)
        levels = [k for k0, k1 in kmarch.chunk_bounds(p.chunks, ktot)
                  for k in range(k0, k1)]
        assert levels == list(range(ktot))


# --------------------------------------------------------------------------
#  the chunked march, emulated
# --------------------------------------------------------------------------

def apply_march(p, s, t, pc, ks, dxi, dyi, dt, can, carry, chunks,
                broken=None):
    """A torch emulation of csrc/pres_glue.cu pres_apply_kernel<T, CARRY>:
    every chunk [k0, k1) of every tile of PA_TJ rows of 32 x VW values (VW
    = 16 / the bytes of a value) fetches level k0 (p at the tile's points
    and at the row j-1, lane 0's p at i-1, the six arrays, dzhi) and p at
    k0-1 (none at k0 = 0); level k fetches level k+1 first, takes p at i-1
    from the value to its left in the row (lane 0's first from its own
    read), computes the gradient (w's zero at the global k = 0) and stores
    the points inside the plane; the level's p becomes the one below.
    s, t: dicts of u, v, w updated in place (t only with carry).  broken
    names one rule to break: "chunk_start" (p at k0 taken for k0-1),
    "local_wall" (w's gradient zero at each chunk's k0), "wrap_i" (lane
    0's i-1 clamped to the plane), "wrap_j" (the row j-1 clamped),
    "dzhi_next" (the dzhi of level k+1 at level k), "lane_left" (lane 0
    takes the shuffle's value, its own last, for its left one)."""
    ktot, jtot, itot = p.shape
    vw = 16 // p.element_size()
    W, TJ = 32 * vw, kmarch.PA_TJ
    names = ("u", "v", "w")
    for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
        for j0 in range(0, jtot, TJ):
            for i0 in range(0, itot, W):
                rows = torch.arange(j0, min(j0 + TJ, jtot))
                below = (rows - 1).clamp(0) if broken == "wrap_j" else (
                    (rows - 1) % jtot)
                cols = torch.arange(i0, i0 + W)
                icol = cols[cols < itot]
                left_of_tile = (max(i0 - 1, 0) if broken == "wrap_i"
                                else (i0 - 1) % itot)

                def fetch(k):
                    pk = p[k]
                    # lane 0's read of i-1, then the values left of each
                    # point within the tile's row
                    own = pk[rows][:, icol]
                    left = (own[:, vw - 1:vw] if broken == "lane_left"
                            else pk[rows][:, left_of_tile:left_of_tile + 1])
                    return {"p": own, "pl": torch.cat([left, own[:, :-1]],
                                                      dim=1),
                            "pj": pk[below][:, icol],
                            "s": [s[n][ks + k][rows][:, icol] for n in names],
                            "t": [t[n][ks + k][rows][:, icol] for n in names]
                            if carry else None,
                            "dzhi": pc[min(k + 1, ktot - 1) if broken ==
                                       "dzhi_next" else k, F.P_DZHI]}

                cur = fetch(k0)
                pdn = None
                if k0 > 0:
                    pdn = p[k0 if broken == "chunk_start" else k0 - 1][
                        rows][:, icol]
                for k in range(k0, k1):
                    nxt = fetch(k + 1) if k + 1 < k1 else None
                    pk = cur["p"]
                    g = [(pk - cur["pl"]) * dxi, (pk - cur["pj"]) * dyi,
                         torch.zeros_like(pk)
                         if k == (k0 if broken == "local_wall" else 0)
                         else (pk - pdn) * cur["dzhi"]]
                    for c, n in enumerate(names):
                        plane = s[n][ks + k]
                        plane[rows[:, None], icol[None, :]] = (
                            cur["s"][c] - dt * g[c])
                        if carry:
                            plane = t[n][ks + k]
                            plane[rows[:, None], icol[None, :]] = (
                                cur["t"][c] - can * g[c])
                    pdn = pk
                    cur = nxt


def inputs(ktot, seed, ks=2, jtot=10, itot=37):
    """Seeded p, s, t and a stretched per-level table on a (jtot, itot)
    plane (37 values: a partial 16-byte piece and a partial tile in both
    dtypes), the ghost levels of s and t NaN (never read)."""
    rng = np.random.default_rng(seed)
    shape = (ktot + 2 * ks, jtot, itot)
    p = torch.tensor(rng.standard_normal((ktot, jtot, itot)))
    s = {n: torch.tensor(rng.standard_normal(shape)) for n in "uvw"}
    t = {n: torch.tensor(0.1 * rng.standard_normal(shape)) for n in "uvw"}
    for x in list(s.values()) + list(t.values()):
        x[:ks] = NAN
        x[ks + ktot:] = NAN
    pc = np.zeros((ktot, F.NP))
    pc[:, F.P_DZHI] = 1. / (0.5 + rng.random(ktot))
    return p, s, t, torch.tensor(pc)


def clone(d):
    return {n: x.clone() for n, x in d.items()}


def interiors(s, t, ks, ktot, carry):
    return [s[n][ks:ks + ktot] for n in s] + (
        [t[n][ks:ks + ktot] for n in t] if carry else [])


def rel_err(got, want):
    """The largest over the outputs of max |got - want| / max |want|,
    infinite where got is not finite."""
    return max(float((g - w).abs().max() / w.abs().max())
               if bool(torch.isfinite(g).all()) else float("inf")
               for g, w in zip(got, want))


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("itot,jtot", [(37, 10), (64, 9), (130, 3)])
@pytest.mark.parametrize("ktot", [6, 16])
def test_apply_march_is_the_plain_version(ktot, itot, jtot, carry):
    """The emulated march equals the plain version to 1e-12 at every chunk
    count, on partial tiles, with NaN ghost levels; without the carry the
    carries are not touched."""
    ks = 2
    p, s0, t0, pc = inputs(ktot, ktot + itot + carry, ks, jtot, itot)
    can = -5. / 9. if carry else 0.
    s_want, t_want = clone(s0), clone(t0)
    F.pres_apply_plain(p, s_want, t_want, pc, ks, 0.7, 1.3, 0.4, can, carry)
    want = interiors(s_want, t_want, ks, ktot, carry)
    assert all(bool(torch.isfinite(x).all()) for x in want)
    for chunks in range(1, ktot + 1):
        s, t = clone(s0), clone(t0)
        apply_march(p, s, t, pc, ks, 0.7, 1.3, 0.4, can, carry, chunks)
        assert rel_err(interiors(s, t, ks, ktot, carry), want) <= 1e-12, (
            chunks)
        for n in s:
            assert bool(s[n][:ks].isnan().all())
            if not carry:
                assert torch.equal(t[n].nan_to_num(), t0[n].nan_to_num())


@pytest.mark.parametrize("broken", RULES)
def test_apply_march_needs_each_edge_rule(broken):
    """Each rule of the march, broken on its own, breaks the result at some
    chunk count (on a plane of one tile and a partial one in i, in
    float64 and float32)."""
    ks, ktot = 2, 6
    worst = 0.
    for dtype in (torch.float64, torch.float32):
        p, s0, t0, pc = inputs(ktot, 5, ks, 9, 70)
        p, pc = p.to(dtype), pc.to(dtype)
        s0 = {n: x.to(dtype) for n, x in s0.items()}
        t0 = {n: x.to(dtype) for n, x in t0.items()}
        s_want, t_want = clone(s0), clone(t0)
        F.pres_apply_plain(p, s_want, t_want, pc, ks, 0.7, 1.3, 0.4, -0.5,
                           True)
        want = interiors(s_want, t_want, ks, ktot, True)
        for chunks in range(1, ktot + 1):
            s, t = clone(s0), clone(t0)
            apply_march(p, s, t, pc, ks, 0.7, 1.3, 0.4, -0.5, True, chunks,
                        broken)
            worst = max(worst, rel_err(interiors(s, t, ks, ktot, True),
                                       want))
    assert worst > 1e-6, broken


class ApplyEmulator(Recorder):
    """K4 apply's stand-in: called with the C entry's arguments, it checks
    what the entry checks and runs apply_march."""

    def __call__(self, dtype, *args):
        (p, su, sv, sw, tu, tv, tw, pc, itot, jtot, ktot, ks, dxi, dyi, dt,
         can, carry, chunks) = args
        super().__call__(dtype, chunks)
        assert 1 <= chunks <= ktot and pc.shape == (ktot, F.NP)
        assert p.shape == (ktot, jtot, itot)
        assert su.shape == (ktot + 2 * ks, jtot, itot)
        assert (tu is None) == (tv is None) == (tw is None) == (not carry)
        apply_march(p, {"u": su, "v": sv, "w": sw},
                    {"u": tu, "v": tv, "w": tw}, pc, ks, dxi, dyi, dt, can,
                    carry, chunks)


def glue_model(n=(37, 10), k=6, dtype=torch.float64):
    """A small sullivan2011 model on the CPU: its PresGlue."""
    m = chip_smoke.build_sullivan(torch, n, k, dtype, "cpu")
    m.build_step()
    return m


def plan_264(self, dtype, carry, chunks=None):
    """PresGlue.apply_plan at two resident blocks an SM on 132 SMs."""
    return kmarch.plan("pres_apply", self.ctx.itot, self.ctx.jtot,
                       self.ctx.ktot, 0, dtype, 264, chunks)


@pytest.mark.parametrize("carry", [True, False])
def test_wrapper_plans_and_forces(carry, monkeypatch):
    """K4 apply passes the plan's chunk count (asked in its carry form) or
    the one forced, after the C entry's other arguments; null carries
    without the carry; the same tensor twice raises."""
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    m = glue_model((40, 24), 16, torch.float32)
    gl, ctx = m.glue, m.ctx
    asked = []

    class Rec(Recorder):
        def info(self, dtype, scheme, S=0):
            asked.append((dtype, scheme, S))
            return super().info(dtype, scheme, S)

    gl.k_apply = Rec("pres_apply")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    s = {n: torch.zeros(shape) for n in "uvw"}
    t = {n: torch.zeros(shape) for n in "uvw"}
    p = torch.zeros((ctx.ktot, ctx.jtot, ctx.itot))
    can = -0.5 if carry else 0.
    gl.apply(p, s, t, 0.3, can, carry)
    gl.apply(p, s, t, 0.3, can, carry, chunks=5)
    (d1, a1), (_, a2) = gl.k_apply.calls
    assert d1 == torch.float32
    tptr = [t[n] for n in "uvw"] if carry else [None] * 3
    assert [x is y for x, y in zip(
        a1[:8], [p, s["u"], s["v"], s["w"]] + tptr + [gl.pc])] == [True] * 8
    assert a1[8:16] == (40, 24, 16, ctx.ks, ctx.dxi, ctx.dyi, 0.3, can)
    want = kmarch.plan("pres_apply", 40, 24, 16, 0, torch.float32,
                       396).chunks
    assert a1[16:] == (int(carry), want)
    assert a2[16:] == (int(carry), 5)
    assert asked and all(a[1:] == (int(carry), 0) for a in asked)
    assert gl.apply_plan(torch.float32, carry, 3).chunks == 3
    with pytest.raises(ValueError):
        gl.apply(p, s, t, 0.3, can, carry, chunks=17)
    with pytest.raises(ValueError):
        gl.apply(p, {"u": s["u"], "v": s["u"], "w": s["w"]}, t, 0.3, can,
                 carry)


@pytest.mark.parametrize("carry", [True, False])
def test_apply_march_through_the_wrapper(carry, monkeypatch):
    """The emulation called with the C entry's arguments through the
    wrapper equals the plain version at every chunk count and at the
    plan's."""
    monkeypatch.setattr(F.PresGlue, "apply_plan", plan_264)
    m = glue_model()
    gl, ctx = m.glue, m.ctx
    p, s0, t0, pc = inputs(6, 9, ctx.ks, 10, 37)
    can = -5. / 9. if carry else 0.
    s_want, t_want = clone(s0), clone(t0)
    gl.apply(p, s_want, t_want, 0.4, can, carry)
    want = interiors(s_want, t_want, ctx.ks, 6, carry)
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    plan = gl.apply_plan(torch.float64, carry).chunks
    for chunks in list(range(1, 7)) + [None]:
        gl.k_apply = ApplyEmulator("pres_apply")
        s, t = clone(s0), clone(t0)
        gl.apply(p, s, t, 0.4, can, carry, chunks=chunks)
        assert rel_err(interiors(s, t, ctx.ks, 6, carry), want) <= 1e-12
        assert [c[1][0] for c in gl.k_apply.calls] == [chunks or plan]


def test_apply_chip_cases_on_the_cpu(monkeypatch):
    """chip_smoke.py's K4 apply cases on a small model on the CPU (both
    calls take the plain version here): the forced counts and the plans',
    each aligned and shifted past a 16-byte boundary, with the carry and
    without, NaN ghost levels; and the forced check of a run's path."""
    monkeypatch.setattr(F.PresGlue, "apply_plan", plan_264)
    m = glue_model((20, 12), 6)
    counts = chip_smoke.apply_chunks(m, torch.float64)
    assert counts == sorted({1, 2, 3, 6, kmarch.plan(
        "pres_apply", 20, 12, 6, 0, torch.float64, 264).chunks})
    cases = chip_smoke.apply_cases(torch, m, 5, counts)
    assert len(cases) == 2 * 2 * len(counts)
    assert {c[0] for c in cases} == {"pres_apply"}
    seen = []
    gl = m.glue
    real = gl.apply

    def apply(p, s, t, dt, can, carry, chunks=None):
        seen.append((chunks, p.data_ptr() % 16, s["u"].data_ptr() % 16,
                     carry, bool(t["u"].isnan().all())))
        return real(p, s, t, dt, can, carry, chunks=chunks)

    gl.apply = apply
    for name, kern, plain_call, kind in cases:
        assert kind == "field"
        got, want = kern(), plain_call()
        assert len(got) in (3, 6)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(bool(torch.isfinite(g).all()) for g in got)
    assert [c[0] for c in seen] == [c for c in counts for _ in range(4)]
    assert {c[1:3] for c in seen} == {(0, 0), (8, 8)}
    # the carries are NaN without the carry
    assert {c[3:] for c in seen} == {(True, False), (False, True)}
    monkeypatch.setattr(chip_smoke, "compare",
                        lambda torch_, name, kern, plain_call, kind, dtype,
                        where: (kern(), 0.)[1])
    del seen[:]
    chip_smoke.check_apply_forced(torch, m)
    assert [c[0] for c in seen] == [c for c in counts for _ in range(4)]
