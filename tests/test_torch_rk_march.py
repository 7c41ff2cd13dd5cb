"""K2 (``tend_rk``), the dry RK sweep of ``Model.build_step(fold=False)``:
K20's k-march with its RK flag, ``tend_uvw_kernel<T, true, true, TH>`` in
``csrc/tend_generic.cu`` (RK and DRY together: the clamped reads of the
fold_ghosts form, s* written, the carry written unless ``carry`` is 0 and
read unless ``first``), on the CPU.

* its constants, entries and shared memory read from the source, and
  ``ops/kmarch.py`` agreeing with them; PR 1's ring kernel and the ring
  helpers only it used gone; its plan at its shapes (drycblles 512^3 and
  256^3, the neutral Ekman LES 768x384x288);
* the wrapper, with a recorder in place of the kernel: the plan's chunk
  count (from the card's resident blocks, asked in the case's thermo form)
  or the one forced, after the C entry's other arguments; th, its s* and
  its carry null without thermo;
* ``dry_march`` with ``rk`` (test_torch_dry_acc_march.py), a torch
  emulation of the kernel's chunked march tile by tile, equals
  ``tend_rk_plain`` to 1e-12 in float64 at every chunk count for ktot 6
  and 16 on a 12 x 10 plane, first x carry, with th, the Coriolis term and
  the sponge columns each on and off; the ghost planes of u, v and th, w's
  planes past ke and below ks, the carries on the first substep, and the
  slots and rows before a copy lands are NaN;
* each edge rule of the clamped march, broken on its own, changes the
  result;
* the emulation called with the C entry's arguments through the wrapper
  equals the plain version and shows the plan's or the forced chunk count,
  and ``chip_smoke.py``'s K2 cases run on the CPU.
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

from test_torch_dry_acc_march import dry_march, flat_source, rel_err
from test_torch_kmarch import Recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "microhh_torch", "csrc")
RULES = ("no_group_km1", "no_plane_k1", "local_wall", "row_next",
         "halo_clamp", "unguarded", "carry_next", "uv_bottom", "uv_top",
         "w_top", "e_index", "first_read", "dry_fold")
ARGS = dict(dxi=0.7, dyi=1.3, visc=1e-3, svisc=2e-3, tPr=1. / 3., fc=0.3,
            utrans=0.2, vtrans=-0.1, cbdt=0.7)
NAN = float("nan")
# (first, carry, can)
STEPS = ((True, True, -5. / 9.), (False, True, -153. / 128.),
         (False, False, 0.), (True, False, 0.))


def test_constants_are_the_source():
    flat = flat_source()
    body = flat[flat.index("tend_uvw_kernel(const UvwArgs<T> a) {"):]
    body = body[:body.index("km::wait_all(); }")]
    # K2 is the RK and DRY flags together; its clamp their product, its
    # code `if constexpr`
    assert "constexpr bool CL = RK && DRY;" in body
    assert re.findall(r"\bif \((CL|TH|DRY)\b", body) == []
    assert body.count("if constexpr (CL)") == 4
    # K2 reads cB*dt from the device (the step's dt, so that a captured
    # launch reads each step's), K8/K9 take it by value
    assert ("T cbdt; if constexpr (CL) cbdt = __ldg(a.cbdt_dev); "
            "else cbdt = a.cbdt;" in body)
    # three level bases a group: u, v and th; w; e of the interior array
    assert ("const int pc = clampi(p, 0, a.ktot - 1); const long long la = "
            "level(pc), lw = level(max(p, 0)); const long long le = "
            "(long long)pc * plane;" in body)
    for copy in ("(d, a.u + g)", "(d + SZ, a.v + g)", "(d + 2 * SZ, a.w + gw)",
                 "(d + 3 * SZ, a.e + ge)", "(d + 4 * SZ, a.th + g)"):
        assert "km::cp_async<16>" + copy in body, copy
        assert "km::cp_async<sizeof(T)>" + copy in body, copy
    # the column fold not under DRY; th's s* and carry under TH
    assert "if (RK && !DRY) {" in body
    assert "if constexpr (RK && TH) a.ths[o] = h.a1 + cbdt * h.t;" in body
    assert "if constexpr (RK && TH) a.tth[o] = a.can * h.t;" in body
    # first: no carry read, at the chunk's first level or a level ahead
    assert body.count("if (!a.first) {") == 2
    # one commit group and one barrier a level, as in K8/K9, K18 and K20
    assert body.count("__syncthreads();") == 2
    assert body.count("km::commit();") == 1
    # the launch of the two thermo forms and their occupancy
    assert ("return a.th ? launch_tend_uvw<T, true, true, true>(a, stream) "
            ": launch_tend_uvw<T, true, true, false>(a, stream);" in flat)
    assert "if (!a.th != !a.tth || !a.th != !a.ths)" in flat
    for entry in ("mhh_tend_rk_info_##SUF(int scheme, int S, int* out)",
                  "return S ? mhh::tend_uvw_info<T, true, true, true>(out)",
                  ": mhh::tend_uvw_info<T, true, true, false>(out);",
                  "double vtrans, int first, int carry, int coriolis, "
                  "int chunks,"):
        assert entry in flat, entry
    # the entry: the old arguments, the chunk count last; an info entry
    assert len(kernels.SIGNATURES["tend_rk"]) == 32
    assert kernels.SIGNATURES["tend_rk"][23] == kernels._P     # cbdt
    assert "double tPr, const void* cbdt, double can, double fc," in flat
    assert kernels.SIGNATURES["tend_rk"][-4:] == [kernels._I] * 4
    assert "tend_rk" in kernels.INFO
    for dtype in (torch.float32, torch.float64):
        for S in (0, 1):
            assert kmarch.SMEM["tend_rk"](S, dtype, True) == (
                kmarch.uvw_smem(dtype, S))
    assert kmarch.TILE_J["tend_rk"] == kmarch.UVW_TJ
    assert kmarch.WARM["tend_rk"] == 2
    # PR 1's ring kernel is gone, and with it the ring helpers only it used
    assert not os.path.exists(os.path.join(CSRC, "tend_rk.cu"))
    sources = {}
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            sources[name] = f.read()
    for gone in ("tend_rk_kernel", "load_tile", "ViewT", "uv_tend(",
                 "Slots slots(", "int slot(int p)", "using View"):
        assert not any(gone in text for text in sources.values()), gone
    # what the other kernels use stays
    for kept in ("struct Slots", "u_folds", "v_folds", "int wrap(",
                 "int clampi("):
        assert any(kept in text for text in sources.values()), kept
    assert F.Fused.tend_rk.__code__.co_varnames[:9] == (
        "self", "s", "t", "e", "cbdt", "can", "first", "carry", "chunks")


def test_plan_at_its_shapes():
    """drycblles 512^3 and 256^3 with th at three resident blocks an SM on
    132 SMs, the neutral Ekman LES without, float64 at two; whole waves,
    every level once."""
    f32 = torch.float32
    p = kmarch.plan("tend_rk", 512, 512, 512, 1, f32, 396)
    assert (p.tiles_i, p.tiles_j, p.smem) == (16, 64, 40480)
    assert p.chunks == kmarch.choose_chunks(1024, 512, 396, 2)
    assert p.waves == -(-1024 * p.chunks // 396)
    p = kmarch.plan("tend_rk", 256, 256, 256, 1, f32, 396)
    assert (p.tiles_i, p.tiles_j) == (8, 32)
    assert p.chunks == kmarch.choose_chunks(256, 256, 396, 2)
    p = kmarch.plan("tend_rk", 768, 384, 288, 0, f32, 528)
    assert p.smem == kmarch.uvw_smem(f32)
    assert kmarch.plan("tend_rk", 512, 512, 512, 1, torch.float64,
                       264).smem == 80960
    for ktot in (6, 16, 512):
        p = kmarch.plan("tend_rk", 45, 20, ktot, 1, f32, 396)
        levels = [k for k0, k1 in kmarch.chunk_bounds(p.chunks, ktot)
                  for k in range(k0, k1)]
        assert levels == list(range(ktot))


def rk_model(n, k, thermo=True, dtype=torch.float64):
    """A small drycblles (th) or neutral Ekman LES on the dry path's RK form
    without the folds, on the CPU."""
    if thermo:
        m = chip_smoke.build_drycblles(torch, n, k, dtype, "cpu")
    else:
        m = chip_smoke.build_andren(torch, n, k, dtype, "cpu")
    m.build_step(fold=False)
    assert not m.fold and not m.unfolded and not m.generic
    assert m.fused.k_tend in m.kernels()
    return m


@pytest.mark.parametrize("thermo", [True, False])
def test_wrapper_plans_and_forces(thermo, monkeypatch):
    """K2 passes the plan's chunk count (from the card's resident blocks,
    asked in the case's thermo form) or the one forced, after the C entry's
    other arguments; th, its s* and its carry null without thermo."""
    monkeypatch.setattr(F, "on_cpu", lambda t: False)
    m = rk_model((40, 40), 16, thermo, torch.float32)
    fz, ctx = m.fused, m.ctx
    asked = []

    class Rec(Recorder):
        def info(self, dtype, scheme, S=0):
            asked.append((dtype, scheme, S))
            return super().info(dtype, scheme, S)

    fz.k_tend = Rec("tend_rk")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    names = fz.prognostic
    s = {n: torch.zeros(shape) for n in names}
    t = {n: torch.zeros(shape) for n in names}
    e = torch.zeros((ctx.ktot, ctx.jtot, ctx.itot))
    want = kmarch.plan("tend_rk", 40, 40, 16, int(thermo), torch.float32,
                       396).chunks
    out = fz.tend_rk(s, t, e, 0.7, -0.5, True, False)
    fz.tend_rk(s, t, e, 0.7, -0.5, False, True, chunks=5)
    (d1, a1), (_, a2) = fz.k_tend.calls
    assert d1 == torch.float32
    th, ths, tth = ((s["th"], out["th"], t["th"]) if thermo
                    else (None, None, None))
    assert [x is y for x, y in zip(
        a1[:14], [s["u"], s["v"], s["w"], th, e, out["u"], out["v"],
                  out["w"], ths, t["u"], t["v"], t["w"], tth, fz.ct])] == (
        [True] * 14)
    assert a1[14:18] == (40, 40, 16, ctx.ks)
    assert a1[18:28] == (ctx.dxi, ctx.dyi, fz.visc, fz.svisc, fz.tPr, 0.7,
                         -0.5, fz.fc, ctx.utrans, ctx.vtrans)
    assert a1[28:] == (1, 0, int(fz.coriolis), want)
    assert a2[28:] == (0, 1, int(fz.coriolis), 5)
    # s*'s ghost planes are zero: the kernel writes the interior only
    for x in out.values():
        assert not bool(x[:ctx.ks].any()) and not bool(x[ctx.ke:].any())
    assert asked and all(a[1:] == (0, int(thermo)) for a in asked)
    assert fz.tend_rk_plan(torch.float32, 3).chunks == 3
    with pytest.raises(ValueError):
        fz.tend_rk(s, t, e, 0.7, -0.5, False, True, chunks=17)


# --------------------------------------------------------------------------
#  the chunked march, emulated
# --------------------------------------------------------------------------

def inputs(ktot, seed, thermo=True, ks=3, jtot=10, itot=12):
    """Seeded u, v, w (w scaled by 0.3), th around 300 K, a positive
    interior eddy viscosity and the carries on a (jtot, itot) plane with ks
    ghost levels, the planes K2 never reads NaN (u's, v's and th's ghost
    planes, w's below ks and past ke), and a random stretched (ktot, NTG)
    table with noise in every column, threfh around 300 K."""
    rng = np.random.default_rng(seed)
    shape = (ktot + 2 * ks, jtot, itot)

    def field(scale=1., sh=shape):
        return torch.tensor(scale * rng.standard_normal(sh))

    s = {"u": field(), "v": field(), "w": field(0.3)}
    if thermo:
        s["th"] = 300. + field()
    for n, x in s.items():
        x[:ks] = NAN
        x[ks + ktot + (1 if n == "w" else 0):] = NAN
    e = field(sh=(ktot, jtot, itot)).abs()
    t = {n: field(0.1) for n in s}
    ct = 1e-2 * rng.standard_normal((ktot, F.NTG))
    ct[:, [F.T_DZI, F.T_DZHI, F.T_DZHI1, F.T_DZI_M1]] += 1. / (
        0.5 + rng.random((ktot, 4)))
    ct[:, [F.T_RHO, F.T_RHOH, F.T_RHOH1, F.T_RHO_M1]] += 1.
    ct[:, F.T_THREFH] += 300.
    ct[:, [F.T_FACZ, F.T_FACZH]] = np.abs(ct[:, [F.T_FACZ, F.T_FACZH]])
    return s, e, t, torch.tensor(ct)


def carries(t0, first):
    """Fresh carries: NaN on the first substep (never read), else t0's."""
    return {n: torch.full_like(x, NAN) if first else x.clone()
            for n, x in t0.items()}


def plain(s, e, t, ct, ks, coriolis, first, carry, can):
    """tend_rk_plain with the test's numbers; returns s* whole and the
    carries' interiors where written."""
    a = ARGS
    out = F.tend_rk_plain(s, e, t, ct, ks, a["dxi"], a["dyi"], a["visc"],
                          a["svisc"], a["tPr"], a["cbdt"], can, first, carry,
                          a["fc"], a["utrans"], a["vtrans"], coriolis,
                          "th" in s)
    ke = ks + ct.shape[0]
    return [out[n] for n in s] + ([t[n][ks:ke] for n in s] if carry else [])


def march(s, e, t, ct, ks, coriolis, first, carry, can, chunks,
          broken=None):
    """dry_march in K2's form with the test's numbers; returns s* whole
    (zero ghost planes, as the wrapper allocates it) and the carries'
    interiors where written."""
    a = ARGS
    star = {n: torch.zeros_like(x) for n, x in s.items()}
    rk = {"us": star["u"], "vs": star["v"], "ws": star["w"],
          "ths": star.get("th"), "cbdt": a["cbdt"], "can": can,
          "first": first, "carry": carry}
    dry_march(s["u"], s["v"], s["w"], s.get("th"), e, t["u"], t["v"],
              t["w"], t.get("th"), ct, ks, a["dxi"], a["dyi"], a["visc"],
              a["svisc"], a["tPr"], a["fc"], a["utrans"], a["vtrans"],
              coriolis, chunks, broken, rk)
    ke = ks + ct.shape[0]
    return [star[n] for n in s] + ([t[n][ks:ke] for n in s]
                                   if carry else [])


FORMS = [(thermo, coriolis, sponge) for thermo in (True, False)
         for coriolis in (True, False) for sponge in (True, False)]


@pytest.mark.parametrize("thermo,coriolis,sponge", FORMS)
@pytest.mark.parametrize("ktot", [6, 16])
def test_rk_march_is_the_plain_version(ktot, thermo, coriolis, sponge):
    """The emulated march equals the plain version to 1e-12 at every chunk
    count, first x carry, on partial tiles, with NaN in every plane and
    carry that K2 never reads."""
    ks = 3
    s, e, t0, ct = inputs(ktot, ktot + 2 * thermo + 4 * coriolis + sponge,
                          thermo, ks)
    if not sponge:
        ct[:, [F.T_FACZ, F.T_FACZH]] = 0.
    for first, carry, can in STEPS:
        want = plain(s, e, carries(t0, first), ct, ks, coriolis, first,
                     carry, can)
        assert all(bool(torch.isfinite(x).all()) for x in want)
        for chunks in range(1, ktot + 1):
            t = carries(t0, first)
            got = march(s, e, t, ct, ks, coriolis, first, carry, can, chunks)
            assert rel_err(got, want) <= 1e-12, (first, carry, chunks)
            # the carries' ghost planes untouched
            for n in t:
                assert torch.equal(t[n][:ks].isnan(),
                                   torch.ones_like(t[n][:ks], dtype=bool)
                                   if first else t0[n][:ks].isnan())


@pytest.mark.parametrize("broken", RULES)
def test_rk_march_needs_each_edge_rule(broken):
    """Each rule of the march, broken on its own, breaks the result at some
    chunk count and step, with th and without."""
    ks, ktot = 3, 6
    worst = 0.
    for thermo in (True, False):
        s, e, t0, ct = inputs(ktot, 11, thermo, ks)
        for first, carry, can in STEPS[:2]:
            want = plain(s, e, carries(t0, first), ct, ks, True, first,
                         carry, can)
            for chunks in range(1, ktot + 1):
                got = march(s, e, carries(t0, first), ct, ks, True, first,
                            carry, can, chunks, broken)
                worst = max(worst, rel_err(got, want))
    assert worst > 1e-6, broken


class RkEmulator(Recorder):
    """K2's stand-in: called with the C entry's arguments, it checks what
    the entry checks and runs dry_march in K2's form."""

    def __call__(self, dtype, *args):
        (u, v, w, th, e, us, vs, ws, ths, tu, tv, tw, tth, ct, itot, jtot,
         ktot, ks, dxi, dyi, visc, svisc, tPr, cbdt, can, fc, utrans, vtrans,
         first, carry, coriolis, chunks) = args
        super().__call__(dtype, chunks)
        assert 1 <= chunks <= ktot and ct.shape == (ktot, F.NTG)
        assert u.shape == (ktot + 2 * ks, jtot, itot)
        assert e.shape == (ktot, jtot, itot)
        assert (th is None) == (tth is None) == (ths is None)
        rk = {"us": us, "vs": vs, "ws": ws, "ths": ths, "cbdt": cbdt,
              "can": can, "first": first, "carry": carry}
        dry_march(u, v, w, th, e, tu, tv, tw, tth, ct, ks, dxi, dyi, visc,
                  svisc, tPr, fc, utrans, vtrans, coriolis, chunks, None, rk)


def plan_396(self, dtype, chunks=None):
    """Fused.tend_rk_plan at three resident blocks an SM on 132 SMs."""
    return kmarch.plan("tend_rk", self.ctx.itot, self.ctx.jtot,
                       self.ctx.ktot, int(self.has_thermo), dtype, 396,
                       chunks)


@pytest.mark.parametrize("thermo", [True, False])
def test_rk_march_through_the_wrapper(thermo, monkeypatch):
    """The emulation called with the C entry's arguments through the
    wrapper (s* fresh with zero ghost planes, the carries in place, the
    case's sponge, the Coriolis term on) equals the plain version at every
    chunk count, first x carry; without chunks= it is given the plan's."""
    monkeypatch.setattr(F.Fused, "tend_rk_plan", plan_396)
    m = rk_model((12, 12), 6, thermo)
    fz, ctx = m.fused, m.ctx
    fz.coriolis, fz.fc = True, 0.3
    s, e, t0, ct = inputs(6, 21, thermo, ctx.ks, 12, 12)
    fz.ct = fz.ct + 1e-2 * ct
    names = list(s)
    wants = []
    for first, carry, can in STEPS:
        t = carries(t0, first)
        wants.append((fz.tend_rk(s, t, e, 0.7, can, first, carry), t))
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    plan = fz.tend_rk_plan(torch.float64).chunks
    for (first, carry, can), (want, t_want) in zip(STEPS, wants):
        for chunks in list(range(1, 7)) + [None]:
            fz.k_tend = RkEmulator("tend_rk")
            t = carries(t0, first)
            got = fz.tend_rk(s, t, e, 0.7, can, first, carry, chunks=chunks)
            assert rel_err([got[n] for n in names],
                           [want[n] for n in names]) <= 1e-12
            if carry:
                assert rel_err([t[n][ctx.ks:ctx.ke] for n in names],
                               [t_want[n][ctx.ks:ctx.ke]
                                for n in names]) <= 1e-12
            assert [c[1][0] for c in fz.k_tend.calls] == [chunks or plan]


@pytest.mark.parametrize("thermo", [True, False])
def test_rk_chip_cases_on_the_cpu(thermo, monkeypatch):
    """chip_smoke.py's K2 cases on a small model on the CPU (both calls take
    the plain version here): the forced counts and the plan's, each
    aligned and shifted past a 16-byte boundary, first x carry, the sponge
    and Coriolis term on and off, with NaN planes and carries that the
    plain version never reads; and the forced check of a run's path."""
    monkeypatch.setattr(F.Fused, "tend_rk_plan", plan_396)
    m = rk_model((20, 20), 6, thermo)
    counts = chip_smoke.rk_chunks(m, torch.float64)
    assert counts == sorted({1, 2, 3, 6, kmarch.plan(
        "tend_rk", 20, 20, 6, int(thermo), torch.float64, 396).chunks})
    cases = chip_smoke.rk_cases(torch, m, 5, counts)
    assert len(cases) == 2 * len(chip_smoke.RK_FORMS) * len(counts)
    assert {c[0] for c in cases} == {"tend_rk"}
    seen = []
    fz = m.fused
    real = fz.tend_rk

    def tend_rk(s, t, e, cbdt, can, first, carry, chunks=None):
        seen.append((chunks, s["u"].data_ptr() % 16, e.data_ptr() % 16,
                     first, carry, fz.coriolis,
                     bool(fz.ct[:, F.T_FACZ].abs().max() > 0),
                     bool(t["u"].isnan().all())))
        return real(s, t, e, cbdt, can, first, carry, chunks=chunks)

    fz.tend_rk = tend_rk
    nf = 4 if thermo else 3
    for name, kern, plain_call, kind in cases:
        assert kind == "field"
        got, want = kern(), plain_call()
        assert len(got) in (nf, 2 * nf)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(bool(torch.isfinite(g).all()) for g in got)
    assert [c[0] for c in seen] == [c for c in counts for _ in range(8)]
    assert {c[1:3] for c in seen} == {(0, 0), (8, 8)}
    assert {c[3:5] for c in seen} == {(True, True), (False, True),
                                      (False, False), (True, False)}
    # the carries are NaN on the first substep only
    assert all(c[7] == c[3] for c in seen)
    # drycblles has a sponge, the neutral Ekman LES none
    assert {c[5:7] for c in seen} == {(True, thermo), (False, False)}
    # the forced check of a run's path: a middle and a first substep
    monkeypatch.setattr(chip_smoke, "compare",
                        lambda torch_, name, kern, plain_call, kind, dtype,
                        where: (kern(), 0.)[1])
    del seen[:]
    chip_smoke.check_rk_forced(torch, m)
    assert [c[0] for c in seen] == [c for c in counts for _ in range(4)]
    assert {c[3:5] for c in seen} == {(False, True), (True, True)}
