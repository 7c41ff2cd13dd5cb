"""K20 (``tendencies``), the dry sweep without the RK fold: K18's k-march
with the sponge and th, ``tend_uvw_kernel<T, false, true, TH>`` in
``csrc/tend_generic.cu`` (the DRY and TH template flags), on the CPU.

* its constants, shared memory and launch bounds read from the source, and
  ``ops/kmarch.py`` agreeing with them; its plan at the shapes of its paths
  (sullivan2011 512^3 and 512^2x64, the neutral Ekman LES 768x384x288);
* the wrapper, with a recorder in place of the kernel: the plan's chunk
  count (from the card's resident blocks, asked in the case's thermo form)
  or the one forced, after the C entry's other arguments; th and its carry
  null without thermo;
* ``dry_march``, a torch emulation of the kernel's chunked march tile by
  tile (ring slots of the five fields' planes, u, v, w, e and th, staged
  rows, the carries read a level ahead, guarded writes of a partial tile's
  wrapped points), equals ``tendencies_plain`` to 1e-12 in float64 at
  every chunk count for ktot 6 and 16, on a 12 x 10 plane (one partial
  tile in i, two in j), with th, the Coriolis term and the sponge columns
  each on and off; the fields' levels outside ks-1..ke are NaN (never
  read), and so are the slots and rows before a copy lands;
* each edge rule of the march, broken on its own (``broken=``), changes
  the result;
* the emulation called with the C entry's arguments through the wrapper
  equals the plain version, and ``chip_smoke.py``'s K20 cases run on the
  CPU.
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
SRC = os.path.join(ROOT, "microhh_torch", "csrc", "tend_generic.cu")
RULES = ("no_group_km1", "no_plane_k1", "local_wall", "row_next",
         "halo_clamp", "unguarded", "carry_next")
ARGS = dict(dxi=0.7, dyi=1.3, visc=1e-3, svisc=2e-3, tPr=1. / 3., fc=0.3,
            utrans=0.2, vtrans=-0.1)
NAN = float("nan")


def flat_source():
    with open(SRC) as f:
        return re.sub(r"\s+", " ", f.read())


def test_constants_are_the_source():
    flat = flat_source()
    # K18's body with the DRY and TH flags, their code `if constexpr`
    assert ("template <typename T, bool RK, bool DRY = false, bool TH = false> "
            "__global__ void __launch_bounds__(UVW_NT, sizeof(T) == 4 ? "
            "(RK || TH ? 3 : 4) : 2) tend_uvw_kernel(const UvwArgs<T> a)"
            in flat)
    # one launch path for K8/K9, K18 and K20, th's plane in the shared
    # memory with TH
    assert "auto kernel = tend_uvw_kernel<T, RK, DRY, TH>;" in flat
    assert "const size_t smem = uvw_smem<T, TH>();" in flat
    assert flat.count("kernel<<<grid, block, smem, stream>>>(args);") == 1
    assert ("return a.th ? launch_tend_uvw<T, false, true, true>(a, stream) "
            ": launch_tend_uvw<T, false, true, false>(a, stream);" in flat)
    assert "constexpr int NF = UVW_NF + (TH ? 1 : 0);" in flat
    assert ("return ((size_t)UVW_R * (UVW_NF + (TH ? 1 : 0)) * "
            "km::Slot<UVW_TJ, UVW_HALO>::SIZE + (size_t)UVW_R * NTGP) * "
            "sizeof(T);" in flat)
    # th's plane fifth in a group; one commit group and one barrier a level
    assert "if constexpr (TH) km::cp_async<16>(d + 4 * SZ, a.th + g);" in flat
    body = flat[flat.index("tend_uvw_kernel(const UvwArgs<T> a) {"):]
    body = body[:body.index("km::wait_all(); }")]
    assert body.count("__syncthreads();") == 2      # the warm-up's, a level's
    assert body.count("km::commit();") == 1
    assert body.count("for (int k = k0; k < k1; ++k)") == 1
    # no code of the flags outside `if constexpr`, so that K8/K9's and
    # K18's instances compile as they did
    assert re.findall(r"\bif \((TH|DRY)\b", body) == []
    assert "template <typename T> struct ThColumn<T, false> {};" in flat
    assert ("if constexpr (TH) { if (tid == 2) r[TQ_GTHREFH] = T(9.81) / "
            "r[T_THREFH]; }" in flat)
    for dtype, nb in ((torch.float32, 4), (torch.float64, 8)):
        assert kmarch.uvw_smem(dtype, 1) == (5 * 5 * 10 * 40 + 5 * 24) * nb
        for S in (0, 1):
            assert kmarch.SMEM["tendencies"](S, dtype, True) == (
                kmarch.uvw_smem(dtype, S))
        # as many blocks as the launch bounds ask fit an SM's 228 KB (1 KB
        # of it reserved a block)
        for S, blocks in ((1, 3 if nb == 4 else 2), (0, 4 if nb == 4 else 2)):
            assert blocks * (kmarch.uvw_smem(dtype, S) + 1024) <= 233472
    assert kmarch.TILE_J["tendencies"] == kmarch.UVW_TJ
    assert kmarch.WARM["tendencies"] == 2
    # the staged row holds the table and the three quotients K20 reads
    assert F.NTG + 3 <= kmarch.NTGP
    # the C entry takes the chunk count last and reports its occupancy in
    # its thermo form, th counted as S
    assert kernels.SIGNATURES["tendencies"][-1] is kernels._I
    assert len(kernels.SIGNATURES["tendencies"]) == 24
    assert "tendencies" in kernels.INFO
    for entry in ("mhh_tendencies_info_##SUF(int scheme, int S, int* out)",
                  "return S ? mhh::tend_uvw_info<T, false, true, true>(out)",
                  ": mhh::tend_uvw_info<T, false, true, false>(out);",
                  "double vtrans, int coriolis, int chunks,"):
        assert entry in flat
    # the ring K20 was is gone, and with K2 on this march tend_rk.cu too
    assert not os.path.exists(os.path.join(ROOT, "microhh_torch", "csrc",
                                           "tend_rk.cu"))
    assert "tendencies_kernel" not in flat


def test_plan_at_its_shapes():
    """sullivan2011 512^3 and 512^2x64 with th at three resident blocks an
    SM on 132 SMs, the neutral Ekman LES 768x384x288 without at four, and
    512^3 float64 at two; whole waves, every level once."""
    f32 = torch.float32
    p = kmarch.plan("tendencies", 512, 512, 512, 1, f32, 396)
    assert (p.tiles_i, p.tiles_j, p.smem) == (16, 64, 40480)
    assert p.waves == -(-1024 * p.chunks // 396)
    p64 = kmarch.plan("tendencies", 512, 512, 64, 1, f32, 396)
    assert p64.chunks == kmarch.choose_chunks(1024, 64, 396, 2)
    p = kmarch.plan("tendencies", 768, 384, 288, 0, f32, 528)
    assert p.smem == kmarch.uvw_smem(f32)
    p = kmarch.plan("tendencies", 512, 512, 512, 1, torch.float64, 264)
    assert p.smem == 80960
    for ktot in (6, 16, 512):
        p = kmarch.plan("tendencies", 45, 20, ktot, 1, f32, 396)
        levels = [k for k0, k1 in kmarch.chunk_bounds(p.chunks, ktot)
                  for k in range(k0, k1)]
        assert levels == list(range(ktot))


def dry_model(n, k, thermo=True, dtype=torch.float64):
    """A small sullivan2011 (th) or neutral Ekman LES on the substep without
    the RK fold, on the CPU."""
    build = chip_smoke.build_sullivan if thermo else chip_smoke.build_andren
    m = build(torch, n, k, dtype, "cpu")
    m.build_step(unfolded=True)
    assert m.unfolded and not m.generic
    return m


@pytest.mark.parametrize("thermo", [True, False])
def test_wrapper_plans_and_forces(thermo, monkeypatch):
    """K20 passes the plan's chunk count (from the card's resident blocks,
    asked in the case's thermo form) or the one forced, after the C entry's
    other arguments; th and its carry null without thermo."""
    monkeypatch.setattr(F, "on_cpu", lambda t: False)
    m = dry_model((40, 24), 16, thermo, torch.float32)
    fz, ctx = m.fused, m.ctx
    asked = []

    class Rec(Recorder):
        def info(self, dtype, scheme, S=0):
            asked.append((dtype, scheme, S))
            return super().info(dtype, scheme, S)

    fz.k_tendencies = Rec("tendencies")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    names = fz.prognostic
    s = {n: torch.zeros(shape) for n in names}
    t = {n: torch.zeros(shape) for n in names}
    e = torch.zeros(shape)
    want = kmarch.plan("tendencies", 40, 24, 16, int(thermo), torch.float32,
                       396).chunks
    fz.tendencies(s, t, e)
    fz.tendencies(s, t, e, chunks=5)
    (d1, a1), (_, a2) = fz.k_tendencies.calls
    assert d1 == torch.float32
    th, tth = (s["th"], t["th"]) if thermo else (None, None)
    assert [x is y for x, y in zip(
        a1[:10], [s["u"], s["v"], s["w"], th, e, t["u"], t["v"], t["w"],
                  tth, fz.ct])] == [True] * 10
    assert a1[10:14] == (40, 24, 16, ctx.ks)
    assert a1[14:22] == (ctx.dxi, ctx.dyi, fz.visc, fz.svisc, fz.tPr, fz.fc,
                         ctx.utrans, ctx.vtrans)
    assert a1[22:] == (int(fz.coriolis), want)
    assert a2[-1] == 5
    assert asked and all(a[1:] == (0, int(thermo)) for a in asked)
    assert fz.tendencies_plan(torch.float32, 3).chunks == 3
    with pytest.raises(ValueError):
        fz.tendencies(s, t, e, chunks=17)


# --------------------------------------------------------------------------
#  the chunked march, emulated
# --------------------------------------------------------------------------

def dry_march(u, v, w, th, e, tu, tv, tw, tth, ct, ks, dxi, dyi, visc,
              svisc, tPr, fc, utrans, vtrans, coriolis, chunks, broken=None,
              rk=None):
    """A torch emulation of csrc/tend_generic.cu tend_uvw_kernel<T, false,
    true, TH> (TH where th is given) or, with rk, of K2's <T, true, true,
    TH> (below): every chunk [k0, k1) of every
    (UVW_TJ, 32) tile (its virtual points wrap around the plane) issues
    group k0-1 (planes k0-1 of u, v, w, e and th, gathered with a halo of
    one, wrapped) into slot 0 and groups k0 .. k0+2 into slots 1-3, a
    group's table row beside it for a level of the chunk; level k reads
    groups k-1, k, k+1 and row k, issues group k+3 (none past plane k1)
    into the slot of group k-2, reads the next level's carries ahead and
    writes its own points only; w's tendency is zero at the global level 0.
    Slots and rows start as NaN.  The carries are updated in place.
    broken names one rule to break: "no_group_km1" (group k0-1 not
    issued), "no_plane_k1" (no plane past k1-1), "local_wall" (w zero at
    each chunk's k0), "row_next" (row k+1 read at level k), "halo_clamp"
    (the halo clamped to the plane, not wrapped), "unguarded" (a partial
    tile's wrapped points write too), "carry_next" (the carries of level
    k+1 read at level k).

    rk: K2's RK form, a dict of its s* (us, vs, ws, ths; th's None without
    th), cbdt, can, first and carry.  e is then the interior eddy viscosity
    and the reads are clamped: group p holds plane clamp(p, 0, ktot-1) past
    ks of u, v and th, clamp(p, 0, ktot) past ks of w and clamp(p, 0,
    ktot-1) of e; the table's column fold is left out (the sponge stands
    in); s* = s + cbdt t_total is written, the carry can t_total when carry,
    and with first no carry is read (0).  Its rules to break: "uv_bottom"
    (u's, v's and th's planes not clamped at the bottom), "uv_top" (nor at
    the top), "w_top" (w's clamped to ktot-1 like u's), "e_index" (e read
    past ks), "first_read" (the carries read with first), "dry_fold" (the
    column fold applied under DRY)."""
    kcells, jtot, itot = u.shape
    ktot = ct.shape[0]
    TI, TJ, R = kmarch.TI, kmarch.UVW_TJ, kmarch.UVW_R
    thermo = th is not None
    fields = (u, v, w, e) + ((th,) if thermo else ())
    carries = (tu, tv, tw) + ((tth,) if thermo else ())
    if rk is not None:
        stars = (rk["us"], rk["vs"], rk["ws"]) + ((rk["ths"],) if thermo
                                                  else ())

    def planes(p):
        """The plane of each field that group p holds."""
        if rk is None:
            return [ks + p] * len(fields)
        lo = -1 if broken == "uv_bottom" else 0
        hi = ktot if broken == "uv_top" else ktot - 1
        pa = ks + min(max(p, lo), hi)
        pw = ks + min(max(p, 0), ktot - 1 if broken == "w_top" else ktot)
        pe = (min(max(ks + p, 0), ktot - 1) if broken == "e_index"
              else min(max(p, 0), ktot - 1))
        return [pa, pa, pw, pe, pa][:len(fields)]
    for k0, k1 in kmarch.chunk_bounds(chunks, ktot):
        top = k1 - 1 if broken == "no_plane_k1" else k1
        for j0 in range(0, jtot, TJ):
            for i0 in range(0, itot, TI):
                def index(x0, n, size):
                    ix = torch.arange(x0 - 1, x0 + n + 1)
                    return (ix.clamp(0, size - 1) if broken == "halo_clamp"
                            else ix % size)
                rj, ci = index(j0, TJ, jtot), index(i0, TI, itot)
                jj, ii = torch.meshgrid(rj[1:-1] % jtot, ci[1:-1] % itot,
                                        indexing="ij")
                jin, iin = torch.meshgrid(torch.arange(j0, j0 + TJ),
                                          torch.arange(i0, i0 + TI),
                                          indexing="ij")
                mask = (jin < jtot) & (iin < itot)
                if broken == "unguarded":
                    mask = torch.ones_like(mask)
                jj, ii = jj[mask], ii[mask]
                ring = [torch.full((len(fields), TJ + 2, TI + 2), NAN,
                                   dtype=u.dtype)] * R
                rows = [torch.full((ct.shape[1],), NAN, dtype=u.dtype)] * R

                def issue(p, sl):
                    if p <= top:
                        ring[sl] = torch.stack([f[q][rj][:, ci] for f, q
                                                in zip(fields, planes(p))])
                        if k0 <= p < k1:
                            rows[sl] = ct[p]

                def carry_at(k):
                    if (rk is not None and rk["first"]
                            and broken != "first_read"):
                        return [torch.zeros(TJ, TI, dtype=u.dtype)
                                for t in carries]
                    return [t[ks + k][rj[1:-1]][:, ci[1:-1]]
                            for t in carries]

                if broken != "no_group_km1":
                    issue(k0 - 1, 0)
                for p in range(k0, k0 + 3):
                    issue(p, p - k0 + 1)
                cur = carry_at(min(k0 + 1, ktot - 1) if broken == "carry_next"
                               else k0)
                sm = 0
                for k in range(k0, k1):
                    sc, sp = (sm + 1) % R, (sm + 2) % R
                    issue(k + 3, (sm - 1) % R)
                    ahead = k + 2 if broken == "carry_next" else k + 1
                    nxt = carry_at(min(ahead, k1 - 1))
                    dn, cn, up = ring[sm], ring[sc], ring[sp]
                    c = F._columns(rows[sp if broken == "row_next"
                                        else sc][None])
                    u_dn, uc, u_up = (x[0][None] for x in (dn, cn, up))
                    v_dn, vc, v_up = (x[1][None] for x in (dn, cn, up))
                    w_dn, wc, w_up = (x[2][None] for x in (dn, cn, up))
                    e_dn, ec, e_up = (x[3][None] for x in (dn, cn, up))
                    ut, vt = F._uv_tend(c, dxi, dyi, visc, u_dn, uc, u_up,
                                        v_dn, vc, v_up, wc, w_up, e_dn, ec,
                                        e_up)
                    wt = F._w_tend(c, dxi, dyi, visc, u_dn, uc, v_dn, vc,
                                   w_dn, wc, w_up, e_dn, ec)
                    facz = c(F.T_FACZ)
                    if rk is not None and broken == "dry_fold":
                        ut = ut + c(F.T_ADDU) - facz * uc
                        vt = vt + c(F.T_ADDV) - facz * vc
                        wdn, wup = c(F.T_WLSDN), c(F.T_WLSUP)
                        ut = ut + wdn * (uc - u_dn) + wup * (u_up - uc)
                        vt = vt + wdn * (vc - v_dn) + wup * (v_up - vc)
                        wt = wt - c(F.T_FACZH) * wc
                    ut = ut - facz * (uc - c(F.T_UREF))
                    vt = vt - facz * (vc - c(F.T_VREF))
                    wt = wt - c(F.T_FACZH) * wc
                    if coriolis:
                        cu, cv = F._coriolis(uc, vc, c, fc, utrans, vtrans)
                        ut, vt = ut + cu, vt + cv
                    tends = [ut, vt, wt]
                    now = [uc, vc, wc]
                    if thermo:
                        a_dn, ac, a_up = (x[4][None] for x in (dn, cn, up))
                        threfh = c(F.T_THREFH)
                        wt += F.cst.grav / threfh * (0.5 * (a_dn + ac)
                                                     - threfh)
                        tht = F._s_tend(c, dxi, dyi, svisc, tPr, uc, vc, wc,
                                        w_up, a_dn, ac, a_up, e_dn, ec, e_up)
                        tends.append(tht - facz * (ac - c(F.T_SREF)))
                        now.append(ac)
                    if k == (k0 if broken == "local_wall" else 0):
                        wt.zero_()
                    for n, tend in enumerate(tends):
                        tt = (cur[n] + tend[0, 1:-1, 1:-1])[mask]
                        if rk is None:
                            carries[n][ks + k][jj, ii] = tt
                            continue
                        a1 = now[n][0, 1:-1, 1:-1][mask]
                        stars[n][ks + k][jj, ii] = a1 + rk["cbdt"] * tt
                        if rk["carry"]:
                            carries[n][ks + k][jj, ii] = rk["can"] * tt
                    cur = nxt
                    sm = sc


def inputs(ktot, seed, thermo=True, ks=3, jtot=10, itot=12):
    """Seeded u, v, w (w scaled by 0.3), th around 300 K, a positive eddy
    viscosity and the carries on a (jtot, itot) plane with ks ghost levels,
    the fields' levels outside ks-1..ke NaN (never read), and a random
    stretched (ktot, NTG) table with noise in every column, threfh around
    300 K."""
    rng = np.random.default_rng(seed)
    shape = (ktot + 2 * ks, jtot, itot)

    def field(scale=1.):
        return torch.tensor(scale * rng.standard_normal(shape))

    s = {"u": field(), "v": field(), "w": field(0.3)}
    if thermo:
        s["th"] = 300. + field()
    e = field().abs()
    for x in list(s.values()) + [e]:
        x[:ks - 1] = NAN
        x[ks + ktot + 1:] = NAN
    t = {n: field(0.1) for n in s}
    ct = 1e-2 * rng.standard_normal((ktot, F.NTG))
    ct[:, [F.T_DZI, F.T_DZHI, F.T_DZHI1, F.T_DZI_M1]] += 1. / (
        0.5 + rng.random((ktot, 4)))
    ct[:, [F.T_RHO, F.T_RHOH, F.T_RHOH1, F.T_RHO_M1]] += 1.
    ct[:, F.T_THREFH] += 300.
    ct[:, [F.T_FACZ, F.T_FACZH]] = np.abs(ct[:, [F.T_FACZ, F.T_FACZH]])
    return s, e, t, torch.tensor(ct)


def plain(s, e, t, ct, ks, coriolis):
    """tendencies_plain with the test's numbers; returns the carries."""
    a = ARGS
    F.tendencies_plain(s, e, t, ct, ks, a["dxi"], a["dyi"], a["visc"],
                       a["svisc"], a["tPr"], a["fc"], a["utrans"],
                       a["vtrans"], coriolis, "th" in s)
    return [t[n] for n in t]


def march(s, e, t, ct, ks, coriolis, chunks, broken=None):
    """dry_march with the test's numbers; returns the carries."""
    a = ARGS
    dry_march(s["u"], s["v"], s["w"], s.get("th"), e, t["u"], t["v"],
              t["w"], t.get("th"), ct, ks, a["dxi"], a["dyi"], a["visc"],
              a["svisc"], a["tPr"], a["fc"], a["utrans"], a["vtrans"],
              coriolis, chunks, broken)
    return [t[n] for n in t]


def rel_err(got, want):
    """The largest over the outputs of max |got - want| / max |want|,
    infinite where got is not finite."""
    return max(float((g - w).abs().max() / w.abs().max())
               if bool(torch.isfinite(g).all()) else float("inf")
               for g, w in zip(got, want))


FORMS = [(thermo, coriolis, sponge) for thermo in (True, False)
         for coriolis in (True, False) for sponge in (True, False)]


@pytest.mark.parametrize("thermo,coriolis,sponge", FORMS)
@pytest.mark.parametrize("ktot", [6, 16])
def test_dry_march_is_the_plain_version(ktot, thermo, coriolis, sponge):
    """The emulated march equals the plain version to 1e-12 at every chunk
    count, on partial tiles, with NaN outside the levels the sweep reads."""
    ks = 3
    s, e, t0, ct = inputs(ktot, ktot + 2 * thermo + 4 * coriolis + sponge,
                          thermo, ks)
    if not sponge:
        ct[:, [F.T_FACZ, F.T_FACZH]] = 0.
    want = plain(s, e, {n: x.clone() for n, x in t0.items()}, ct, ks,
                 coriolis)
    assert all(bool(torch.isfinite(x).all()) for x in want)
    assert rel_err([t0[n] for n in t0], want) > 1e-3
    for chunks in range(1, ktot + 1):
        got = march(s, e, {n: x.clone() for n, x in t0.items()}, ct, ks,
                    coriolis, chunks)
        assert rel_err(got, want) <= 1e-12, chunks
        for g, w in zip(got, want):
            assert torch.equal(g[:ks], w[:ks])
            assert torch.equal(g[ks + ktot:], w[ks + ktot:])


@pytest.mark.parametrize("broken", RULES)
def test_dry_march_needs_each_edge_rule(broken):
    """Each rule of the march, broken on its own, breaks the result at some
    chunk count, with th and without."""
    ks, ktot = 3, 6
    worst = 0.
    for thermo in (True, False):
        s, e, t0, ct = inputs(ktot, 11, thermo, ks)
        want = plain(s, e, {n: x.clone() for n, x in t0.items()}, ct, ks,
                     True)
        for chunks in range(1, ktot + 1):
            got = march(s, e, {n: x.clone() for n, x in t0.items()}, ct, ks,
                        True, chunks, broken)
            worst = max(worst, rel_err(got, want))
    assert worst > 1e-6, broken


class DryEmulator(Recorder):
    """K20's stand-in: called with the C entry's arguments, it checks what
    the entry checks and runs dry_march."""

    def __call__(self, dtype, *args):
        (u, v, w, th, e, tu, tv, tw, tth, ct, itot, jtot, ktot, ks, dxi, dyi,
         visc, svisc, tPr, fc, utrans, vtrans, coriolis, chunks) = args
        super().__call__(dtype, chunks)
        assert 1 <= chunks <= ktot and ct.shape == (ktot, F.NTG)
        assert u.shape == (ktot + 2 * ks, jtot, itot)
        assert (th is None) == (tth is None)
        dry_march(u, v, w, th, e, tu, tv, tw, tth, ct, ks, dxi, dyi, visc,
                  svisc, tPr, fc, utrans, vtrans, coriolis, chunks)


@pytest.mark.parametrize("thermo", [True, False])
def test_dry_march_through_the_wrapper(thermo, monkeypatch):
    """The emulation called with the C entry's arguments through the
    wrapper (the carries in place, the case's sponge, the Coriolis term
    on) equals the plain version at every chunk count."""
    m = dry_model((12, 10), 6, thermo)
    fz, ctx = m.fused, m.ctx
    fz.coriolis, fz.fc = True, 0.3
    s, e, t0, ct = inputs(6, 21, thermo, ctx.ks)
    fz.ct = fz.ct + 1e-2 * ct
    t_want = {n: x.clone() for n, x in t0.items()}
    fz.tendencies(s, t_want, e)
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    for chunks in range(1, 7):
        fz.k_tendencies = DryEmulator("tendencies")
        t = {n: x.clone() for n, x in t0.items()}
        fz.tendencies(s, t, e, chunks=chunks)
        assert rel_err(list(t.values()), list(t_want.values())) <= 1e-12
        assert [c[1][0] for c in fz.k_tendencies.calls] == [chunks]


@pytest.mark.parametrize("thermo", [True, False])
def test_dry_chip_cases_on_the_cpu(thermo, monkeypatch):
    """chip_smoke.py's K20 cases on a small dry model on the CPU (both calls
    take the plain version here): the forced counts and the plan's, each
    aligned and shifted past a 16-byte boundary, the sponge and Coriolis
    term each on and off, with NaN levels that the plain version never
    reads, and the forced check of a run in the path's own form."""
    monkeypatch.setattr(F.Fused, "tendencies_plan",
                        lambda self, dtype, chunks=None: kmarch.plan(
                            "tendencies", self.ctx.itot, self.ctx.jtot,
                            self.ctx.ktot, int(self.has_thermo), dtype, 396,
                            chunks))
    m = dry_model((20, 12), 6, thermo)
    # sullivan2011 has a sponge, the neutral Ekman LES none
    sponge = bool(m.fused.ct[:, F.T_FACZ].abs().max() > 0)
    assert sponge == thermo
    counts = chip_smoke.dry_chunks(m, torch.float64)
    assert counts == sorted({1, 2, 3, 6, kmarch.plan(
        "tendencies", 20, 12, 6, int(thermo), torch.float64, 396).chunks})
    cases = chip_smoke.dry_cases(torch, m, 5, counts)
    assert len(cases) == 2 * 2 * len(counts)
    assert {c[0] for c in cases} == {"tendencies"}
    seen = []
    fz = m.fused
    real = fz.tendencies

    def tendencies(s, t, e, chunks=None):
        seen.append((chunks, s["u"].data_ptr() % 16, e.data_ptr() % 16,
                     fz.coriolis, bool(fz.ct[:, F.T_FACZ].abs().max() > 0)))
        return real(s, t, e, chunks=chunks)

    fz.tendencies = tendencies
    for name, kern, plain_call, kind in cases:
        assert kind == "field"
        got, want = kern(), plain_call()
        assert len(got) == (4 if thermo else 3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(bool(torch.isfinite(g).all()) for g in got)
    assert [c[0] for c in seen] == [c for c in counts for _ in range(4)]
    assert {c[1:3] for c in seen} == {(0, 0), (8, 8)}
    assert {c[3:] for c in seen} == {(True, sponge), (False, False)}
    # the forced check of a run's path: its own sponge and Coriolis term
    monkeypatch.setattr(chip_smoke, "compare",
                        lambda torch_, name, kern, plain_call, kind, dtype,
                        where: (kern(), 0.)[1])
    del seen[:]
    chip_smoke.check_dry_forced(torch, m)
    assert [c[0] for c in seen] == [c for c in counts for _ in range(2)]
    assert {c[3:] for c in seen} == {(fz.coriolis, sponge)}
