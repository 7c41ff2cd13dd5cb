"""The momentum sweep K8/K9 (``tend_uvw``) and K18 (``tend_uvw_acc``): one
k-march, ``tend_uvw_kernel<T, RK>`` in ``csrc/tend_generic.cu``, on the CPU.

* its constants, shared memory and launch bounds read from the source, and
  ``ops/kmarch.py`` agreeing with them; its plan at the four main shapes
  (rico 384^3 in float32 and float64, SBL_Smag 256^3, jaenschwalde
  1024x256x256);
* the wrappers, with recorders in place of the kernels: the plan's chunk
  count (from the card's resident blocks) or the one forced, after the C
  entries' other arguments;
* ``uvw_march``, a torch emulation of the kernel's chunked march tile by
  tile (ring slots of the four fields' planes, staged rows, the carries
  read a level ahead, guarded writes of a partial tile's wrapped points),
  equals ``tend_uvw_plain`` and ``tend_uvw_acc_plain`` to 1e-12 in float64
  at every chunk count for ktot 6 and 16, on a 12 x 10 plane (one partial
  tile in i, two in j), with RK on and off and advection, the Coriolis
  term and the carry each on and off; the fields' levels outside ks-1..ke
  are NaN (never read), and so are the slots and rows before a copy lands;
* each edge rule of the march, broken on its own (``broken=``), changes
  the result: group k0-1 issued first, plane k1 read at a chunk's top, w's
  wall at the global level 0 only, the staged row of level k, the halo
  wrapped, a partial tile's writes guarded, no carry written when carry
  is 0;
* the emulation called with the C entries' arguments through the
  wrappers equals the plain versions, and ``chip_smoke.py``'s K8/K9/K18
  cases run on the CPU.
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
SRC = os.path.join(ROOT, "microhh_torch", "csrc", "tend_generic.cu")
RULES = ("no_group_km1", "no_plane_k1", "local_wall", "row_next",
         "halo_clamp", "unguarded", "carry_always")
ARGS = dict(dxi=0.7, dyi=1.3, visc=1e-3, fc=0.3, utrans=0.2, vtrans=-0.1,
            cbdt=0.6)
NAN = float("nan")


def source():
    with open(SRC) as f:
        src = f.read()
    consts = {}
    for key, expr in re.findall(r"constexpr int (UVW_\w+) = ([^;]+);", src):
        expr = re.sub(r"//.*", "", expr)
        try:
            consts[key] = eval(expr, {}, dict(consts))
        except (NameError, SyntaxError):
            pass    # a name of another header (km::TI)
    return consts, re.sub(r"\s+", " ", src)


def test_constants_are_the_source():
    c, flat = source()
    assert (c["UVW_TJ"], c["UVW_HALO"], c["UVW_NF"], c["UVW_R"]) == (
        kmarch.UVW_TJ, kmarch.UVW_HALO, kmarch.UVW_NF, kmarch.UVW_R)
    assert "constexpr int UVW_NT = km::TI * UVW_TJ;" in flat
    assert ("((size_t)UVW_R * (UVW_NF + (TH ? 1 : 0)) * "
            "km::Slot<UVW_TJ, UVW_HALO>::SIZE + (size_t)UVW_R * NTGP) * "
            "sizeof(T)" in flat)
    # (K20's forms, DRY and TH, share the body: three blocks an SM with th)
    assert ("template <typename T, bool RK, bool DRY = false, bool TH = false> "
            "__global__ void __launch_bounds__(UVW_NT, sizeof(T) == 4 ? "
            "(RK || TH ? 3 : 4) : 2) tend_uvw_kernel(const UvwArgs<T> a)"
            in flat)
    # three groups read at a level, one landing, one being filled: group
    # k+3 goes into the slot of group k-2, one commit group a level
    assert kmarch.UVW_R == 5
    assert "issue(k + 3, sm == 0 ? UVW_R - 1 : sm - 1);" in flat
    assert "km::wait_pending<1>(); // group k+1 has landed" in flat
    assert "km::wait_pending<2>(); // groups k0-1 and k0 have landed" in flat
    # one body for both (the scalar sweep, K15 among its forms, and this
    # one in the file), launched with its dynamic shared memory (K20's too)
    assert "auto kernel = tend_uvw_kernel<T, RK, DRY, TH>;" in flat
    assert "kernel<<<grid, block, smem, stream>>>(args);" in flat
    assert flat.count("__global__") == 2
    assert flat.count("tend_uvw_kernel(") == 1
    for dtype, nb in ((torch.float32, 4), (torch.float64, 8)):
        assert kmarch.uvw_smem(dtype) == (5 * 4 * 10 * 40 + 5 * 24) * nb
        for name in ("tend_uvw", "tend_uvw_acc"):
            assert kmarch.SMEM[name](0, dtype, True) == kmarch.uvw_smem(dtype)
            assert kmarch.TILE_J[name] == kmarch.UVW_TJ
            assert kmarch.WARM[name] == 2
        # as many blocks as the launch bounds ask fit an SM's 228 KB (1 KB
        # of it reserved a block)
        blocks = 4 if dtype == torch.float32 else 2
        assert blocks * (kmarch.uvw_smem(dtype) + 1024) <= 233472
    # the staged row holds the table and the two quotients the kernel reads
    assert F.NTG + 2 <= kmarch.NTGP
    # the C entries take the chunk count last and report their occupancy
    assert kernels.SIGNATURES["tend_uvw"][-1] is kernels._I
    assert len(kernels.SIGNATURES["tend_uvw"]) == 27
    assert len(kernels.SIGNATURES["tend_uvw_acc"]) == 21
    assert {"tend_uvw", "tend_uvw_acc"} <= set(kernels.INFO)
    for entry in ("mhh_tend_uvw_info_##SUF", "mhh_tend_uvw_acc_info_##SUF",
                  "int advec, int chunks, void* stream"):
        assert entry in flat


def test_plan_at_the_main_shapes():
    """rico 384^3 (K8/K9) and SBL_Smag 256^3 (K8/K9) with three resident
    blocks an SM on 132 SMs, jaenschwalde 1024x256x256 (K18) with four
    (and three), rico 384^3 float64 with two; whole waves, every level
    once."""
    f32 = torch.float32
    p = kmarch.plan("tend_uvw", 384, 384, 384, 0, f32, 396)
    assert (p.tiles_i, p.tiles_j, p.chunks, p.waves, p.smem) == (
        12, 48, 2, 3, 32480)
    p = kmarch.plan("tend_uvw", 256, 256, 256, 0, f32, 396)
    assert (p.tiles_i * p.tiles_j, p.chunks, p.waves) == (256, 3, 2)
    p = kmarch.plan("tend_uvw_acc", 1024, 256, 256, 0, f32, 528)
    assert (p.tiles_i * p.tiles_j, p.chunks, p.waves) == (1024, 1, 2)
    p = kmarch.plan("tend_uvw_acc", 1024, 256, 256, 0, f32, 396)
    assert (p.chunks, p.waves) == (5, 13)
    p = kmarch.plan("tend_uvw", 384, 384, 384, 0, torch.float64, 264)
    assert (p.chunks, p.waves, p.smem) == (5, 11, 64960)
    for ktot in (6, 16, 384):
        for name in ("tend_uvw", "tend_uvw_acc"):
            p = kmarch.plan(name, 45, 20, ktot, 0, f32, 396)
            levels = [k for k0, k1 in kmarch.chunk_bounds(p.chunks, ktot)
                      for k in range(k0, k1)]
            assert levels == list(range(ktot))


def test_wrappers_plan_and_force(monkeypatch):
    """K8/K9 and K18 pass the plan's chunk count (from the card's resident
    blocks) or the one forced, after the C entries' other arguments."""
    monkeypatch.setattr(F, "on_cpu", lambda t: False)
    m = rico_model(16, "2", torch.float32)
    fz, ctx = m.fused, m.ctx
    fz.k_uvw, fz.k_uvw_acc = Recorder("tend_uvw"), Recorder("tend_uvw_acc")
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    s = {n: torch.zeros(shape) for n in ("u", "v", "w")}
    t = {n: torch.zeros(shape) for n in ("u", "v", "w")}
    e = torch.zeros(shape)
    ct = torch.zeros(ctx.ktot, F.NTG)
    want = kmarch.plan("tend_uvw", 40, 24, 16, 0, torch.float32, 396).chunks
    out = fz.tend_uvw(s, t, e, ct, 0.5, -0.6, True)
    fz.tend_uvw(s, t, e, ct, 0.5, -0.6, False, chunks=5)
    (d1, a1), (_, a2) = fz.k_uvw.calls
    assert d1 == torch.float32
    assert [x is y for x, y in zip(a1[:11], [s["u"], s["v"], s["w"], e]
                                   + list(out.values()) + list(t.values())
                                   + [ct])] == [True] * 11
    assert a1[11:15] == (40, 24, 16, ctx.ks)
    assert a1[15:23] == (ctx.dxi, ctx.dyi, fz.visc, fz.fc, ctx.utrans,
                         ctx.vtrans, 0.5, -0.6)
    assert a1[23:] == (int(fz.coriolis), 1, int(fz.advec), want)
    assert a2[24] == 0 and a2[-1] == 5
    fz.tend_uvw_acc(s, t, e)
    fz.tend_uvw_acc(s, t, e, chunks=16)
    (_, b1), (_, b2) = fz.k_uvw_acc.calls
    assert [x is y for x, y in zip(b1[:8], [s["u"], s["v"], s["w"], e]
                                   + list(t.values()) + [fz.ct_static])] \
        == [True] * 8
    assert b1[8:12] == (40, 24, 16, ctx.ks)
    assert b1[12:18] == (ctx.dxi, ctx.dyi, fz.visc, fz.fc, ctx.utrans,
                         ctx.vtrans)
    assert b1[18:] == (int(fz.fold_force), int(fz.advec), want)
    assert b2[-1] == 16
    assert fz.uvw_plan(torch.float32, True, 3).chunks == 3
    with pytest.raises(ValueError):
        fz.tend_uvw_acc(s, t, e, chunks=17)


# --------------------------------------------------------------------------
#  the chunked march, emulated
# --------------------------------------------------------------------------

def uvw_march(u, v, w, e, us, vs, ws, tu, tv, tw, ct, ks, dxi, dyi, visc,
              fc, utrans, vtrans, cbdt, can, coriolis, carry, advec, chunks,
              rk=True, broken=None):
    """A torch emulation of csrc/tend_generic.cu tend_uvw_kernel: every
    chunk [k0, k1) of every (UVW_TJ, 32) tile (the tile's virtual points
    wrap around the plane) issues group k0-1 (planes k0-1 of u, v, w and e,
    gathered with a halo of one, wrapped) into slot 0 and groups k0 .. k0+2
    into slots 1-3, a group's table row beside it for a level of the chunk;
    level k reads groups k-1, k, k+1 and row k, issues group k+3 (none past
    plane k1) into the slot of group k-2, reads the next level's carries
    ahead and writes its own points only; w's tendency is zero at the
    global level 0.  Slots and rows start as NaN.  us, vs, ws: s* (RK);
    the carries are updated in place.  broken names one rule to break:
    "no_group_km1" (group k0-1 not issued), "no_plane_k1" (no plane past
    k1-1), "local_wall" (w zero at each chunk's k0), "row_next" (row k+1
    read at level k), "halo_clamp" (the halo clamped to the plane, not
    wrapped), "unguarded" (a partial tile's wrapped points write too),
    "carry_always" (the carry written when carry is 0)."""
    kcells, jtot, itot = u.shape
    ktot = ct.shape[0]
    TI, TJ, R = kmarch.TI, kmarch.UVW_TJ, kmarch.UVW_R
    fields, stars, carries = (u, v, w, e), (us, vs, ws), (tu, tv, tw)
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
                ring = [torch.full((4, TJ + 2, TI + 2), NAN,
                                   dtype=u.dtype)] * R
                rows = [torch.full((ct.shape[1],), NAN, dtype=u.dtype)] * R

                def issue(p, sl):
                    if p <= top:
                        ring[sl] = torch.stack([f[ks + p][rj][:, ci]
                                                for f in fields])
                        if k0 <= p < k1:
                            rows[sl] = ct[p]

                def carry_at(k):
                    return [t[ks + k][rj[1:-1]][:, ci[1:-1]]
                            for t in carries]

                if broken != "no_group_km1":
                    issue(k0 - 1, 0)
                for p in range(k0, k0 + 3):
                    issue(p, p - k0 + 1)
                cur = carry_at(k0)
                sm = 0
                for k in range(k0, k1):
                    sc, sp = (sm + 1) % R, (sm + 2) % R
                    issue(k + 3, (sm - 1) % R)
                    nxt = carry_at(min(k + 1, k1 - 1))
                    dn, cn, up = ring[sm], ring[sc], ring[sp]
                    c = F._columns(rows[sp if broken == "row_next"
                                        else sc][None])
                    u_dn, uc, u_up = (x[0][None] for x in (dn, cn, up))
                    v_dn, vc, v_up = (x[1][None] for x in (dn, cn, up))
                    w_dn, wc, w_up = (x[2][None] for x in (dn, cn, up))
                    e_dn, ec, e_up = (x[3][None] for x in (dn, cn, up))
                    ut, vt = F._uv_tend(c, dxi, dyi, visc, u_dn, uc, u_up,
                                        v_dn, vc, v_up, wc, w_up, e_dn, ec,
                                        e_up, advec)
                    wt = F._w_tend(c, dxi, dyi, visc, u_dn, uc, v_dn, vc,
                                   w_dn, wc, w_up, e_dn, ec, advec)
                    if rk:
                        facz = c(F.T_FACZ)
                        ut = ut + c(F.T_ADDU) - facz * uc
                        vt = vt + c(F.T_ADDV) - facz * vc
                        wdn, wup = c(F.T_WLSDN), c(F.T_WLSUP)
                        ut = ut + wdn * (uc - u_dn) + wup * (u_up - uc)
                        vt = vt + wdn * (vc - v_dn) + wup * (v_up - vc)
                        wt = wt - c(F.T_FACZH) * wc
                    if coriolis:
                        cu, cv = F._coriolis(uc, vc, c, fc, utrans, vtrans)
                        ut, vt = ut + cu, vt + cv
                    if k == (k0 if broken == "local_wall" else 0):
                        wt = torch.zeros_like(wt)
                    for n, tend in enumerate((ut, vt, wt)):
                        tt = (cur[n] + tend[0, 1:-1, 1:-1])[mask]
                        if rk:
                            own = cn[n, 1:-1, 1:-1][mask]
                            stars[n][ks + k][jj, ii] = own + cbdt * tt
                            if carry or broken == "carry_always":
                                carries[n][ks + k][jj, ii] = can * tt
                        else:
                            carries[n][ks + k][jj, ii] = tt
                    cur = nxt
                    sm = sc


def inputs(ktot, seed, ks=3, jtot=10, itot=12):
    """Seeded u, v, w (w scaled by 0.3), a positive eddy viscosity and
    three carries on a (jtot, itot) plane with ks ghost levels, the
    fields' levels outside ks-1..ke NaN (never read), and a random
    stretched (ktot, NTG) table with noise in every column."""
    rng = np.random.default_rng(seed)
    shape = (ktot + 2 * ks, jtot, itot)

    def field(scale=1.):
        return torch.tensor(scale * rng.standard_normal(shape))

    s = {"u": field(), "v": field(), "w": field(0.3)}
    e = field().abs()
    for x in list(s.values()) + [e]:
        x[:ks - 1] = NAN
        x[ks + ktot + 1:] = NAN
    t = {n: field(0.1) for n in ("u", "v", "w")}
    ct = 1e-2 * rng.standard_normal((ktot, F.NTG))
    ct[:, [F.T_DZI, F.T_DZHI, F.T_DZHI1, F.T_DZI_M1]] += 1. / (
        0.5 + rng.random((ktot, 4)))
    ct[:, [F.T_RHO, F.T_RHOH, F.T_RHOH1, F.T_RHO_M1]] += 1.
    return s, e, t, torch.tensor(ct)


def plain(s, e, t, ct, ks, rk, coriolis, carry, advec):
    """The plain version with the test's numbers; t updated as it does.
    Returns s* (RK) and the carries."""
    a = ARGS
    can = -0.8 if carry else 0.
    if rk:
        out = F.tend_uvw_plain(s, e, t, ct, ks, a["dxi"], a["dyi"], a["visc"],
                               a["fc"], a["utrans"], a["vtrans"], a["cbdt"],
                               can, coriolis, carry, advec)
        return [out[n] for n in out] + [t[n] for n in t]
    F.tend_uvw_acc_plain(s, e, t, ct, ks, a["dxi"], a["dyi"], a["visc"],
                         a["fc"], a["utrans"], a["vtrans"], coriolis, advec)
    return [t[n] for n in t]


def march(s, e, t, ct, ks, rk, coriolis, carry, advec, chunks, broken=None):
    """uvw_march with the test's numbers into s* whose ghost planes are
    zero and whose interior is NaN until written."""
    a = ARGS
    can = -0.8 if carry else 0.
    stars = []
    for n in ("u", "v", "w"):
        x = torch.full_like(s[n], NAN)
        x[:ks] = 0.
        x[ks + ct.shape[0]:] = 0.
        stars.append(x)
    uvw_march(s["u"], s["v"], s["w"], e, *stars, t["u"], t["v"], t["w"], ct,
              ks, a["dxi"], a["dyi"], a["visc"], a["fc"], a["utrans"],
              a["vtrans"], a["cbdt"], can, coriolis, carry, advec, chunks,
              rk, broken)
    return (stars if rk else []) + [t[n] for n in ("u", "v", "w")]


def rel_err(got, want):
    """The largest over the outputs of max |got - want| / max |want|,
    infinite where got is not finite."""
    return max(float((g - w).abs().max() / w.abs().max())
               if bool(torch.isfinite(g).all()) else float("inf")
               for g, w in zip(got, want))


FORMS = [(True, coriolis, carry, advec) for advec in (True, False)
         for coriolis in (True, False) for carry in (True, False)] + [
    (False, coriolis, False, advec) for advec in (True, False)
    for coriolis in (True, False)]


@pytest.mark.parametrize("rk,coriolis,carry,advec", FORMS)
@pytest.mark.parametrize("ktot", [6, 16])
def test_uvw_march_is_the_plain_version(ktot, rk, coriolis, carry, advec):
    """The emulated march equals the plain version to 1e-12 at every chunk
    count, on partial tiles, with NaN outside the levels the sweep reads."""
    ks = 3
    s, e, t0, ct = inputs(ktot, ktot + 2 * rk + coriolis + 4 * carry, ks)
    want = plain(s, e, {n: x.clone() for n, x in t0.items()}, ct, ks, rk,
                 coriolis, carry, advec)
    assert all(bool(torch.isfinite(x).all()) for x in want)
    # the carries change unless K8/K9 leaves them
    assert (rel_err([t0[n] for n in t0], want[-3:]) > 1e-3) == (
        carry or not rk)
    for chunks in range(1, ktot + 1):
        got = march(s, e, {n: x.clone() for n, x in t0.items()}, ct, ks, rk,
                    coriolis, carry, advec, chunks)
        assert rel_err(got, want) <= 1e-12, chunks
        for g, w in zip(got, want):
            assert torch.equal(g[:ks], w[:ks])
            assert torch.equal(g[ks + ktot:], w[ks + ktot:])


@pytest.mark.parametrize("broken", RULES)
def test_uvw_march_needs_each_edge_rule(broken):
    """Each rule of the march, broken on its own, breaks the result at some
    chunk count in some form (K8/K9 with and without the carry, K18)."""
    ks, ktot = 3, 6
    worst = 0.
    for rk, carry in ((True, True), (True, False), (False, False)):
        s, e, t0, ct = inputs(ktot, 11, ks)
        want = plain(s, e, {n: x.clone() for n, x in t0.items()}, ct, ks, rk,
                     True, carry, True)
        for chunks in range(1, ktot + 1):
            got = march(s, e, {n: x.clone() for n, x in t0.items()}, ct, ks,
                        rk, True, carry, True, chunks, broken)
            worst = max(worst, rel_err(got, want))
    assert worst > 1e-6, broken


class UvwEmulator(Recorder):
    """K8/K9's or K18's stand-in: called with the C entry's arguments, it
    checks what the entry checks and runs uvw_march."""

    def __call__(self, dtype, *args):
        rk = self.name == "tend_uvw"
        if rk:
            (u, v, w, e, us, vs, ws, tu, tv, tw, ct, itot, jtot, ktot, ks,
             dxi, dyi, visc, fc, utrans, vtrans, cbdt, can, coriolis, carry,
             advec, chunks) = args
        else:
            (u, v, w, e, tu, tv, tw, ct, itot, jtot, ktot, ks, dxi, dyi, visc,
             fc, utrans, vtrans, coriolis, advec, chunks) = args
            us = vs = ws = None
            cbdt = can = 0.
            carry = 0
        super().__call__(dtype, chunks)
        assert 1 <= chunks <= ktot and ct.shape == (ktot, F.NTG)
        assert u.shape == (ktot + 2 * ks, jtot, itot)
        uvw_march(u, v, w, e, us, vs, ws, tu, tv, tw, ct, ks, dxi, dyi, visc,
                  fc, utrans, vtrans, cbdt, can, coriolis, carry, advec,
                  chunks, rk)


@pytest.mark.parametrize("advec", [True, False])
def test_uvw_march_through_the_wrappers(advec, monkeypatch):
    """The emulation called with the C entries' arguments through the
    wrappers (the s* they allocate, the carries in place, the Coriolis
    term on) equals the plain versions at every chunk count."""
    m = rico_model(6, "2", itot=12, jtot=10)
    fz, ctx = m.fused, m.ctx
    fz.advec, fz.fold_force, fz.fc = advec, True, 0.3
    s, e, t0, _ = inputs(6, 21, ctx.ks)
    ct = fz.base + 1e-2 * torch.tensor(np.random.default_rng(3)
                                       .standard_normal((6, F.NTG)))
    fz.ct_static = ct
    t_want = {n: x.clone() for n, x in t0.items()}
    want = list(fz.tend_uvw(s, t_want, e, ct, 0.6, -0.8, True).values())
    acc_want = {n: x.clone() for n, x in t0.items()}
    fz.tend_uvw_acc(s, acc_want, e)
    monkeypatch.setattr(F, "on_cpu", lambda x: False)
    for chunks in range(1, 7):
        fz.k_uvw = UvwEmulator("tend_uvw")
        fz.k_uvw_acc = UvwEmulator("tend_uvw_acc")
        t = {n: x.clone() for n, x in t0.items()}
        out = fz.tend_uvw(s, t, e, ct, 0.6, -0.8, True, chunks=chunks)
        assert rel_err(list(out.values()), want) <= 1e-12, chunks
        assert rel_err(list(t.values()), list(t_want.values())) <= 1e-12
        t = {n: x.clone() for n, x in t0.items()}
        fz.tend_uvw_acc(s, t, e, chunks=chunks)
        assert rel_err(list(t.values()), list(acc_want.values())) <= 1e-12
        assert [c[1][0] for c in fz.k_uvw.calls] == [chunks]
        assert [c[1][0] for c in fz.k_uvw_acc.calls] == [chunks]


def test_uvw_chip_cases_on_the_cpu(monkeypatch):
    """chip_smoke.py's K8/K9 and K18 cases on a small rico, on the CPU (both
    calls take the plain version here): the forced counts and the plans',
    each aligned and shifted past a 16-byte boundary, with NaN levels that
    the plain versions never read, and the forced check of a run in the
    path's own form."""
    import chip_smoke
    monkeypatch.setattr(F.FusedGeneric, "uvw_plan",
                        lambda self, dtype, acc=False, chunks=None:
                        kmarch.plan("tend_uvw_acc" if acc else "tend_uvw",
                                    self.ctx.itot, self.ctx.jtot,
                                    self.ctx.ktot, 0, dtype, 396, chunks))
    m = rico_model(6, "2", itot=20, jtot=12)
    counts = chip_smoke.uvw_chunks(m, torch.float64)
    assert counts == sorted({1, 2, 3, 6, kmarch.plan(
        "tend_uvw", 20, 12, 6, 0, torch.float64, 396).chunks})
    cases = chip_smoke.uvw_cases(torch, m, 5, counts)
    assert len(cases) == 2 * 2 * 2 * len(counts)
    assert sorted({c[0] for c in cases}) == ["tend_uvw", "tend_uvw_acc"]
    seen = []
    fz = m.fused
    real, real_acc = fz.tend_uvw, fz.tend_uvw_acc

    def tend_uvw(s, t, e, *a, chunks=None):
        seen.append(("K8/K9", chunks, s["u"].data_ptr() % 16,
                     e.data_ptr() % 16, fz.advec, fz.coriolis))
        return real(s, t, e, *a, chunks=chunks)

    def tend_uvw_acc(s, t, e, chunks=None):
        seen.append(("K18", chunks, s["u"].data_ptr() % 16,
                     e.data_ptr() % 16, fz.advec, fz.fold_force))
        return real_acc(s, t, e, chunks=chunks)

    fz.tend_uvw, fz.tend_uvw_acc = tend_uvw, tend_uvw_acc
    for name, kern, plain_call, kind in cases:
        assert kind == "field"
        got, want = kern(), plain_call()
        assert len(got) == (6 if name == "tend_uvw" else 3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert all(bool(torch.isfinite(g).all()) for g in got)
    assert [c[1] for c in seen] == [c for c in counts for _ in range(8)]
    assert {c[2:4] for c in seen} == {(0, 0), (8, 8)}
    assert {c[4:] for c in seen} == {(True, True), (False, False)}
    # the forced check of a run's path: K8/K9 here, K18 on an unfolded one
    monkeypatch.setattr(chip_smoke, "compare",
                        lambda torch_, name, kern, plain_call, kind, dtype,
                        where: seen.append(name) or 0.)
    del seen[:]
    chip_smoke.check_uvw_forced(torch, m)
    # the path's own form, aligned and shifted, at each forced count
    assert seen == ["tend_uvw"] * 2 * len(counts)
