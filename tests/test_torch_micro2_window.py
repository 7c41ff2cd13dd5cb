"""K11 (``csrc/micro2.cu``, ``micro2_kernel``) on the CPU: the window march
of its design, emulated in torch and held against ``micro2_plain``.

The kernel gives a block 32 columns and the whole column height and
marches it top-down in windows of W levels: (a) the rain properties, fall
speeds and process rates of the window's levels and of the row below it
(clamped to row 0 at the bottom); (b) slopes, CFL numbers and the nsed-deep
flux gather, the rows above the window from a history of NSED_MAX - 1 rows
kept from the windows before; (c) the limiter's running sums S and M and
the flux above, carried from window to window; (d) the flux divergence.
``emulate`` copies that structure with the kernel's buffer rows and edge
rules; ``micro2_plain`` computes the same scheme in closed form.

* the emulation equals ``micro2_plain`` on a stretched 16^2 x 26 rico grid
  at W = 1, 3, 8, 13, 26 and 32 (windows that end exactly at k = 0 and
  ones that do not, a last window shorter than nsed, one window longer
  than the column) and nsed = 3, 4 and 8, in the rainy, strong and
  cloud-free states of tests/test_torch_moist.py::_micro_state and in a
  deep state (rain at every level, drops crossing up to 3.5 cells at the
  top), float64: qt's and thl's tendencies bit for bit (the same operations
  in the same order); qr's, nr's and rr_bot to 1e-12 of their maximum (the
  gather takes rho dz as one factor and the divergence multiplies by 1/rho,
  as the kernel does, where the plain version divides);
* each edge rule is needed: the emulation with one rule broken (the fall
  speed above the top taken as the top row's, qr and nr above the top as
  0, the row below row 0 as dry, nr's CFL advanced with dzi one row up as
  qr's) disagrees with ``micro2_plain`` in the deep state.  The last rule
  of the gather, dzi = 0 beyond the top row, only sets the CFL of a row
  above the top, whose share of the flux is 0 either way;
* the Python copies of the window, the block shape and the shared-memory
  formula are the constants of ``micro2.cu``, and a block's shared memory
  leaves room for the blocks an SM its launch bounds ask for, in float32
  and float64.
"""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import rico_ini, rico_state
from microhh_torch import constants as cst
from microhh_torch.cases import MemoryDataset, rico_profiles
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.ops import microphys as MP
from microhh_torch.ops.thermo_moist import esat_liq, qsat_liq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KT = 26
HIST = MP.NSED_MAX - 1
RULES = ("w_above_top", "qr_above_top", "below_bottom", "nr_dzi_at_out")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rico():
    """A 16^2 x 26 rico model on geometrically stretched levels (dz from
    69 to 286 m) with the seeded rainy state of chip_smoke.rico_state."""
    dz = 1.06 ** np.arange(KT)
    dz *= 4000. / dz.sum()
    zh = np.concatenate([[0.], np.cumsum(dz)])
    z = 0.5 * (zh[1:] + zh[:-1])
    m = Model(Ini(rico_ini(16, KT)), "run", "rico", dtype=torch.float64,
              device="cpu",
              input_nc=MemoryDataset({"z": z}, {"init": rico_profiles(z)}))
    m.finish_setup()
    m.build_step()
    s, sfc = m.as_device_state(rico_state(m, seed=5))
    s = m.boundary.set_ghost_cells(m.ctx, s, sfc)
    return m, s


def micro_case(m, s, case):
    """The fields, table and dt of a state: the three of
    test_torch_moist._micro_state, and 'deep' (rain in every level, dt so
    that W_MAX crosses 3.5 of the top level's cells)."""
    ctx = m.ctx
    ks, ke = ctx.ks, ctx.ke
    s = dict(s)
    dz = ctx.dz[ks:ke]
    dt = 2.
    if case == "strong":
        s["qr"] = 50. * s["qr"]
        dt = 2.5 * float(dz.min()) / 9.65
    elif case == "cloudfree":
        s["qt"] = 0.5 * s["qt"]
    elif case == "deep":
        rng = np.random.RandomState(11)
        sh = (ctx.ktot, ctx.jtot, ctx.itot)
        qr = torch.tensor(10. ** rng.uniform(-5, -3, sh))
        s["qr"] = s["qr"].clone()
        s["nr"] = s["nr"].clone()
        s["qr"][ks:ke] = qr
        s["nr"][ks:ke] = qr * torch.tensor(10. ** rng.uniform(6.5, 7.5, sh))
        dt = 3.5 * float(dz.max()) / 9.65
    pref, exnref, _, _ = m.thermo._p_profiles(ctx, {})
    ql = m.thermo.get_ql(ctx, s)
    fields = [s[n][ks:ke] for n in ("qr", "nr", "qt", "thl")] + [ql]
    return fields, m.micro.table(ctx, pref, exnref), dt


def plain(m, fields, cc, dt, nsed):
    def col(slot):
        return cc[:, slot][:, None, None]
    return MP.micro2_plain(*fields, col(MP.M_RHO), col(MP.M_DZ),
                           col(MP.M_DZI), col(MP.M_P), col(MP.M_EXN),
                           m.micro.Nc0, dt, nsed)


def emulate(qr, nr, qt, thl, ql, cc, Nc0, dt, nsed, W, broken=None):
    """K11's window march in torch: (qrt, nrt, qtt, thlt, rr_bot) as
    micro2_plain returns them.  Buffer row br of a window whose top level
    is ktop holds level ktop + HIST - br (the window's row r at HIST + r,
    the row below at HIST + nrows); `broken` breaks one edge rule."""
    kt = qr.shape[0]
    zero = torch.zeros_like(qr[0])
    out = [torch.zeros_like(qr) for _ in range(4)]
    rr_bot = None
    hist_a = torch.zeros((2, HIST) + qr.shape[1:], dtype=qr.dtype)
    hist_sl, hist_c = hist_a.clone(), hist_a.clone()
    hist_w = torch.zeros((2,) + qr.shape[1:], dtype=qr.dtype)
    S = torch.zeros_like(hist_w)
    M = torch.full_like(hist_w, float("inf"))
    flux_above = torch.zeros_like(hist_w)
    nwin = -(-kt // W)
    for win in range(nwin):
        ktop = kt - 1 - win * W
        nrows = min(W, ktop + 1)
        r = torch.arange(nrows)
        k = ktop - r
        kb = max(ktop - nrows, 0)
        if broken == "below_bottom" and ktop - nrows < 0:
            kb = None
        levels = torch.arange(ktop + HIST, ktop - nrows - 1, -1)
        tb = cc[levels.clamp(0, kt - 1)]          # (HIST + nrows + 1, N_M)

        def t(slot, rows):
            return tb[rows, slot][:, None, None]

        # ---- (a) rain properties, fall speeds, process rates ----
        rows = HIST + torch.arange(nrows + 1)
        a_w = torch.stack([torch.cat([x[k], x[[kb]] if kb is not None
                                      else zero[None]]) for x in (qr, nr)])
        rho, rho_n = t(MP.M_RHO, rows), t(MP.M_RHON, rows)
        mr, dr, mur, lamr = MP.calc_rain_props(a_w[0], a_w[1], rho)
        p4, p1 = MP._sedi_pow_pair(mur, lamr)
        has_qr = a_w[0] > MP.QR_MIN
        w_w = torch.stack([
            torch.where(has_qr, torch.clamp(rho_n * MP.A_R - MP.B_R * p, 0.1,
                                            MP.W_MAX), 0.) for p in (p4, p1)])
        pq, pn, qtt, thlt = process_rates(
            a_w[0, :nrows], a_w[1, :nrows], qt[k], thl[k], ql[k],
            mr[:nrows], dr[:nrows], lamr[:nrows], t(MP.M_RHO, rows[:-1]),
            t(MP.M_P, rows[:-1]), t(MP.M_EXN, rows[:-1]), Nc0)
        out[2][k] += qtt
        out[3][k] += thlt
        a = torch.cat([hist_a, a_w], 1)             # buffer rows
        w = torch.cat([hist_w[:, None], w_w], 1)    # row above, window, below

        # ---- (b) slopes and CFL numbers of the window's levels ----
        br = HIST + r
        a_c, a_m, a_p = a[:, br], a[:, br + 1], a[:, br - 1].clone()
        w_c, w_m, w_p = w[:, r + 1], w[:, r + 2], w[:, r].clone()
        if win == 0:   # above the top: qr, nr clamped, the fall speed 0
            a_p[:, 0] = 0. if broken == "qr_above_top" else a_c[:, 0]
            w_p[:, 0] = w_c[:, 0] if broken == "w_above_top" else 0.
        dzi = t(MP.M_DZI, br)
        sl = torch.cat([hist_sl, MP._minmod(a_c - a_m, a_p - a_c)], 1)
        c = torch.cat([hist_c, 0.25 * (w_m + 2. * w_c + w_p) * dzi * dt], 1)

        # ---- (b) the nsed-deep gather of rows k .. k+nsed-1 ----
        ftot = []
        for sp in range(2):
            dzi_at_out = (sp == 1) != (broken == "nr_dzi_at_out")
            ccm = torch.clamp(c[sp, br], max=1.)
            dzz = torch.zeros_like(ccm)
            f = torch.zeros_like(ccm)
            for m in range(nsed):
                valid = (k + m <= kt - 1)[:, None, None]
                bm = br - m
                a_m_ = torch.where(valid, a[sp, bm], 0.)
                sl_m = torch.where(valid, sl[sp, bm], 0.)
                rhodz_m = torch.where(valid, t(MP.M_RHODZ, bm), 0.)
                dz_m = torch.where(valid, t(MP.M_DZ, bm), 0.)
                active = ccm > 0.
                f = torch.where(active, f + rhodz_m * (
                    a_m_ + 0.5 * sl_m * (1. - ccm)) * ccm, f)
                dzz = torch.where(active, dzz + dz_m, dzz)
                if m + 1 < nsed:
                    if dzi_at_out:
                        dzi_nxt = dzi
                    else:
                        above = (k + m + 1 <= kt - 1)[:, None, None]
                        dzi_nxt = torch.where(above, t(MP.M_DZI, bm - 1), 0.)
                    c_m = torch.where(valid, c[sp, bm], 0.)
                    ccm = torch.where(active, torch.clamp(
                        c_m - dzz * dzi_nxt, max=1.), 0.)
            ftot.append(f)

        # ---- (c) the limiter's running sums, level by level ----
        flux = torch.zeros((2, nrows) + qr.shape[1:], dtype=qr.dtype)
        above = flux_above
        for row in range(nrows):
            mass = tb[HIST + row, MP.M_RHODZ] * a[:, HIST + row]
            S = S + mass
            M = torch.minimum(M, torch.stack([f[row] for f in ftot]) - S)
            ft = S + torch.clamp(M, max=0.)
            flux_above = -ft / dt
            flux[:, row] = flux_above

        # ---- (d) the flux divergence ----
        f_up = torch.cat([above[:, None], flux[:, :-1]], 1)
        sed = -(f_up - flux) * t(MP.M_RRHO, br) * dzi
        out[0][k] += pq + sed[0]
        out[1][k] += pn + sed[1]
        if ktop - nrows < 0:
            rr_bot = -flux[0, -1]

        # ---- the rows above the next window ----
        hist_a = a[:, :HIST + nrows][:, -HIST:]
        hist_sl, hist_c = sl[:, -HIST:], c[:, -HIST:]
        hist_w = w[:, nrows]
    return out + [rr_bot]


def process_rates(qr, nr, qt, thl, ql, mr, dr, lamr, rho, p, exn, Nc0):
    """The conversion rates of micro2_plain, the same expressions: the
    process parts of qr's and nr's tendencies and qt's and thl's."""
    qrt = torch.zeros_like(qr)
    nrt = torch.zeros_like(qr)
    qtt = torch.zeros_like(qr)
    thlt = torch.zeros_like(qr)
    lv_cpe = cst.Lv / (cst.cp * exn)
    nu_c, k_cc = 1., 9.44e9
    kccxs = k_cc / (20. * MP.X_STAR) * (nu_c + 2.) * (nu_c + 4.) / (nu_c + 1.) ** 2
    has_ql = ql > MP.QL_MIN
    xc = rho * ql / Nc0
    tau = 1. - ql / (ql + qr + cst.dsmall)
    phi_au = 600. * tau ** 0.68 * (1. - tau ** 0.68) ** 3
    au = MP.RHO_0 * kccxs * ql ** 2 * xc ** 2 * (1. + phi_au / (1. - tau) ** 2)
    au = torch.where(has_ql, au, 0.)
    qrt += au
    nrt += au * rho / MP.X_STAR
    qtt -= au
    thlt += lv_cpe * au
    has_both = has_ql & (qr > MP.QR_MIN)
    tau_ac = 1. - ql / torch.clamp(ql + qr, min=cst.dsmall)
    phi_ac = (tau_ac / (tau_ac + 5e-5)) ** 4
    ac = 5.25 * ql * qr * phi_ac * torch.sqrt(MP.RHO_0 / rho)
    ac = torch.where(has_both, ac, 0.)
    qrt += ac
    qtt -= ac
    thlt += lv_cpe * ac
    has_qr = qr > MP.QR_MIN
    T = thl * exn + cst.Lv * ql / (cst.cp * exn)
    Glv = 1. / (cst.Rv * T / (esat_liq(T) * MP.D_V)
                + (cst.Lv / (MP.K_T * T)) * (cst.Lv / (cst.Rv * T) - 1.))
    S = (qt - ql) / qsat_liq(p, T) - 1.
    ev = 2. * np.pi * dr * Glv * S * nr / rho
    ev = torch.where(has_qr, ev, 0.)
    qrt += ev
    nrt += 1.0 * ev * rho / mr
    qtt -= ev
    thlt += lv_cpe * ev
    k_rr, kappa_rr, D_eq = 7.12, 60.7, 0.9e-3
    sc = (-k_rr * nr * qr * rho
          / (1. + kappa_rr / lamr * MP.PIRHOW ** (1. / 3.)) ** 9
          * torch.sqrt(MP.RHO_0 / rho))
    sc = torch.where(has_qr, sc, 0.)
    dDr = dr - D_eq
    phi_br = torch.where(dr <= D_eq, 1.0e3 * dDr, 2. * torch.exp(2.3e3 * dDr) - 1.)
    br = torch.where(has_qr & (dr > 0.35e-3), -(phi_br + 1.) * sc, 0.)
    nrt += sc + br
    return qrt, nrt, qtt, thlt


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("case", ["rainy", "strong", "cloudfree", "deep"])
@pytest.mark.parametrize("nsed", [3, 4, 8])
@pytest.mark.parametrize("W", [1, 3, 8, 13, KT, 32])
def test_window_march_matches_plain(rico, W, nsed, case):
    m, s = rico
    fields, cc, dt = micro_case(m, s, case)
    want = plain(m, fields, cc, dt, nsed)
    got = emulate(*fields, cc, m.micro.Nc0, dt, nsed, W)
    names = ("qr", "nr", "qt", "thl", "rr_bot")
    for name, g, w in zip(names, got, want):
        if name in ("qt", "thl"):
            assert torch.equal(g, w), name
        else:
            assert rel(g, w) <= 1e-12, name
    assert float(want[0].abs().max()) > 0.


@pytest.mark.parametrize("rule", RULES)
def test_each_edge_rule_is_needed(rico, rule):
    m, s = rico
    fields, cc, dt = micro_case(m, s, "deep")
    want = plain(m, fields, cc, dt, 8)
    got = emulate(*fields, cc, m.micro.Nc0, dt, 8, 8, broken=rule)
    assert max(rel(g, w) for g, w in zip(got, want)) > 1e-9


def source():
    with open(os.path.join(ROOT, "microhh_torch", "csrc", "micro2.cu")) as f:
        return f.read()


def test_python_constants_are_the_sources():
    src = source()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                          src)}
    assert (c["M2_W"], c["M2_C"], c["M2_NT"], c["NSED_MAX"]) == (
        MP.M2_W, MP.M2_C, MP.M2_NT, MP.NSED_MAX)
    assert "constexpr int M2_HIST = NSED_MAX - 1;" in src
    assert "constexpr int M2_H = M2_HIST + M2_W + 1;" in src
    assert "constexpr int M2_WARPS = M2_NT / M2_C;" in src
    # the per-level table: the M_* enum of micro2.cu and ops/microphys.py
    enum = re.search(r"enum \{\s*(M_RHO[^}]*)\}", src).group(1)
    cols = [x.strip() for x in enum.split(",")]
    assert cols[-1] == "NM" and len(cols) - 1 == MP.N_M
    assert [getattr(MP, n) for n in cols[:-1]] == list(range(MP.N_M))
    # the shared-memory struct that micro2_smem counts
    body = re.search(r"struct M2Smem \{(.*?)\};", src, re.S).group(1)
    arrays = [re.sub(r"\s+", "", x) for x in
              re.findall(r"T (\w+(?:\[[^\]]+\])+);", body)]
    assert arrays == ["a[2][M2_H][M2_C]", "w[2][M2_W+2][M2_C]",
                      "sl[2][M2_H-1][M2_C]", "c[2][M2_H-1][M2_C]",
                      "f[2][M2_W][M2_C]", "p[2][M2_W][M2_C]", "fa[2][M2_C]",
                      "tb[2][NM][M2_H]"]
    assert "sizeof(M2Smem<T>)" in src
    # the launch bounds the blocks an SM below assume
    assert "__launch_bounds__(M2_NT, sizeof(T) == 4 ? 6 : 3)" in src


@pytest.mark.parametrize("dtype,blocks", [(torch.float32, 6),
                                          (torch.float64, 3)])
def test_shared_memory_fits(dtype, blocks):
    """A block's shared memory at NSED_MAX = 8 fits the 227 KB a block may
    take, and the blocks an SM the launch bounds ask for fit the SM's 228 KB
    with the 1 KB the card reserves a block."""
    smem = MP.micro2_smem(dtype)
    assert MP.NSED_MAX == 8
    assert smem <= 227 * 1024
    assert blocks * (smem + 1024) <= 228 * 1024
    assert smem == (32896 if dtype == torch.float32 else 65792)
