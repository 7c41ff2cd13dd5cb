"""K22 (``csrc/tend_rk_fold.cu``, ``tend_rk_fold_kernel``) on the CPU: the
chunked k-march of its design, emulated in torch and held against
``tend_rk_fold_plain`` (which tests/test_torch_fold.py holds against the
TPU kernel in interpret mode).

A launch splits the levels into chunks (``kmarch.chunk_bounds``); the
blocks of a chunk [k0, k1) read the fields' planes k0-2 .. k1+1 (clamped to
the interior, w's to [0, ktot]), the table rows of those levels, the eddy
viscosity e_in at k0-1 .. k1 when it is given, the MOST surface row
wherever e(0) is needed, the carries of u, v and th at the chunk's levels
and w's at k0 .. k1 (w*(k1) enters rhs(k1-1)), and write the chunk's levels
only.  ``emulate`` runs the plain version once a chunk on inputs that are
NaN outside what the chunk may read, top chunk first (so that a carry
updated in place would be seen overwritten by the chunk above), and
stitches the chunks' levels together.

* the emulation equals ``tend_rk_fold_plain`` bit for bit in float64 at
  every chunk count 1..ktot for ktot 6 and 16, on a stretched grid with
  random tables, first x carry, the surface row given or not, e_in given,
  without th, and with the Coriolis fold;
* each of the kernel's chunk-edge rules is needed: the emulation with one
  rule broken (planes from k0-1 only, so no e(k0-1); planes up to k1 only,
  so no e(k1) nor w*(k1); e_in from k0 only; the surface row only for the
  chunk at the wall, so a chunk starting at k0 = 1 computes e(0) instead;
  w*(k1) taken as 0 below every chunk top, as at the domain's; w's carry
  read from the buffer the chunks write, as u's and v's must not be)
  disagrees with the plain version.
"""

import numpy as np
import pytest
import torch

from microhh_torch.ops import fused as F
from microhh_torch.ops import kmarch

RULES = ("planes_below", "planes_above", "e_in_below", "se_at_wall_only",
         "top_is_wall", "w_carry_in_place")
KS = 1
ARGS = dict(dxi=0.7, dyi=1.3, visc=1e-3, svisc=2e-3, tPr=0.33, cbdt=0.6,
            dti=1.7)


def inputs(ktot, rng, thermo=True):
    """Fields, carries, tables on a random stretched grid (ks = 1, kcells =
    ktot + 2), the surface row and an interior eddy viscosity."""
    shape = (ktot + 2 * KS, 10, 12)

    def field(scale=1., off=0.):
        return torch.tensor(off + scale * rng.standard_normal(shape))

    s = {"u": field(), "v": field(), "w": field(0.3)}
    t = {"u": field(0.1), "v": field(0.1), "w": field(0.1)}
    if thermo:
        s["th"] = field(1., 300.)
        t["th"] = field(0.1)
    ct = 1e-2 * rng.standard_normal((ktot, F.NTG))
    ct[:, [F.T_DZI, F.T_DZHI, F.T_DZHI1, F.T_DZI_M1]] += 1. / (
        0.5 + rng.random((ktot, 4)))
    ct[:, [F.T_RHO, F.T_RHOH, F.T_RHOH1, F.T_RHO_M1]] += 1.
    ct[:, F.T_THREFH] += 300.
    ce = 1e-2 * rng.standard_normal((ktot, F.NE))
    ce[:, [F.E_DZI, F.E_DZHI, F.E_DZHI1]] += 1. / (0.5 + rng.random((ktot, 3)))
    ce[:, F.E_MLEN2] = 0.5 + rng.random(ktot)
    ce[:, F.E_THREF] += 300.
    se_row = torch.tensor(np.abs(rng.standard_normal(shape[1:])))
    e = torch.tensor(np.abs(rng.standard_normal((ktot,) + shape[1:])))
    return s, t, torch.tensor(ct), torch.tensor(ce), se_row, e


def plain(s, t, ct, ce, first, carry, se_row, e, thermo, coriolis):
    """tend_rk_fold_plain with the test's numbers; t updated as it does."""
    a = ARGS
    can = -0.8 if carry else 0.
    return F.tend_rk_fold_plain(
        s, t, ct, ce, KS, a["dxi"], a["dyi"], a["visc"], a["svisc"], a["tPr"],
        a["cbdt"], can, a["dti"], first, carry, se_row, e, 0.3, 0.2, -0.1,
        coriolis, thermo)


def window(x, lo, hi, off=KS):
    """x with everything outside the levels [lo, hi] (interior numbering,
    planes off + lo .. off + hi) set to NaN."""
    y = torch.full_like(x, float("nan"))
    y[off + lo:off + hi + 1] = x[off + lo:off + hi + 1]
    return y


def emulate(s, t, ct, ce, first, carry, chunks, se_row, e, thermo, coriolis,
            broken=None):
    """The kernel's chunked march: returns (s*, e, rhs) and leaves the
    carries in t as the wrapper does (u's, v's and w's in new tensors when
    they are read and written)."""
    kt = ct.shape[0]
    names = list(s)
    split = carry and not first
    t_in = dict(t)
    if split:
        for n in ("u", "v") + (() if broken == "w_carry_in_place" else ("w",)):
            t[n] = t[n].clone()
    s_star = {n: torch.zeros_like(s[n]) for n in names}
    e_out = torch.zeros((kt,) + s["u"].shape[1:], dtype=s["u"].dtype)
    rhs = torch.zeros_like(e_out)
    for k0, k1 in reversed(kmarch.chunk_bounds(chunks, kt)):
        lo = k0 - (1 if broken == "planes_below" else 2)
        hi = k1 + (0 if broken == "planes_above" else 1)
        lo, hi_c = max(lo, 0), min(hi, kt - 1)
        seen = {n: window(s[n], lo, min(hi, kt) if n == "w" else hi_c)
                for n in names}
        rows = window(ct, lo, hi_c, 0)
        erows = window(ce, lo, hi_c, 0)
        e_c = None
        if e is not None:
            e_lo = k0 if broken == "e_in_below" else k0 - 1
            e_c = window(e, max(e_lo, 0), min(k1, kt - 1), 0)
        se_c = se_row
        if broken == "se_at_wall_only" and k0 > 0:
            se_c = None
        # the carries the chunk reads, from the buffers the wrapper gives it
        t_c = {n: window(t_in[n] if split and n != "th" else t[n], k0,
                         min(k1, kt - 1) if n == "w" else k1 - 1)
               for n in names}
        out, ev, rh = plain(seen, t_c, rows, erows, first, carry, se_c, e_c,
                            thermo, coriolis)
        if broken == "top_is_wall" and k1 < kt:
            rh[k1 - 1] -= (ARGS["dti"] * ct[k1 - 1, F.T_RHOH1]
                           * out["w"][KS + k1] * ct[k1 - 1, F.T_DZI])
        lev = slice(KS + k0, KS + k1)
        for n in names:
            s_star[n][lev] = out[n][lev]
            if carry:
                t[n][lev] = t_c[n][lev]
        e_out[k0:k1] = ev[k0:k1]
        rhs[k0:k1] = rh[k0:k1]
    return s_star, e_out, rhs


def results(out, t, names):
    s_star, e, rhs = out
    return ([s_star[n][KS:-KS] for n in names]
            + [t[n][KS:-KS] for n in names] + [e, rhs])


CASES = {
    "first": dict(first=True, carry=True),
    "carry": dict(first=False, carry=True),
    "last_substep": dict(first=False, carry=False),
    "no_surface_row": dict(first=False, carry=True, se=False),
    "e_in": dict(first=False, carry=True, e_in=True),
    "no_th": dict(first=False, carry=True, thermo=False),
    "coriolis": dict(first=False, carry=True, coriolis=True),
}


def run_case(ktot, name, chunks_list, broken=None, seed=None):
    c = dict(first=False, carry=True, se=True, e_in=False, thermo=True,
             coriolis=False)
    c.update(CASES[name])
    rng = np.random.default_rng(ktot if seed is None else seed)
    s, t0, ct, ce, se_row, e = inputs(ktot, rng, c["thermo"])
    se_row = se_row if c["se"] and not c["e_in"] else None
    e = e if c["e_in"] else None
    names = list(s)
    t = {n: x.clone() for n, x in t0.items()}
    want = results(plain(s, t, ct, ce, c["first"], c["carry"], se_row, e,
                         c["thermo"], c["coriolis"]), t, names)
    for chunks in chunks_list:
        t = {n: x.clone() for n, x in t0.items()}
        got = results(emulate(s, t, ct, ce, c["first"], c["carry"], chunks,
                              se_row, e, c["thermo"], c["coriolis"], broken),
                      t, names)
        yield chunks, got, want


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("ktot", [6, 16])
def test_chunked_march_is_the_plain_version(ktot, name):
    for chunks, got, want in run_case(ktot, name, range(1, ktot + 1)):
        for g, w in zip(got, want):
            assert torch.equal(g, w), chunks


# the case and chunk count that expose each rule: a chunk starting at
# k0 = 1 (se_at_wall_only) needs ktot chunks; the rest two or more
RULE_CASE = {"planes_below": ("carry", 3), "planes_above": ("carry", 3),
             "e_in_below": ("e_in", 3), "se_at_wall_only": ("carry", 6),
             "top_is_wall": ("carry", 2), "w_carry_in_place": ("carry", 2)}


@pytest.mark.parametrize("rule", RULES)
def test_each_edge_rule_is_needed(rule):
    name, chunks = RULE_CASE[rule]
    for _, got, want in run_case(6, name, [chunks], broken=rule):
        assert not all(torch.equal(g, w) for g, w in zip(got, want))
    # and the same chunks with every rule kept agree
    for _, got, want in run_case(6, name, [chunks]):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
