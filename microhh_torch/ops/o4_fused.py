"""Hand-kernel form of the 4th-order advection + diffusion pair (counterpart
of ``microhh_tpu/ops/o4_pallas.py``).

The op path (ops/advec_4.py or ops/advec_4m.py, then ops/diff_4.py) builds
every interpolation, flux and divergence as a separate field-sized tensor.
The two kernels here add both ops' interior tendencies into the RK carry in
one pass per field group:

* K16 ``O4Fused.momentum`` - tu, tv, tw += advection of (u, v, w with
  conservation-type ghosts) + visc * diffusion of (u, v, w with plain
  ghosts) (``csrc/o4.cu``);
* K17 ``O4Fused.scalars`` - every scalar's carry += its advection + its
  diffusion, with u, v and w read once for all of them.

The vertical ladders are per-level rows of six tap weights
(``build_o4_tables``, a numpy copy of the JAX package's, bit for bit): the
ci interior rows and the bi/ti wall rows of the interpolations, the cg/bg/tg
gradient rows with dzhi4 or dzi4 folded in.  K17 takes them combined into
seven weights on the column of planes k-3..k+3 per level
(``build_k17_rows``): per unit w at each of the four half levels k-1..k+2
for the advection (in 4m with the mirrored wall fluxes), and for the
diffusion.  The fields are ghost-filled to three levels, so no plane index
is clamped.  A 2-D run (jtot = 1) takes each kernel's 2-D form, an
instance of its own (``O4Fused``).  On a CPU tensor the wrappers run the
plain versions: the two ops, one after the other.
"""

import ctypes

import numpy as np
import torch

from .. import fd
from ..kernels import Kernel, check, on_cpu
from . import kmarch
from .advec_4 import Advec4
from .advec_4m import Advec4m
from .diff_4 import Diff4

# table columns, shared with csrc/o4.cu: cell-family interpolation and
# gradient rows (6 each), w-family interpolation and gradient rows (6 each),
# then per-level factors
TXA, TG, TWC, TGW = 0, 6, 12, 18
DZI4, DZHI4, WMASK, NC = 24, 25, 26, 27

SCHEME_ID = {"4": 0, "4m": 1}

# K17's per-level rows (csrc/o4.cu K17_ZA, K17_ZD, K17_NCP): at ZA + 8 e + m
# the vertical advection's weight on column value m (plane k-3+m) per unit
# w at half level k-1+e, at ZD + m the vertical diffusion's
ZA, ZD, NZ = 0, 32, kmarch.K17_NCP


def build_o4_tables(ks, ke, dzi4, dzhi4):
    """The per-level six-tap weight rows as float64 (ktot + 3, NC).

    Cell family (outputs at the centres k): row r holds the half level
    hk = r - 1 (r = 0..kt+2); taps d = -3..+2 on q[hk + d].
      - interpolation rows (TXA): ci in the interior (advec_4.cxx phi_mid),
        bi at hk = -1, ti at hk = kt + 1;
      - gradient rows (TG): cg * dzhi4 in the interior, bg and tg * dzhi4 at
        the sub- and above-wall rows (diff_4.cxx diff_c).
    w family (outputs at the half levels k): row r holds the centre
    c = r - 1 (r = 0..kt+1); taps d = -2..+3 on w[c + d].
      - interpolation rows (TWC): ci in the interior, bi at c = -1, ti at
        c = kt (advec_4.cxx:327-331, 380-384);
      - gradient rows (TGW): cg * dzi4 in the interior, bg and tg * dzi4 at
        the edge rows (diff_4.cxx diff_w).
    """
    kt = ke - ks
    dzi4 = np.asarray(dzi4, dtype=np.float64)
    dzhi4 = np.asarray(dzhi4, dtype=np.float64)
    cc = np.zeros((kt + 3, NC), dtype=np.float64)

    ci = (fd.ci0, fd.ci1, fd.ci2, fd.ci3)
    bi = (fd.bi0, fd.bi1, fd.bi2, fd.bi3)
    ti = (fd.ti0, fd.ti1, fd.ti2, fd.ti3)
    cg = (fd.cg0, fd.cg1, fd.cg2, fd.cg3)
    bg = (fd.bg0, fd.bg1, fd.bg2, fd.bg3)
    tg = (fd.tg0, fd.tg1, fd.tg2, fd.tg3)

    # cell family: taps d = -3..2 -> column d + 3
    for r in range(kt + 3):
        hk = r - 1
        if hk == -1:
            w4, d0 = bi, -1
            g4, gs = bg, dzhi4[ks - 1]
        elif hk == kt + 1:
            w4, d0 = ti, -3
            g4, gs = tg, dzhi4[ke + 1]
        else:
            w4, d0 = ci, -2
            g4, gs = cg, dzhi4[ks + hk]
        for i in range(4):
            cc[r, TXA + (d0 + i) + 3] = w4[i]
            cc[r, TG + (d0 + i) + 3] = g4[i] * gs

    # w family: taps d = -2..3 -> column d + 2
    for r in range(kt + 2):
        c = r - 1
        if c == -1:
            w4, d0 = bi, 0
            g4, gs = bg, dzi4[ks - 1]
        elif c == kt:
            w4, d0 = ti, -2
            g4, gs = tg, dzi4[ke]
        else:
            w4, d0 = ci, -1
            g4, gs = cg, dzi4[ks + c]
        for i in range(4):
            cc[r, TWC + (d0 + i) + 2] = w4[i]
            cc[r, TGW + (d0 + i) + 2] = g4[i] * gs

    for k in range(kt):
        cc[k, DZI4] = dzi4[ks + k]
        cc[k, DZHI4] = dzhi4[ks + k]
        cc[k, WMASK] = 0. if k == 0 else 1.
    return cc


def build_k17_rows(cc, scheme):
    """K17's per-level rows as float64 (ktot, NZ) from the table cc of
    ``build_o4_tables``: row k holds the seven weights of the column
    q[0..6] = planes k-3..k+3 that give the vertical part at level k,

        advection = sum_m (sum_e w_e A[k, e, m]) q[m],
        diffusion = svisc * sum_m D[k, m] q[m],

    w_e the velocity at half level k-1+e.  Scheme 4: A = -cg_e dzi4 times
    the interpolation row of half level k-1+e, D = dzi4 sum_e cg_e times its
    gradient row (advec_4.cxx advec_s, diff_4.cxx diff_c).  Scheme 4m: the
    fluxes w_e (q_a + q_b) / 2 of the two-point means, with the mirrored
    negative outer flux at the global levels 0 and ktot - 1 (advec_4m.cxx
    advec_s)."""
    kt = cc.shape[0] - 3
    cg = (fd.cg0, fd.cg1, fd.cg2, fd.cg3)
    z = np.zeros((kt, NZ), dtype=np.float64)
    for k in range(kt):
        dzi4 = cc[k, DZI4]
        for e in range(4):
            for m in range(7):
                j = m - e + 1
                if 0 <= j <= 5:
                    g = cg[e] * dzi4
                    if scheme == "4":
                        z[k, ZA + 8 * e + m] -= g * cc[k + e, TXA + j]
                    z[k, ZD + m] += g * cc[k + e, TG + j]
        if scheme == "4m":
            # -grad4 of the fluxes a, b, c, d: (half level of w, column
            # taps of the two-point mean, sign); at the bottom level a is
            # -w2 (q2 + q5) / 2, at the top d is -w1 (q1 + q4) / 2
            flux = [(0, (0, 3), 1.), (1, (2, 3), 1.), (2, (3, 4), 1.),
                    (3, (3, 6), 1.)]
            if k == 0:
                flux[0] = (2, (2, 5), -1.)
            if k == kt - 1:
                flux[3] = (1, (1, 4), -1.)
            for g, (e, taps, sign) in zip(cg, flux):
                for m in taps:
                    z[k, ZA + 8 * e + m] -= 0.5 * sign * g * dzi4
    return z


def max_scalars(dtype):
    """The most scalars one K17 launch takes: its scalar count is a template
    parameter up to K17_MAXS, and their planes must fit one block's shared
    memory (csrc/o4.cu k17_smem)."""
    return max(S for S in range(1, kmarch.K17_MAXS + 1)
               if kmarch.k17_smem(S, dtype) <= kmarch.SMEM_MAX)


class O4Fused:
    """K16 and K17 for one advection scheme, diffusion and grid.

    ``exec(ctx, s_cons, s, t, aux)`` adds the interior tendencies of
    ``advec.exec(s_cons)`` and ``diff.exec(s)`` into the carry t in place.
    A 2-D run (jtot = 1) takes the kernels' 2-D form, the JAX op path's
    with ``dim3`` false (the JAX package runs it there, its Pallas kernels
    carrying the 3-D form only): no y flux and no y part of the Laplacian,
    no diffusion of v at all (``Diff4.exec`` leaves v out), v still
    advected.  That form is its own instance of each kernel, counted under
    its own name (``o4_mom_2d``, ``o4_scalars_2d``, on the entries
    ``o4_mom`` and ``o4_scalars``, which pick it from jtot); its info
    entries take the scheme plus 2."""

    def __init__(self, advec, diff, ctx):
        if not (type(advec) in (Advec4, Advec4m) and type(diff) is Diff4):
            raise TypeError("O4Fused takes advec 4 or 4m with diff 4")
        self.advec = advec
        self.diff = diff
        self.scheme = advec.scheme
        self.ctx = ctx
        self.dim3 = ctx.jtot > 1
        cc = build_o4_tables(ctx.ks, ctx.ke, ctx.np_dzi4, ctx.np_dzhi4)
        self.cc = ctx.tensor(cc)
        self.cz = ctx.tensor(build_k17_rows(cc, self.scheme))
        form = "" if self.dim3 else "_2d"
        self.k_mom = Kernel("o4_mom" + form, "microhh_torch/csrc/o4.cu",
                            "microhh_tpu/ops/o4_pallas.py:408",
                            entry="o4_mom")
        self.k_scal = Kernel("o4_scalars" + form, "microhh_torch/csrc/o4.cu",
                             "microhh_tpu/ops/o4_pallas.py:435",
                             entry="o4_scalars")

    def info_scheme(self):
        """The scheme as the info entries take it: SCHEME_ID, plus 2 in
        the 2-D form."""
        return SCHEME_ID[self.scheme] + (0 if self.dim3 else 2)

    def momentum_plain(self, u, v, wc, wd, tu, tv, tw):
        """K16 in plain torch: the two ops' momentum parts, in place."""
        ctx = self.ctx
        ks, ke = ctx.ks, ctx.ke
        for carry, lo, adv, dif in zip(
                (tu, tv, tw), (ks, ks, ks + 1),
                self.advec.momentum(ctx, u, v, wc),
                self.diff.momentum(ctx, u, v, wd)):
            carry[lo:ke] += adv
            # a 2-D run does not diffuse v (Diff4.momentum gives None)
            if dif is not None:
                carry[lo:ke] += dif

    def scalars_plain(self, u, v, wc, names, fields, carries):
        """K17 in plain torch, in place."""
        ctx = self.ctx
        for name, a, ta in zip(names, fields, carries):
            ta[ctx.ks:ctx.ke] += self.advec.scalar(ctx, a, u, v, wc)
            ta[ctx.ks:ctx.ke] += self.diff.scalar(ctx, a, name)

    def plan(self, dtype, chunks=None):
        """The k-march of K16 (ops/kmarch.py), the chunk count chosen from
        the card's resident blocks unless given."""
        ctx = self.ctx
        info = self.k_mom.info(dtype, self.info_scheme())
        return kmarch.plan("o4_mom", ctx.itot, ctx.jtot, ctx.ktot, 0, dtype,
                           info["blocks_per_sm"] * info["sms"], chunks)

    def momentum(self, u, v, wc, wd, tu, tv, tw, chunks=None):
        """K16: tu, tv, tw += advection of (u, v, wc) + diffusion of
        (u, v, wd), in place; wc and wd are w under its two ghost types.
        chunks: force the k-split (checks and timings only)."""
        ctx = self.ctx
        if on_cpu(u):
            return self.momentum_plain(u, v, wc, wd, tu, tv, tw)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        check((u, v, wc, wd, tu, tv, tw, self.cc), u.dtype, u.device,
              [shape] * 7 + [(ctx.ktot + 3, NC)])
        self.k_mom(u.dtype, u, v, wc, wd, tu, tv, tw, self.cc, ctx.itot,
                   ctx.jtot, ctx.ktot, ctx.ks, SCHEME_ID[self.scheme],
                   ctx.dxi, ctx.dyi, self.diff.visc,
                   self.plan(u.dtype, chunks).chunks)

    def scalar_plan(self, S, dtype, chunks=None):
        """The k-march of one K17 launch of S scalars (ops/kmarch.py), the
        chunk count chosen from the card's resident blocks unless given."""
        ctx = self.ctx
        info = self.k_scal.info(dtype, self.info_scheme(), S)
        return kmarch.plan("o4_scalars", ctx.itot, ctx.jtot, ctx.ktot, S,
                           dtype, info["blocks_per_sm"] * info["sms"], chunks)

    def scalars(self, u, v, wc, names, fields, carries, chunks=None):
        """K17: carries[n] += advection + diffusion of fields[n], in place;
        the scalars go max_scalars at a time.  chunks: force the k-split
        (checks and timings only)."""
        ctx = self.ctx
        if on_cpu(u):
            return self.scalars_plain(u, v, wc, names, fields, carries)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        check([u, v, wc] + list(fields) + list(carries) + [self.cz], u.dtype,
              u.device, [shape] * (3 + 2 * len(fields)) + [(ctx.ktot, NZ)])
        per = max_scalars(u.dtype)
        for i0 in range(0, len(fields), per):
            grp_a, grp_t = fields[i0:i0 + per], carries[i0:i0 + per]
            S = len(grp_a)

            def ptrs(arrays):
                return (ctypes.c_void_p * S)(*[a.data_ptr() for a in arrays])

            sviscs = (ctypes.c_double * S)(
                *[self.diff.viscs[n] for n in names[i0:i0 + per]])
            self.k_scal(u.dtype, u, v, wc, ptrs(grp_a), ptrs(grp_t), sviscs,
                        S, self.cz, ctx.itot, ctx.jtot, ctx.ktot, ctx.ks,
                        SCHEME_ID[self.scheme], ctx.dxi, ctx.dyi,
                        self.scalar_plan(S, u.dtype, chunks).chunks)

    def exec(self, ctx, s_cons, s, t, aux):
        """Add advec(s_cons) + diff(s) into the carry t, in place."""
        u, v = s["u"], s["v"]
        self.momentum(u, v, s_cons["w"], s["w"], t["u"], t["v"], t["w"])
        names = list(ctx.scalar_names)
        if names:
            self.scalars(u, v, s_cons["w"], names, [s[n] for n in names],
                         [t[n] for n in names])
        return t
