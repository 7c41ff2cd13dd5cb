"""2nd-order constant-viscosity diffusion (``microhh_tpu/ops/diff_2.py``;
reference ``src/diff_2.cxx``), as plain torch.

``diff_c`` and ``diff_w`` are also the molecular terms of the DNN closure
(ops/diff_dnn.py).  ``Diff2`` (``swdiff=2``) runs on the model's plain
substep, as the JAX package runs it in XLA: no eddy viscosity, and a
diffusion number that is a constant of the grid (``dnmul``).
"""

import torch

from .stencil import im, ip, jm, jp


def _col(arr, lo, hi):
    return arr[lo:hi][:, None, None]


def diff_c(ctx, a, visc):
    """Laplacian diffusion of a cell-centred field, interior levels."""
    ks, ke = ctx.ks, ctx.ke
    dxidxi = ctx.dxi * ctx.dxi
    dyidyi = ctx.dyi * ctx.dyi
    lap_h = ((ip(a) - 2. * a + im(a)) * dxidxi
             + (jp(a) - 2. * a + jm(a)) * dyidyi)[ks:ke]
    lap_z = ((a[ks + 1:ke + 1] - a[ks:ke]) * _col(ctx.dzhi, ks + 1, ke + 1)
             - (a[ks:ke] - a[ks - 1:ke - 1]) * _col(ctx.dzhi, ks, ke)) \
        * _col(ctx.dzi, ks, ke)
    return visc * (lap_h + lap_z)


def diff_w(ctx, w, visc):
    """Diffusion of w on the half levels ks+1 .. ke-1."""
    ks, ke = ctx.ks, ctx.ke
    lo, hi = ks + 1, ke
    dxidxi = ctx.dxi * ctx.dxi
    dyidyi = ctx.dyi * ctx.dyi
    lap_h = ((ip(w) - 2. * w + im(w)) * dxidxi
             + (jp(w) - 2. * w + jm(w)) * dyidyi)[lo:hi]
    lap_z = ((w[lo + 1:hi + 1] - w[lo:hi]) * _col(ctx.dzi, lo, hi)
             - (w[lo:hi] - w[lo - 1:hi - 1]) * _col(ctx.dzi, lo - 1, hi - 1)) \
        * _col(ctx.dzhi, lo, hi)
    return visc * (lap_h + lap_z)


class Diff2:
    def __init__(self, ini, grid, fields):
        self.dnmax = ini.get_float("diff", "dnmax", default=0.4)
        # dnmul: static dt multiplier (reference diff_2.cxx:139-151)
        viscmax = fields.visc
        for f in fields.sp.values():
            viscmax = max(viscmax, f.visc)
        g = grid
        dn = 0.
        for k in range(g.kstart, g.kend):
            dn = max(dn, abs(viscmax * (1. / g.dx ** 2 + 1. / g.dy ** 2
                                        + 1. / g.dz[k] ** 2)))
        self.dnmul = dn
        self.visc = fields.visc
        self.viscs = {name: f.visc for name, f in fields.sp.items()}

    def exec_viscosity(self, ctx, s, sfc, aux):
        return aux

    def exec(self, ctx, s, t, aux, sfc=None):
        """t plus the diffusion of every prognostic field (new tensors)."""
        ks, ke = ctx.ks, ctx.ke
        t = {n: a.clone() for n, a in t.items()}
        t["u"][ks:ke] += diff_c(ctx, s["u"], self.visc)
        t["v"][ks:ke] += diff_c(ctx, s["v"], self.visc)
        t["w"][ks + 1:ke] += diff_w(ctx, s["w"], self.visc)
        for name in ctx.scalar_names:
            t[name][ks:ke] += diff_c(ctx, s[name], self.viscs[name])
        return t

    def get_dn(self, ctx, s, aux):
        """Diffusion number per unit dt (the host multiplies by dt)."""
        return torch.full((), self.dnmul, dtype=ctx.dtype, device=ctx.device)
