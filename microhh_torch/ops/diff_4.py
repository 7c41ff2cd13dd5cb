"""4th-order constant-viscosity diffusion (``microhh_tpu/ops/diff_4.py``;
reference ``src/diff_4.cxx``).  On the model's main path the same terms run
inside K16/K17 (ops/o4_fused.py); this op path is their plain version."""

import torch

from .. import fd
from .stencil import im, ip, jm, jp


def _lap_h(a, dxidxi, dyidyi, dim3):
    """7-point 4th-order second derivative, horizontal (cdg stencil)."""
    out = (fd.cdg3 * (im(a, 3) + ip(a, 3)) + fd.cdg2 * (im(a, 2) + ip(a, 2))
           + fd.cdg1 * (im(a, 1) + ip(a, 1)) + fd.cdg0 * a) * dxidxi
    if dim3:
        out = out + (fd.cdg3 * (jm(a, 3) + jp(a, 3)) + fd.cdg2 * (jm(a, 2) + jp(a, 2))
                     + fd.cdg1 * (jm(a, 1) + jp(a, 1)) + fd.cdg0 * a) * dyidyi
    return out


def _div_cg(gz, kt, col):
    return (fd.cg0 * gz[0:kt] + fd.cg1 * gz[1:kt + 1]
            + fd.cg2 * gz[2:kt + 2] + fd.cg3 * gz[3:kt + 3]) * col[:, None, None]


def diff_c(ctx, a, visc, dim3=True):
    """Cell-centred field, interior levels (diff_4.cxx diff_c)."""
    ks, ke = ctx.ks, ctx.ke
    out = _lap_h(a[ks:ke], ctx.dxi ** 2, ctx.dyi ** 2, dim3)
    # vertical: gradient at the half levels ks-1..ke+1, cg divergence
    gz_mid = ((fd.cg0 * a[ks - 2:ke - 1] + fd.cg1 * a[ks - 1:ke]
               + fd.cg2 * a[ks:ke + 1] + fd.cg3 * a[ks + 1:ke + 2])
              * ctx.dzhi4[ks:ke + 1][:, None, None])
    gz_bot = ((fd.bg0 * a[ks - 2] + fd.bg1 * a[ks - 1] + fd.bg2 * a[ks] + fd.bg3 * a[ks + 1])
              * ctx.dzhi4[ks - 1])
    gz_top = ((fd.tg0 * a[ke - 2] + fd.tg1 * a[ke - 1] + fd.tg2 * a[ke] + fd.tg3 * a[ke + 1])
              * ctx.dzhi4[ke + 1])
    gz = torch.cat([gz_bot[None], gz_mid, gz_top[None]], dim=0)
    return visc * (out + _div_cg(gz, ke - ks, ctx.dzi4[ks:ke]))


def diff_w(ctx, w, visc, dim3=True):
    """w on the half levels ks+1..ke-1 (diff_4.cxx diff_w)."""
    ks, ke = ctx.ks, ctx.ke
    lo, hi = ks + 1, ke
    out = _lap_h(w[lo:hi], ctx.dxi ** 2, ctx.dyi ** 2, dim3)
    # gradient of w at the centres ks-1..ke (edge rows bg/tg), times dzi4
    gz_mid = ((fd.cg0 * w[ks - 1:ke - 1] + fd.cg1 * w[ks:ke]
               + fd.cg2 * w[ks + 1:ke + 1] + fd.cg3 * w[ks + 2:ke + 2])
              * ctx.dzi4[ks:ke][:, None, None])
    gz_bot = ((fd.bg0 * w[ks - 1] + fd.bg1 * w[ks] + fd.bg2 * w[ks + 1] + fd.bg3 * w[ks + 2])
              * ctx.dzi4[ks - 1])
    gz_top = ((fd.tg0 * w[ke - 2] + fd.tg1 * w[ke - 1] + fd.tg2 * w[ke] + fd.tg3 * w[ke + 1])
              * ctx.dzi4[ke])
    gz = torch.cat([gz_bot[None], gz_mid, gz_top[None]], dim=0)
    return visc * (out + _div_cg(gz, hi - lo, ctx.dzhi4[lo:hi]))


class Diff4:
    def __init__(self, ini, grid, fields):
        self.dnmax = ini.get_float("diff", "dnmax", default=0.4)
        viscmax = fields.visc
        for f in fields.sp.values():
            viscmax = max(viscmax, f.visc)
        g = grid
        dn = 0.
        for k in range(g.kstart, g.kend):
            dn = max(dn, abs(viscmax * (1. / g.dx ** 2 + 1. / g.dy ** 2 + 1. / g.dz[k] ** 2)))
        self.dnmul = dn
        self.visc = fields.visc
        self.viscs = {name: f.visc for name, f in fields.sp.items()}
        self.jtot = grid.jtot

    def momentum(self, ctx, u, v, w):
        """The interior tendencies of u, v (ks..ke-1) and w (ks+1..ke-1);
        a 2-D run has no diffusion of v (diff_4.cxx exec)."""
        dim3 = self.jtot > 1
        return (diff_c(ctx, u, self.visc, dim3),
                diff_c(ctx, v, self.visc, dim3) if dim3 else None,
                diff_w(ctx, w, self.visc, dim3))

    def scalar(self, ctx, a, name):
        return diff_c(ctx, a, self.viscs[name], self.jtot > 1)

    def exec_viscosity(self, ctx, s, sfc, aux):
        """No eddy viscosity (post mode's re-diagnosis asks every
        diffusion)."""
        return aux

    def exec(self, ctx, s, t, aux, sfc=None):
        """Add the diffusion tendencies into t, in place on the interior."""
        ks, ke = ctx.ks, ctx.ke
        tu, tv, tw = self.momentum(ctx, s["u"], s["v"], s["w"])
        t["u"][ks:ke] += tu
        if tv is not None:
            t["v"][ks:ke] += tv
        t["w"][ks + 1:ke] += tw
        for name in ctx.scalar_names:
            t[name][ks:ke] += self.scalar(ctx, s[name], name)
        return t

    def get_dn(self, ctx, s, aux):
        """The diffusion number per unit dt: a constant of the grid."""
        return torch.as_tensor(self.dnmul, dtype=ctx.dtype, device=ctx.device)
