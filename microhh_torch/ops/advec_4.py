"""Fully 4th-order energy-conserving advection (``microhh_tpu/ops/advec_4.py``;
reference ``src/advec_4.cxx``).

Flux-divergence form with the ci/cg interior stencils and the bi/ti rows at
the walls; it needs three vertical ghost levels and conservation-type w
ghosts, which the model sets around it (model.cxx:387-389).  On the model's
main path the same terms run inside K16/K17 (ops/o4_fused.py); this op path
is their plain version and serves ``cfl_max``.
"""

import torch

from .. import fd
from . import fd4
from .stencil import im, ip, jm, jp


def _phi_ext(mid, bot, top):
    return torch.cat([bot[None], mid, top[None]], dim=0)


def _col(arr, lo, hi):
    return arr[lo:hi][:, None, None]


def advec_u(ctx, u, v, w, dim3=True):
    ks, ke = ctx.ks, ctx.ke
    G = fd4.ixh(u)
    out = -fd4.ixd(G * G)[ks:ke] * ctx.dxi
    if dim3:
        out = out - fd4.jyd(fd4.ixh(v) * fd4.jyh(u))[ks:ke] * ctx.dyi
    wix = fd4.ixh(w)
    phi_mid = wix[ks:ke + 1] * fd4.izh_mid(u, ks, ke)
    phi_bot = wix[ks - 1] * fd4.izh_bot(u, ks)
    phi_top = wix[ke + 1] * fd4.izh_top(u, ke)
    return out - fd4.izd(_phi_ext(phi_mid, phi_bot, phi_top),
                         _col(ctx.dzi4, ks, ke))


def advec_v(ctx, u, v, w, dim3=True):
    """v is advected in 2-D runs too; only the vv y-flux is gated
    (advec_4.cxx:605 instantiates advec_v<TF,0>)."""
    ks, ke = ctx.ks, ctx.ke
    out = -fd4.ixd(fd4.jyh(u) * fd4.ixh(v))[ks:ke] * ctx.dxi
    if dim3:
        G = fd4.jyh(v)
        out = out - fd4.jyd(G * G)[ks:ke] * ctx.dyi
    wjy = fd4.jyh(w)
    phi_mid = wjy[ks:ke + 1] * fd4.izh_mid(v, ks, ke)
    phi_bot = wjy[ks - 1] * fd4.izh_bot(v, ks)
    phi_top = wjy[ke + 1] * fd4.izh_top(v, ke)
    return out - fd4.izd(_phi_ext(phi_mid, phi_bot, phi_top),
                         _col(ctx.dzi4, ks, ke))


def advec_w(ctx, u, v, w, dim3=True):
    """Half levels ks+1..ke-1."""
    ks, ke = ctx.ks, ctx.ke
    lo, hi = ks + 1, ke
    uzh = fd4.izh_mid(u, lo, hi - 1)
    out = -fd4.ixd(uzh * fd4.ixh(w)[lo:hi]) * ctx.dxi
    if dim3:
        vzh = fd4.izh_mid(v, lo, hi - 1)
        out = out - fd4.jyd(vzh * fd4.jyh(w)[lo:hi]) * ctx.dyi

    # wc[c]: w interpolated to the centre c = ks-1..ke (uses w[c-1..c+2])
    wc = (fd.ci0 * w[ks - 2:ke] + fd.ci1 * w[ks - 1:ke + 1]
          + fd.ci2 * w[ks:ke + 2] + fd.ci3 * w[ks + 1:ke + 3])
    wc2 = wc * wc
    kt = hi - lo
    # term_z[k] = cg0 wc2[k-2] + cg1 wc2[k-1] + cg2 wc2[k] + cg3 wc2[k+1],
    # with the edge replacements of advec_4.cxx:327-331, 380-384
    wb = fd.bi0 * w[ks - 1] + fd.bi1 * w[ks] + fd.bi2 * w[ks + 1] + fd.bi3 * w[ks + 2]
    wt = fd.ti0 * w[ke - 2] + fd.ti1 * w[ke - 1] + fd.ti2 * w[ke] + fd.ti3 * w[ke + 1]
    c0 = torch.cat([(wb * wb)[None], wc2[1:kt]], dim=0)
    c3 = torch.cat([wc2[3:kt + 2], (wt * wt)[None]], dim=0)
    return out - ((fd.cg0 * c0 + fd.cg1 * wc2[1:kt + 1] + fd.cg2 * wc2[2:kt + 2]
                   + fd.cg3 * c3) * _col(ctx.dzhi4, lo, hi))


def advec_s(ctx, s, u, v, w, dim3=True):
    ks, ke = ctx.ks, ctx.ke
    out = -fd4.ixd(u * fd4.ixh(s))[ks:ke] * ctx.dxi
    if dim3:
        out = out - fd4.jyd(v * fd4.jyh(s))[ks:ke] * ctx.dyi
    phi_mid = w[ks:ke + 1] * fd4.izh_mid(s, ks, ke)
    phi_bot = w[ks - 1] * fd4.izh_bot(s, ks)
    phi_top = w[ke + 1] * fd4.izh_top(s, ke)
    return out - fd4.izd(_phi_ext(phi_mid, phi_bot, phi_top),
                         _col(ctx.dzi4, ks, ke))


class Advec4:
    needs_w_cons_ghosts = True
    scheme = "4"

    def __init__(self, ini, grid):
        self.cflmax = ini.get_float("advec", "cflmax", default=1.0)
        self.cflmin = 1.e-5
        self.jtot = grid.jtot

    def momentum(self, ctx, u, v, w):
        """The interior tendencies of u, v (ks..ke-1) and w (ks+1..ke-1)."""
        dim3 = self.jtot > 1
        return (advec_u(ctx, u, v, w, dim3), advec_v(ctx, u, v, w, dim3),
                advec_w(ctx, u, v, w, dim3))

    def scalar(self, ctx, a, u, v, w):
        return advec_s(ctx, a, u, v, w, self.jtot > 1)

    def exec(self, ctx, s, t, aux):
        """Add the advection tendencies into t, in place on the interior."""
        u, v, w = s["u"], s["v"], s["w"]
        ks, ke = ctx.ks, ctx.ke
        tu, tv, tw = self.momentum(ctx, u, v, w)
        t["u"][ks:ke] += tu
        t["v"][ks:ke] += tv
        t["w"][ks + 1:ke] += tw
        for name in ctx.scalar_names:
            t[name][ks:ke] += self.scalar(ctx, s[name], u, v, w)
        return t

    def cfl_max(self, ctx, s):
        """The interp4c-based CFL rate (advec_4.cxx:51-86)."""
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"], s["v"], s["w"]
        uc = (fd.ci0 * im(u) + fd.ci1 * u + fd.ci2 * ip(u) + fd.ci3 * ip(u, 2))[ks:ke]
        vc = (fd.ci0 * jm(v) + fd.ci1 * v + fd.ci2 * jp(v) + fd.ci3 * jp(v, 2))[ks:ke]
        wc = (fd.ci0 * w[ks - 1:ke - 1] + fd.ci1 * w[ks:ke]
              + fd.ci2 * w[ks + 1:ke + 1] + fd.ci3 * w[ks + 2:ke + 2])
        c = (torch.abs(uc) * ctx.dxi + torch.abs(vc) * ctx.dyi
             + torch.abs(wc) * _col(ctx.dzi, ks, ke))
        return torch.max(c)
