"""4th-order modified (kinetic-energy conserving) advection
(``microhh_tpu/ops/advec_4m.py``; reference ``src/advec_4m.cxx``).

Fluxes at the four half-positions around each node: the 4th-order
interpolated advecting velocity times a midpoint (2-point) interpolation of
the transported quantity, narrow (adjacent) for the inner pair and wide
(3 apart) for the outer pair, combined with grad4.  The wall rows replace
the flux outside the wall by a mirrored negative flux.  The op path is the
plain version of K16/K17 in their ``4m`` scheme (ops/o4_fused.py).
"""

import torch

from .. import fd
from . import fd4
from .stencil import im, ip, jm, jp
from .advec_4 import Advec4


def _grad4(a, b, c, d):
    return -fd.cg0 * (d - a) - fd.cg1 * (c - b)


def _flux4_x(velh, q):
    """-grad4 of the x-fluxes around each node; velh at i-1/2."""
    a = im(velh) * 0.5 * (im(q, 3) + q)
    b = velh * 0.5 * (im(q) + q)
    c = ip(velh) * 0.5 * (q + ip(q))
    d = ip(velh, 2) * 0.5 * (q + ip(q, 3))
    return -_grad4(a, b, c, d)


def _flux4_y(velh, q):
    a = jm(velh) * 0.5 * (jm(q, 3) + q)
    b = velh * 0.5 * (jm(q) + q)
    c = jp(velh) * 0.5 * (q + jp(q))
    d = jp(velh, 2) * 0.5 * (q + jp(q, 3))
    return -_grad4(a, b, c, d)


def _vert_4m(ctx, wvel_h, q):
    """Vertical -grad4 term for a cell-centred target, levels ks..ke-1;
    wvel_h: the advecting velocity at the half levels (kcells planes)."""
    ks, ke = ctx.ks, ctx.ke
    a = wvel_h[ks - 1:ke - 1] * 0.5 * (q[ks - 3:ke - 3] + q[ks:ke])
    b = wvel_h[ks:ke] * 0.5 * (q[ks - 1:ke - 1] + q[ks:ke])
    c = wvel_h[ks + 1:ke + 1] * 0.5 * (q[ks:ke] + q[ks + 1:ke + 1])
    d = wvel_h[ks + 2:ke + 2] * 0.5 * (q[ks:ke] + q[ks + 3:ke + 3])
    # wall rows: mirrored negative outer fluxes (advec_4m.cxx bottom/top)
    a_wall = -wvel_h[ks + 1] * 0.5 * (q[ks - 1] + q[ks + 2])
    d_wall = -wvel_h[ke - 1] * 0.5 * (q[ke - 3] + q[ke])
    a = torch.cat([a_wall[None], a[1:]], dim=0)
    d = torch.cat([d[:-1], d_wall[None]], dim=0)
    return -_grad4(a, b, c, d) * ctx.dzi4[ks:ke][:, None, None]


def _izh_full(a, ks, ke):
    """a interpolated to the half levels ks-1..ke+1, zero elsewhere."""
    out = torch.zeros_like(a)
    out[ks - 1:ke + 2] = (fd.ci0 * a[ks - 3:ke] + fd.ci1 * a[ks - 2:ke + 1]
                          + fd.ci2 * a[ks - 1:ke + 2] + fd.ci3 * a[ks:ke + 3])
    return out


class Advec4m(Advec4):
    """Inherits the CFL from Advec4 (the same interp4c formula)."""

    scheme = "4m"

    def momentum(self, ctx, u, v, w):
        ks, ke = ctx.ks, ctx.ke
        dxi, dyi = ctx.dxi, ctx.dyi
        dim3 = self.jtot > 1

        tu = _flux4_x(fd4.ixh(u), u)[ks:ke] * dxi
        if dim3:
            tu = tu + _flux4_y(fd4.ixh(v), u)[ks:ke] * dyi
        tu = tu + _vert_4m(ctx, fd4.ixh(w), u)

        # v is advected in 2-D too; only the y-flux is gated
        # (advec_4m.cxx:536 instantiates advec_v<TF,0>)
        tv = _flux4_x(fd4.jyh(u), v)[ks:ke] * dxi
        if dim3:
            tv = tv + _flux4_y(fd4.jyh(v), v)[ks:ke] * dyi
        tv = tv + _vert_4m(ctx, fd4.jyh(w), v)

        # w at the half levels ks+1..ke-1, with conservation w ghosts
        lo, hi = ks + 1, ke
        tw = _flux4_x(_izh_full(u, ks, ke), w)[lo:hi] * dxi
        if dim3:
            tw = tw + _flux4_y(_izh_full(v, ks, ke), w)[lo:hi] * dyi
        # centre-located fluxes: wc4[c] needs w[c-1..c+2], so the usable
        # centres are ks-1..ke (w has three ghost levels)
        wc4 = torch.zeros_like(w)
        wc4[ks - 1:ke + 1] = (fd.ci0 * w[ks - 2:ke] + fd.ci1 * w[ks - 1:ke + 1]
                              + fd.ci2 * w[ks:ke + 2] + fd.ci3 * w[ks + 1:ke + 3])
        a = wc4[lo - 2:hi - 2] * 0.5 * (w[lo - 3:hi - 3] + w[lo:hi])
        b = wc4[lo - 1:hi - 1] * 0.5 * (w[lo - 1:hi - 1] + w[lo:hi])
        c = wc4[lo:hi] * 0.5 * (w[lo:hi] + w[lo + 1:hi + 1])
        d = wc4[lo + 1:hi + 1] * 0.5 * (w[lo:hi] + w[lo + 3:hi + 3])
        tw = tw - _grad4(a, b, c, d) * ctx.dzhi4[lo:hi][:, None, None]
        return tu, tv, tw

    def scalar(self, ctx, a, u, v, w):
        ks, ke = ctx.ks, ctx.ke
        ts = _flux4_x(u, a)[ks:ke] * ctx.dxi
        if self.jtot > 1:
            ts = ts + _flux4_y(v, a)[ks:ke] * ctx.dyi
        return ts + _vert_4m(ctx, w, a)
