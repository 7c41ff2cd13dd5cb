"""2nd-order centered advection (``microhh_tpu/ops/advec_2.py``; reference
``src/advec_2.cxx``).

ut/vt/wt/st += -nabla.(u q) in anelastic form with rhoref weighting, as
plain torch on ghost-padded (kcells, jtot, itot) tensors.  On the model's
main path the same terms run inside the RK tendency kernel (ops/fused.py);
this op path is its independent reference and serves ``cfl_max``.
"""

import torch

from .stencil import im, ip, jm, jp, i2


def _col(arr, sl):
    """Broadcast a k-profile slice to (nk, 1, 1)."""
    return arr[sl][:, None, None]


def add_rows(a, lo, hi, val):
    """a with val added to planes lo:hi (a new tensor)."""
    out = a.clone()
    out[lo:hi] += val
    return out


def advec_u(ctx, u, v, w):
    ks, ke = ctx.ks, ctx.ke
    dxi, dyi = ctx.dxi, ctx.dyi

    term_x = (i2(u, ip(u)) ** 2 - i2(im(u), u) ** 2) * dxi
    term_y = (i2(im(jp(v)), jp(v)) * i2(u, jp(u))
              - i2(im(v), v) * i2(jm(u), u)) * dyi

    w_at_u = i2(im(w), w)
    flux_top = _col(ctx.rhorefh, slice(ks + 1, ke + 1)) * w_at_u[ks + 1:ke + 1] * i2(u[ks:ke], u[ks + 1:ke + 1])
    flux_bot = _col(ctx.rhorefh, slice(ks, ke)) * w_at_u[ks:ke] * i2(u[ks - 1:ke - 1], u[ks:ke])
    term_z = (flux_top - flux_bot) / _col(ctx.rhoref, slice(ks, ke)) * _col(ctx.dzi, slice(ks, ke))

    return -(term_x[ks:ke] + term_y[ks:ke] + term_z)


def advec_v(ctx, u, v, w):
    ks, ke = ctx.ks, ctx.ke
    dxi, dyi = ctx.dxi, ctx.dyi

    term_x = (i2(jm(ip(u)), ip(u)) * i2(v, ip(v))
              - i2(jm(u), u) * i2(im(v), v)) * dxi
    term_y = (i2(v, jp(v)) ** 2 - i2(jm(v), v) ** 2) * dyi

    w_at_v = i2(jm(w), w)
    flux_top = _col(ctx.rhorefh, slice(ks + 1, ke + 1)) * w_at_v[ks + 1:ke + 1] * i2(v[ks:ke], v[ks + 1:ke + 1])
    flux_bot = _col(ctx.rhorefh, slice(ks, ke)) * w_at_v[ks:ke] * i2(v[ks - 1:ke - 1], v[ks:ke])
    term_z = (flux_top - flux_bot) / _col(ctx.rhoref, slice(ks, ke)) * _col(ctx.dzi, slice(ks, ke))

    return -(term_x[ks:ke] + term_y[ks:ke] + term_z)


def advec_w(ctx, u, v, w):
    """Tendency on half levels k in [ks+1, ke) (walls untouched)."""
    ks, ke = ctx.ks, ctx.ke
    dxi, dyi = ctx.dxi, ctx.dyi
    lo, hi = ks + 1, ke

    u_at_w = i2(u[lo - 1:hi - 1], u[lo:hi])
    up_at_w = i2(ip(u)[lo - 1:hi - 1], ip(u)[lo:hi])
    term_x = (up_at_w * i2(w[lo:hi], ip(w)[lo:hi])
              - u_at_w * i2(im(w)[lo:hi], w[lo:hi])) * dxi

    v_at_w = i2(v[lo - 1:hi - 1], v[lo:hi])
    vp_at_w = i2(jp(v)[lo - 1:hi - 1], jp(v)[lo:hi])
    term_y = (vp_at_w * i2(w[lo:hi], jp(w)[lo:hi])
              - v_at_w * i2(jm(w)[lo:hi], w[lo:hi])) * dyi

    flux_top = _col(ctx.rhoref, slice(lo, hi)) * i2(w[lo:hi], w[lo + 1:hi + 1]) ** 2
    flux_bot = _col(ctx.rhoref, slice(lo - 1, hi - 1)) * i2(w[lo - 1:hi - 1], w[lo:hi]) ** 2
    term_z = (flux_top - flux_bot) / _col(ctx.rhorefh, slice(lo, hi)) * _col(ctx.dzhi, slice(lo, hi))

    return -(term_x + term_y + term_z)


def advec_s(ctx, s, u, v, w):
    ks, ke = ctx.ks, ctx.ke
    dxi, dyi = ctx.dxi, ctx.dyi

    term_x = (ip(u) * i2(s, ip(s)) - u * i2(im(s), s)) * dxi
    term_y = (jp(v) * i2(s, jp(s)) - v * i2(jm(s), s)) * dyi

    flux_top = _col(ctx.rhorefh, slice(ks + 1, ke + 1)) * w[ks + 1:ke + 1] * i2(s[ks:ke], s[ks + 1:ke + 1])
    flux_bot = _col(ctx.rhorefh, slice(ks, ke)) * w[ks:ke] * i2(s[ks - 1:ke - 1], s[ks:ke])
    term_z = (flux_top - flux_bot) / _col(ctx.rhoref, slice(ks, ke)) * _col(ctx.dzi, slice(ks, ke))

    return -(term_x[ks:ke] + term_y[ks:ke] + term_z)


class Advec2:
    def __init__(self, ini, grid):
        self.cflmax = ini.get_float("advec", "cflmax", default=1.0)
        self.cflmin = 1.e-5

    def exec(self, ctx, s, t, aux):
        u, v, w = s["u"], s["v"], s["w"]
        ks, ke = ctx.ks, ctx.ke
        t = dict(t)
        t["u"] = add_rows(t["u"], ks, ke, advec_u(ctx, u, v, w))
        t["v"] = add_rows(t["v"], ks, ke, advec_v(ctx, u, v, w))
        t["w"] = add_rows(t["w"], ks + 1, ke, advec_w(ctx, u, v, w))
        for name in ctx.scalar_names:
            t[name] = add_rows(t[name], ks, ke, advec_s(ctx, s[name], u, v, w))
        return t

    def cfl_max(self, ctx, s):
        """max over the grid of |u|/dx+|v|/dy+|w|/dz at cell centers; multiply
        by dt on the host (reference calc_cfl, advec_2.cxx:50-78)."""
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"], s["v"], s["w"]
        c = (torch.abs(i2(u, ip(u)))[ks:ke] * ctx.dxi
             + torch.abs(i2(v, jp(v)))[ks:ke] * ctx.dyi
             + torch.abs(i2(w[ks:ke], w[ks + 1:ke + 1])) * _col(ctx.dzi, slice(ks, ke)))
        return torch.max(c)
