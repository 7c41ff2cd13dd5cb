"""Interpolated advection family 2i4, 2i5, 2i53, 2i62
(``microhh_tpu/ops/advec_interp.py``; reference ``src/advec_2i4.cxx``,
``advec_2i5.cxx``, ``advec_2i53.cxx``, ``advec_2i62.cxx``).

2nd-order flux-divergence schemes: the advecting velocity is interpolated
2nd-order to the flux face, the transported quantity at higher order.

* 2i4  - 4th-order centred (interp4c) horizontal and vertical, 2nd order
         at the two half levels nearest each wall;
* 2i5  - 6th-order centred + 5th-order upwind (|vel| * interp5_ws)
         horizontal and vertical, the vertical ladder 2nd / 4th-WS+3rd /
         6th+5th from the walls inward;
* 2i62 - 6th-order centred horizontal (no upwind), 2nd-order vertical;
* 2i53 - 6th+5th-upwind horizontal, 4th-order WS + 3rd-order upwind
         vertical, 2nd order at the first half level off each wall.

This module is the op path in plain torch: the reference of the hand-written
kernels K12/K13 (ops/advec_interp_fused.py), the Koren-limited scalars of
``fluxlimit_list`` (advec_monotonic.h), and ``cfl_max``.
"""

import torch

from .. import fd
from .stencil import im, ip, jm, jp, i2

SCHEMES = ("2i4", "2i5", "2i53", "2i62")
UPWIND = ("2i5", "2i53")    # schemes with the upwind-dissipative part


# --- half-location interpolators (value at i-1/2 / j-1/2) -----------------

def i4h_x(q):
    return fd.ci0 * im(q, 2) + fd.ci1 * im(q) + fd.ci2 * q + fd.ci3 * ip(q)


def i6h_x(q):
    return ((37. / 60.) * (im(q) + q) - (8. / 60.) * (im(q, 2) + ip(q))
            + (1. / 60.) * (im(q, 3) + ip(q, 2)))


def i5h_x(q):
    return ((10. / 60.) * (q - im(q)) - (5. / 60.) * (ip(q) - im(q, 2))
            + (1. / 60.) * (ip(q, 2) - im(q, 3)))


def i4h_y(q):
    return fd.ci0 * jm(q, 2) + fd.ci1 * jm(q) + fd.ci2 * q + fd.ci3 * jp(q)


def i6h_y(q):
    return ((37. / 60.) * (jm(q) + q) - (8. / 60.) * (jm(q, 2) + jp(q))
            + (1. / 60.) * (jm(q, 3) + jp(q, 2)))


def i5h_y(q):
    return ((10. / 60.) * (q - jm(q)) - (5. / 60.) * (jp(q) - jm(q, 2))
            + (1. / 60.) * (jp(q, 2) - jm(q, 3)))


def _i6(q, lo, hi):
    """6th-order centred value between planes lo-1.. and lo.. (hi exclusive)."""
    return ((37. / 60.) * (q[lo - 1:hi - 1] + q[lo:hi])
            - (8. / 60.) * (q[lo - 2:hi - 2] + q[lo + 1:hi + 1])
            + (1. / 60.) * (q[lo - 3:hi - 3] + q[lo + 2:hi + 2]))


def _i5(q, lo, hi):
    return ((10. / 60.) * (q[lo:hi] - q[lo - 1:hi - 1])
            - (5. / 60.) * (q[lo + 1:hi + 1] - q[lo - 2:hi - 2])
            + (1. / 60.) * (q[lo + 2:hi + 2] - q[lo - 3:hi - 3]))


def _i4ws(q, lo, hi):
    return fd.interp4_ws(q[lo - 2:hi - 2], q[lo - 1:hi - 1], q[lo:hi],
                         q[lo + 1:hi + 1])


def _i3ws(q, lo, hi):
    return fd.interp3_ws(q[lo - 2:hi - 2], q[lo - 1:hi - 1], q[lo:hi],
                         q[lo + 1:hi + 1])


def _i4c(q, lo, hi):
    return (fd.ci0 * q[lo - 2:hi - 2] + fd.ci1 * q[lo - 1:hi - 1]
            + fd.ci2 * q[lo:hi] + fd.ci3 * q[lo + 1:hi + 1])


def _zh_ladder(scheme, q, ks, ke):
    """The transported quantity at the half levels ks..ke (index 0 = ks) and
    the matching upwind part (zeros where none applies).  The wall half
    levels carry 0 (w = 0 there); inward the ladder is 2nd / [4th] / [6th]
    order per scheme."""
    kt = ke - ks
    X = torch.zeros((kt + 1,) + q.shape[1:], dtype=q.dtype, device=q.device)
    U = torch.zeros_like(X)

    def i2z(m):
        return 0.5 * (q[m - 1] + q[m])

    if scheme == "2i62":
        X[1:kt] = 0.5 * (q[ks:ke - 1] + q[ks + 1:ke])
        return X, U
    if scheme not in SCHEMES:
        raise ValueError(scheme)
    X[1] = i2z(ks + 1)
    X[kt - 1] = i2z(ke - 1)
    if scheme == "2i53":
        if kt > 3:
            X[2:kt - 1] = _i4ws(q, ks + 2, ke - 1)
            U[2:kt - 1] = _i3ws(q, ks + 2, ke - 1)
    elif scheme == "2i4":
        if kt > 3:
            X[2:kt - 1] = _i4c(q, ks + 2, ke - 1)
    else:   # 2i5
        if kt > 3:
            # second face off each wall: 4th-order WS + 3rd-order upwind
            # (advec_2i5.cxx:239-242, 284-287)
            X[2] = _i4ws(q, ks + 2, ks + 3)[0]
            U[2] = _i3ws(q, ks + 2, ks + 3)[0]
            X[kt - 2] = _i4ws(q, ke - 2, ke - 1)[0]
            U[kt - 2] = _i3ws(q, ke - 2, ke - 1)[0]
        if kt > 5:
            X[3:kt - 2] = _i6(q, ks + 3, ke - 2)
            U[3:kt - 2] = _i5(q, ks + 3, ke - 2)
    return X, U


def _koren(vel, sm2, sm1, sp1, sp2):
    """Koren (1993) limited upwind flux (advec_monotonic.h flux_lim)."""
    eps = torch.finfo(vel.dtype).eps

    def branch(a2, a1, b1, b2):
        d = (torch.where(a1 - a2 >= 0., 1., -1.)
             * torch.clamp(torch.abs(a1 - a2), min=eps))
        two_r = 2. * (b1 - a1) / d
        phi = torch.clamp(torch.minimum(
            two_r, torch.clamp((1. + two_r) / 3., max=2.)), min=0.)
        return a1 + 0.5 * phi * (a1 - a2)

    return vel * torch.where(vel >= 0., branch(sm2, sm1, sp1, sp2),
                             branch(sp2, sp1, sm1, sm2))


def advec_s_lim(ctx, a, u, v, w):
    """Monotone scalar advection (advec_monotonic.h advec_s_lim): Koren
    fluxes in all directions, first-order upwind at the first face off each
    wall, zero wall fluxes.  Returns the interior tendency."""
    ks, ke = ctx.ks, ctx.ke
    kt = ke - ks
    dxi, dyi = ctx.dxi, ctx.dyi

    Fx = _koren(u, im(a, 2), im(a), a, ip(a))
    Fy = _koren(v, jm(a, 2), jm(a), a, jp(a))
    ts = (-(ip(Fx) - Fx) * dxi - (jp(Fy) - Fy) * dyi)[ks:ke]

    ai = a[ks:ke]
    wi = w[ks:ke + 1]
    F = torch.zeros((kt + 1,) + a.shape[1:], dtype=a.dtype, device=a.device)
    if kt > 3:
        F[2:kt - 1] = _koren(wi[2:kt - 1], ai[0:kt - 3], ai[1:kt - 2],
                             ai[2:kt - 1], ai[3:kt])
    # first face off the bottom wall: upwind from below is 1st order
    f_up = wi[1] * ai[0]
    f_dn = _koren(torch.clamp(wi[1], max=0.), ai[0], ai[0], ai[1], ai[2])
    F[1] = torch.where(wi[1] >= 0., f_up, f_dn)
    # first face off the top wall: upwind from above is 1st order
    f_dn_t = wi[kt - 1] * ai[kt - 1]
    f_up_t = _koren(torch.clamp(wi[kt - 1], min=0.), ai[kt - 3], ai[kt - 2],
                    ai[kt - 1], ai[kt - 1])
    F[kt - 1] = torch.where(wi[kt - 1] >= 0., f_up_t, f_dn_t)

    rho = ctx.rhoref[ks:ke][:, None, None]
    rhoh = ctx.rhorefh[ks:ke + 1][:, None, None]
    dzi = ctx.dzi[ks:ke][:, None, None]
    return ts - (rhoh[1:] * F[1:] - rhoh[:-1] * F[:-1]) / rho * dzi


class AdvecInterp:
    """One body for the four schemes; ``scheme`` names the ladder."""

    scheme = None

    def __init__(self, ini, grid):
        self.cflmax = ini.get_float("advec", "cflmax", default=1.0)
        self.cflmin = 1.e-5
        # Koren (1993) monotone fluxes for the listed scalars
        # (advec_2i5.cxx:39-44, include/advec_monotonic.h)
        self.fluxlimit_list = ini.get_list(str, "advec", "fluxlimit_list",
                                           default=[])

    # face value and optional upwind part at the LEFT face (-1/2)
    def _hx(self, q):
        if self.scheme == "2i4":
            return i4h_x(q), None
        return i6h_x(q), (i5h_x(q) if self.scheme in UPWIND else None)

    def _hy(self, q):
        if self.scheme == "2i4":
            return i4h_y(q), None
        return i6h_y(q), (i5h_y(q) if self.scheme in UPWIND else None)

    def _hterms(self, velR_x, velR_y, q):
        """-d(vel q)/dx and -d(vel q)/dy (+ upwind) before the 1/dx, 1/dy
        factors; velR_* are the RIGHT-face advecting velocities of point i
        (left = im/jm of them)."""
        qx, ux = self._hx(q)
        Fx = velR_x * ip(qx)
        out_x = -(Fx - im(Fx))
        if ux is not None:
            Gx = torch.abs(velR_x) * ip(ux)
            out_x = out_x + (Gx - im(Gx))
        qy, uy = self._hy(q)
        Fy = velR_y * jp(qy)
        out_y = -(Fy - jm(Fy))
        if uy is not None:
            Gy = torch.abs(velR_y) * jp(uy)
            out_y = out_y + (Gy - jm(Gy))
        return out_x, out_y

    def _vterm(self, ctx, velw_h, q):
        """Vertical flux divergence at the centres from the half-level
        ladder; velw_h is the advecting w at the half levels ks..ke."""
        ks, ke = ctx.ks, ctx.ke
        X, U = _zh_ladder(self.scheme, q, ks, ke)
        rhh = ctx.rhorefh[ks:ke + 1][:, None, None]
        rho = ctx.rhoref[ks:ke][:, None, None]
        dzi = ctx.dzi[ks:ke][:, None, None]
        F = rhh * velw_h * X
        out = -(F[1:] - F[:-1]) / rho * dzi
        if self.scheme in UPWIND:
            G = rhh * torch.abs(velw_h) * U
            out = out + (G[1:] - G[:-1]) / rho * dzi
        return out

    def _w_center_ladder(self, w, ks, ke):
        """w at the centres ks..ke-1 for the w equation's vertical fluxes,
        with its upwind part: edge centres 2nd order, inward per scheme."""
        kt = ke - ks
        Xc = torch.zeros((kt,) + w.shape[1:], dtype=w.dtype, device=w.device)
        Uc = torch.zeros_like(Xc)
        Xc[0] = i2(w[ks], w[ks + 1])
        Xc[kt - 1] = i2(w[ke - 1], w[ke])
        if self.scheme == "2i62":
            Xc[1:kt - 1] = i2(w[ks + 1:ke - 1], w[ks + 2:ke])
        elif self.scheme == "2i53":
            if kt > 2:
                Xc[1:kt - 1] = _i4ws(w, ks + 2, ke)
                Uc[1:kt - 1] = _i3ws(w, ks + 2, ke)
        elif self.scheme == "2i4":
            if kt > 2:
                Xc[1:kt - 1] = _i4c(w, ks + 2, ke)
        else:   # 2i5
            if kt > 2:
                # second centre off each wall: 4th-order WS + 3rd upwind
                # (advec_2i5.cxx:530-533, 574-577)
                Xc[1] = fd.interp4_ws(w[ks], w[ks + 1], w[ks + 2], w[ks + 3])
                Uc[1] = fd.interp3_ws(w[ks], w[ks + 1], w[ks + 2], w[ks + 3])
                Xc[kt - 2] = fd.interp4_ws(w[ke - 3], w[ke - 2], w[ke - 1], w[ke])
                Uc[kt - 2] = fd.interp3_ws(w[ke - 3], w[ke - 2], w[ke - 1], w[ke])
            if kt > 4:
                Xc[2:kt - 2] = _i6(w, ks + 3, ke - 1)
                Uc[2:kt - 2] = _i5(w, ks + 3, ke - 1)
        return Xc, Uc

    def momentum(self, ctx, s):
        """The interior advection tendencies (tu, tv on ks:ke, tw on
        ks+1:ke) of u, v and w."""
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"], s["v"], s["w"]
        dxi, dyi = ctx.dxi, ctx.dyi

        tx, ty = self._hterms(i2(u, ip(u)), jp(i2(im(v), v)), u)
        tu = (tx[ks:ke] * dxi + ty[ks:ke] * dyi
              + self._vterm(ctx, i2(im(w), w)[ks:ke + 1], u))

        tx, ty = self._hterms(ip(i2(jm(u), u)), i2(v, jp(v)), v)
        tv = (tx[ks:ke] * dxi + ty[ks:ke] * dyi
              + self._vterm(ctx, i2(jm(w), w)[ks:ke + 1], v))

        # w at the half levels ks+1..ke-1
        lo, hi = ks + 1, ke
        u_at_wh = torch.zeros_like(u)
        u_at_wh[lo:hi] = 0.5 * (u[lo - 1:hi - 1] + u[lo:hi])
        v_at_wh = torch.zeros_like(v)
        v_at_wh[lo:hi] = 0.5 * (v[lo - 1:hi - 1] + v[lo:hi])
        tx, ty = self._hterms(ip(u_at_wh), jp(v_at_wh), w)
        tw = tx[lo:hi] * dxi + ty[lo:hi] * dyi
        velw_c = i2(w[ks:ke], w[ks + 1:ke + 1])
        Xc, Uc = self._w_center_ladder(w, ks, ke)
        rho_c = ctx.rhoref[ks:ke][:, None, None]
        rhh = ctx.rhorefh[lo:hi][:, None, None]
        dzhi = ctx.dzhi[lo:hi][:, None, None]
        Fc = rho_c * velw_c * Xc
        tw = tw - (Fc[1:] - Fc[:-1]) / rhh * dzhi
        if self.scheme in UPWIND:
            Gc = rho_c * torch.abs(velw_c) * Uc
            tw = tw + (Gc[1:] - Gc[:-1]) / rhh * dzhi
        return tu, tv, tw

    def scalar(self, ctx, s, name):
        """The interior advection tendency of one scalar (Koren-limited
        when it is in fluxlimit_list)."""
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"], s["v"], s["w"]
        a = s[name]
        if name in self.fluxlimit_list:
            return advec_s_lim(ctx, a, u, v, w)
        tx, ty = self._hterms(ip(u), jp(v), a)
        return (tx[ks:ke] * ctx.dxi + ty[ks:ke] * ctx.dyi
                + self._vterm(ctx, w[ks:ke + 1], a))

    def exec(self, ctx, s, t, aux):
        """Add the advection tendencies into t, in place on the interior."""
        ks, ke = ctx.ks, ctx.ke
        tu, tv, tw = self.momentum(ctx, s)
        t["u"][ks:ke] += tu
        t["v"][ks:ke] += tv
        t["w"][ks + 1:ke] += tw
        for name in ctx.scalar_names:
            t[name][ks:ke] += self.scalar(ctx, s, name)
        return t

    def cfl_max(self, ctx, s):
        """The scheme's own CFL rate (advec_2i5.cxx:89-143,
        advec_2i53.cxx:83-113, advec_2i4.cxx:69-99, advec_2i62.cxx:94-96):
        |u|, |v| interpolated to the centres at the scheme's horizontal
        order, |w| by its vertical ladder."""
        ks, ke = ctx.ks, ctx.ke
        kt = ke - ks
        u, v, w = s["u"][ks:ke], s["v"][ks:ke], s["w"]
        if self.scheme == "2i4":
            uc = fd.ci0 * im(u) + fd.ci1 * u + fd.ci2 * ip(u) + fd.ci3 * ip(u, 2)
            vc = fd.ci0 * jm(v) + fd.ci1 * v + fd.ci2 * jp(v) + fd.ci3 * jp(v, 2)
        else:
            uc = ip(i6h_x(u))
            vc = jp(i6h_y(v))
        wc = i2(w[ks:ke], w[ks + 1:ke + 1])
        if self.scheme == "2i4" and kt > 2:
            wc[1:kt - 1] = fd.interp4c(w[ks:ke - 2], w[ks + 1:ke - 1],
                                       w[ks + 2:ke], w[ks + 3:ke + 1])
        elif self.scheme == "2i53" and kt > 2:
            wc[1:kt - 1] = _i4ws(w, ks + 2, ke)
        elif self.scheme == "2i5":
            if kt > 2:
                wc[1] = fd.interp4_ws(w[ks], w[ks + 1], w[ks + 2], w[ks + 3])
                wc[kt - 2] = fd.interp4_ws(w[ke - 3], w[ke - 2], w[ke - 1], w[ke])
            if kt > 4:
                wc[2:kt - 2] = _i6(w, ks + 3, ke - 1)
        c = (torch.abs(uc) * ctx.dxi + torch.abs(vc) * ctx.dyi
             + torch.abs(wc) * ctx.dzi[ks:ke][:, None, None])
        return torch.max(c)


class Advec2i4(AdvecInterp):
    scheme = "2i4"


class Advec2i5(AdvecInterp):
    scheme = "2i5"


class Advec2i62(AdvecInterp):
    scheme = "2i62"


class Advec2i53(AdvecInterp):
    scheme = "2i53"


CLASSES = {c.scheme: c for c in (Advec2i4, Advec2i5, Advec2i62, Advec2i53)}
