"""Deep-neural-network subgrid-stress diffusion (``microhh_tpu/ops/diff_dnn.py``;
reference ``src/diff_dnn_local.cxx``, ``diff_dnn_global.cxx``,
``diff_dnn_stats.cxx``): the three normalisations of the CNN closure for
stably stratified boundary layers.

Per substep:

1. the Smagorinsky eddy viscosity, for the scalars' diffusion and the
   diffusion number (diff_dnn_local.cxx:1689-1840): K14 (or K1 in the moist
   N2 form) with its MOST row, ``ops/fused.py generic_viscosity``, through
   ``self.fused``, which ``Model.build_step`` sets;
2. u, v, w destaggered to the cell centres and, with the buoyancy, put
   through the 27-point top-hat filter (:422-614); dnn_local's Taylor
   estimates TKEh, TKEv and TPE (:615-810);
3. the 3x3x3 patch of the four filtered fields at every point of levels
   ks+1 .. kendBL-2 (kendBL = ks + 3/4 ktot), less its mean and scaled by
   the variant's normaliser, in the reference's channel order (:813-889);
   the network (models/dnn.py) on it (:891-894); the six stresses
   denormalised, less their trace with ``swdeviatoric`` (:896-939);
4. the stresses spread to their faces with the surface fluxes blended in
   (set_flux, :942-1030) and the tendencies -dTau_ij/dx_j (:1060-1210),
   the molecular diffusion of momentum (:1662-1676), and the scalars'
   Smagorinsky diffusion.

All but the eddy viscosity run as plain torch on the run's device, as the
JAX package runs them in XLA; the network's products are ``torch.matmul``
(the JAX package computes them outside any Pallas kernel).  The patches
and the network run over blocks of levels, ``BLOCK_POINTS`` points a block:
the whole 108-channel stack of a 256^3 grid would be 5.4 GB in float32.
A point's result does not depend on its block.
"""

import math

import torch

from ..models.dnn import TauDNN
from .diff_2 import diff_c as molecular_diff_c, diff_w as molecular_diff_w
from .diff_smag2 import DiffSmag2
from .fused import generic_viscosity
from .stencil import im, ip, jm, jp

DSMALLER = 1.e-16   # Constants::dsmaller (constants.h:96)
DTINY = 1.e-30      # Constants::dtiny (constants.h:95)

# points of one block of levels of the patches and the network: the inputs
# and two layers' activations take about 1 KB a point in float32
BLOCK_POINTS = 1 << 21

# the first of the 9 inputs (ix, iy) of each field's level iz among the 108
# inputs, in the order of the reference's x[n, 12, 3, 3] flattened: channels
# u(-1), v(-1), u(0), v(0), u(1), v(1), w(-1), w(0), w(1), b(-1), b(0), b(1)
# (diff_dnn_local.cxx:870-886)
FIRST_ROW = {("u", -1): 0, ("v", -1): 9, ("u", 0): 18, ("v", 0): 27,
             ("u", 1): 36, ("v", 1): 45, ("w", -1): 54, ("w", 0): 63,
             ("w", 1): 72, ("b", -1): 81, ("b", 0): 90, ("b", 1): 99}


def _hsum9(a):
    row = im(a) + a + ip(a)
    return jm(row) + row + jp(row)


def _interior(like, ks, ke, values):
    """A field of like's shape: values on ks..ke-1, zero on the ghost
    levels (the reference's zero-initialised diagnostic fields)."""
    out = torch.zeros_like(like)
    out[ks:ke] = values
    return out


def _col(arr, lo, hi):
    return arr[lo:hi][:, None, None]


def _fill_patches(x, name, a, k0, k1):
    """Write field ``name`` = a at the 27 offsets (iz, ix, iy) of each point
    of levels k0 .. k1-1 into its rows of the inputs x (108, k1 - k0,
    jtot, itot): a's levels k0-1 .. k1, padded periodically by one point in
    j and i, give each offset as a view."""
    nk, nj, ni = x.shape[1:]
    pad = torch.nn.functional.pad(a[k0 - 1:k1 + 1][None], (1, 1, 1, 1),
                                  mode="circular")[0]
    for iz in (-1, 0, 1):
        row = FIRST_ROW[name, iz]
        for ix in (-1, 0, 1):
            for iy in (-1, 0, 1):
                x[row + 3 * (ix + 1) + iy + 1] = pad[
                    1 + iz:1 + iz + nk, 1 + iy:1 + iy + nj, 1 + ix:1 + ix + ni]


def _rows(x, name):
    """The 27 rows of field ``name`` in the inputs x, a (3, 9, ...) view."""
    if name in ("u", "v"):
        first = FIRST_ROW[name, -1]
        return x[first:first + 45].unflatten(0, (5, 9))[0::2]
    return x[FIRST_ROW[name, -1]:FIRST_ROW[name, 1] + 9].unflatten(0, (3, 9))


class DiffDNN:
    def __init__(self, ini, grid, fields, boundary, variant="dnn_local"):
        self.variant = variant
        self.smag = DiffSmag2(ini, grid, fields, boundary)
        self.dnmax = self.smag.dnmax
        self.tPr = self.smag.tPr
        self.visc = fields.visc
        self.viscs = self.smag.viscs
        self.swdeviatoric = ini.get_bool("diff", "swdeviatoric", default=True)
        # [diff] ce (diff_dnn_local.cxx:1446): the coefficient of the
        # TKE-based eddy viscosity whose call site is commented out upstream
        # (:1807-1817); read for ini parity, unused like the reference
        self.ce = ini.get_float("diff", "ce", default=0.15)
        dnnpath = ini.get_str("diff", "dnnpath", default="")
        allow_random = ini.get_bool("diff", "swdnnrandom", default=False)
        self.net = TauDNN.load(dnnpath, allow_random=allow_random)
        if not getattr(boundary, "is_surface", False):
            raise NotImplementedError("diff_dnn currently requires "
                                      "swboundary=surface")
        if variant == "dnn_global":
            # diff_dnn_global.cxx:1247-1259
            Re = ini.get_float("diff", "Re", default=20000.0)
            Ug = ini.get_float("diff", "Ug", default=0.05)
            b0 = ini.get_float("diff", "b0", default=-0.0044)
            self.ivel_scale = math.sqrt(Re) / Ug
            self.stress_scale = Ug * Ug / Re
            self.ib_scale = 1.0 / (0. - b0)
        elif variant == "dnn_stats":
            # diff_dnn_stats.cxx:1250-1262
            self.iuvStd = 1.0 / ini.get_float("diff", "uvStd", default=1.0)
            self.iwStd = 1.0 / ini.get_float("diff", "wStd", default=1.0)
            self.ibStd = 1.0 / ini.get_float("diff", "bStd", default=1.0)
            self.ThStd = ini.get_float("diff", "ThStd", default=1.0)
            self.Ti3Std = ini.get_float("diff", "Ti3Std", default=1.0)
            self.T33Std = ini.get_float("diff", "T33Std", default=1.0)
        self._thermo = None
        # the eddy viscosity's kernels (ops/fused.py FusedGeneric), set by
        # Model.build_step with the run's Context
        self.fused = None

    @property
    def thermo(self):
        return self._thermo

    @thermo.setter
    def thermo(self, value):
        self._thermo = value
        self.smag.thermo = value

    def bind(self, fused):
        """Take the eddy viscosity's kernels and hold the network in the
        run's dtype on its device."""
        self.fused = fused
        self.net = self.net.to(device=fused.ctx.device, dtype=fused.ctx.dtype)

    def kendBL(self, ctx):
        return ctx.ks + (3 * ctx.ktot) // 4

    # ------------------------------------------------------------------
    def _box_filter(self, ctx, a, lo):
        """27-point top-hat from level lo+1 up, 9-point at level lo, zero
        elsewhere (the reference's zero-initialised fields); a is zero
        above the interior."""
        ke = ctx.ke
        h = _hsum9(a[lo:ke + 1])
        out = torch.zeros_like(a)
        out[lo] = h[0] / 9.
        out[lo + 1:ke] = (h[:-2] + h[1:-1] + h[2:]) / 27.
        return out

    def exec_viscosity(self, ctx, s, sfc, aux):
        """aux with the eddy viscosity ('evisc', K14) and the stresses
        ('Tau', (6, kendBL - ks - 2, jtot, itot))."""
        aux = generic_viscosity(self.fused, ctx, s, sfc, aux)
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"], s["v"], s["w"]
        # the cell-centre fields, zero on the ghost levels
        uc = _interior(u, ks, ke, 0.5 * (u[ks:ke] + ip(u[ks:ke])))
        vc = _interior(v, ks, ke, 0.5 * (v[ks:ke] + jp(v[ks:ke])))
        wc = _interior(u, ks, ke, 0.5 * (w[ks:ke] + w[ks + 1:ke + 1]))
        b = _interior(u, ks, ke, self._thermo.get_buoyancy(ctx, s)[ks:ke])

        uf = self._box_filter(ctx, uc, ks)
        vf = self._box_filter(ctx, vc, ks)
        wf = self._box_filter(ctx, wc, ks)
        bf = self._box_filter(ctx, b, ks)

        if self.variant == "dnn_local":
            # Taylor-estimate energies (diff_dnn_local.cxx:615-810)
            lo = ks + 1
            ucl, vcl, wcl = uc[lo:ke], vc[lo:ke], wc[lo:ke]
            dk2 = lambda a: (a[ks + 2:ke + 1] - a[ks:ke - 1]) ** 2
            tkeh = _interior(u, lo, ke, (
                0.25 * ((ip(ucl) - im(ucl)) ** 2 + (ip(vcl) - im(vcl)) ** 2
                        + (jp(ucl) - jm(ucl)) ** 2 + (jp(vcl) - jm(vcl)) ** 2)
                + 0.25 * (dk2(uc) + dk2(vc))))
            tkehf = self._box_filter(ctx, tkeh, lo)
            tkev = _interior(u, lo, ke, (
                0.25 * ((ip(wcl) - im(wcl)) ** 2 + (jp(wcl) - jm(wcl)) ** 2)
                + 0.25 * dk2(wc)))
            tkevf = self._box_filter(ctx, tkev, lo)
            bfl = bf[lo:ke]
            n2loc = ((bf[ks + 2:ke + 1] - bf[ks:ke - 1])
                     / (ctx.z[ks + 2:ke + 1] - ctx.z[ks:ke - 1])[:, None, None])
            tpe = _interior(u, lo, ke, (
                0.25 * ((ip(bfl) - im(bfl)) ** 2 + (jp(bfl) - jm(bfl)) ** 2)
                + 0.25 * dk2(bf)) / n2loc)
        else:
            tkeh = tkev = tkehf = tkevf = tpe = None

        aux = dict(aux)
        aux["Tau"] = self._calc_tau(ctx, uf, vf, wf, bf, tkeh, tkev, tkehf,
                                    tkevf, tpe)
        return aux

    def _calc_tau(self, ctx, uf, vf, wf, bf, tkeh, tkev, tkehf, tkevf, tpe,
                  block=None):
        """Tau (6, nk, jtot, itot) on levels ks+1 .. kendBL-2, computed over
        blocks of ``block`` levels (by default BLOCK_POINTS points)."""
        lo, hi = ctx.ks + 1, self.kendBL(ctx) - 1
        if block is None:
            block = max(1, BLOCK_POINTS // (ctx.jtot * ctx.itot))
        tau = torch.empty((6, hi - lo, ctx.jtot, ctx.itot), dtype=uf.dtype,
                          device=uf.device)
        for k0 in range(lo, hi, block):
            k1 = min(k0 + block, hi)
            tau[:, k0 - lo:k1 - lo] = self._tau_block(
                ctx, k0, k1, uf, vf, wf, bf, tkeh, tkev, tkehf, tkevf, tpe)
        return tau

    def _normalisers(self, ctx, k0, k1, tkeh, tkev, tpe):
        """The scales of u, v, w and b of the variant (diff_dnn_*.cxx
        calc_Tau): per point for dnn_local, constants otherwise."""
        if self.variant == "dnn_local":
            rootki = (tkeh[k0:k1] + tkev[k0:k1] + DSMALLER) ** -0.5
            rootkvi = (tkev[k0:k1] + DSMALLER) ** -0.5
            bscalei = _col(ctx.dz, k0, k1) / (tpe[k0:k1] + DTINY)
            return rootki, rootki, rootkvi, bscalei
        if self.variant == "dnn_global":
            return (self.ivel_scale,) * 3 + (self.ib_scale,)
        return self.iuvStd, self.iuvStd, self.iwStd, self.ibStd

    def _tau_block(self, ctx, k0, k1, uf, vf, wf, bf, tkeh, tkev, tkehf,
                   tkevf, tpe):
        """The six stresses at levels k0 .. k1-1: (6, k1 - k0, jtot,
        itot)."""
        scales = self._normalisers(ctx, k0, k1, tkeh, tkev, tpe)
        shape = (k1 - k0, ctx.jtot, ctx.itot)
        # each field's 27 values less their mean, times its scale
        x = uf.new_empty((108,) + shape)
        for name, a, sc in zip("uvwb", (uf, vf, wf, bf), scales):
            _fill_patches(x, name, a, k0, k1)
            rows = _rows(x, name)
            rows.sub_(rows.mean(dim=(0, 1))).mul_(sc)
        tau = self.net(x.reshape(108, -1).T).T.reshape((6,) + shape)

        # denormalisation (diff_dnn_local.cxx:896-939 and the variants')
        if self.variant == "dnn_local":
            ktot_e = tkehf[k0:k1] + tkevf[k0:k1]
            kv = tkevf[k0:k1]
            rootkkv = torch.sqrt(ktot_e * kv)
            t11 = tau[0] * ktot_e
            t12 = tau[1] * ktot_e
            t13 = tau[2] * rootkkv
            t22 = tau[3] * ktot_e
            t23 = tau[4] * rootkkv
            t33 = tau[5] * kv
            if self.swdeviatoric:
                third = (tau[0] * ktot_e + tau[3] * ktot_e + tau[5] * kv) / 3.
                t11 = t11 - third
                t22 = t22 - third
                t33 = t33 - third
        elif self.variant == "dnn_global":
            sc = self.stress_scale
            if self.swdeviatoric:
                third = (tau[0] + tau[3] + tau[5]) / 3.
                t11 = (tau[0] - third) * sc
                t22 = (tau[3] - third) * sc
                t33 = (tau[5] - third) * sc
            else:
                t11, t22, t33 = tau[0] * sc, tau[3] * sc, tau[5] * sc
            t12, t13, t23 = tau[1] * sc, tau[2] * sc, tau[4] * sc
        else:
            if self.swdeviatoric:
                third = ((tau[0] + tau[3]) * self.ThStd
                         + tau[5] * self.T33Std) / 3.
                t11 = tau[0] * self.ThStd - third
                t22 = tau[3] * self.ThStd - third
                t33 = tau[5] * self.T33Std - third
            else:
                t11 = tau[0] * self.ThStd
                t22 = tau[3] * self.ThStd
                t33 = tau[5] * self.T33Std
            t12 = tau[1] * self.ThStd
            t13 = tau[2] * self.Ti3Std
            t23 = tau[4] * self.Ti3Std
        return torch.stack([t11, t12, t13, t22, t23, t33])

    # ------------------------------------------------------------------
    def _set_flux(self, ctx, tau_k, dim, sfc):
        """One stress component on all levels, with the surface blending
        (diff_dnn_local.cxx set_flux, :942-1030)."""
        ks = ctx.ks
        kBL = self.kendBL(ctx)
        T = tau_k.new_zeros((ctx.kcells,) + tuple(tau_k.shape[1:]))
        T[ks + 1:kBL - 1] = tau_k
        z, zh = ctx.z, ctx.zh
        fac = (z[ks] - zh[ks]) / (z[ks + 1] - zh[ks])
        if dim == 2:
            fb = 0.5 * (sfc["u_fluxbot"] + ip(sfc["u_fluxbot"]))
            T[ks] = fb + fac * (T[ks + 1] - fb)
        elif dim == 4:
            fb = 0.5 * (sfc["v_fluxbot"] + jp(sfc["v_fluxbot"]))
            T[ks] = fb + fac * (T[ks + 1] - fb)
        else:
            T[ks] = fac * T[ks + 1]
        # zero-gradient top of the DNN region
        T[kBL - 1] = T[kBL - 2]
        T[kBL] = T[kBL - 1]
        return T

    def exec(self, ctx, s, t, aux, sfc):
        """t plus the closure's tendencies (new tensors)."""
        ks, ke = ctx.ks, ctx.ke
        kBL = self.kendBL(ctx)
        tau = aux["Tau"]
        T11, T12, T13, T22, T23, T33 = [self._set_flux(ctx, tau[c], c, sfc)
                                        for c in range(6)]
        dxi, dyi = ctx.dxi, ctx.dyi
        z, zh = ctx.z, ctx.zh
        ub, vb = sfc["u_fluxbot"], sfc["v_fluxbot"]
        t = dict(t)

        # ---- u (diff_dnn_local.cxx diff_u) ----
        dz2 = (z[ks + 2:kBL + 1] - z[ks:kBL - 1])[:, None, None]
        a11, a12 = T11[ks + 1:kBL], T12[ks + 1:kBL]
        c13 = T13 + im(T13)
        du = (-dxi * (a11 - im(a11))
              - 0.25 * dyi * (jp(a12) + im(jp(a12)) - jm(a12) - im(jm(a12)))
              - 0.5 * (c13[ks + 2:kBL + 1] - c13[ks:kBL - 1]) / dz2)
        b11, b12 = T11[ks], T12[ks]
        du_bot = (-dxi * (ip(b11) - b11)
                  - 0.25 * dyi * (jp(b12) + ip(jp(b12)) - jm(b12) - ip(jm(b12)))
                  - (0.5 * c13[ks + 1] - ub) / (z[ks + 1] - zh[ks]))
        tu = t["u"].clone()
        tu[ks + 1:kBL] += du
        tu[ks] += du_bot

        # ---- v ----
        c23 = T23 + jm(T23)
        a22 = T22[ks + 1:kBL]
        dv = (-0.25 * dxi * (ip(a12) + jm(ip(a12)) - im(a12) - jm(im(a12)))
              - dyi * (a22 - jm(a22))
              - 0.5 * (c23[ks + 2:kBL + 1] - c23[ks:kBL - 1]) / dz2)
        b22 = T22[ks]
        dv_bot = (-0.25 * dxi * (ip(b12) + jp(ip(b12)) - im(b12) - jp(im(b12)))
                  - dyi * (jp(b22) - b22)
                  - (0.5 * c23[ks + 1] - vb) / (z[ks + 1] - zh[ks]))
        tv = t["v"].clone()
        tv[ks + 1:kBL] += dv
        tv[ks] += dv_bot

        # ---- w, half levels ks+1 .. kBL-1 ----
        dzw = (z[ks + 1:kBL] - z[ks:kBL - 1])[:, None, None]
        up13, lo13 = T13[ks + 1:kBL], T13[ks:kBL - 1]
        up23, lo23 = T23[ks + 1:kBL], T23[ks:kBL - 1]
        dw = (-0.25 * dxi * (ip(up13) + ip(lo13) - im(up13) - im(lo13))
              - 0.25 * dyi * (jp(up23) + jp(lo23) - jm(up23) - jm(lo23))
              - (T33[ks + 1:kBL] - T33[ks:kBL - 1]) / dzw)
        tw = t["w"].clone()
        tw[ks + 1:kBL] += dw

        # ---- the scalars: the Smagorinsky diffusion with K14's viscosity
        t.update(self.smag.exec_scalars(ctx, s, t, aux, sfc))

        # ---- molecular diffusion of momentum (diff_dnn_local.cxx:1662-1676)
        tu[ks:ke] += molecular_diff_c(ctx, s["u"], self.visc)
        tv[ks:ke] += molecular_diff_c(ctx, s["v"], self.visc)
        tw[ks + 1:ke] += molecular_diff_w(ctx, s["w"], self.visc)
        t["u"], t["v"], t["w"] = tu, tv, tw
        return t
