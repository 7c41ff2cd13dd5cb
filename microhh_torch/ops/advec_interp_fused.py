"""Hand-kernel form of the interpolated advection schemes 2i4 / 2i5 / 2i53 /
2i62 (counterpart of ``microhh_tpu/ops/advec_interp_pallas.py``).

The op path (ops/advec_interp.py) builds the face values, the upwind parts,
the vertical ladders and the flux divergences as separate field-sized
tensors.  The two kernels here add the scheme's whole tendency into the RK
carry in one pass per field group:

* K12 ``AdvecInterpFused.momentum`` - tu, tv, tw += advection of u, v, w
  (``csrc/advec_interp.cu``);
* K13 ``AdvecInterpFused.scalars``  - every non-limited scalar's carry +=
  its advection, u, v, w read once for all of them.

The vertical ladder (2nd / 4th-WS / 6th order from the walls inward,
advec_2i5.cxx:197-610) is a per-level row of six tap weights, prescaled
with the density, applied to planes k-3..k+3 whose index is clamped to the
interior: the zero weights of the rows near a wall, not the ghost planes,
make the wall fluxes right, so one body serves every rung.
``build_interp_tables`` makes that (ktot+1, 27) table on the host in
float64; it bakes the base state's density in, so ``AdvecInterpFused``
rebuilds it whenever ``Context.refresh_basestate`` has changed the density.

Scalars in ``fluxlimit_list`` (Koren fluxes) stay on the op path.  On a CPU
tensor the wrappers run the plain-torch versions in this module.
"""

import ctypes

import numpy as np
import torch

from .. import fd
from ..kernels import Kernel, check, on_cpu
from . import kmarch
from .advec_interp import UPWIND, advec_s_lim
from .fused import _planes

# table columns, shared with csrc/advec_interp.cu: face weights of the
# centred and the upwind part (6 each), the w equation's centre weights
# (6 + 6), then per-level factors
WXF, WUF, WXC, WUC = 0, 6, 12, 18
RCDZI, RHDZHI, WMASK, NC = 24, 25, 26, 27

SCHEME_ID = {"2i4": 0, "2i5": 1, "2i53": 2, "2i62": 3}


def build_interp_tables(scheme, ks, ke, rhoref, rhorefh, dzi, dzhi):
    """The per-level ladder weights, density-prescaled, as float64
    (ktot + 1, NC).

    Row m of the face tables holds the 6 taps (d = -3..+2 relative to the
    half level) of the transported quantity's interpolation at half level
    m (m = 0..kt, walls zero), times rhorefh[m].  Row c of the centre
    tables holds the 6 taps (d = -2..+3) of the w ladder at centre c, times
    rhoref[c].  Mirrors advec_interp._zh_ladder and the w-centre ladder,
    the small-kt guards included."""
    kt = ke - ks
    cc = np.zeros((kt + 1, NC), dtype=np.float64)
    WXf = np.zeros((kt + 1, 6))   # taps d=-3..2 -> col d+3
    WUf = np.zeros((kt + 1, 6))

    def setf(W, m, taps):
        W[m, :] = 0.
        for d, w in taps.items():
            W[m, d + 3] = w

    i2f = {-1: .5, 0: .5}
    i4f = {-2: fd.ci0, -1: fd.ci1, 0: fd.ci2, 1: fd.ci3}
    i4wsf = {-2: -1. / 12., -1: 7. / 12., 0: 7. / 12., 1: -1. / 12.}
    i3wsf = {-2: 1. / 12., -1: -3. / 12., 0: 3. / 12., 1: -1. / 12.}
    i6f = {-3: 1. / 60., -2: -8. / 60., -1: 37. / 60.,
           0: 37. / 60., 1: -8. / 60., 2: 1. / 60.}
    i5f = {-3: -1. / 60., -2: 5. / 60., -1: -10. / 60.,
           0: 10. / 60., 1: -5. / 60., 2: 1. / 60.}

    if scheme == "2i62":
        for m in range(1, kt):
            setf(WXf, m, i2f)
    elif scheme == "2i53":
        setf(WXf, 1, i2f)
        setf(WXf, kt - 1, i2f)
        if kt > 3:
            for m in range(2, kt - 1):
                setf(WXf, m, i4wsf)
                setf(WUf, m, i3wsf)
    elif scheme == "2i4":
        setf(WXf, 1, i2f)
        setf(WXf, kt - 1, i2f)
        if kt > 3:
            for m in range(2, kt - 1):
                setf(WXf, m, i4f)
    elif scheme == "2i5":
        setf(WXf, 1, i2f)
        setf(WXf, kt - 1, i2f)
        if kt > 3:
            setf(WXf, 2, i4wsf)
            setf(WUf, 2, i3wsf)
            setf(WXf, kt - 2, i4wsf)
            setf(WUf, kt - 2, i3wsf)
        if kt > 5:
            for m in range(3, kt - 2):
                setf(WXf, m, i6f)
                setf(WUf, m, i5f)
    else:
        raise ValueError(scheme)

    # centre (w equation) tables, taps d=-2..3 -> col d+2
    WXc = np.zeros((kt + 1, 6))
    WUc = np.zeros((kt + 1, 6))

    def setc(W, c, taps):
        W[c, :] = 0.
        for d, w in taps.items():
            W[c, d + 2] = w

    i2c = {0: .5, 1: .5}
    i4c = {-1: fd.ci0, 0: fd.ci1, 1: fd.ci2, 2: fd.ci3}
    i4wsc = {-1: -1. / 12., 0: 7. / 12., 1: 7. / 12., 2: -1. / 12.}
    i3wsc = {-1: 1. / 12., 0: -3. / 12., 1: 3. / 12., 2: -1. / 12.}
    i6c = {-2: 1. / 60., -1: -8. / 60., 0: 37. / 60.,
           1: 37. / 60., 2: -8. / 60., 3: 1. / 60.}
    i5c = {-2: -1. / 60., -1: 5. / 60., 0: -10. / 60.,
           1: 10. / 60., 2: -5. / 60., 3: 1. / 60.}

    setc(WXc, 0, i2c)
    setc(WXc, kt - 1, i2c)
    if scheme == "2i62":
        for c in range(1, kt - 1):
            setc(WXc, c, i2c)
    elif scheme == "2i53":
        if kt > 2:
            for c in range(1, kt - 1):
                setc(WXc, c, i4wsc)
                setc(WUc, c, i3wsc)
    elif scheme == "2i4":
        if kt > 2:
            for c in range(1, kt - 1):
                setc(WXc, c, i4c)
    else:  # 2i5
        if kt > 2:
            setc(WXc, 1, i4wsc)
            setc(WUc, 1, i3wsc)
            setc(WXc, kt - 2, i4wsc)
            setc(WUc, kt - 2, i3wsc)
        if kt > 4:
            for c in range(2, kt - 2):
                setc(WXc, c, i6c)
                setc(WUc, c, i5c)

    rho = np.asarray(rhoref, dtype=np.float64)
    rhoh = np.asarray(rhorefh, dtype=np.float64)
    dzi = np.asarray(dzi, dtype=np.float64)
    dzhi = np.asarray(dzhi, dtype=np.float64)
    for m in range(kt + 1):
        WXf[m] *= rhoh[ks + m]
        WUf[m] *= rhoh[ks + m]
    for c in range(kt):
        WXc[c] *= rho[ks + c]
        WUc[c] *= rho[ks + c]

    cc[:, WXF:WXF + 6] = WXf
    cc[:, WUF:WUF + 6] = WUf
    cc[:, WXC:WXC + 6] = WXc
    cc[:, WUC:WUC + 6] = WUc
    for k in range(kt):
        cc[k, RCDZI] = dzi[ks + k] / rho[ks + k]
        cc[k, RHDZHI] = dzhi[ks + k] / rhoh[ks + k]
        cc[k, WMASK] = 0. if k == 0 else 1.
    return cc


# ==========================================================================
#  plain-torch versions of the kernels
# ==========================================================================

def _hface(scheme, q, dim):
    """Left-face value (and upwind part or None) at -1/2 along dim."""
    def r(n):
        return torch.roll(q, n, dims=dim)

    if scheme == "2i4":
        return fd.ci0 * r(2) + fd.ci1 * r(1) + fd.ci2 * q + fd.ci3 * r(-1), None
    c = ((37. / 60.) * (r(1) + q) - (8. / 60.) * (r(2) + r(-1))
         + (1. / 60.) * (r(3) + r(-2)))
    if scheme not in UPWIND:
        return c, None
    u = ((10. / 60.) * (q - r(1)) - (5. / 60.) * (r(-1) - r(2))
         + (1. / 60.) * (r(-2) - r(3)))
    return c, u


def _hterms(scheme, velRx, velRy, q, dxi, dyi):
    """Horizontal flux divergence (+ upwind) from the RIGHT-face advecting
    velocities."""
    out = 0.
    for vel, dim, d in ((velRx, -1, dxi), (velRy, -2, dyi)):
        qf, uf = _hface(scheme, q, dim)
        F = vel * torch.roll(qf, -1, dims=dim)
        term = -(F - torch.roll(F, 1, dims=dim))
        if uf is not None:
            G = torch.abs(vel) * torch.roll(uf, -1, dims=dim)
            term = term + (G - torch.roll(G, 1, dims=dim))
        out = out + term * d
    return out


def _wsum(rows, base, planes):
    """sum_j rows[:, base + j] * planes[j] over the 6 taps."""
    acc = rows[:, base][:, None, None] * planes[0]
    for j in range(1, 6):
        acc = acc + rows[:, base + j][:, None, None] * planes[j]
    return acc


def _vterm_c(scheme, cc, planes, wf0, wf1):
    """Vertical flux divergence of a cell-centred quantity: faces k (wf0)
    and k+1 (wf1); planes = q at k-3..k+3."""
    kt = cc.shape[0] - 1
    lo, hi = cc[:kt], cc[1:]
    adv = -(wf1 * _wsum(hi, WXF, planes[1:7]) - wf0 * _wsum(lo, WXF, planes[0:6]))
    if scheme in UPWIND:
        adv = adv + (torch.abs(wf1) * _wsum(hi, WUF, planes[1:7])
                     - torch.abs(wf0) * _wsum(lo, WUF, planes[0:6]))
    return adv * lo[:, RCDZI][:, None, None]


def _window(a, ks, kt, hi):
    """Planes k-3..k+3 of a for the interior k, each index clamped to
    [ks, hi]."""
    return [_planes(a, ks, kt, off, ks, hi) for off in range(-3, 4)]


def _roll(a, n, dim):
    return torch.roll(a, n, dims=dim)


def momentum_plain(scheme, u, v, w, tu, tv, tw, cc, ks, dxi, dyi):
    """K12 in plain torch: tu, tv, tw (kcells, jtot, itot) gain the
    advection of u, v, w on their interior planes, in place."""
    kt = cc.shape[0] - 1
    ke = ks + kt
    U = _window(u, ks, kt, ke - 1)
    V = _window(v, ks, kt, ke - 1)
    W = _window(w, ks, kt, ke)
    u0, v0, w0 = U[3], V[3], W[3]
    um1, vm1, wm1, wp1 = U[2], V[2], W[2], W[4]

    velRx = 0.5 * (u0 + _roll(u0, -1, -1))
    velRy = 0.5 * _roll(_roll(v0, 1, -1) + v0, -1, -2)
    add = _hterms(scheme, velRx, velRy, u0, dxi, dyi)
    wf0 = 0.5 * (_roll(w0, 1, -1) + w0)
    wf1 = 0.5 * (_roll(wp1, 1, -1) + wp1)
    tu[ks:ke] += add + _vterm_c(scheme, cc, U, wf0, wf1)

    velRx = _roll(0.5 * (_roll(u0, 1, -2) + u0), -1, -1)
    velRy = 0.5 * (v0 + _roll(v0, -1, -2))
    add = _hterms(scheme, velRx, velRy, v0, dxi, dyi)
    wf0 = 0.5 * (_roll(w0, 1, -2) + w0)
    wf1 = 0.5 * (_roll(wp1, 1, -2) + wp1)
    tv[ks:ke] += add + _vterm_c(scheme, cc, V, wf0, wf1)

    # w at half level k; k = 0 is the wall (masked)
    velRx = _roll(0.5 * (um1 + u0), -1, -1)
    velRy = _roll(0.5 * (vm1 + v0), -1, -2)
    add = _hterms(scheme, velRx, velRy, w0, dxi, dyi)
    velw0 = 0.5 * (wm1 + w0)
    velw1 = 0.5 * (w0 + wp1)
    rows = cc[:kt]
    rows0 = torch.cat([cc[:1], cc[:kt - 1]])    # row max(k-1, 0)
    adv = -(velw1 * _wsum(rows, WXC, W[1:7]) - velw0 * _wsum(rows0, WXC, W[0:6]))
    if scheme in UPWIND:
        adv = adv + (torch.abs(velw1) * _wsum(rows, WUC, W[1:7])
                     - torch.abs(velw0) * _wsum(rows0, WUC, W[0:6]))
    add = add + adv * rows[:, RHDZHI][:, None, None]
    tw[ks:ke] += add * rows[:, WMASK][:, None, None]


def scalars_plain(scheme, u, v, w, fields, carries, cc, ks, dxi, dyi):
    """K13 in plain torch: each carry gains the advection of its scalar on
    the interior planes, in place."""
    kt = cc.shape[0] - 1
    ke = ks + kt
    velRx = _roll(u[ks:ke], -1, -1)
    velRy = _roll(v[ks:ke], -1, -2)
    w0, w1 = w[ks:ke], w[ks + 1:ke + 1]
    for a, ta in zip(fields, carries):
        A = _window(a, ks, kt, ke - 1)
        ta[ks:ke] += (_hterms(scheme, velRx, velRy, A[3], dxi, dyi)
                      + _vterm_c(scheme, cc, A, w0, w1))


# ==========================================================================
#  kernel wrappers
# ==========================================================================

def max_scalars(dtype):
    """The most scalars one K13 launch takes: its scalar count is a template
    parameter up to MAXA, and their rings must fit one block's shared
    memory (csrc/advec_interp.cu k13_smem)."""
    return max(S for S in range(1, kmarch.K13_MAXS + 1)
               if kmarch.k13_smem(S, dtype) <= kmarch.SMEM_MAX)


class AdvecInterpFused:
    """K12 and K13 for one scheme instance and grid."""

    def __init__(self, advec, ctx):
        self.advec = advec
        self.scheme = advec.scheme
        self.ctx = ctx
        self._cc = None
        self._cc_version = None
        self.k_mom = Kernel("advec_mom", "microhh_torch/csrc/advec_interp.cu",
                            "microhh_tpu/ops/advec_interp_pallas.py:379")
        self.k_scal = Kernel("advec_scalars",
                             "microhh_torch/csrc/advec_interp.cu",
                             "microhh_tpu/ops/advec_interp_pallas.py:403")

    def table(self):
        """The weight table on the device, rebuilt when the base state's
        density has changed since it was made."""
        ctx = self.ctx
        if self._cc_version != ctx.basestate_version:
            self._cc = ctx.tensor(build_interp_tables(
                self.scheme, ctx.ks, ctx.ke, ctx.np_rhoref, ctx.np_rhorefh,
                ctx.np_dzi, ctx.np_dzhi))
            self._cc_version = ctx.basestate_version
        return self._cc

    def mom_plan(self, dtype, chunks=None):
        """The k-march of one K12 launch (ops/kmarch.py), the chunk count
        chosen from the card's resident blocks unless given."""
        ctx = self.ctx
        info = self.k_mom.info(dtype, SCHEME_ID[self.scheme])
        return kmarch.plan("advec_mom", ctx.itot, ctx.jtot, ctx.ktot, 0,
                           dtype, info["blocks_per_sm"] * info["sms"], chunks)

    def momentum(self, u, v, w, tu, tv, tw, chunks=None):
        """K12: tu, tv, tw += advection of u, v, w, in place.  chunks: force
        the k-split (checks and timings only)."""
        ctx = self.ctx
        cc = self.table()
        if on_cpu(u):
            return momentum_plain(self.scheme, u, v, w, tu, tv, tw, cc,
                                  ctx.ks, ctx.dxi, ctx.dyi)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        check((u, v, w, tu, tv, tw, cc), u.dtype, u.device,
              [shape] * 6 + [(ctx.ktot + 1, NC)])
        self.k_mom(u.dtype, u, v, w, tu, tv, tw, cc, ctx.itot, ctx.jtot,
                   ctx.ktot, ctx.ks, SCHEME_ID[self.scheme], ctx.dxi, ctx.dyi,
                   self.mom_plan(u.dtype, chunks).chunks)

    def plan(self, S, dtype, chunks=None):
        """The k-march of one K13 launch of S scalars (ops/kmarch.py), the
        chunk count chosen from the card's resident blocks unless given."""
        ctx = self.ctx
        info = self.k_scal.info(dtype, SCHEME_ID[self.scheme], S)
        return kmarch.plan("advec_scalars", ctx.itot, ctx.jtot, ctx.ktot, S,
                           dtype, info["blocks_per_sm"] * info["sms"], chunks)

    def scalars(self, u, v, w, fields, carries, chunks=None):
        """K13: carries[n] += advection of fields[n], in place; the scalars
        go max_scalars at a time.  chunks: force the k-split (checks and
        timings only)."""
        ctx = self.ctx
        cc = self.table()
        if on_cpu(u):
            return scalars_plain(self.scheme, u, v, w, fields, carries, cc,
                                 ctx.ks, ctx.dxi, ctx.dyi)
        shape = (ctx.kcells, ctx.jtot, ctx.itot)
        check([u, v, w] + list(fields) + list(carries) + [cc], u.dtype,
              u.device, [shape] * (3 + 2 * len(fields)) + [(ctx.ktot + 1, NC)])
        per = max_scalars(u.dtype)
        for i0 in range(0, len(fields), per):
            grp_a, grp_t = fields[i0:i0 + per], carries[i0:i0 + per]
            S = len(grp_a)

            def ptrs(arrays):
                return (ctypes.c_void_p * S)(*[a.data_ptr() for a in arrays])

            self.k_scal(u.dtype, u, v, w, ptrs(grp_a), ptrs(grp_t), S, cc,
                        ctx.itot, ctx.jtot, ctx.ktot, ctx.ks,
                        SCHEME_ID[self.scheme], ctx.dxi, ctx.dyi,
                        self.plan(S, u.dtype, chunks).chunks)

    def exec(self, ctx, s, t, aux):
        """Add the scheme's tendencies into the carry t, in place:
        momentum through K12, the non-limited scalars through K13, the
        Koren-limited ones through the op path."""
        u, v, w = s["u"], s["v"], s["w"]
        self.momentum(u, v, w, t["u"], t["v"], t["w"])
        limited = self.advec.fluxlimit_list
        names = [n for n in ctx.scalar_names if n not in limited]
        if names:
            self.scalars(u, v, w, [s[n] for n in names], [t[n] for n in names])
        for n in ctx.scalar_names:
            if n in limited:
                t[n][ctx.ks:ctx.ke] += advec_s_lim(ctx, s[n], u, v, w)
        return t
