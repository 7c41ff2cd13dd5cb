"""Monin-Obukhov similarity functions on (jtot, itot) surface planes
(``microhh_tpu/ops/most.py``; reference ``include/monin_obukhov.h``: Wilson
2001 unstable / IFS stable forms).

The Obukhov length comes either from the reference's z/L lookup table
(``boundary_surface_kernels.h:84-133``, searched with ``torch.searchsorted``)
or from the warm-started fixed-iteration Newton solve that the JAX package
uses by default.  Both are elementwise torch on the surface plane.
"""

import math

import numpy as np
import torch

from .. import constants as cst

NZL_LUT = 10000


def _log(x):
    return torch.log(x) if torch.is_tensor(x) else math.log(x)


# --- gradient functions ----------------------------------------------------

def phim_unstable(zeta):
    return (1. + 3.6 * torch.abs(zeta) ** (2. / 3.)) ** -0.5


def phim_stable(zeta):
    return 1. + 5. * zeta


def phim(zeta):
    return torch.where(zeta <= 0., phim_unstable(zeta), phim_stable(zeta))


def phih_unstable(zeta):
    return (1. + 7.9 * torch.abs(zeta) ** (2. / 3.)) ** -0.5


def phih_stable(zeta):
    return (1. + 4. * zeta) ** 2


def phih(zeta):
    return torch.where(zeta <= 0., phih_unstable(zeta), phih_stable(zeta))


# --- integrated functions --------------------------------------------------

def psim_unstable(zeta):
    return 3. * torch.log((1. + 1. / phim_unstable(zeta)) / 2.)


def psim_stable(zeta):
    a, b, c, d = 1., 2. / 3., 5., 0.35
    zeta = torch.clamp(zeta, min=0.)  # guard: only evaluated for zeta > 0
    return -b * (zeta - c / d) * torch.exp(-d * zeta) - a * zeta - (b * c) / d


def psih_unstable(zeta):
    return 3. * torch.log((1. + 1. / phih_unstable(zeta)) / 2.)


def psih_stable(zeta):
    a, b, c, d = 1., 2. / 3., 5., 0.35
    zeta = torch.clamp(zeta, min=0.)  # guard: only evaluated for zeta > 0
    return (-b * (zeta - c / d) * torch.exp(-d * zeta)
            - (1. + b * a * zeta) ** 1.5 - (b * c) / d + 1.)


def fm(zsl, z0m, L):
    """kappa / (log(zsl/z0m) - psim(zsl/L) + psim(z0m/L))."""
    unstable = cst.kappa / (_log(zsl / z0m) - psim_unstable(zsl / L)
                            + psim_unstable(z0m / L))
    stable = cst.kappa / (_log(zsl / z0m) - psim_stable(zsl / L)
                          + psim_stable(z0m / L))
    return torch.where(L <= 0., unstable, stable)


def fh(zsl, z0h, L):
    unstable = cst.kappa / (_log(zsl / z0h) - psih_unstable(zsl / L)
                            + psih_unstable(z0h / L))
    stable = cst.kappa / (_log(zsl / z0h) - psih_stable(zsl / L)
                          + psih_stable(z0h / L))
    return torch.where(L <= 0., unstable, stable)


# --- numpy versions for LUT construction -----------------------------------

def _np_psim(zeta):
    unst = 3. * np.log((1. + (1. + 3.6 * np.abs(zeta) ** (2. / 3.)) ** 0.5) / 2.)
    a, b, c, d = 1., 2. / 3., 5., 0.35
    zs = np.maximum(zeta, 0.)  # stable branch only evaluated for zeta > 0
    st = -b * (zs - c / d) * np.exp(-d * zs) - a * zs - (b * c) / d
    return np.where(zeta <= 0., unst, st)


def _np_psih(zeta):
    unst = 3. * np.log((1. + (1. + 7.9 * np.abs(zeta) ** (2. / 3.)) ** 0.5) / 2.)
    a, b, c, d = 1., 2. / 3., 5., 0.35
    zs = np.maximum(zeta, 0.)
    st = -b * (zs - c / d) * np.exp(-d * zs) - (1. + b * a * zs) ** 1.5 - (b * c) / d + 1.
    return np.where(zeta <= 0., unst, st)


def _np_fm(zsl, z0m, L):
    return cst.kappa / (np.log(zsl / z0m) - _np_psim(zsl / L) + _np_psim(z0m / L))


def _np_fh(zsl, z0h, L):
    return cst.kappa / (np.log(zsl / z0h) - _np_psih(zsl / L) + _np_psih(z0h / L))


def prepare_lut(z0m, z0h, zsl, mbcbot_dirichlet, thermobc_flux):
    """Build the (zL_sl, f_sl) lookup table exactly like the reference
    (boundary_surface_kernels.h:84-133): 9/10 of the points linear in
    [-zL_max, 5], last 1/10 geometrically stretched to -zL_min."""
    n = NZL_LUT
    zL_tmp = np.zeros(n)
    zLrange_min = -5.

    dzL = (cst.zL_max - zLrange_min) / (9. * n / 10. - 1.)
    zL_tmp[0] = -cst.zL_max
    for i in range(1, 9 * n // 10):
        zL_tmp[i] = zL_tmp[i - 1] + dzL

    zLend = -(cst.zL_min - zLrange_min)
    r, r0 = 1.01, cst.dhuge
    while abs((r - r0) / r0) > 1.e-10:
        r0 = r
        r = (1. - (zLend / dzL) * (1. - r)) ** (1. / (n / 10.))
    for i in range(9 * n // 10, n):
        zL_tmp[i] = zL_tmp[i - 1] + dzL
        dzL *= r

    zL_sl = -zL_tmp[::-1].copy()

    L = zsl / zL_sl
    if mbcbot_dirichlet and thermobc_flux:
        f_sl = zL_sl * _np_fm(zsl, z0m, L) ** 3
    elif mbcbot_dirichlet and not thermobc_flux:
        f_sl = zL_sl * _np_fm(zsl, z0m, L) ** 2 / _np_fh(zsl, z0h, L)
    else:
        raise ValueError("unsupported LUT combination")

    # f_sl is non-monotonic for very stable zL; the reference's linear
    # search walks to the table end there, returning zL_max.  A running max
    # makes searchsorted reproduce that clamping.
    f_sl = np.maximum.accumulate(f_sl)

    # float32 like the reference (it stores the LUT in float).
    return zL_sl.astype(np.float32), f_sl.astype(np.float32)


def lookup_zL(zL_sl, f_sl, Ri):
    """Vectorized find_zL (boundary_surface_kernels.h:246-260): f_sl is
    monotonically increasing; searchsorted + linear interpolation."""
    Ri = Ri.to(torch.float32)
    n = torch.searchsorted(f_sl, Ri.contiguous())
    n = torch.clamp(n, 0, NZL_LUT - 1)
    nm = torch.clamp(n - 1, min=0)
    interp = zL_sl[nm] + (Ri - f_sl[nm]) / (f_sl[n] - f_sl[nm] + 1e-30) * (zL_sl[n] - zL_sl[nm])
    edge = (n == 0) | (n == NZL_LUT - 1)
    return torch.where(edge, zL_sl[n], interp)


# --- direct Newton solvers -------------------------------------------------
#
# Fixed-iteration vectorized Newton solves of the same monotone relations
# (boundary_surface_kernels.h calc_obuk_noslip_*_iterative), warm-started
# from the previous step's Obukhov length; 8 iterations reach float32
# roundoff.

_ZL_EPS = 1e-8


def _seed_zL(zL0, Ri):
    """Previous-step z/L if the stability regime matches, else a small seed
    of the correct sign (the reference resets L on regime change too)."""
    same_sign = torch.sign(zL0) == torch.sign(Ri)
    seed = torch.sign(Ri) * 0.05
    zL = torch.where(same_sign, zL0, seed)
    mag = torch.clamp(torch.abs(zL), _ZL_EPS, -cst.zL_min)
    return torch.sign(zL) * mag


def _stable_peak(fn):
    """Peak of the stable branch of fn(zL): beyond it the relation is not
    invertible (numpy, once per call; zsl/z0 are constants)."""
    zg = np.linspace(1e-3, cst.zL_max, 4000)
    fv = fn(zg)
    ipk = int(np.argmax(fv))
    return float(zg[ipk]), float(fv[ipk])


def solve_zL_flux(Ri, zL0, zsl, z0m, niter=8):
    """Solve zL * fm(zL)^3 = Ri (flux thermal BC).  Beyond the stable-branch
    peak the relation has no root; clamp to zL_max like the reference's LUT
    walk-to-end behavior (find_zL returning the last table entry)."""
    zL_pk, f_pk = _stable_peak(lambda z: z * _np_fm(zsl, z0m, zsl / z) ** 3)
    no_solution = Ri >= f_pk
    Ri = torch.where(no_solution, 0.5 * f_pk, Ri)
    Ri = torch.where(torch.abs(Ri) < 1e-12,
                     torch.sign(Ri) * 1e-12 + (Ri == 0.).to(Ri.dtype) * 1e-12,
                     Ri)
    zL = _seed_zL(zL0, Ri)
    zL = torch.clamp(zL, max=zL_pk)

    def f(zL_):
        return zL_ * fm(zsl, z0m, zsl / zL_) ** 3 - Ri

    for _ in range(niter):
        h = 0.001 * torch.abs(zL) + 1e-10
        fp = (f(zL + h) - f(zL - h)) / (2. * h)
        step = f(zL) / torch.where(torch.abs(fp) < 1e-30, 1e-30, fp)
        zL_new = zL - step
        # keep the iterate on the correct branch
        zL_new = torch.where(torch.sign(zL_new) == torch.sign(Ri), zL_new,
                             0.5 * zL)
        zL = torch.clamp(zL_new, cst.zL_min, zL_pk)
        zL = torch.sign(zL) * torch.clamp(torch.abs(zL), _ZL_EPS, -cst.zL_min)
    return torch.where(no_solution, cst.zL_max, zL)


def solve_zL_dirichlet(Ri, zL0, zsl, z0m, z0h, niter=8):
    """Solve zL * fm(zL)^2 / fh(zL) = Ri (Dirichlet thermal BC).  For
    Ri > 0.13 the system has no solution; clamp to zL_max like the
    reference (L_min_stable)."""
    no_solution = Ri > 0.13
    Ri_c = torch.where(no_solution, 0.12, Ri)
    Ri_c = torch.where(torch.abs(Ri_c) < 1e-12, 1e-12, Ri_c)
    zL = _seed_zL(zL0, Ri_c)

    def f(zL_):
        L = zsl / zL_
        return zL_ * fm(zsl, z0m, L) ** 2 / fh(zsl, z0h, L) - Ri_c

    for _ in range(niter):
        h = 0.001 * torch.abs(zL) + 1e-10
        fp = (f(zL + h) - f(zL - h)) / (2. * h)
        step = f(zL) / torch.where(torch.abs(fp) < 1e-30, 1e-30, fp)
        zL_new = zL - step
        zL_new = torch.where(torch.sign(zL_new) == torch.sign(Ri_c), zL_new,
                             0.5 * zL)
        zL = torch.clamp(zL_new, cst.zL_min, cst.zL_max)
        zL = torch.sign(zL) * torch.clamp(torch.abs(zL), _ZL_EPS, -cst.zL_min)
    return torch.where(no_solution, cst.zL_max, zL)
