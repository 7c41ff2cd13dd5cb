"""4th-order spectral Poisson pressure solver (``microhh_tpu/ops/pres_4.py``;
reference ``src/pres_4.cxx``).

The FFT structure of pres_2 with 4th-order modified wavenumbers and a
heptadiagonal vertical system of kmax + 4 rows (two BC rows per wall).  The
matrix does not depend on time, so everything but the transforms is
precomputed once per case in float64 numpy (``set_values``):

* the default solve is the fast diagonalisation.  The ghost BC rows are pure
  mirrors, so eliminating them leaves a kmax x kmax banded matrix that is
  the same for every mode, with the mode entering as ``+ bm I``.  One dense
  eigendecomposition turns the per-step solve into ``rfft2``, two k-axis
  matrix products (``eigVi``, ``eigV``) around a division, a dense inverse
  slice for the mean mode (``eigM0``), and ``irfft2``.  None of this is a
  hand-written kernel, as in the JAX package, where the products are plain
  einsums outside any Pallas kernel: the transforms go to ``torch.fft`` and
  the products to ``torch.matmul`` in full float32 (TF32 stays off: their
  rounding reaches the divergence);
* when the eigenbasis is ill-conditioned, or ``MICROHH_EIGEN_POISSON=0``,
  the solve is the reference's hdma substitution (pres_4.cxx:573-680) with
  the LU factors of every mode, as a plain loop over k.  The factors are
  built only when that path is first taken: for a large grid they take
  7 (kmax + 4) jtot (itot/2 + 1) values.

The JAX package's matmul-as-DFT branch is a TPU detail and is not carried.
"""

import os

import numpy as np
import torch

from .. import fd
from .stencil import im, ip, jm, jp


def _hdma_factorize(m):
    """Vectorised LU factorisation of the hepta system.

    m: (7, N, ...) bands m1..m7 for N = kmax + 4 rows.  Mirrors
    Pres_4::hdma's factorisation exactly (pres_4.cxx)."""
    m1, m2, m3, m4, m5, m6, m7 = [m[i].copy() for i in range(7)]
    N = m1.shape[0]
    kmax = N - 4

    # k = 0
    m1[0] = 1.
    m2[0] = 1.
    m3[0] = 1. / m4[0]
    m4[0] = 1.
    m5[0] = m5[0] * m3[0]
    m6[0] = m6[0] * m3[0]
    m7[0] = m7[0] * m3[0]
    # k = 1
    m1[1] = 1.
    m2[1] = 1.
    m3[1] = m3[1] / m4[0]
    m4[1] = m4[1] - m3[1] * m5[0]
    m5[1] = m5[1] - m3[1] * m6[0]
    m6[1] = m6[1] - m3[1] * m7[0]
    # k = 2
    m1[2] = 1.
    m2[2] = m2[2] / m4[0]
    m3[2] = (m3[2] - m2[2] * m5[0]) / m4[1]
    m4[2] = m4[2] - m3[2] * m5[1] - m2[2] * m6[0]
    m5[2] = m5[2] - m3[2] * m6[1] - m2[2] * m7[0]
    m6[2] = m6[2] - m3[2] * m7[1]
    # k = 3 .. kmax+1 (general)
    for k in range(3, kmax + 2):
        m1[k] = m1[k] / m4[k - 3]
        m2[k] = (m2[k] - m1[k] * m5[k - 3]) / m4[k - 2]
        m3[k] = (m3[k] - m2[k] * m5[k - 2] - m1[k] * m6[k - 3]) / m4[k - 1]
        m4[k] = m4[k] - m3[k] * m5[k - 1] - m2[k] * m6[k - 2] - m1[k] * m7[k - 3]
        m5[k] = m5[k] - m3[k] * m6[k - 1] - m2[k] * m7[k - 2]
        m6[k] = m6[k] - m3[k] * m7[k - 1]
    m7[kmax + 1] = 1.
    k = kmax + 2
    m1[k] = m1[k] / m4[k - 3]
    m2[k] = (m2[k] - m1[k] * m5[k - 3]) / m4[k - 2]
    m3[k] = (m3[k] - m2[k] * m5[k - 2] - m1[k] * m6[k - 3]) / m4[k - 1]
    m4[k] = m4[k] - m3[k] * m5[k - 1] - m2[k] * m6[k - 2] - m1[k] * m7[k - 3]
    m5[k] = m5[k] - m3[k] * m6[k - 1] - m2[k] * m7[k - 2]
    m6[k] = 1.
    m7[k] = 1.
    k = kmax + 3
    m1[k] = m1[k] / m4[k - 3]
    m2[k] = (m2[k] - m1[k] * m5[k - 3]) / m4[k - 2]
    m3[k] = (m3[k] - m2[k] * m5[k - 2] - m1[k] * m6[k - 3]) / m4[k - 1]
    m4[k] = m4[k] - m3[k] * m5[k - 1] - m2[k] * m6[k - 2] - m1[k] * m7[k - 3]
    m5[k] = 1.
    m6[k] = 1.
    m7[k] = 1.
    return np.stack([m1, m2, m3, m4, m5, m6, m7])


def hepta_bands(grid):
    """The raw bands m1..m7 of the kmax interior rows, (7, kmax), from the
    4th-order metrics (pres_4.cxx:216-258)."""
    kmax, ks = grid.ktot, grid.kstart
    dzi4, dzhi4 = grid.dzi4, grid.dzhi4
    mk = np.zeros((7, kmax))
    kc = ks
    mk[0, 0] = 0.
    mk[1, 0] = (1. / 576.) * (-27. * dzhi4[kc]) * dzi4[kc]
    mk[2, 0] = (1. / 576.) * (-1. * dzhi4[kc + 1] + 729. * dzhi4[kc] + 27. * dzhi4[kc + 1]) * dzi4[kc]
    mk[3, 0] = (1. / 576.) * (27. * dzhi4[kc + 1] - 729. * dzhi4[kc] - 729. * dzhi4[kc + 1] - 1. * dzhi4[kc + 2]) * dzi4[kc]
    mk[4, 0] = (1. / 576.) * (-27. * dzhi4[kc + 1] + 27. * dzhi4[kc] + 729. * dzhi4[kc + 1] + 27. * dzhi4[kc + 2]) * dzi4[kc]
    mk[5, 0] = (1. / 576.) * (1. * dzhi4[kc + 1] - 27. * dzhi4[kc + 1] - 27. * dzhi4[kc + 2]) * dzi4[kc]
    mk[6, 0] = (1. / 576.) * (1. * dzhi4[kc + 2]) * dzi4[kc]
    for k in range(1, kmax - 1):
        kc = ks + k
        mk[0, k] = (1. / 576.) * (1. * dzhi4[kc - 1]) * dzi4[kc]
        mk[1, k] = (1. / 576.) * (-27. * dzhi4[kc - 1] - 27. * dzhi4[kc]) * dzi4[kc]
        mk[2, k] = (1. / 576.) * (27. * dzhi4[kc - 1] + 729. * dzhi4[kc] + 27. * dzhi4[kc + 1]) * dzi4[kc]
        mk[3, k] = (1. / 576.) * (-1. * dzhi4[kc - 1] - 729. * dzhi4[kc] - 729. * dzhi4[kc + 1] - 1. * dzhi4[kc + 2]) * dzi4[kc]
        mk[4, k] = (1. / 576.) * (27. * dzhi4[kc] + 729. * dzhi4[kc + 1] + 27. * dzhi4[kc + 2]) * dzi4[kc]
        mk[5, k] = (1. / 576.) * (-27. * dzhi4[kc + 1] - 27. * dzhi4[kc + 2]) * dzi4[kc]
        mk[6, k] = (1. / 576.) * (1. * dzhi4[kc + 2]) * dzi4[kc]
    k = kmax - 1
    kc = ks + k
    mk[0, k] = (1. / 576.) * (1. * dzhi4[kc - 1]) * dzi4[kc]
    mk[1, k] = (1. / 576.) * (-27. * dzhi4[kc - 1] - 27. * dzhi4[kc] + 1. * dzhi4[kc]) * dzi4[kc]
    mk[2, k] = (1. / 576.) * (27. * dzhi4[kc - 1] + 729. * dzhi4[kc] + 27. * dzhi4[kc + 1] - 27. * dzhi4[kc]) * dzi4[kc]
    mk[3, k] = (1. / 576.) * (-1. * dzhi4[kc - 1] - 729. * dzhi4[kc] - 729. * dzhi4[kc + 1] + 27. * dzhi4[kc]) * dzi4[kc]
    mk[4, k] = (1. / 576.) * (27. * dzhi4[kc] + 729. * dzhi4[kc + 1] - 1. * dzhi4[kc]) * dzi4[kc]
    mk[5, k] = (1. / 576.) * (-27. * dzhi4[kc + 1]) * dzi4[kc]
    mk[6, k] = 0.
    return mk


def modified_wavenumbers(n, total, didi):
    """The first n of total 4th-order modified wavenumbers of one axis."""
    ang = np.pi * np.arange(total // 2 + 1) / total
    b = (2. * (1. / 576.) * np.cos(6. * ang)
         - 2. * (54. / 576.) * np.cos(4. * ang)
         + 2. * (783. / 576.) * np.cos(2. * ang)
         - (1460. / 576.)) * didi
    full = np.empty(total)
    full[:total // 2 + 1] = b
    for j in range(total // 2 + 1, total):
        full[j] = full[total - j]
    return full[:n] if n != total else full


def hepta_system(mk, bm, mean):
    """The seven bands of the full kmax + 4 row system of the modes whose
    wavenumber sums are bm and which are (mean) or are not the mean mode,
    (7, kmax + 4) + bm.shape (pres_4.cxx solve())."""
    kmax = mk.shape[1]
    N = kmax + 4
    m = np.zeros((7, N) + bm.shape)
    # bottom BC rows: zero gradient
    m[3, 0] = 1.
    m[6, 0] = -1.
    m[3, 1] = 1.
    m[4, 1] = -1.
    for k in range(kmax):
        for b in range(7):
            m[b, k + 2] = mk[b, k]
        m[3, k + 2] += bm
    # top BC rows: the mean mode pins p, the others have zero gradient
    r = kmax + 2
    m[1, r] = np.where(mean, -1. / 3., 0.)
    m[2, r] = np.where(mean, 2., -1.)
    m[3, r] = 1.
    r = kmax + 3
    m[0, r] = np.where(mean, -2., -1.)
    m[1, r] = np.where(mean, 9., 0.)
    m[3, r] = 1.
    return m


def _dense(m_sys, col):
    """The dense (N, N) matrix of column col of a banded system."""
    N = m_sys.shape[1]
    A = np.zeros((N, N))
    for r in range(N):
        for b in range(7):
            c = r + b - 3
            if 0 <= c < N:
                A[r, c] = m_sys[b, r, col]
    return A


class Pres4:
    def __init__(self, ini, grid, fields):
        self.grid = grid
        self.fields = fields
        self._eig_ok = False
        self._lu = None

    def set_values(self, ctx):
        """The wavenumbers, the bands and the eigen tables, in float64 numpy
        and as tensors of ctx's dtype on ctx's device."""
        g = self.grid
        itot, jtot = g.itot, g.jtot
        self.kmax = g.ktot
        self.ctx = ctx
        self._bmati_np = modified_wavenumbers(itot // 2 + 1, itot,
                                              1. / (g.dx * g.dx))
        self._bmatj_np = modified_wavenumbers(jtot, jtot, 1. / (g.dy * g.dy))
        self._bm_np = self._bmatj_np[:, None] + self._bmati_np[None, :]
        self._mean_np = np.zeros(self._bm_np.shape, dtype=bool)
        self._mean_np[0, 0] = True
        self._mk_np = hepta_bands(g)
        self._build_eigen()
        self.eig = {k: ctx.tensor(v) for k, v in self._eig_np.items()}
        self._lu = None

    def _build_eigen(self):
        """Fast-diagonalisation tables (see the module docstring): the
        mode-independent T_eff from the non-mean mode (0, 1) with its own bm
        taken off the diagonal again, one dense nonsymmetric eig of it, and
        the mean mode's dense inverse slice."""
        kmax = self.kmax
        bm = self._bm_np
        # the modes (0, 0) and (0, 1) of the full system
        two = hepta_system(self._mk_np, bm[0, :2], self._mean_np[0, :2])
        A = _dense(two, 1)
        for k in range(kmax):
            A[k + 2, k + 2] -= bm[0, 1]
        T = A[2:kmax + 2, 2:kmax + 2].copy()
        T[:, 1] += A[2:kmax + 2, 0]
        T[:, 0] += A[2:kmax + 2, 1]
        T[:, kmax - 1] += A[2:kmax + 2, kmax + 2]
        T[:, kmax - 2] += A[2:kmax + 2, kmax + 3]
        lam, V = np.linalg.eig(T)
        self._eig_ok = bool(
            np.abs(lam.imag).max() < 1e-8 * max(1., np.abs(lam.real).max())
            and np.linalg.cond(V.real) < 1e8)
        if not self._eig_ok:
            self._eig_np = {}
            return
        lam, V = lam.real, V.real
        M0 = np.linalg.inv(_dense(two, 0))[2:kmax + 2, 2:kmax + 2]
        bmji = bm.copy()
        bmji[0, 0] = -1.   # dummy; the (0, 0) column is overwritten
        self._eig_np = {"eigV": V, "eigVi": np.linalg.inv(V), "eiglam": lam,
                        "eigM0": M0, "eigbm": bmji}

    def lu_factors(self):
        """The LU factors of every mode's system, (7, kmax + 4, jtot,
        itot/2 + 1) float64, built at first use."""
        if self._lu is None:
            self._lu = _hdma_factorize(
                hepta_system(self._mk_np, self._bm_np, self._mean_np))
        return self._lu

    def use_eigen(self):
        return (os.environ.get("MICROHH_EIGEN_POISSON", "1") == "1"
                and self._eig_ok)

    # ------------------------------------------------------------------
    def input(self, ctx, s, t, dti):
        """The 4th-order divergence of t + s / dt on the interior, with
        antisymmetric ghosts of w's tendency (pres_4.cxx:260-318)."""
        ks, ke = ctx.ks, ctx.ke
        kt = ke - ks
        u, v, w, wt = s["u"], s["v"], s["w"], t["w"]
        uu = t["u"][ks:ke] + u[ks:ke] * dti
        rhs = (fd.cg0 * im(uu) + fd.cg1 * uu + fd.cg2 * ip(uu) + fd.cg3 * ip(uu, 2)) * ctx.dxi
        if ctx.jtot > 1:
            vv = t["v"][ks:ke] + v[ks:ke] * dti
            rhs += (fd.cg0 * jm(vv) + fd.cg1 * vv + fd.cg2 * jp(vv) + fd.cg3 * jp(vv, 2)) * ctx.dyi
        # the half levels ks-1..ke+1; the carry's own ghost levels stay zero
        ww = wt[ks - 1:ke + 2] + w[ks - 1:ke + 2] * dti
        ww[0] = -wt[ks + 1] + w[ks - 1] * dti
        ww[kt + 2] = -wt[ke - 1] + w[ke + 1] * dti
        rhs += ((fd.cg0 * ww[0:kt] + fd.cg1 * ww[1:kt + 1]
                 + fd.cg2 * ww[2:kt + 2] + fd.cg3 * ww[3:kt + 3])
                * ctx.dzi4[ks:ke][:, None, None])
        return rhs

    def solve(self, rhs):
        """p on the interior levels from the right-hand side."""
        p_hat = torch.fft.rfft2(rhs, dim=(-2, -1))
        if self.use_eigen():
            x = self.solve_eigen(p_hat)
        else:
            x = self.solve_hdma(p_hat)
        return torch.fft.irfft2(x, s=rhs.shape[-2:], dim=(-2, -1))

    def solve_eigen(self, p_hat):
        """Two k-axis matrix products around the division by lam + bm; the
        mean mode through its dense inverse."""
        ep = self.eig
        kmax, jtot, nf = p_hat.shape
        # real and imaginary parts as 2 jtot nf real columns per level
        pr = torch.view_as_real(p_hat)
        mean_rhs = pr[:, 0, 0].clone()
        g = torch.matmul(ep["eigVi"], pr.reshape(kmax, -1))
        g = g.reshape(kmax, jtot, nf, 2)
        g /= (ep["eiglam"][:, None, None] + ep["eigbm"][None])[..., None]
        x = torch.matmul(ep["eigV"], g.reshape(kmax, -1))
        x = x.reshape(kmax, jtot, nf, 2)
        x[:, 0, 0] = torch.matmul(ep["eigM0"], mean_rhs)
        return torch.view_as_complex(x)

    def solve_hdma(self, p_hat):
        """The reference's substitutions with the precomputed LU factors: two
        depth-3 recurrences along k, every mode at once."""
        kmax = self.kmax
        ctx = self.ctx
        m1, m2, m3, m4, m5, m6, m7 = (ctx.tensor(b) for b in self.lu_factors())
        N = kmax + 4
        y = p_hat.new_zeros((N,) + p_hat.shape[1:])
        y[2:kmax + 2] = p_hat
        # forward: L y = p (the right-hand side's BC rows are zero)
        y[0] = y[0] * m3[0]
        y[1] = y[1] - y[0] * m3[1]
        y[2] = y[2] - y[1] * m3[2] - y[0] * m2[2]
        for k in range(3, N):
            y[k] = y[k] - y[k - 1] * m3[k] - y[k - 2] * m2[k] - y[k - 3] * m1[k]
        # backward: U x = y
        k = N - 1
        y[k] = y[k] / m4[k]
        y[k - 1] = (y[k - 1] - y[k] * m5[k - 1]) / m4[k - 1]
        y[k - 2] = (y[k - 2] - y[k - 1] * m5[k - 2] - y[k] * m6[k - 2]) / m4[k - 2]
        for k in range(N - 4, -1, -1):
            y[k] = (y[k] - y[k + 1] * m5[k] - y[k + 2] * m6[k]
                    - y[k + 3] * m7[k]) / m4[k]
        return y[2:kmax + 2].contiguous()

    def output(self, ctx, t, p):
        """Subtract the 4th-order pressure gradient from the momentum
        tendencies, in place (pres_4.cxx output)."""
        ks, ke = ctx.ks, ctx.ke
        pc = p[ks:ke]
        t["u"][ks:ke] -= (fd.cg0 * im(pc, 2) + fd.cg1 * im(pc) + fd.cg2 * pc + fd.cg3 * ip(pc)) * ctx.dxi
        if ctx.jtot > 1:
            t["v"][ks:ke] -= (fd.cg0 * jm(pc, 2) + fd.cg1 * jm(pc) + fd.cg2 * pc + fd.cg3 * jp(pc)) * ctx.dyi
        t["w"][ks + 1:ke] -= ((fd.cg0 * p[ks - 1:ke - 2] + fd.cg1 * p[ks:ke - 1]
                               + fd.cg2 * p[ks + 1:ke] + fd.cg3 * p[ks + 2:ke + 1])
                              * ctx.dzhi4[ks + 1:ke][:, None, None])
        return t

    def exec(self, ctx, s, t, aux, subdt):
        """Project s + subdt t: solve for p and take its gradient off the
        carry t in place; s carries conservation-type w ghosts.  aux["p"]
        is p with its two zero-gradient ghost levels on each side
        (pres_4.cxx:497-521)."""
        ks, ke = ctx.ks, ctx.ke
        p_int = self.solve(self.input(ctx, s, t, 1. / subdt))
        p = torch.zeros_like(s["u"])
        p[ks:ke] = p_int
        p[ks - 1] = p_int[0]
        p[ks - 2] = p_int[1]
        p[ke] = p_int[-1]
        p[ke + 1] = p_int[-2]
        self.output(ctx, t, p)
        aux["p"] = p
        return t, aux

    def divergence_max(self, ctx, s):
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"][ks:ke], s["v"][ks:ke], s["w"]
        div = (fd.cg0 * im(u) + fd.cg1 * u + fd.cg2 * ip(u) + fd.cg3 * ip(u, 2)) * ctx.dxi
        if ctx.jtot > 1:
            div += (fd.cg0 * jm(v) + fd.cg1 * v + fd.cg2 * jp(v) + fd.cg3 * jp(v, 2)) * ctx.dyi
        div += ((fd.cg0 * w[ks - 1:ke - 1] + fd.cg1 * w[ks:ke]
                 + fd.cg2 * w[ks + 1:ke + 1] + fd.cg3 * w[ks + 2:ke + 2])
                * ctx.dzi4[ks:ke][:, None, None])
        return torch.max(torch.abs(div))
