"""2nd-order spectral Poisson pressure solver (``microhh_tpu/ops/pres_2.py``;
reference ``src/pres_2.cxx``).

The horizontal transform pair is K5/K6 (``csrc/dft.cu``), the counterparts
of the JAX package's Pallas DFT kernels ``dft2_fwd`` / ``dft2_inv``; they
keep ``torch.fft.rfft2``'s natural mode order, which is also their plain
version, and neither writes its input.  Each comes in two forms, chosen by
``dft_form`` from the plane's shape and dtype alone before any launch: the
cluster form (entries ``dft_fwd``/``dft_inv``, one launch a transform, a
k-plane per thread-block cluster of C CTAs that holds it in shared memory)
wherever C = 1, 2, 4 or 8 CTAs hold the plane, and the two-pass split form
(``dft_fwd_split``/``dft_inv_split``) for larger planes (f64 at 512^2).  A
failed launch raises; neither form stands in for the other.  The vertical
tridiagonal system of every mode is solved by K3, the Thomas kernel
(``csrc/tdma.cu``): the forward-elimination pivots are precomputed once per
case (``set_values``, pres_2.cxx:124-153,306-324), including the mean-mode
top BC p = 0, so the per-step solve is two first-order recurrences over k
per mode.  K3 too has two forms, chosen by ``tdma_form`` from kmax and the
dtype before any launch: the scan form (one read of the spectrum and the
pivots, one write; a mode's column on chip in chunks of L levels that
scan side by side) wherever TD_NCMAX chunks hold the column, and the sweep
form (one thread a mode, two sweeps through device memory) above.  On a
CPU tensor each of them runs its plain-torch version.

``solve`` serves the RK-folded paths, whose projection glue is K4
(ops/fused.py pressure_rk).  ``exec`` is the projection of the substep
without the RK fold (``microhh_tpu/ops/pres_2.py:995``): ``input`` and
``output`` in plain torch, as the JAX package leaves them to XLA, and
``solve_ri`` between them: K5, the spectrum times dz^2 split into its real
and imaginary parts, K21 (the Thomas kernel of ``Pres2._tdma_ri``, every
mode in one launch), K6.
"""

import collections

import numpy as np
import torch

from ..kernels import Kernel, check, on_cpu
from .stencil import im, ip, jm, jp


COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}

# the most dynamic shared memory a block can have on sm_90 (227 KB)
SMEM_MAX = 232448

DftForm = collections.namedtuple("DftForm", "form C F smem")
TdmaForm = collections.namedtuple("TdmaForm", "form L chunks threads smem")

# csrc/tdma.cu: modes a block and chunks a mode at most of the scan form,
# its levels a chunk (one length a dtype) and the threads a block of the
# sweep form
TD_MT, TD_NCMAX, TD_SWEEP_NT = 16, 32, 256
TD_L = {torch.float32: 32, torch.float64: 16}

def line_stride(n, real_bytes):
    """Entries of one padded line of n complex values in shared memory (one
    pad entry per 128 B and one at the end; csrc/dft.cu line_stride)."""
    return n + (n >> (4 if real_bytes == 4 else 3)) + 1


def cluster_smem(jtot, itot, C, F, real_bytes):
    """Dynamic shared memory of one CTA of the cluster form (csrc/dft.cu
    cluster_geom and cluster_smem): its rows, the scratch of two column
    chunks of F lines (at least one row), the stage twiddles of rows and
    columns and the unpack twiddles of packed rows."""
    packed = itot % 2 == 0
    m = itot // 2 if packed else itot
    ld_row, ld_col = line_stride(m, real_bytes), line_stride(jtot, real_bytes)
    rows = -(-jtot // C)
    scratch = max(2 * F * ld_col, ld_row)
    entries = (rows * ld_row + scratch + m + jtot + (m + 1 if packed else 0))
    return entries * 2 * real_bytes


def dft_form(jtot, itot, dtype):
    """The DFT form of a (jtot, itot) plane of dtype: the cluster form with
    the smallest C of 1, 2, 4, 8 whose CTAs hold the plane with column
    chunks of F = 16 or 8 modes (the larger that fits), else the smallest C
    that holds it with F = 4, 2 or 1; the split form where no C holds it."""
    real_bytes = torch.empty((), dtype=dtype).element_size()
    for chunks in ((16, 8), (4, 2, 1)):
        for C in (1, 2, 4, 8):
            for F in chunks:
                smem = cluster_smem(jtot, itot, C, F, real_bytes)
                if smem <= SMEM_MAX:
                    return DftForm("cluster", C, F, smem)
    return DftForm("split", 0, 0, 0)


def tdma_form(kmax, dtype, sweep=False):
    """K3's form for columns of kmax levels of dtype: the scan form, in
    chunks of TD_L[dtype] levels, where TD_NCMAX chunks hold the column,
    else the sweep form (L = 0).  sweep forces the sweep form (checks and
    timings only)."""
    real_bytes = torch.empty((), dtype=dtype).element_size()
    L = TD_L[dtype]
    chunks = -(-kmax // L)
    if sweep or chunks > TD_NCMAX:
        return TdmaForm("sweep", 0, 1, TD_SWEEP_NT, 0)
    # the composites of TD_NCMAX x TD_MT threads and the staged table rows
    return TdmaForm("scan", L, chunks, TD_MT * chunks,
                    (6 * TD_MT + 3 * L) * TD_NCMAX * real_bytes)


def tdma_plain(x, winv, tab):
    """K3 in plain torch, in place on the complex spectrum x (kmax, jtot,
    nf); tab columns [-a, -c, dz^2] (the JAX package's _tdma_dz2_body)."""
    kmax = x.shape[0]
    y = torch.zeros_like(x[0])
    for k in range(kmax):
        w = winv[k]
        y = (tab[k, 0] * w) * y + (x[k] * tab[k, 2]) * w
        x[k] = y
    y = torch.zeros_like(x[0])
    for k in range(kmax - 1, -1, -1):
        y = x[k] + (tab[k, 1] * winv[k]) * y
        x[k] = y
    return x


def tdma_ri_plain(dr, di, winv, afcf):
    """K21 in plain torch: the Thomas solve of every mode on the split
    spectrum dr, di (kmax, jtot, nf) that is already multiplied by dz^2;
    afcf columns [-a, -c] (the JAX package's _tdma_body).  Returns new
    (xr, xi)."""
    kmax = dr.shape[0]
    xr, xi = torch.empty_like(dr), torch.empty_like(di)
    yr, yi = torch.zeros_like(dr[0]), torch.zeros_like(di[0])
    for k in range(kmax):
        w = winv[k]
        af = afcf[k, 0] * w
        yr = af * yr + dr[k] * w
        yi = af * yi + di[k] * w
        xr[k], xi[k] = yr, yi
    r, i_ = torch.zeros_like(dr[0]), torch.zeros_like(di[0])
    for k in range(kmax - 1, -1, -1):
        cf = afcf[k, 1] * winv[k]
        r = xr[k] + cf * r
        i_ = xi[k] + cf * i_
        xr[k], xi[k] = r, i_
    return xr, xi


class Pres2:
    def __init__(self, ini, grid, fields):
        self.grid = grid
        self.fields = fields
        # [pres] sw_fft_per_slice batches the reference's cuFFT plans per
        # z-slice; K5/K6 transform the whole batch, so the knob is accepted
        # and has no effect.
        ini.get_bool("pres", "sw_fft_per_slice", default=False)
        self.k_tdma = Kernel("tdma", "microhh_torch/csrc/tdma.cu",
                             "microhh_tpu/ops/pres_2.py:448")
        self.k_dft_fwd = Kernel("dft_fwd", "microhh_torch/csrc/dft.cu",
                                "microhh_tpu/ops/pallas_dft.py:322")
        self.k_dft_inv = Kernel("dft_inv", "microhh_torch/csrc/dft.cu",
                                "microhh_tpu/ops/pallas_dft.py:344")
        self.k_dft_fwd_split = Kernel("dft_fwd_split",
                                      "microhh_torch/csrc/dft.cu",
                                      "microhh_tpu/ops/pallas_dft.py:322")
        self.k_dft_inv_split = Kernel("dft_inv_split",
                                      "microhh_torch/csrc/dft.cu",
                                      "microhh_tpu/ops/pallas_dft.py:344")
        self.k_tdma_ri = Kernel("tdma_ri", "microhh_torch/csrc/tdma.cu",
                                "microhh_tpu/ops/pres_2.py:898")

    def set_values(self, ctx):
        """Thomas pivots for the natural rfft2 mode order (reference
        set_values), as tensors of ctx's dtype on ctx's device."""
        g, f = self.grid, self.fields
        itot, jtot, kmax, kgc = g.itot, g.jtot, g.ktot, g.kgc
        ihalf = itot // 2 + 1
        dxidxi = 1. / (g.dx * g.dx)
        dyidyi = 1. / (g.dy * g.dy)

        # modified wavenumbers (pres_2.cxx:124-153)
        ii = np.arange(ihalf)
        bmati = 2. * (np.cos(2. * np.pi * ii / itot) - 1.) * dxidxi
        jj = np.arange(jtot)
        bmatj = 2. * (np.cos(2. * np.pi * jj / jtot) - 1.) * dyidyi
        bmatj[jtot // 2 + 1:] = bmatj[jtot - jj[jtot // 2 + 1:]]

        dz = g.dz[kgc:kgc + kmax]
        rhoref = f.rhoref[kgc:kgc + kmax]
        rhorefh = f.rhorefh[kgc:kgc + kmax + 1]
        dzhi = g.dzhi[kgc:kgc + kmax + 1]
        a = dz * rhorefh[:kmax] * dzhi[:kmax]
        c = dz * rhorefh[1:kmax + 1] * dzhi[1:kmax + 1]

        bm = bmatj[:, None] + bmati[None, :]
        b = (dz[:, None, None] ** 2 * rhoref[:, None, None] * bm[None]
             - (a + c)[:, None, None])
        b[0] += a[0]
        # top BC: dp/dz = 0 (b += c) except the mean mode, where p_top = 0
        b[kmax - 1] += c[kmax - 1]
        b[kmax - 1, 0, 0] -= 2. * c[kmax - 1]
        w = np.empty_like(b)
        w[0] = b[0]
        for k in range(1, kmax):
            w[k] = b[k] - a[k] * (c[k - 1] / w[k - 1])

        tab = np.zeros((kmax, 3))
        tab[1:, 0] = -a[1:]
        tab[:-1, 1] = -c[:-1]
        tab[:, 2] = dz ** 2
        self.winv = ctx.tensor(1. / w)
        self.tab = ctx.tensor(tab)
        # K21's table and the rhs scale it does not fold in
        self.afcf = ctx.tensor(tab[:, :2].copy())
        self.dz2 = ctx.tensor(dz ** 2)[:, None, None]

    tdma_form = staticmethod(tdma_form)

    def tdma(self, x, sweep=False):
        """K3: solve every mode of the spectrum x in place, in the form
        tdma_form picks (sweep: force the sweep form; checks and timings
        only)."""
        if on_cpu(x):
            return tdma_plain(x, self.winv, self.tab)
        real = self.winv.dtype
        if x.dtype != COMPLEX[real]:
            raise TypeError("spectrum %s does not match pivots %s"
                            % (x.dtype, real))
        if (x.device != self.winv.device or not x.is_contiguous()
                or x.shape != self.winv.shape):
            raise ValueError("spectrum %s on %s does not match pivots %s"
                             % (tuple(x.shape), x.device,
                                tuple(self.winv.shape)))
        kmax = x.shape[0]
        form = tdma_form(kmax, real, sweep)
        self.k_tdma(real, x, self.winv, self.tab, kmax,
                    x.shape[1] * x.shape[2], int(form.form == "sweep"))
        return x

    def tdma_ri(self, dr, di):
        """K21: the Thomas solve of every mode on the split spectrum (times
        dz^2); returns new (xr, xi)."""
        if on_cpu(dr):
            return tdma_ri_plain(dr, di, self.winv, self.afcf)
        real = self.winv.dtype
        check((dr, di, self.winv, self.afcf), real, self.winv.device,
              [tuple(self.winv.shape)] * 3 + [(dr.shape[0], 2)])
        xr, xi = torch.empty_like(dr), torch.empty_like(di)
        self.k_tdma_ri(real, dr, di, self.winv, self.afcf, xr, xi,
                       dr.shape[0], dr.shape[1] * dr.shape[2])
        return xr, xi

    dft_form = staticmethod(dft_form)

    def dft_kernels(self, dtype):
        """K5 and K6 in the form the model's planes take."""
        g = self.grid
        if dft_form(g.jtot, g.itot, dtype).form == "cluster":
            return [self.k_dft_fwd, self.k_dft_inv]
        return [self.k_dft_fwd_split, self.k_dft_inv_split]

    def rfft2(self, x):
        """K5: the spectrum (kmax, jtot, itot//2+1) of the real x (kmax,
        jtot, itot), as torch.fft.rfft2 over the last two axes."""
        if on_cpu(x):
            return torch.fft.rfft2(x, dim=(-2, -1))
        check([x], x.dtype, x.device)
        kt, jtot, itot = x.shape
        y = torch.empty((kt, jtot, itot // 2 + 1), dtype=COMPLEX[x.dtype],
                        device=x.device)
        form = dft_form(jtot, itot, x.dtype)
        if form.form == "cluster":
            self.k_dft_fwd(x.dtype, x, y, kt, jtot, itot, form.C, form.F)
        else:
            self.k_dft_fwd_split(x.dtype, x, y, kt, jtot, itot)
        return y

    def irfft2(self, y, itot):
        """K6: the real (kmax, jtot, itot) field of the spectrum y, as
        torch.fft.irfft2; y is not written."""
        kt, jtot, nf = y.shape
        if on_cpu(y):
            return torch.fft.irfft2(y, s=(jtot, itot), dim=(-2, -1))
        if nf != itot // 2 + 1:
            raise ValueError("spectrum of %d modes for %d points" % (nf, itot))
        real = {c: r for r, c in COMPLEX.items()}.get(y.dtype)
        if real is None:
            raise TypeError("spectrum of dtype %s" % y.dtype)
        check([torch.view_as_real(y)], real, y.device)
        x = torch.empty((kt, jtot, itot), dtype=real, device=y.device)
        form = dft_form(jtot, itot, real)
        if form.form == "cluster":
            self.k_dft_inv(real, y, x, kt, jtot, itot, form.C, form.F)
        else:
            # the split form's j pass writes a scratch spectrum
            self.k_dft_inv_split(real, y, torch.empty_like(y), x, kt, jtot,
                                 itot)
        return x

    def solve(self, rhs):
        """Pressure on the interior (kmax, jtot, itot) from the rhs."""
        return self.irfft2(self.tdma(self.rfft2(rhs)), rhs.shape[-1])

    def solve_ri(self, rhs):
        """Pressure on the interior from the rhs through K5, K21 and K6
        (Pres2.solve with _solve_spectral_pallas in the JAX package); the
        scaling by dz^2 and the split into real and imaginary parts are
        plain torch, as they are XLA there."""
        d = self.rfft2(rhs) * self.dz2
        xr, xi = self.tdma_ri(d.real.contiguous(), d.imag.contiguous())
        return self.irfft2(torch.complex(xr, xi), rhs.shape[-1])

    def input(self, ctx, s, t, dti):
        """rhs = div(rho (t + s/dt)) on the interior (pres_2.cxx:156-196)."""
        ks, ke = ctx.ks, ctx.ke
        uu = t["u"][ks:ke] + s["u"][ks:ke] * dti
        vv = t["v"][ks:ke] + s["v"][ks:ke] * dti
        ww = t["w"][ks:ke + 1] + s["w"][ks:ke + 1] * dti
        rho = ctx.rhoref[ks:ke][:, None, None]
        rhoh = ctx.rhorefh[ks:ke + 1][:, None, None]
        dzi = ctx.dzi[ks:ke][:, None, None]
        return (rho * ((ip(uu) - uu) * ctx.dxi + (jp(vv) - vv) * ctx.dyi)
                + (rhoh[1:] * ww[1:] - rhoh[:-1] * ww[:-1]) * dzi)

    def output(self, ctx, t, p):
        """t -= grad p for u, v, w, in place on the interior; p is the
        interior pressure (pres_2.cxx:364-387)."""
        ks, ke = ctx.ks, ctx.ke
        t["u"][ks:ke] -= (p - im(p)) * ctx.dxi
        t["v"][ks:ke] -= (p - jm(p)) * ctx.dyi
        t["w"][ks + 1:ke] -= (p[1:] - p[:-1]) * ctx.dzhi[ks + 1:ke][:, None, None]

    def exec(self, ctx, s, t, aux, subdt):
        """The projection of the substep without the RK fold: the carry t
        is made divergence-free in place; aux['p'] is the interior
        pressure."""
        p = self.solve_ri(self.input(ctx, s, t, 1. / subdt))
        self.output(ctx, t, p)
        aux["p"] = p
        return aux

    def divergence_max(self, ctx, s):
        """max |div(rho u)| (reference calc_divergence)."""
        ks, ke = ctx.ks, ctx.ke
        u, v, w = s["u"][ks:ke], s["v"][ks:ke], s["w"]
        rho = ctx.rhoref[ks:ke][:, None, None]
        rhoh = ctx.rhorefh[ks:ke + 1][:, None, None]
        dzi = ctx.dzi[ks:ke][:, None, None]
        div = (rho * ((ip(u) - u) * ctx.dxi + (jp(v) - v) * ctx.dyi)
               + (rhoh[1:] * w[ks + 1:ke + 1] - rhoh[:-1] * w[ks:ke]) * dzi)
        return torch.max(torch.abs(div))
