"""4th-order periodic-axis stencil helpers (``microhh_tpu/ops/fd4.py``;
coefficients in fd.py).

Conventions for the (k, j, i) layout:
  ``ixh(a)[..., i]`` = 4th-order interpolation of a to i-1/2
  ``ixd(F)[..., i]`` = 4th-order flux divergence of F located at i-1/2
and the same for y (``jyh``/``jyd``).  The vertical variants take explicit
k-slices; the wall rows use the bi/ti stencils.
"""

from .. import fd
from .stencil import im, ip, jm, jp


def ixh(a):
    return fd.ci0 * im(a, 2) + fd.ci1 * im(a, 1) + fd.ci2 * a + fd.ci3 * ip(a, 1)


def ixd(F):
    return fd.cg0 * im(F, 1) + fd.cg1 * F + fd.cg2 * ip(F, 1) + fd.cg3 * ip(F, 2)


def jyh(a):
    return fd.ci0 * jm(a, 2) + fd.ci1 * jm(a, 1) + fd.ci2 * a + fd.ci3 * jp(a, 1)


def jyd(F):
    return fd.cg0 * jm(F, 1) + fd.cg1 * F + fd.cg2 * jp(F, 1) + fd.cg3 * jp(F, 2)


def izh_mid(a, ks, ke):
    """Vertical interpolation to the half levels ks..ke (inclusive)."""
    return (fd.ci0 * a[ks - 2:ke - 1] + fd.ci1 * a[ks - 1:ke]
            + fd.ci2 * a[ks:ke + 1] + fd.ci3 * a[ks + 1:ke + 2])


def izh_bot(a, ks):
    """bi-stencil interpolation at the sub-wall half level ks-1 (a plane)."""
    return fd.bi0 * a[ks - 2] + fd.bi1 * a[ks - 1] + fd.bi2 * a[ks] + fd.bi3 * a[ks + 1]


def izh_top(a, ke):
    """ti-stencil interpolation at the above-wall half level ke+1."""
    return fd.ti0 * a[ke - 2] + fd.ti1 * a[ke - 1] + fd.ti2 * a[ke] + fd.ti3 * a[ke + 1]


def izd(phi_ext, dzi4_col):
    """Vertical flux divergence: phi_ext holds the ktot+3 half-level planes
    ks-1..ke+1; returns the ktot centre levels."""
    kt = phi_ext.shape[0] - 3
    return (fd.cg0 * phi_ext[0:kt] + fd.cg1 * phi_ext[1:kt + 1]
            + fd.cg2 * phi_ext[2:kt + 2] + fd.cg3 * phi_ext[3:kt + 3]) * dzi4_col
