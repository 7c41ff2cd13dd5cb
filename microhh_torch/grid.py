"""Staggered-grid geometry.

Host-side copy of ``microhh_tpu/grid.py`` (numpy only), which re-designs the
reference grid layer (``src/grid.cxx``).  Differences
from the reference:

* Fields are stored as dense ``(kcells, jtot, itot)`` arrays: the vertical axis
  keeps ``kgc`` ghost levels exactly like the reference (ghost values are
  re-computed functionally from the boundary conditions each substep), while
  the horizontal axes carry NO ghost cells — horizontal periodicity is applied
  spectrally/by-roll, and under ``jax.sharding`` XLA turns the rolls into ICI
  collective-permutes, which replaces the reference's MPI halo exchange
  (``src/boundary_cyclic.cxx``).
* All grid metric arrays are computed once in float64 numpy, mirroring
  ``Grid<TF>::calculate()`` (reference ``src/grid.cxx:237-368``) including the
  2nd and 4th order ghost extrapolations, and then cast to the run dtype.

The vertical index convention matches the reference: interior levels are
``k in [kstart, kend)`` with ``kstart = kgc`` and ``kend = ktot + kgc``.
"""

import numpy as np

DHUGE = 1.e30


class Grid:
    def __init__(self, ini, z_in=None):
        self.xsize = ini.get_float("grid", "xsize")
        self.ysize = ini.get_float("grid", "ysize")
        self.zsize = ini.get_float("grid", "zsize")
        self.itot = ini.get_int("grid", "itot")
        self.jtot = ini.get_int("grid", "jtot")
        self.ktot = ini.get_int("grid", "ktot")
        self.utrans = ini.get_float("grid", "utrans", default=0.)
        self.vtrans = ini.get_float("grid", "vtrans", default=0.)
        self.lat = ini.get_float("grid", "lat", default=ini.get_float("radiation", "lat", default=0.))
        self.lon = ini.get_float("grid", "lon", default=ini.get_float("radiation", "lon", default=0.))

        order = ini.get_str("grid", "swspatialorder")
        if order not in ("2", "4"):
            raise ValueError("%s is an illegal value for swspatialorder" % order)
        self.spatial_order = int(order)
        self.igc = self.jgc = self.kgc = 1 if self.spatial_order == 2 else 3

        self.kstart = self.kgc
        self.kend = self.ktot + self.kgc
        self.kcells = self.ktot + 2 * self.kgc
        self.kmax = self.ktot

        self.dx = self.xsize / self.itot
        self.dy = self.ysize / self.jtot
        self.dxi = 1. / self.dx
        self.dyi = 1. / self.dy

        # Global coordinates (cell centers and staggered "h"/flux locations).
        # x[i] is the center of cell i; xh[i] the west face (u location).
        i = np.arange(self.itot)
        j = np.arange(self.jtot)
        self.x = (0.5 + i) * self.dx
        self.xh = i * self.dx
        self.y = (0.5 + j) * self.dy
        self.yh = j * self.dy

        if z_in is not None:
            self.set_z(np.asarray(z_in, dtype=np.float64))

    def set_z(self, z_in):
        """Compute all vertical metric arrays from the input z profile.

        Mirrors reference ``src/grid.cxx:237-368`` (``calculate()``).  Arrays
        have length ``kcells`` and are indexed with the ghost offset like the
        reference (interior at ``[kstart:kend]``).
        """
        if len(z_in) != self.ktot:
            raise ValueError("z profile length %d != ktot %d" % (len(z_in), self.ktot))
        if z_in[-1] > self.zsize:
            raise ValueError("Highest grid point is above prescribed zsize")

        kc, ks, ke, kgc = self.kcells, self.kstart, self.kend, self.kgc
        z = np.zeros(kc)
        z[ks:ke] = z_in
        zh = np.zeros(kc)
        dz = np.zeros(kc)
        dzh = np.zeros(kc)

        if self.spatial_order == 2:
            z[ks - 1] = -z[ks]
            z[ke] = 2. * self.zsize - z[ke - 1]

            zh[ks + 1:ke] = 0.5 * (z[ks:ke - 1] + z[ks + 1:ke])
            zh[ks] = 0.
            zh[ke] = self.zsize

            dzh[1:] = z[1:] - z[:-1]
            dzh[ks - 1] = dzh[ks + 1]

            dz[1:-1] = zh[2:] - zh[1:-1]
            dz[ks - 1] = dz[ks]
            dz[ke] = dz[ke - 1]

            with np.errstate(divide="ignore"):
                dzi = np.where(dz != 0., 1. / np.where(dz == 0., 1., dz), 0.)
                dzhi = np.where(dzh != 0., 1. / np.where(dzh == 0., 1., dzh), 0.)
            self.dzi4 = None
            self.dzhi4 = None

        else:  # 4th order, reference src/grid.cxx:299-367
            from . import fd

            z[ks - 1] = -2. * z[ks] + (1. / 3.) * z[ks + 1]
            z[ks - 2] = -9. * z[ks] + 2. * z[ks + 1]
            z[ke] = (8. / 3.) * self.zsize - 2. * z[ke - 1] + (1. / 3.) * z[ke - 2]
            z[ke + 1] = 8. * self.zsize - 9. * z[ke - 1] + 2. * z[ke - 2]
            z[ks - 3] = DHUGE
            z[ke + 2] = DHUGE

            zh[ks] = 0.
            for k in range(ks + 1, ke):
                zh[k] = fd.ci0 * z[k - 2] + fd.ci1 * z[k - 1] + fd.ci2 * z[k] + fd.ci3 * z[k + 1]
            zh[ke] = self.zsize
            zh[ks - 1] = fd.bi0 * z[ks - 2] + fd.bi1 * z[ks - 1] + fd.bi2 * z[ks] + fd.bi3 * z[ks + 1]
            zh[ke + 1] = fd.ti0 * z[ke - 2] + fd.ti1 * z[ke - 1] + fd.ti2 * z[ke] + fd.ti3 * z[ke + 1]

            dzh[1:] = z[1:] - z[:-1]
            dzh[ks - 3] = dzh[ks + 3]

            dz[1:-1] = zh[2:] - zh[1:-1]
            dz[ks - 3] = dz[ks + 2]
            dz[ke + 2] = dz[ke - 3]

            dzi = np.zeros(kc)
            dzhi = np.zeros(kc)
            nz = dz != 0.
            nzh = dzh != 0.
            dzi[nz] = 1. / dz[nz]
            dzhi[nzh] = 1. / dzh[nzh]

            dzi4 = np.full(kc, DHUGE)
            dzhi4 = np.full(kc, DHUGE)
            for k in range(ks, ke):
                dzi4[k] = 1. / (fd.cg0 * zh[k - 1] + fd.cg1 * zh[k] + fd.cg2 * zh[k + 1] + fd.cg3 * zh[k + 2])
                dzhi4[k] = 1. / (fd.cg0 * z[k - 2] + fd.cg1 * z[k - 1] + fd.cg2 * z[k] + fd.cg3 * z[k + 1])
            dzhi4[ke] = 1. / (fd.cg0 * z[ke - 2] + fd.cg1 * z[ke - 1] + fd.cg2 * z[ke] + fd.cg3 * z[ke + 1])
            dzi4[ks - 1] = 1. / (fd.bg0 * zh[ks - 1] + fd.bg1 * zh[ks] + fd.bg2 * zh[ks + 1] + fd.bg3 * zh[ks + 2])
            dzhi4[ks - 1] = 1. / (fd.bg0 * z[ks - 2] + fd.bg1 * z[ks - 1] + fd.bg2 * z[ks] + fd.bg3 * z[ks + 1])
            dzi4[ke] = 1. / (fd.tg0 * zh[ke - 2] + fd.tg1 * zh[ke - 1] + fd.tg2 * zh[ke] + fd.tg3 * zh[ke + 1])
            dzhi4[ke + 1] = 1. / (fd.tg0 * z[ke - 2] + fd.tg1 * z[ke - 1] + fd.tg2 * z[ke] + fd.tg3 * z[ke + 1])

            self.dzhi4bot = 1. / (fd.bg0 * z[ks - 1] + fd.bg1 * z[ks] + fd.bg2 * z[ks + 1] + fd.bg3 * z[ks + 2])
            self.dzhi4top = 1. / (fd.tg0 * z[ke - 3] + fd.tg1 * z[ke - 2] + fd.tg2 * z[ke - 1] + fd.tg3 * z[ke])

            dzi4[ks - 2] = dzi4[ks - 3] = DHUGE
            dzi4[ke + 1] = dzi4[ke + 2] = DHUGE
            self.dzi4 = dzi4
            self.dzhi4 = dzhi4

        self.z, self.zh, self.dz, self.dzh, self.dzi, self.dzhi = z, zh, dz, dzh, dzi, dzhi

    # -- restart-file compatibility (reference grid.0000000 layout) --------
    def save(self, path="grid.0000000", dtype=np.float64):
        """Binary grid file: x, xh, y, yh, z, zh interior values in order
        (reference ``src/grid_serial.cxx`` save_grid)."""
        with open(path, "wb") as f:
            for arr in (self.x, self.xh, self.y, self.yh,
                        self.z[self.kstart:self.kend], self.zh[self.kstart:self.kend]):
                np.asarray(arr, dtype=dtype).tofile(f)

    def load(self, path="grid.0000000", dtype=np.float64):
        with open(path, "rb") as f:
            raw = np.fromfile(f, dtype=dtype)
        it, jt, kt = self.itot, self.jtot, self.ktot
        if len(raw) != 2 * (it + jt + kt):
            raise ValueError("grid file size mismatch")
        o = 2 * it + 2 * jt
        self.set_z(raw[o:o + kt].astype(np.float64))

    @property
    def z_int(self):
        return self.z[self.kstart:self.kend]

    @property
    def zh_int(self):
        return self.zh[self.kstart:self.kend + 1]
