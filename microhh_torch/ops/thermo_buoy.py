"""Buoyancy as the prognostic thermodynamic variable
(``microhh_tpu/ops/thermo_buoy.py``; reference ``src/thermo_buoy.cxx``).

Used by the stable-boundary-layer (SBL) cases.  Carries the tilted-slope
variant (alpha, background N2), where buoyancy feeds the u and w tendencies
and the flow tilts the stratification into bt (thermo_buoy.cxx:110-165), and
the ``swbaroclinic`` term, at 2nd and at 4th order.
"""

import math

from .. import fd
from .stencil import i2, im, ip, jp


class ThermoBuoy:
    def __init__(self, ini, grid, fields):
        self.grid = grid
        fields.init_prognostic_field("b", "Buoyancy", "m s-2", "thermo")
        self.alpha = ini.get_float("thermo", "alpha", default=0.)
        self.n2 = ini.get_float("thermo", "N2", default=0.)
        fields.sp["b"].visc = ini.get_float("fields", "svisc", subitem="th")
        self.has_slope = abs(self.alpha) > 0.
        self.has_n2 = abs(self.n2) > 0.
        self.swbaroclinic = ini.get_bool("thermo", "swbaroclinic", default=False)
        if self.swbaroclinic:
            self.dbdy_ls = ini.get_float("thermo", "dbdy_ls")

    @property
    def scalars(self):
        return ("b",)

    def create_basestate(self, input_nc):
        pass

    def _interp_z(self, ctx, b):
        """b interpolated to the half levels ks+1..ke-1."""
        ks, ke = ctx.ks, ctx.ke
        if ctx.spatial_order == 2:
            return i2(b[ks:ke - 1], b[ks + 1:ke])
        return (fd.ci0 * b[ks - 1:ke - 2] + fd.ci1 * b[ks:ke - 1]
                + fd.ci2 * b[ks + 1:ke] + fd.ci3 * b[ks + 2:ke + 1])

    def exec(self, ctx, s, t, aux):
        """Add the buoyancy terms into t, in place on the interior."""
        ks, ke = ctx.ks, ctx.ke
        b = s["b"]
        b_h = self._interp_z(ctx, b)
        if self.has_slope or self.has_n2:
            sina, cosa = math.sin(self.alpha), math.cos(self.alpha)
            u = s["u"][ks:ke]
            bc = b[ks:ke]
            if ctx.spatial_order == 2:
                b_at_u = i2(im(bc), bc)
                u_at_c = i2(u, ip(u))
            else:
                b_at_u = (fd.ci0 * im(bc, 2) + fd.ci1 * im(bc) + fd.ci2 * bc
                          + fd.ci3 * ip(bc))
                u_at_c = (fd.ci0 * im(u) + fd.ci1 * u + fd.ci2 * ip(u)
                          + fd.ci3 * ip(u, 2))
            w_at_c = i2(s["w"][ks:ke], s["w"][ks + 1:ke + 1])
            t["u"][ks:ke] += sina * b_at_u
            t["w"][ks + 1:ke] += cosa * b_h
            t["b"][ks:ke] += -self.n2 * (sina * (u_at_c + ctx.utrans)
                                         + cosa * w_at_c)
        else:
            t["w"][ks + 1:ke] += b_h
        if self.swbaroclinic:
            v_c = i2(s["v"], jp(s["v"]))[ks:ke]
            t["b"][ks:ke] += -self.dbdy_ls * v_c
        return t

    def get_buoyancy(self, ctx, s):
        return s["b"]

    def get_n2(self, ctx, s):
        """N2 on the interior levels: db/dz plus the background N2."""
        ks, ke = ctx.ks, ctx.ke
        b = s["b"]
        return (0.5 * (b[ks + 1:ke + 1] - b[ks - 1:ke - 1])
                * ctx.dzi[ks:ke][:, None, None] + self.n2)

    def get_buoyancy_fluxbot(self, ctx, s, sfc):
        return sfc["b_fluxbot"]

    def get_buoyancy_surf(self, ctx, s, sfc):
        return s["b"][ctx.ks], sfc["b_bot"]

    def get_db_ref(self):
        return 0.
