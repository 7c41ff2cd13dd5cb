"""Open lateral boundaries (in/outflow) for selected scalars
(``microhh_tpu/ops/boundary_outflow.py``; reference
``src/boundary_outflow.cxx`` and ``src/boundary.cxx:271-272,410-470``).

The reference overwrites the horizontal ghost cells of each scalar in
``[boundary] scalar_outflow`` after the cyclic exchange: an outflow edge
copies the interior value (zero gradient), an inflow edge extrapolates
through the prescribed profile ``<scalar>_inflow`` of the ``init`` group.
The fields here have no horizontal ghost cells (periodicity is a roll), and
with one ghost cell such a value enters one thing only: the advective and
diffusive flux through the open face of the first or last column.  So the
open boundary is a tendency correction after the periodic advection and
diffusion: on the four edge columns the wrapped face flux is replaced by
the open one,

* outflow, ghost = a_edge: face value a_edge, diffusive flux 0;
* inflow, ghost = 2 prof - a_edge: face value prof, diffusive gradient
  2 (a_edge - prof) dxi.

Face velocities and the eddy viscosity stay periodic, as in the reference.

The wrapped flux that is taken out is advec_2's, ``u 0.5 (a_w + a_0)``,
whatever the advection scheme: under an interpolated scheme (jaenschwalde
runs 2i5 with a flux limiter on co2) that is not the flux the scheme added.
The port follows the JAX package here so that the two stay comparable
(ROADMAP Queue 3).

Ported: the 2nd-order correction with static inflow profiles.  The
4th-order form and ``swtimedep_outflow`` raise (ROADMAP Queue 1 item 14).
"""

import numpy as np

from . import not_ported

EDGES = ("west", "east", "south", "north")


class BoundaryOutflow:
    def __init__(self, ini, grid, spatial_order):
        self.grid = grid
        self.scalars = ini.get_list(str, "boundary", "scalar_outflow",
                                    default=[])
        self.direction = {}
        self.inflow_profiles = {}
        if not self.scalars:
            return
        if spatial_order == 4:
            raise not_ported("[boundary] scalar_outflow at swspatialorder=4",
                             14)
        for edge in EDGES:
            d = ini.get_str("boundary", "flow_direction", subitem=edge)
            if d not in ("inflow", "outflow"):
                raise ValueError("flow direction %r is invalid" % d)
            self.direction[edge] = d
        if ini.get_bool("boundary", "swtimedep_outflow", default=False):
            raise not_ported("[boundary] swtimedep_outflow", 14)

    @property
    def active(self):
        return bool(self.scalars)

    def create(self, input_nc):
        """Load the constant inflow profiles (boundary.cxx:418-426)."""
        g = self.grid
        init = input_nc.groups["init"]
        for name in self.scalars:
            prof = np.zeros(g.kcells)
            prof[g.kstart:g.kend] = np.asarray(
                init.variables[name + "_inflow"][:g.ktot])
            self.inflow_profiles[name] = prof

    def correct(self, ctx, s, t, aux, tPr=None, sviscs=None):
        """Replace the wrapped-face advective and diffusive fluxes by the
        open-boundary fluxes on the edge columns of each outflow scalar, in
        place on the interior levels of the carry t (the JAX package
        corrects the ghost levels of the tendency too, which nothing reads).
        aux['evisc']: the kcells eddy viscosity."""
        ks, ke = ctx.ks, ctx.ke
        dxi, dyi = ctx.dxi, ctx.dyi
        u, v = s["u"], s["v"]
        evisc = aux.get("evisc")
        for name in self.scalars:
            a, ta = s[name], t[name]
            if name in self.inflow_profiles:
                prof = ctx.tensor(self.inflow_profiles[name])[ks:ke, None]
            else:
                prof = ctx.tensor(np.zeros((ke - ks, 1)))
            svisc = (sviscs or {}).get(name, 0.)

            def face_coef(lo, hi):
                # the scalar diffusivity on a face (diff_smag2 diff_c)
                if evisc is None:
                    return svisc
                return 0.5 * (lo(evisc) + hi(evisc)) / tPr + svisc

            # (first column or row, last one, face velocity, spacing): the
            # west/east pair in x, then the south/north pair in y
            for (low, high), first, last, vel, di in (
                    (("west", "east"), lambda f: f[ks:ke, :, 0],
                     lambda f: f[ks:ke, :, -1], u, dxi),
                    (("south", "north"), lambda f: f[ks:ke, 0, :],
                     lambda f: f[ks:ke, -1, :], v, dyi)):
                vf = first(vel)
                a0, al = first(a), last(a)
                ev_face = face_coef(last, first)
                # the wrapped face between the last and the first column
                adv_wrap = vf * 0.5 * (al + a0)
                dif_wrap = ev_face * (a0 - al) * di
                if self.direction[low] == "inflow":
                    adv_open = vf * prof
                    dif_open = ev_face * 2. * (a0 - prof) * di
                else:
                    adv_open = vf * a0
                    dif_open = 0.
                first(ta).add_((adv_open - adv_wrap) * di
                               + (dif_wrap - dif_open) * di)
                if self.direction[high] == "inflow":
                    adv_open = vf * prof
                    dif_open = ev_face * 2. * (prof - al) * di
                else:
                    adv_open = vf * al
                    dif_open = 0.
                last(ta).add_((adv_wrap - adv_open) * di
                              + (dif_open - dif_wrap) * di)
        return t
