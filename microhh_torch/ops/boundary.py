"""Boundary-condition table and the vertical ghost fills
(``microhh_tpu/ops/boundary.py``; reference ``src/boundary.cxx`` ``set_bc``,
``calc_ghost_cells_top_2nd``, ``calc_ghost_cells_{bot,top}_4th``,
``calc_ghost_cells_{bot,top}w[_cons]_4th``).

Only the vertical ghost levels exist (horizontal periodicity is a roll, see
stencil.py).  Under the surface model (boundary_surface.py) the bottom
ghosts come from its fluxes and this module fills the top.
``DefaultBoundary`` (``swboundary=default``) fills every cell-centred
field's ghosts from its static BCs, in place: one level on each side at 2nd
order (``calc_ghost_cells_{bot,top}_2nd``; w has none), two at 4th order,
with w's under one of its two ghost types.
"""

import torch

from .. import fd

DIRICHLET = "dirichlet"
NEUMANN = "neumann"
FLUX = "flux"
OFF = "off"
USTAR = "ustar"

_MOMENTUM_MAP = {"noslip": DIRICHLET, "freeslip": NEUMANN, "neumann": NEUMANN,
                 "ustar": USTAR, "off": OFF}


class BC:
    """Per-field boundary condition: (type, value) at bot and top.

    ``value`` semantics per type (reference ``set_bc``, boundary.cxx:50-91):
    dirichlet -> surface value; neumann -> gradient; flux -> flux (the ghost
    fill converts it to a gradient with -flux/visc).
    """

    def __init__(self, bcbot, bot, bctop, top):
        self.bcbot, self.bot, self.bctop, self.top = bcbot, bot, bctop, top


def make_bcs(ini, fields):
    """Parse [boundary] like Boundary::process_bcs (boundary.cxx:185-273)."""
    swbot = ini.get_str("boundary", "mbcbot")
    swtop = ini.get_str("boundary", "mbctop")
    if swbot not in _MOMENTUM_MAP:
        raise ValueError("%s is an illegal value for mbcbot" % swbot)
    if swtop not in _MOMENTUM_MAP:
        raise ValueError("%s is an illegal value for mbctop" % swtop)

    ubot = ini.get_float("boundary", "ubot", default=0.)
    utop = ini.get_float("boundary", "utop", default=0.)
    vbot = ini.get_float("boundary", "vbot", default=0.)
    vtop = ini.get_float("boundary", "vtop", default=0.)

    bcs = {
        "u": BC(_MOMENTUM_MAP[swbot], ubot, _MOMENTUM_MAP[swtop], utop),
        "v": BC(_MOMENTUM_MAP[swbot], vbot, _MOMENTUM_MAP[swtop], vtop),
    }
    for name in fields.sp:
        bcs[name] = BC(
            ini.get_str("boundary", "sbcbot", subitem=name),
            ini.get_float("boundary", "sbot", subitem=name, default=0.),
            ini.get_str("boundary", "sbctop", subitem=name),
            ini.get_float("boundary", "stop", subitem=name, default=0.),
        )
    return bcs


def grad_from(bctype, value, visc):
    """Neumann gradient equivalent of a BC value (flux -> -flux/visc)."""
    if bctype == FLUX:
        return -value / visc
    return value


def bot_ghost_2nd(ctx, a, bcbot, bot, visc, offset=0.):
    """Bottom ghost plane (reference calc_ghost_cells_bot_2nd); None where
    the BC type leaves it untouched."""
    ks = ctx.ks
    if bcbot == DIRICHLET:
        return 2. * (bot - offset) - a[ks]
    if bcbot in (NEUMANN, FLUX):
        return -grad_from(bcbot, bot, visc) * ctx.dzh[ks] + a[ks]
    return None


def top_ghost_2nd(ctx, a, bctop, top, visc, offset=0.):
    """Top ghost plane (reference calc_ghost_cells_top_2nd)."""
    ke = ctx.ke
    if bctop in (DIRICHLET, OFF):
        topv = top - offset
        if bctop == OFF:
            topv = 1.5 * a[ke - 1] - 0.5 * a[ke - 2]
        return 2. * topv - a[ke - 1]
    if bctop in (NEUMANN, FLUX):
        return grad_from(bctop, top, visc) * ctx.dzh[ke] + a[ke - 1]
    return None


def assemble_ghosts(ctx, a, bot, top):
    """The field with new bottom/top ghost planes (None keeps the old one)."""
    ks, ke = ctx.ks, ctx.ke
    bot = a[ks - 1] if bot is None else torch.as_tensor(bot, dtype=a.dtype,
                                                        device=a.device)
    top = a[ke] if top is None else torch.as_tensor(top, dtype=a.dtype,
                                                    device=a.device)
    plane = a.shape[1:]
    return torch.cat([bot.expand(plane)[None], a[ks:ke],
                      top.expand(plane)[None]], dim=0)


def set_ghost_cells_field_2nd(ctx, a, bc, visc, offset=0.):
    """Fill one vertical ghost level on each side of a cell-centred field,
    in place; a BC type that gives no plane leaves its side untouched."""
    bot = bot_ghost_2nd(ctx, a, bc.bcbot, bc.bot, visc, offset)
    top = top_ghost_2nd(ctx, a, bc.bctop, bc.top, visc, offset)
    if bot is not None:
        a[ctx.ks - 1] = bot
    if top is not None:
        a[ctx.ke] = top
    return a


def set_ghost_cells_field_4th(ctx, a, bc, visc, offset=0.):
    """Fill two vertical ghost levels on each side of a cell-centred field,
    in place (reference calc_ghost_cells_bot_4th / _top_4th); a BC type
    other than Dirichlet, Neumann or flux leaves its side untouched."""
    ks, ke = ctx.ks, ctx.ke
    z = ctx.np_z
    if bc.bcbot == DIRICHLET:
        bot = bc.bot - offset
        a[ks - 1] = (8. / 3.) * bot - 2. * a[ks] + (1. / 3.) * a[ks + 1]
        a[ks - 2] = 8. * bot - 9. * a[ks] + 2. * a[ks + 1]
    elif bc.bcbot in (NEUMANN, FLUX):
        grad = grad_from(bc.bcbot, bc.bot, visc)
        g4 = float(fd.grad4(z[ks - 2], z[ks - 1], z[ks], z[ks + 1]))
        a[ks - 1] = -1. * g4 * grad + a[ks]
        a[ks - 2] = -3. * g4 * grad + a[ks + 1]
    if bc.bctop == DIRICHLET:
        top = bc.top - offset
        a[ke] = (8. / 3.) * top - 2. * a[ke - 1] + (1. / 3.) * a[ke - 2]
        a[ke + 1] = 8. * top - 9. * a[ke - 1] + 2. * a[ke - 2]
    elif bc.bctop in (NEUMANN, FLUX):
        grad = grad_from(bc.bctop, bc.top, visc)
        g4 = float(fd.grad4(z[ke - 2], z[ke - 1], z[ke], z[ke + 1]))
        a[ke] = 1. * g4 * grad + a[ke - 1]
        a[ke + 1] = 3. * g4 * grad + a[ke - 2]
    return a


def set_ghost_cells_w_4th(ctx, w, conservation=False):
    """Fill w's 4th-order ghost levels in place (boundary.cxx:843-915): the
    conservation type (two antisymmetric levels) goes around the advection
    and the pressure solver, the plain type (one extrapolated level) around
    the diffusion."""
    ks, ke = ctx.ks, ctx.ke
    if conservation:
        w[ks - 1] = -w[ks + 1]
        w[ks - 2] = -w[ks + 2]
        w[ke + 1] = -w[ke - 1]
        w[ke + 2] = -w[ke - 2]
    else:
        w[ks - 1] = -6. * w[ks + 1] + 4. * w[ks + 2] - w[ks + 3]
        w[ke + 1] = -6. * w[ke - 1] + 4. * w[ke - 2] - w[ke - 3]
    return w


def w_cons(ctx, w):
    """A copy of w under conservation-type ghosts."""
    return set_ghost_cells_w_4th(ctx, w.clone(), conservation=True)


def ghost_filled(bnd, ctx, s, sfc=None):
    """s with its ghost levels filled, the caller's tensors left as they
    are: a boundary that fills in place (the default one) fills copies."""
    if getattr(bnd, "in_place", False):
        s = {n: a.clone() for n, a in s.items()}
    return bnd.set_ghost_cells(ctx, s, sfc)


class DefaultBoundary:
    """swboundary=default: static BCs from the ini file, u and v relative to
    the grid's translation (utrans, vtrans)."""

    # set_ghost_cells writes into the tensors it is given
    in_place = True

    def __init__(self, ini, fields, grid):
        self.bcs = make_bcs(ini, fields)
        self.viscs = {"u": fields.visc, "v": fields.visc}
        for name, f in fields.sp.items():
            self.viscs[name] = f.visc
        self.offsets = {"u": grid.utrans, "v": grid.vtrans}

    def set_ghost_cells(self, ctx, s, sfc=None, names=None):
        """Fill the vertical ghost levels of every field (of ``names``
        only, when given), in place; returns s."""
        fill = (set_ghost_cells_field_2nd if ctx.spatial_order == 2
                else set_ghost_cells_field_4th)
        for name, bc in self.bcs.items():
            if names is None or name in names:
                fill(ctx, s[name], bc, self.viscs[name],
                     self.offsets.get(name, 0.))
        if ctx.spatial_order == 4 and (names is None or "w" in names):
            set_ghost_cells_w_4th(ctx, s["w"], conservation=False)
        return s

    def exec(self, ctx, s, sfc, aux):
        """The surface model's hook; the default scheme has none."""
        return sfc

    def init_surface_state(self, dtype=None):
        return {}

    def save(self, sfc, iotime, path="."):
        pass

    def load(self, sfc, iotime, path=".", dtype=None):
        return sfc
