"""Boundary-condition table and the 2nd-order top ghost fill
(``microhh_tpu/ops/boundary.py``; reference ``src/boundary.cxx`` ``set_bc``,
``calc_ghost_cells_top_2nd``).

Only the vertical ghost levels exist (horizontal periodicity is a roll, see
stencil.py).  The bottom ghosts come from the surface model
(boundary_surface.py).  The default boundary and the 4th-order fills are
not ported yet (ROADMAP Queue 1 items 14 and 11).
"""

import torch

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
