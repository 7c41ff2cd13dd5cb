"""True 4th-order TKE / variance / flux budget statistics
(``microhh_tpu/budget4.py``; reference ``src/budget_4.cxx``).

The terms are ``budget4_kernels.py``'s; this module assembles their inputs
as ``Budget_4::exec_stats`` does (budget_4.cxx:2804-2980):

* w' = w - <w>; wx / wy = 4th-order horizontal interps of w' to the u / v
  locations (grid.cxx interpolate_4th with symmetric ci weights);
* umean/vmean include ghost rows (the kernels reach k-3 .. k+3);
* p is the solver pressure with its two mirrored ghost rows
  (pres_4.cxx:497-521, ``Pres4.exec``'s aux["p"]); b is the thermo
  buoyancy field.

Profiles are horizontal means.  ``b_sort`` follows calc_sorted_prof
(budget_4.cxx:2565-2692): an equivalent-height histogram of the buoyancy
integrated back onto the grid heights."""

import torch

from . import budget4_kernels as bk
from . import fd
from .ops.stencil import im, ip, jm, jp


def _wx(w):
    """w interpolated to the u location (xh, y, zh)."""
    return fd.ci0 * im(w, 2) + fd.ci1 * im(w, 1) + fd.ci2 * w \
        + fd.ci3 * ip(w, 1)


def _wy(w):
    return fd.ci0 * jm(w, 2) + fd.ci1 * jm(w, 1) + fd.ci2 * w \
        + fd.ci3 * jp(w, 1)


def sorted_buoyancy_prof(ctx, b, nbins=None):
    """Sorted ("background potential energy") buoyancy profile b_sort.

    Mirrors calc_sorted_prof (budget_4.cxx:2565-2692): bin the interior
    buoyancy into ``nbins`` equal-width bins, each sample weighted by its
    equivalent height contribution dz[k]/(itot*jtot); integrate bin
    half-widths into a monotone height coordinate; then read the profile
    back at the grid's cell heights with the reference's linear
    bin-fraction correction.  ``nbins`` defaults to the reference's
    gd.nmax = itot*jtot*ktot.  Returns the ktot interior rows."""
    ks, ke = ctx.ks, ctx.ke
    data = b[ks:ke]
    ktot, jtot, itot = data.shape
    nmax = int(itot * jtot * ktot) if nbins is None else int(nbins)
    minval = data.min()
    maxval = data.max() * (1. + 1e-9)        # Constants::dsmall
    rng = maxval - minval
    uniform = rng < 1e-16
    dbin = torch.where(uniform, torch.ones_like(rng), rng / (nmax - 1))
    lo = minval - 0.5 * dbin
    idx = torch.clamp(((data - lo) / dbin).to(torch.int32), 0, nmax - 1)
    w = torch.broadcast_to((ctx.dz[ks:ke] / (itot * jtot))[:, None, None],
                           data.shape)
    hist = torch.zeros(nmax, dtype=data.dtype, device=data.device)
    hist.index_add_(0, idx.reshape(-1).long(), w.reshape(-1))
    # zpos[i] = equivalent height after integrating through bin centre i
    zpos = 0.5 * hist[0] + torch.cat(
        [torch.zeros(1, dtype=data.dtype, device=data.device),
         torch.cumsum(0.5 * (hist[:-1] + hist[1:]), 0)])
    z = ctx.z[ks:ke].contiguous()
    index = torch.clamp(torch.searchsorted(zpos, z, side="left"), 0, nmax - 1)
    profval = minval + index * dbin
    binm1 = hist[torch.clamp(index - 1, 0, nmax - 1)]
    dzfrac = (zpos[index] - z) / (0.5 * (binm1 + hist[index]))
    prof = torch.where(index == 0, profval, profval - dzfrac * dbin)
    return torch.where(uniform, minval, prof)


FULL_TERMS = ("ke", "tke",
              "u2_shear", "v2_shear", "tke_shear",
              "u2_turb", "v2_turb", "tke_turb",
              "tke_pres",
              "u2_visc", "v2_visc", "tke_visc",
              "u2_diss", "v2_diss", "tke_diss",
              "u2_rdstr", "v2_rdstr",
              "tke_buoy",
              "b2_shear", "b2_turb", "b2_visc", "b2_diss")
HALF_TERMS = ("uw_shear",
              "w2_turb", "uw_turb",
              "w2_pres", "uw_pres",
              "w2_visc", "uw_visc",
              "w2_diss", "uw_diss",
              "w2_rdstr", "uw_rdstr",
              "w2_buoy", "uw_buoy",
              "bw_shear", "bw_turb", "bw_visc", "bw_rdstr", "bw_buoy",
              "bw_diss", "bw_pres")


def budget4_profiles(ctx, s, aux, thermo, visc):
    """All budget_4 profiles as a dict of horizontal means."""
    ks, ke = ctx.ks, ctx.ke
    u, v, w = s["u"], s["v"], s["w"]
    has_thermo = hasattr(thermo, "get_buoyancy")

    def hmean(a):
        return torch.mean(a, dim=(1, 2))

    umean = hmean(u)
    vmean = hmean(v)
    wmean = hmean(w)
    w_p = w - wmean[:, None, None]
    wx = _wx(w_p)
    wy = _wy(w_p)

    A = {"u": u, "v": v, "w": w, "wx": wx, "wy": wy,
         "umean": umean, "vmean": vmean, "wmean": wmean,
         "umodel": umean, "vmodel": vmean, "wmodel": wmean,
         "dzi4": ctx.dzi4, "dzhi4": ctx.dzhi4,
         "dxi": float(ctx.dxi), "dyi": float(ctx.dyi),
         "dzhi4bot": float(ctx.dzhi4bot), "dzhi4top": float(ctx.dzhi4top),
         "visc": float(visc),
         "utrans": float(ctx.utrans), "vtrans": float(ctx.vtrans),
         "kstart": ks, "kend": ke, "_tmpl": u}

    terms = {}
    terms.update(bk.calc_ke(A))        # ke/tke use the RAW w
    A["w"] = w_p                       # every other kernel takes w'
    terms.update(bk.calc_tke_budget_shear(A))
    terms.update(bk.calc_tke_budget_turb(A))

    p = aux.get("p") if aux is not None else None
    if p is not None:
        A["p"] = p
        # upstream fills pmean from the BUOYANCY field (budget_4.cxx:2999,
        # a copy-paste slip); the JAX package and this port take the
        # pressure's own mean.
        A["pmean"] = hmean(p)
        terms.update(bk.calc_tke_budget_pres(A))

    visc_out = bk.calc_tke_budget_visc(A)
    visc_out.pop("wz", None)
    visc_out.pop("uz", None)
    terms.update(visc_out)
    terms.update(bk.calc_tke_budget_diss(A))
    if p is not None:
        terms.update(bk.calc_tke_budget_rdstr(A))

    if has_thermo:
        b = thermo.get_buoyancy(ctx, s)
        A["b"] = b
        A["bmean"] = hmean(b)
        terms.update(bk.calc_tke_budget_buoy(A))
        terms.update(bk.calc_b2_budget(A))
        if p is not None:
            bw1 = bk.calc_bw_budget_shear_turb_visc(A)
            A["bz"] = bw1.pop("bz")
            terms.update(bw1)
            terms.update(bk.calc_bw_budget_buoy_rdstr_diss_pres(A))

    out = {}
    for name, arr in terms.items():
        prof = hmean(arr)
        if name in HALF_TERMS:
            out[name] = prof[ks:ke + 1]       # half levels ks..ke
        else:
            out[name] = prof[ks:ke]           # full levels

    if has_thermo:
        out["b_sort"] = sorted_buoyancy_prof(ctx, A["b"])
    return out
