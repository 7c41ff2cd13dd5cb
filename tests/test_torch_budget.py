"""The port's budgets (``microhh_torch/budget.py``, ``budget4.py``,
``budget4_kernels.py``) against the JAX package's, float64 on the CPU:

* budget_4 through the statistics of a seeded 4th-order channel state with
  a seeded pressure (moser180 as written, no thermo; and the weakscaling
  case with ``swbudget=4``, thermo buoy, for the buoyancy, b2, bw and
  ``b_sort`` terms): every profile <= 1e-10 of its scale
  (``chip_smoke.stats_scales``; budget terms by their largest term), with
  and without the pressure (the first sample has none);
* ``sorted_buoyancy_prof`` on a raw field with garbage ghosts, at the
  reference's bin count and at a coarse one, and on a uniform field;
* budget_2 on drycblles (thermo dry) and sullivan2011 (with the Coriolis
  terms) at ``swbudget=2``: the JAX package takes its pressure with edge
  ghosts, the port its solvers' interior pressure.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (DRYCBL_INI, case_ini, initial_state, o4_state,
                        stats_scales, unfolded_state)
from microhh_torch import cases
from test_torch_stats import as_file, diag_pair

N, KT = 8, 16


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def moser(n, k):
    return ("moser180", case_ini("moser180", itot=n[0], jtot=n[1], ktot=k),
            lambda: cases.moser180_input(k, 2.), lambda m: o4_state(m, 3))


def weakscaling_buoy(n, k):
    mem, zsize = cases.weakscaling_input(k)
    text = case_ini("weakscaling", itot=n[0], jtot=n[1], ktot=k,
                    zsize="%.17g" % zsize).replace(
        "[stats]\nswstats=0\n", "[stats]\nswstats=1\nsampletime=1\n")
    text += "\n[budget]\nswbudget=4\n"

    def state_of(m):
        st = o4_state(m, 4)
        g = m.grid
        rng = np.random.RandomState(5)
        st["b"][g.kstart:g.kend] += 0.1 * rng.randn(g.ktot, g.jtot, g.itot)
        return st
    return ("weakscaling", text, lambda: mem, state_of)


def seeded_p(shape, ks, ke, seed, ghosts):
    """A random pressure; ``ghosts`` 4: pres_4's two mirrored ghost rows a
    side, 2: pres_2's edge rows.  Returns (full, interior)."""
    p = np.random.RandomState(seed).randn(*shape)
    if ghosts == 4:
        p[ks - 1], p[ks - 2] = p[ks], p[ks + 1]
        p[ke], p[ke + 1] = p[ke - 1], p[ke - 2]
    else:
        p[:ks] = p[ks]
        p[ke:] = p[ke - 1]
    return p, p[ks:ke].copy()


def hold(tout, jout, tm, names):
    assert set(tout) == set(jout)
    assert set(names) <= set(tout)
    z = tm.grid.z[tm.grid.kstart:tm.grid.kend]
    budget = [n for n in tm_budget_names(tm) if n in jout]
    scales = stats_scales(as_file(jout, z, budget))
    for name in jout:
        key = ("budget" if name in budget else "default", name)
        assert tout[name].shape == jout[name].shape, name
        both_nan = np.isnan(tout[name]) & np.isnan(jout[name])
        d = np.where(both_nan, 0., np.abs(tout[name] - jout[name]))
        assert d.max() <= 1e-10 * scales[key], (name, d.max() / scales[key])


def tm_budget_names(tm):
    from microhh_torch.budget import Budget
    from microhh_torch.budget4 import FULL_TERMS, HALF_TERMS
    return set(Budget.FULL + Budget.HALF) | set(FULL_TERMS + HALF_TERMS) \
        | {"b_sort"}


@pytest.mark.parametrize("case", ["moser180", "weakscaling"])
@pytest.mark.parametrize("with_p", [True, False])
def test_budget4_matches_jax(case, with_p, tmp_path):
    spec = (moser if case == "moser180" else weakscaling_buoy)((N, 8), KT)
    p = pp = None
    if with_p:
        kc = KT + 6
        p, _ = seeded_p((kc, 8, N), 3, 3 + KT, 11, 4)
        pp = p
    tout, jout, tm = diag_pair(tmp_path, *spec, p=p, p_port=pp)
    names = {"tke", "u2_diss", "uw_visc", "w2_turb"}
    if with_p:
        names |= {"tke_pres", "uw_rdstr"}
    if case == "weakscaling":
        names |= {"tke_buoy", "b2_diss", "b_sort"}
        if with_p:
            names |= {"bw_pres", "bw_diss"}
    hold(tout, jout, tm, names)


def test_sorted_buoyancy_prof_matches_jax():
    import jax.numpy as jnp
    from microhh_tpu.budget4 import sorted_buoyancy_prof as jsorted
    from microhh_torch.budget4 import sorted_buoyancy_prof

    class Ctx:
        pass

    rng = np.random.default_rng(7)
    kgc, ktot, jtot, itot = 3, 12, 6, 8
    kc = ktot + 2 * kgc
    dz = np.full(kc, 0.1)
    dz[kgc:kgc + ktot] = 0.1 + 0.02 * np.arange(ktot)
    z = np.zeros(kc)
    z[kgc:kgc + ktot] = np.cumsum(dz[kgc:kgc + ktot]) - 0.5 * dz[kgc:kgc + ktot]
    jctx, tctx = Ctx(), Ctx()
    for c, conv in ((jctx, jnp.asarray), (tctx, torch.as_tensor)):
        c.ks, c.ke = kgc, kgc + ktot
        c.dz, c.z = conv(dz), conv(z)
    b = rng.normal(size=(kc, jtot, itot))
    b[kgc:kgc + ktot] += np.linspace(0., 1., ktot)[:, None, None]
    for field in (b, np.full_like(b, 0.3)):
        for nbins in (None, 17):
            want = np.asarray(jsorted(jctx, jnp.asarray(field), nbins))
            got = sorted_buoyancy_prof(tctx, torch.as_tensor(field),
                                       nbins).numpy()
            assert got.shape == (ktot,)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14,
                                       equal_nan=True)


@pytest.mark.parametrize("case", ["drycblles", "sullivan2011"])
def test_budget2_matches_jax(case, tmp_path):
    budget = "\n[budget]\nswbudget=2\n"
    if case == "drycblles":
        spec = ("drycblles", DRYCBL_INI % {"n": N, "k": KT}
                + "\n[stats]\nswstats=1\nsampletime=300\n" + budget,
                lambda: cases.drycblles_input(KT),
                lambda m: initial_state(m, 5))
    else:
        spec = ("sullivan2011", case_ini("sullivan2011", itot=N, jtot=N,
                                         ktot=KT) + budget,
                lambda: cases.sullivan2011_input(KT),
                lambda m: unfolded_state(m, 6))
    p, p_int = seeded_p((KT + 2, N, N), 1, 1 + KT, 12, 2)
    tout, jout, tm = diag_pair(tmp_path, *spec, p=p, p_port=p_int)
    names = {"tke_shear", "w2_turb", "uw_diss", "tke_pres", "vw_rdstr",
             "tke_buoy", "bw_visc", "bw_pres"}
    if case == "sullivan2011":
        names |= {"u2_cor", "vw_cor"}
    hold(tout, jout, tm, names)
