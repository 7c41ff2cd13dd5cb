"""``[source] swsource=1`` on the two steps other than the substep without the
RK fold, and the ``post`` mode, in float64 on the CPU:

* the RK-folded generic step: the 16x8x24 jaenschwalde ini without its
  ``scalar_outflow`` and ``flow_direction`` lines (closed edges, so the case
  stays on the RK-folded step) against the JAX Model, two RK3 steps <= 1e-10,
  and ``swsource=1`` against ``swsource=0``: the co2 fields differ;
* the 4th-order step: a 16^3 moser180 with a source on its scalar ``s``, the
  same two checks;
* ``run_case(..., "post")`` (ROADMAP item 15) re-reads the saved states and
  writes their statistics again.
"""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import case_ini, o4_state, unfolded_state
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_tpu.utils import nc as jnc
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.model import Model, run_case

SOURCE_ON_S = """
[source]
swsource=1
sourcelist=s
source_x0=6.
source_y0=2.
source_z0=0.7
sigma_x=1.5
sigma_y=0.8
sigma_z=0.3
strength=2.
swvmr=false
"""


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def closed_plume_ini(swsource):
    text = case_ini("jaenschwalde", itot=16, jtot=8, ktot=24,
                    swsource=swsource)
    text, n = re.subn(r"(?m)^(scalar_outflow=.*|flow_direction\[\w+\]=.*)\n",
                      "", text)
    assert n == 5
    return text


def moser_ini(swsource):
    text = case_ini("moser180", itot=16, jtot=16, ktot=16, swstats=0,
                    swbudget=0)
    return text + SOURCE_ON_S.replace("swsource=1", "swsource=%d" % swsource)


CASES = {
    "generic": ("jaenschwalde", closed_plume_ini,
                lambda: cases.jaenschwalde_input(24),
                lambda m: unfolded_state(m, 3), "co2", (2.0, 3.0)),
    "fourth_order": ("moser180", moser_ini,
                     lambda: cases.moser180_input(16, 2.),
                     lambda m: o4_state(m, 3), "s", (0.5, 0.25)),
}


def port_model(casename, text, mem):
    m = Model(Ini(text), "run", casename, dtype=torch.float64, device="cpu",
              input_nc=mem)
    m.finish_setup()
    m.build_step()
    return m


def two_steps(m, state, dts):
    s, sfc = m.as_device_state({k: v.copy() for k, v in state.items()})
    for dt in dts:
        s, sfc, aux = m.step(s, sfc, dt)
    return s, aux


@pytest.mark.parametrize("path", list(CASES))
def test_source_is_applied_and_matches_jax(path, tmp_path):
    casename, ini_of, mem_of, state_of, scalar, dts = CASES[path]
    mem = mem_of()
    tm = port_model(casename, ini_of(1), mem)
    assert tm.source is not None and not tm.unfolded
    assert tm.generic == (path == "generic")
    assert (tm.o4 is not None) == (path == "fourth_order")
    state = state_of(tm)

    z = np.asarray(mem.variables["z"][:])
    f = jnc.Dataset(os.path.join(str(tmp_path), "%s_input.nc" % casename), "w")
    f.createDimension("z", len(z))
    f.createVariable("z", "f8", ("z",))[:] = z
    g = f.createGroup("init")
    for name, var in mem.groups["init"].variables.items():
        g.createVariable(name, "f8", ("z",))[:] = np.asarray(var[:])
    f.close()
    jm = JModel(JIni(ini_of(1)), "run", casename, workdir=str(tmp_path),
                dtype=np.float64)
    jm.force_fused = True
    jm.finish_setup()
    jm.build_step()
    assert jm.source.sw
    if path == "generic":
        assert jm._use_rkfold_generic and not jm.outflow.active
    js, _, jsfc = jm.as_device_state({k: v.copy() for k, v in state.items()})
    for dt in dts:
        js, jsfc, jaux = jm._step_fn(js, jsfc, jm.pres_params,
                                     jnp.float64(dt), jnp.float64(0.))

    ts, taux = two_steps(tm, state, dts)
    ks, ke = tm.ctx.ks, tm.ctx.ke
    for n in ts:
        assert rel(ts[n][ks:ke], np.asarray(js[n])[ks:ke]) <= 1e-10, n
    pj, pt = (a[ks:ke] if a.shape[0] == tm.ctx.kcells else a
              for a in (np.asarray(jaux["p"]), taux["p"].numpy()))
    assert rel(pt, pj) <= 1e-10

    # without the source the scalar differs, and nothing else does
    off = port_model(casename, ini_of(0), mem_of())
    assert off.source is None
    os_, _ = two_steps(off, state, dts)
    assert rel(ts[scalar][ks:ke], os_[scalar][ks:ke]) > 1e-6
    for n in ("u", "v", "w"):
        if path == "fourth_order":      # s is passive
            assert torch.equal(ts[n], os_[n]), n


def test_post_mode_names_its_roadmap_item(tmp_path):
    """post mode (ROADMAP item 15, done) runs: drycblles 8^2 x 16 run to
    600 s with a restart every 300 s, then post at postproctime 300 reads
    each saved state back and writes its statistics, whose horizontal means
    of u and th equal the run's samples of the same states."""
    text = case_ini("drycblles", itot=8, jtot=8, ktot=16, endtime=600,
                    savetime=300)
    text = text.replace("starttime=0", "starttime=0\npostproctime=300")
    (tmp_path / "drycblles.ini").write_text(text)
    mem = cases.drycblles_input(16)
    wd = str(tmp_path)
    for mode in ("init", "run"):
        run_case(wd, "drycblles", mode, dtype=torch.float64, device="cpu",
                 input_nc=mem)
    name = os.path.join(wd, "drycblles.default.0000000.nc")
    os.rename(name, name + ".run")
    m = run_case(wd, "drycblles", "post", dtype=torch.float64, device="cpu",
                 input_nc=mem)
    assert m.timeloop.itime > m.timeloop.iendtime
    from microhh_torch.stats import open_stats
    with open_stats(name + ".run") as f, open_stats(name) as g:
        assert list(g.variables["time"][:]) == [0., 300., 600.]
        assert list(f.variables["time"][:]) == [0., 300., 600.]
        assert np.array_equal(f.variables["iter"][:], g.variables["iter"][:])
        for var in ("u", "th"):
            a = np.asarray(f.groups["default"].variables[var][:])
            b = np.asarray(g.groups["default"].variables[var][:])
            assert rel(b, a) <= 1e-12, var
