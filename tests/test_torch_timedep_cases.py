"""The time-dependent cases as written, in float64 on the CPU: two steps of arm (moist, its surface fluxes and large-scale thl and qt
  sources over time, the generic path) and gabls4s3 (2i4, its diurnal
  surface temperature, the generic path) at small sizes from the port's
in-memory inputs, against the JAX package fed the files that the cases'
scripts write (<= 1e-10), and from steep series of the test's own, without
whose updates the states move by more than 1e3 times that.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import case_ini
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.utils.nc import MemoryDataset
from test_torch_timedep import CONTROL, ROOT, TOL, pair_against_jax


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def script(case):
    return os.path.join(ROOT, "cases", case, "%s_input.py" % case)


# the cases at 8^2 x their script's levels, over 8 of their ini's grid
# spacings (arm 100 m, gabls4s3 5 m): at gabls4s3's 1280 m over 8 points
# the first adaptive step is 34 s long, after which two steps amplify a
# change of 1e-15 in th to 2e-9 in the state, the JAX package's and the
# port's alike
CASES = {"arm": (8, 64, 800.), "gabls4s3": (8, 288, 40.)}


def steep(case, mem):
    """The case's input with series of the test's own that change steeply
    over the first 10 s."""
    td = dict(mem.groups["timedep"].variables)
    t_sfc = np.array([0., 10., 1e5])
    if case == "arm":
        z = np.asarray(mem.variables["z"][:])
        prof = np.exp(-z / 1000.)
        td.update(time_surface=t_sfc, thl_sbot=np.array([-0.02, 0.4, 0.]),
                  qt_sbot=np.array([1e-6, 3e-4, 0.]),
                  time_ls=t_sfc, thl_ls=np.outer([0., 3e-3, 0.], prof),
                  qt_ls=np.outer([0., -2e-6, 0.], prof))
    else:
        td.update(time_surface=t_sfc, th_sbot=np.array([265., 300., 270.]))
    return MemoryDataset({"z": mem.variables["z"][:]},
                         {"init": dict(mem.groups["init"].variables),
                          "timedep": td})


@pytest.mark.parametrize("series", ["script", "steep"])
@pytest.mark.parametrize("case", list(CASES))
def test_case_two_steps_match_jax(tmp_path, case, series):
    """Two steps of the ini as written, small, from the port's in-memory
    input against the JAX package fed the file of the case's script; then
    from a steep series of the test's own, written for both, with the
    control: without the updates the port's state moves by more than 1e3
    times the tolerance."""
    n, k, size = CASES[case]
    text = case_ini(case, itot=n, jtot=n, xsize=size, ysize=size)
    ini = Ini(text)
    assert ini.get_int("grid", "ktot") == k
    mem = cases.case_input(case, k, ini.get_float("grid", "zsize"))
    if series == "script":
        tm, err, off = pair_against_jax(tmp_path, case, text, mem,
                                        script=script(case))
    else:
        tm, err, off = pair_against_jax(tmp_path, case, text,
                                        steep(case, mem))
        assert off >= CONTROL, off
    assert tm.generic and not tm.unfolded and tm.btimedep.items
    assert not tm._chunk_supported()
    if case == "arm":
        assert set(tm.force.tdep_ls) == {"thl", "qt"}
    else:
        assert tm.advec_fused is not None and tm.fused.stratified == 2
    assert err <= TOL, err


@pytest.mark.parametrize("case,n,k,forms", [
    ("gabls1", 8, 16, "kernel_cases"),
    ("arm", 8, 16, "generic_kernel_cases"),
    ("drycbl", (8, 4), 16, "o4_kernel_cases"),
    ("prandtlslope", (8, 4), 32, "o4_kernel_cases"),
    ("moser600", (8, 6), 16, "o4_kernel_cases")])
def test_chip_smoke_path_kernel_cases_on_the_cpu(case, n, k, forms,
                                                 monkeypatch):
    """chip_smoke.py's [28] check of a case's kernels at its path's shapes,
    on a small model of the case on the CPU (both calls take the plain
    version here): path_forms picks the path's cases, and they hold every
    kernel that the path launches."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    m = chip_smoke.build_case(torch, case, n, k, torch.float64, "cpu")
    m.build_step()
    cases_fn, timer = chip_smoke.path_forms(m)
    assert cases_fn is getattr(chip_smoke, forms)
    errs = chip_smoke.check_kernels_full(torch, m, cases_fn)
    assert {kern.name for kern in m.kernels()} <= set(errs)
    assert all(err == 0. for err in errs.values())
