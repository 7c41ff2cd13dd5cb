"""The 4th-order DNS cases whose inputs the port now computes in memory
(``cases.drycbl_input``, ``prandtlslope_input``, ``rayleighbenard_input``,
``rayleightaylor_input``, ``moser600_input``), each as its ini is written:
two steps of ``Model.run`` on the port's 4th-order path (K16, K17) from the
in-memory input against the JAX package fed the file of the case's script,
in float64 on the CPU (<= 1e-10 of each field's maximum).  moser600 runs at
16^2 x 32 (its script takes the ini's ktot), the others at their ini's
size."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import case_ini
from microhh_torch import cases
from microhh_torch.config import Ini
from test_torch_timedep import (ROOT, TOL, initial_files, jax_run, port_run,
                                state_err)

CASES = {"drycbl": {}, "prandtlslope": {}, "rayleighbenard": {},
         "rayleightaylor": {},
         "moser600": {"itot": 16, "jtot": 16, "ktot": 32, "swstats": 0,
                      "swbudget": 0}}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("case", list(CASES))
def test_case_two_steps_match_jax(tmp_path, case):
    text = case_ini(case, **CASES[case])
    ini = Ini(text)
    mem = cases.case_input(case, ini.get_int("grid", "ktot"),
                           ini.get_float("grid", "zsize"))
    jdir, tdir = initial_files(
        tmp_path, case, text,
        script=os.path.join(ROOT, "cases", case, "%s_input.py" % case))
    _, js = jax_run(jdir, case, text, 2)
    tm, ts = port_run(tdir, case, text, mem, 2)
    assert tm.o4 is not None
    assert [k.name for k in tm.kernels()] == ["o4_mom", "o4_scalars"]
    assert tm._chunk_supported()
    assert all(np.isfinite(v).all() for v in ts.values())
    assert state_err(tm, ts, js) <= TOL
