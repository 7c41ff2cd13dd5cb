"""``microhh_torch/ring_timing.py`` on the CPU, at tiny shapes: what it
reads from a build log and how it wires its timed calls, without a card.

* ``ptxas_info`` reads a kernel's template arguments and registers from
  nvcc's ptxas lines;
* every CUDA function the script looks up is a ``__global__`` function of
  ``csrc/`` (this tree's names; the older layout's names are those of the
  tree before the scalar sweep's k-march);
* each timed group runs end to end on the CPU at a tiny shape of its case
  (the wrappers take their plain versions there), with CUDA-event timing
  replaced by one call: the scalar sweep's rows (K10 with advection off
  and on; K19 once a scalar and in one launch) and the rows of the kernels
  that call ``s_tend`` (K2, K22, K20, K15).
"""

import os
import re

import pytest
import torch

from microhh_torch import ring_timing as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "microhh_torch", "csrc")
INFO = {"registers": 64, "local_bytes": 0, "smem": 0, "blocks_per_sm": 3,
        "sms": 132}


def _globals():
    """Names of the __global__ functions of csrc/: the name after the
    qualifier, its return type and its launch bounds, if any."""
    names = set()
    for f in os.listdir(CSRC):
        if not f.endswith(".cu"):
            continue
        with open(os.path.join(CSRC, f)) as fh:
            text = fh.read()
        for hit in re.finditer(r"__global__\s+void\s+", text):
            i = hit.end()
            if text.startswith("__launch_bounds__", i):
                depth, i = 0, text.index("(", i)
                while True:
                    depth += {"(": 1, ")": -1}.get(text[i], 0)
                    i += 1
                    if depth == 0:
                        break
            names.add(re.match(r"\s*(\w+)\s*\(", text[i:]).group(1))
    return names


@pytest.fixture
def one_call(monkeypatch):
    monkeypatch.setattr(R, "events_ms", lambda fn, reps=0: (fn(), 1.0)[1])


def test_ptxas_info_reads_template_arguments_and_registers():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN3mhh19scalar_sweep_kernelIfLb1ELb0ELi4EEEvNS_9SweepArgsIT_EE' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 79 registers, 25152 bytes smem"])
    assert R.ptxas_info(log) == {
        "scalar_sweep_kernel<float,true,false,4>": {
            "stack": 0, "spill_stores": 8, "spill_loads": 4,
            "registers": 79}}


@pytest.mark.parametrize("name", sorted(set(R.FUNCTIONS.values())
                                        | set(R.S_TEND_FUNCTIONS.values())
                                        | {R.SWEEP}))
def test_timed_functions_are_kernels_of_the_sources(name):
    assert name in _globals()


def test_sweep_function_keys():
    f32 = torch.float32
    assert (R.sweep_function("tend_scalars", f32, True, 4, False)
            == "scalar_sweep_kernel<float,true,true,4>")
    assert (R.sweep_function("tend_scalar_acc", torch.float64, False, 3,
                             False)
            == "scalar_sweep_kernel<double,false,false,3>")
    # the older layout: K10 and K19 as ring kernels, whatever S and advec
    assert (R.sweep_function("tend_scalars", f32, True, 4, True)
            == "tend_scalars_kernel<float>")
    assert (R.sweep_function("tend_scalar_acc", f32, False, 1, True)
            == "tend_scalar_kernel<float,false>")


@pytest.mark.parametrize("label,shape", [("rico", (40, 24, 16)),
                                         ("jaenschwalde", (64, 16, 8))])
def test_sweep_rows_run_on_the_cpu(label, shape, one_call, tmp_path):
    torch.manual_seed(3)
    m = R.build("rico", *shape, torch.float32, str(tmp_path), device="cpu")
    m.fused.k_scalars.info = lambda *a: INFO
    m.fused.k_scalar_acc.info = lambda *a: INFO
    full = (m.ctx.kcells, shape[1], shape[0])
    S = 4 if label == "rico" else 3
    rows = R.sweep_rows(m, label, shape, torch.float32, S, {}, "cpu",
                        lambda scale=1.: scale * torch.randn(full))
    forms = [(r["kernel"], r["form"], r["advec"], r["function"])
             for r in rows]
    if label == "rico":
        assert forms == [
            ("tend_scalars", "one launch", False,
             "scalar_sweep_kernel<float,true,false,4>"),
            ("tend_scalars", "one launch", True,
             "scalar_sweep_kernel<float,true,true,4>")]
    else:
        assert forms == [
            ("tend_scalar_acc", "one launch a scalar", False,
             "scalar_sweep_kernel<float,false,false,1>"),
            ("tend_scalar_acc", "one launch", False,
             "scalar_sweep_kernel<float,false,false,3>")]
    for r in rows:
        assert r["chunks"] >= 1 and r["blocks_per_sm"] == 3
        assert r["gbytes"] > 0 and r["bound_ms"] > 0


@pytest.mark.parametrize("label,case,shape,step", R.S_TEND_SHAPES,
                         ids=[s[0] for s in R.S_TEND_SHAPES])
def test_s_tend_rows_run_on_the_cpu(label, case, shape, step, one_call):
    torch.manual_seed(3)
    rows = R.s_tend_rows(label, case, (16, 8, 12), step, {}, "cpu",
                         device="cpu")
    want = {"drycblles": ["tend_rk", "tend_rk_fold"],
            "sullivan2011": ["tendencies"],
            "SBL_Smag": ["tend_scalar_rk"]}[case]
    assert [r["kernel"] for r in rows] == want
    for r in rows:
        assert r["function"] == "%s<float>" % R.S_TEND_FUNCTIONS[r["kernel"]]
        assert r["bound_ms"] > 0 and r["shape"] == [16, 8, 12]
