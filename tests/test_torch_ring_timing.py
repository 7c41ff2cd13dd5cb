"""``microhh_torch/ring_timing.py`` on the CPU, at tiny shapes: what it
reads from a build log and how it wires its timed calls, without a card.

* ``ptxas_info`` reads a kernel's template arguments and registers from
  nvcc's ptxas lines;
* every CUDA function the script looks up is a ``__global__`` function of
  ``csrc/``;
* ``sass_sections`` cuts a cuobjdump listing at its barriers and counts
  each section's instructions, FP64 and MUFU ones apart, and
  ``micro2_issue`` turns K11's six sections into an issue time;
  ``sass_loops`` finds K22's per-level loop (a backward branch around a
  barrier, the code after the kernel's last EXIT left out) and
  ``fold_issue`` turns it into instructions a point and an issue time;
* each timed group runs end to end on the CPU at a tiny shape of its case
  (the wrappers take their plain versions there), with CUDA-event timing
  replaced by one call: the scalar sweep's rows (K10 with advection off
  and on; K19 once a scalar and in one launch), the rows of the kernels
  that call ``s_tend`` (K2, K22, K20), K22's on its other paths
  (``fold_rows``: both forms, with its occupancy, chunks, waves and
  one-chunk time), K11's (the cell's state and heavy rain) and K16's and
  K17's at the weakscaling and moser180 shapes (``time_shape``: K17 with
  its plan, occupancy, a forced one-chunk run and the SASS count of its
  per-level loop), K12's and K13's at rico's (K12 with the same columns;
  ``only`` times K12 alone, as for its float64 row), and the momentum
  sweep's (``uvw_rows``: K8/K9 with advection on and off, K18) with the
  same columns, and without them where the tree's kernel reports no
  occupancy (an earlier tree's); K1's and K14's (``evisc_rows``: the
  kernel and mode of each case, K7's time beside it) and K7's
  (``limits_rows``: the mode of each of its paths, K1's or K14's time
  beside it) with the same columns, or without them and under the ring's
  key on an earlier tree; K15's (``scalar_rk_rows``: its fold on and
  off, the sweep's columns, the info asked in the fold's form) and K3's
  (``tdma_rows``: the plan's form and the sweep form beside it, with
  form, chunk length, occupancy and waves) and the chunked loop's
  (``chunk_rows``: the graphs' and the eager body's walls; no span or
  device time on the CPU);
* ``sass_digests`` gives each kernel instance of a listing one digest of
  its instructions, the same for the same code at other addresses, and
  ``compare_digests`` holds two builds' digests, through the caller's map
  of renamed instances.
"""

import os
import re

import pytest
import torch

from microhh_torch import ring_timing as R
from microhh_torch.ops import microphys as MP

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
                                        | set(R.TDMA.values())
                                        | {R.SWEEP, R.MICRO2, R.UVW,
                                           R.EVISC, R.LIMITS, R.APPLY}))
def test_timed_functions_are_kernels_of_the_sources(name):
    assert name in _globals()


def test_sweep_function_keys():
    f32 = torch.float32
    assert (R.sweep_function("tend_scalars", f32, True, 4)
            == "scalar_sweep_kernel<float,true,true,4,true>")
    assert (R.sweep_function("tend_scalar_acc", torch.float64, False, 3)
            == "scalar_sweep_kernel<double,false,false,3,false>")
    # K15: the RK form at one scalar, its fold the last argument
    assert (R.sweep_function("tend_scalars", f32, True, 1, False)
            == "scalar_sweep_kernel<float,true,true,1,false>")
    assert (R.sweep_function("tend_scalars", f32, False, 1)
            == "scalar_sweep_kernel<float,true,false,1,true>")
    # K19 has no fold, whatever the flag
    assert (R.sweep_function("tend_scalar_acc", f32, True, 2, True)
            == "scalar_sweep_kernel<float,false,true,2,false>")


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
             "scalar_sweep_kernel<float,true,false,4,true>"),
            ("tend_scalars", "one launch", True,
             "scalar_sweep_kernel<float,true,true,4,true>")]
    else:
        assert forms == [
            ("tend_scalar_acc", "one launch a scalar", False,
             "scalar_sweep_kernel<float,false,false,1,false>"),
            ("tend_scalar_acc", "one launch", False,
             "scalar_sweep_kernel<float,false,false,3,false>")]
    for r in rows:
        assert r["chunks"] >= 1 and r["blocks_per_sm"] == 3
        assert r["gbytes"] > 0 and r["bound_ms"] > 0


@pytest.mark.parametrize("label,case,shape,step", R.S_TEND_SHAPES,
                         ids=[s[0] for s in R.S_TEND_SHAPES])
def test_s_tend_rows_run_on_the_cpu(label, case, shape, step, one_call,
                                    monkeypatch):
    from microhh_torch import kernels
    torch.manual_seed(3)
    # K22's row asks the card for its occupancy (fold_extra)
    monkeypatch.setattr(kernels.Kernel, "info", lambda self, *a: INFO)
    rows = R.s_tend_rows(label, case, (16, 8, 12), step, {}, "cpu",
                         device="cpu")
    want = {"drycblles": ["tend_rk", "tend_rk_fold"],
            "sullivan2011": ["tendencies"]}[case]
    assert [r["kernel"] for r in rows] == want
    for r in rows:
        # K22 is templated on its thermo flag, K20 and K2 are the momentum
        # sweep's instances with its DRY and TH flags, without RK and with
        want = {"tend_rk_fold": "<float,true>",
                "tendencies": "<float,false,true,true>",
                "tend_rk": "<float,true,true,true>"}[r["kernel"]]
        assert r["function"] == R.S_TEND_FUNCTIONS[r["kernel"]] + want
        assert r["bound_ms"] > 0 and r["shape"] == [16, 8, 12]
        assert r["blocks_per_sm"] == 3 and r["chunks"] >= 1
        assert r["ms_one_chunk"] == 1.0


# a cuobjdump -sass listing in the form the CUDA toolkit prints it: two
# kernels, K11's with five barriers and a slow-path subroutine after its
# body
SASS = """
\t\tFunction : _ZN3mhh13micro2_kernelIfEEvPKT_S3_S3_S3_PS1_S4_S4_S4_S3_S4_S3_iiiiiS1_S1_
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   MUFU.LG2 R2, R3 ;
        /*0040*/              @!P0 FFMA R2, R3, R4, R5 ;
        /*0050*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0060*/                   FMNMX R2, R3, R4, !PT ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/               @P1 FFMA R2, R3, R4, R5 ;
        /*0090*/                   FFMA R2, R3, R4, R5 ;
        /*00a0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00b0*/                   FADD R2, R3, R4 ;
        /*00c0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00d0*/                   STG.E desc[UR4][R2.64], R5 ;
        /*00e0*/              @!P2 CALL.REL.NOINC 0x100 ;
        /*00f0*/                   EXIT ;
        /*0100*/                   FCHK P0, R2, R3 ;
        /*0110*/                   MUFU.RCP R4, R3 ;
        /*0120*/                   RET.REL.NODEC R2 0x0 ;
        /*0130*/                   BRA 0x130;
        /*0140*/                   NOP;
\t\t..........

\t\tFunction : _ZN3mhh13micro2_kernelIdEEvPKT_S3_S3_S3_PS1_S4_S4_S4_S3_S4_S3_iiiiiS1_S1_
        /*0000*/                   DFMA R2, R4, R6, R8 ;
        /*0010*/              @!UP0 DADD R2, R4, R6 ;
\t\tFunction : _ZN3mhh12tdma_kernelIfEEvPT_
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
"""


def test_sass_sections_cut_at_barriers():
    got = R.sass_sections(SASS, R.MICRO2)
    assert set(got) == {"micro2_kernel<float>", "micro2_kernel<double>"}
    f32 = got["micro2_kernel<float>"]
    assert [sec["total"] for sec in f32] == [3, 3, 2, 3, 2, 3]
    assert [sec["mufu"] for sec in f32] == [0, 1, 0, 0, 0, 0]
    assert got["micro2_kernel<double>"] == [{"total": 2, "fp64": 2,
                                             "mufu": 0}]
    # K11 at rico 384^3: 4608 blocks of 8 warps, 384 / M2_W windows, a
    # warp's loops run M2_RPT levels a window
    out = R.micro2_issue(f32, (384, 384, 384), 4, 1.98, 132)
    warps = 12 * 384 * (384 // MP.M2_W) * 8 * MP.M2_RPT
    per = 3 + 2 + 3 * 4 / 8 + 3
    assert out["issue_ms"] == pytest.approx(
        1e3 * warps * per / (132 * 4 * 1.98e9))
    assert out["issue_bound_by"] == "total"
    assert out["instructions_a_point"] == pytest.approx(per)
    assert R.micro2_issue(got["micro2_kernel<double>"], (384, 384, 384),
                          4, 1.98, 132) is None


def test_micro2_rows_run_on_the_cpu(one_call, tmp_path):
    torch.manual_seed(3)
    shape = (40, 8, 40)
    m = R.build("rico", *shape, torch.float32, str(tmp_path), device="cpu")
    m.micro.k_micro.info = lambda *a: dict(INFO, blocks_per_sm=4)
    sections = R.sass_sections(SASS, R.MICRO2)
    rows = R.micro2_rows(m, "rico", shape, torch.float32, {}, "cpu",
                         sections, 1.98)
    assert [r["state"] for r in rows] == ["cell", "heavy rain"]
    for r in rows:
        assert r["function"] == "micro2_kernel<float>" and r["nsed"] == 4
        assert r["blocks"] == 2 * 8 and r["waves"] == 16 / (4 * 132)
        assert r["issue_ms"] > 0 and len(r["sass_sections"]) == 6
        assert r["gbytes"] == pytest.approx(13 * 40 * 8 * 40 * 4 / 1e9)
    # the heavy-rain state rains, the cell's own does not
    s, ql, dt = R.micro2_state(m, False)
    assert float(s["qr"].abs().max()) == 0.
    s, ql, dt = R.micro2_state(m, True)
    assert float(s["qr"].max()) > 0.
    assert dt == 2.5 * float(m.grid.dz.min()) / 9.65


# K22's k-loop around its barrier (after the warm-up's), an inner loop
# without one, a slow-path subroutine and, after the kernel's last EXIT,
# the path a diverged warp takes to the barrier
FOLD_SASS = """
\t\tFunction : _ZN3mhh19tend_rk_fold_kernelIfLb1EEEvNS_8FoldArgsIT_EE
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   FADD R2, R3, R4 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/                   LDS R2, [R3] ;
        /*0050*/                   FMUL R2, R3, R4 ;
        /*0060*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0070*/               @P1 BRA 0x50 ;
        /*0080*/                   STG.E desc[UR4][R2.64], R5 ;
        /*0090*/              @!P2 CALL.REL.NOINC 0x110 ;
        /*00a0*/               @P3 BRA 0x30 ;
        /*00b0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00c0*/               @P0 EXIT ;
        /*00d0*/                   STG.E desc[UR4][R2.64], R6 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BAR.SYNC.DEFER_BLOCKING R2, R2 ;
        /*0100*/                   BRA 0x40 ;
        /*0110*/                   MUFU.RCP R4, R3 ;
        /*0120*/                   BRA 0x110 ;
"""


def test_sass_loops_and_fold_issue():
    loops = R.sass_loops(FOLD_SASS, R.S_TEND_FUNCTIONS["tend_rk_fold"])
    (key, found), = loops.items()
    assert key == "tend_rk_fold_kernel<float,true>"
    assert R.fold_function(torch.float32, True, loops) == key
    assert (R.fold_function(torch.float64, False, {"x<double>"})
            == "tend_rk_fold_kernel<double,false>")
    # the PR-6 form's instance, where a build holds it
    assert (R.fold_function(torch.float32, True,
                            {"tend_rk_fold_kernel<float>"})
            == "tend_rk_fold_kernel<float>")
    # the k-loop 0x30-0xa0; the inner loop has no barrier, and the diverged
    # warp's branch back lies past the last EXIT
    assert found == [{"total": 8, "fp64": 0, "mufu": 0, "bar": 1}]
    out = R.fold_issue(found, (64, 16, 10), 8, 2.0, 132)
    assert out["instructions_a_point"] == 8
    warps = 2 * 2 * 8 * 10
    assert out["issue_ms"] == pytest.approx(
        1e3 * warps * 8 / (132 * 4 * 2.0e9))
    assert out["issue_bound_by"] == "total"
    assert R.fold_issue([], (64, 16, 10), 8, 2.0, 132) is None
    assert R.fold_issue(found * 2, (64, 16, 10), 8, 2.0, 132) is None


@pytest.mark.parametrize("label,case,shape,dtype", R.FOLD_SHAPES,
                         ids=[s[0] + " " + str(s[3])[6:] for s in R.FOLD_SHAPES])
def test_fold_rows_run_on_the_cpu(label, case, shape, dtype, one_call,
                                  monkeypatch):
    from microhh_torch import kernels
    torch.manual_seed(3)
    monkeypatch.setattr(kernels.Kernel, "info", lambda self, *a: INFO)
    found = R.sass_loops(FOLD_SASS, R.S_TEND_FUNCTIONS["tend_rk_fold"])
    loops = {"tend_rk_fold_kernel<%s,%s>" % (t, th): found[
        "tend_rk_fold_kernel<float,true>"] for t in ("float", "double")
        for th in ("true", "false")}
    rows = R.fold_rows(label, case, (40, 16, 12), dtype, {}, "cpu", loops,
                       1.98, device="cpu")
    assert [r["form"] for r in rows] == ["evisc", "e_in"]
    thermo = "false" if case == "andren1994" else "true"
    for r in rows:
        assert r["function"] == "tend_rk_fold_kernel<%s,%s>" % (
            "float" if dtype == torch.float32 else "double", thermo)
        assert r["kernel"] == "tend_rk_fold" and r["dtype"] == str(dtype)[6:]
        assert r["blocks_per_sm"] == 3 and r["registers"] == 64
        assert r["chunks"] >= 1 and r["ms_one_chunk"] == 1.0
        assert r["blocks"] == 2 * 2 * r["chunks"]
        assert r["instructions_a_point"] == 8
        nf = 3 if case == "andren1994" else 4
        assert r["gbytes"] == pytest.approx(
            (4 * nf + 2) * 40 * 16 * 12 * torch.finfo(dtype).bits / 8 / 1e9)


# K17's per-level loop around its barrier, after the warm-up's
K17_SASS = """
\t\tFunction : _ZN3mhh2o417o4_scalars_kernelIfLb0ELi1EEEvPKT_S4_S4_NS0_9O4ScalarsIS2_EES4_iiiiS2_S2_ii
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0040*/                   LDS R2, [R3] ;
        /*0050*/                   FFMA R2, R3, R4, R5 ;
        /*0060*/                   STG.E desc[UR4][R2.64], R5 ;
        /*0070*/               @P3 BRA 0x20 ;
        /*0080*/                   EXIT ;
"""


def test_k17_variant_keys():
    """K17's ptxas and SASS key: the k-march's <T, M, S>, and the earlier
    <T, M> of a tree whose K17 reports no occupancy."""
    from microhh_torch import kernels
    loops = R.sass_loops(K17_SASS, R.FUNCTIONS["o4_scalars"])
    assert list(loops) == ["o4_scalars_kernel<float,false,1>"]
    assert loops["o4_scalars_kernel<float,false,1>"] == [
        {"total": 6, "fp64": 0, "mufu": 0, "bar": 1}]
    assert (R.variant("o4_scalars", torch.float32, "4", 1)
            == "float,false,1")
    assert (R.variant("o4_scalars", torch.float64, "4m", 2)
            == "double,true,2")
    assert R.variant("o4_mom", torch.float64, "4m", 1) == "double,true"
    info = tuple(k for k in kernels.INFO if k != "o4_scalars")
    import unittest.mock
    with unittest.mock.patch.object(kernels, "INFO", info):
        assert (R.variant("o4_scalars", torch.float32, "4", 1)
                == "float,false")


@pytest.mark.parametrize("label,case,dtype", [
    ("weakscaling", "weakscaling", torch.float32),
    ("moser180", "moser180", torch.float64)])
def test_o4_rows_run_on_the_cpu(label, case, dtype, one_call, monkeypatch):
    """K16's and K17's rows at a tiny shape of their cells: K17 with the
    plan's chunks, blocks and waves, its occupancy, a forced one-chunk run
    (chunks=1 through the wrapper) and its SASS count a point."""
    from microhh_torch import kernels
    from microhh_torch.ops import kmarch
    torch.manual_seed(3)
    monkeypatch.setattr(kernels.Kernel, "info", lambda self, *a: INFO)
    found = R.sass_loops(K17_SASS, R.FUNCTIONS["o4_scalars"])
    t = "float" if dtype == torch.float32 else "double"
    scheme = "false" if case == "weakscaling" else "true"
    key = "o4_scalars_kernel<%s,%s,1>" % (t, scheme)
    loops = {key: found["o4_scalars_kernel<float,false,1>"]}
    seen = []
    from microhh_torch.ops import o4_fused as O4
    real = O4.O4Fused.scalars

    def scalars(self, *a, chunks=None):
        seen.append(chunks)
        return real(self, *a, chunks=chunks)

    monkeypatch.setattr(O4.O4Fused, "scalars", scalars)
    shape = (40, 16, 12)
    rows = R.time_shape(label, case, shape, dtype, 1, {}, "cpu", loops,
                        1.98, device="cpu")
    assert [r["kernel"] for r in rows] == ["o4_mom", "o4_scalars"]
    k16, k17 = rows
    assert k16["function"] == "o4_mom_kernel<%s,%s>" % (t, scheme)
    assert k17["function"] == key and "instructions_a_point" not in k16
    p = kmarch.plan("o4_scalars", 40, 16, 12, 1, dtype, 396)
    assert (k17["chunks"], k17["waves"]) == (p.chunks, p.waves)
    assert k17["blocks"] == 2 * 2 * p.chunks and k17["blocks_per_sm"] == 3
    assert k17["ms_one_chunk"] == 1.0 and seen == [None, 1]
    assert k17["instructions_a_point"] == 6
    warps = 2 * 2 * kmarch.K17_TJ * 12
    assert k17["issue_ms"] == pytest.approx(1e3 * warps * 6
                                            / (132 * 4 * 1.98e9))
    assert k17["gbytes"] == pytest.approx(
        6 * 40 * 16 * 12 * torch.finfo(dtype).bits / 8 / 1e9)


# K12's per-level loop around its barrier, after the warm-up's
K12_SASS = """
\t\tFunction : _ZN3mhh16advec_mom_kernelIfLb0ELb1EEEvPKT_S3_S3_PS1_S4_S4_S3_iiiiS1_S1_ii
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   LDS R2, [R3] ;
        /*0040*/                   FFMA R2, R3, R4, R5 ;
        /*0050*/                   FFMA R2, R3, R4, R5 ;
        /*0060*/                   STG.E desc[UR4][R2.64], R5 ;
        /*0070*/               @P3 BRA 0x20 ;
        /*0080*/                   EXIT ;
"""


def test_sass_digests_follow_the_code_not_the_addresses():
    got = R.sass_digests(K12_SASS + K17_SASS)
    assert set(got) == {"advec_mom_kernel<float,false,true>",
                        "o4_scalars_kernel<float,false,1>"}
    moved = K12_SASS.replace("/*00", "/*01")
    assert (R.sass_digests(moved)["advec_mom_kernel<float,false,true>"]
            == got["advec_mom_kernel<float,false,true>"])
    edited = K12_SASS.replace("LDS R2, [R3]", "LDS R2, [R3+0x4]")
    assert (R.sass_digests(edited)["advec_mom_kernel<float,false,true>"]
            != got["advec_mom_kernel<float,false,true>"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rico_rows_run_on_the_cpu(dtype, one_call, monkeypatch):
    """K13's and K12's rows at a tiny shape of the rico cell in 2i5: K12
    with its plan's chunks, blocks and waves, its occupancy, a forced
    one-chunk run and the SASS count of its per-level loop; with only, K12
    alone and no scalar sweep."""
    from microhh_torch import kernels
    from microhh_torch.ops import advec_interp_fused as A
    from microhh_torch.ops import kmarch
    torch.manual_seed(3)
    monkeypatch.setattr(kernels.Kernel, "info", lambda self, *a: INFO)
    t = "float" if dtype == torch.float32 else "double"
    key = "advec_mom_kernel<%s,false,true>" % t
    loops = {key: R.sass_loops(K12_SASS, R.FUNCTIONS["advec_mom"])[
        "advec_mom_kernel<float,false,true>"]}
    seen = []
    real = A.AdvecInterpFused.momentum

    def momentum(self, *a, chunks=None):
        seen.append(chunks)
        return real(self, *a, chunks=chunks)

    monkeypatch.setattr(A.AdvecInterpFused, "momentum", momentum)
    shape = (40, 16, 12)
    rows = R.time_shape("rico", "rico", shape, dtype, 4, {}, "cpu", loops,
                        1.98, device="cpu", only=("advec_scalars",
                                                  "advec_mom"))
    assert [r["kernel"] for r in rows] == ["advec_scalars", "advec_mom"]
    k13, k12 = rows
    assert k12["function"] == key and "instructions_a_point" not in k13
    assert k13["function"] == "advec_scalars_kernel<%s,false,true,4>" % t
    p = kmarch.plan("advec_mom", 40, 16, 12, 0, dtype, 396)
    assert (k12["chunks"], k12["waves"]) == (p.chunks, p.waves)
    assert k12["blocks"] == 2 * 2 * p.chunks and k12["blocks_per_sm"] == 3
    assert k12["ms_one_chunk"] == 1.0 and seen == [None, 1]
    assert k12["instructions_a_point"] == 6
    warps = 2 * 2 * kmarch.K12_TJ * 12
    assert k12["issue_ms"] == pytest.approx(1e3 * warps * 6
                                            / (132 * 4 * 1.98e9))
    assert k12["gbytes"] == pytest.approx(
        9 * 40 * 16 * 12 * torch.finfo(dtype).bits / 8 / 1e9)
    rows = R.time_shape("rico", "rico", shape, dtype, 4, {}, "cpu", loops,
                        1.98, device="cpu", only=("advec_mom",))
    assert [r["kernel"] for r in rows] == ["advec_mom"]


# the momentum sweep's per-level loop around its barrier
UVW_SASS = """
\t\tFunction : _ZN3mhh15tend_uvw_kernelIfLb1EEEvNS_7UvwArgsIT_EE
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0030*/                   LDS R2, [R3] ;
        /*0040*/                   FFMA R2, R3, R4, R5 ;
        /*0050*/                   STG.E desc[UR4][R2.64], R5 ;
        /*0060*/               @P3 BRA 0x10 ;
        /*0070*/                   EXIT ;
"""


@pytest.mark.parametrize("label,case,shape,dtype,kernel,advecs",
                         R.UVW_SHAPES,
                         ids=["%s %s %s" % (s[0], str(s[3])[6:], s[4])
                              for s in R.UVW_SHAPES])
def test_uvw_rows_run_on_the_cpu(label, case, shape, dtype, kernel, advecs,
                                 one_call, monkeypatch):
    """The momentum sweep's rows at a tiny shape of each of its cases: one
    a timed advec flag, with the plan's chunks, blocks and waves, the
    occupancy, a forced one-chunk run and the SASS count of the per-level
    loop; an earlier tree's kernel (no info entry) gets none of the
    k-march's columns."""
    from microhh_torch import kernels
    from microhh_torch.ops import fused as F
    from microhh_torch.ops import kmarch
    torch.manual_seed(3)
    monkeypatch.setattr(kernels.Kernel, "info", lambda self, *a: INFO)
    assert R.UVW_SHAPES[0][2] == (384, 384, 384)
    acc = kernel == "tend_uvw_acc"
    t = "float" if dtype == torch.float32 else "double"
    key = "tend_uvw_kernel<%s,%s,false,false>" % (t, "false" if acc
                                                   else "true")
    found = R.sass_loops(UVW_SASS, R.UVW)
    assert list(found) == ["tend_uvw_kernel<float,true>"]
    loops = {key: found["tend_uvw_kernel<float,true>"]}
    seen = []
    name = "tend_uvw_acc" if acc else "tend_uvw"
    real = getattr(F.FusedGeneric, name)

    def call(self, *a, chunks=None):
        seen.append((chunks, self.advec))
        return real(self, *a, chunks=chunks)

    monkeypatch.setattr(F.FusedGeneric, name, call)
    tiny = (40, 16, 12)
    rows = R.uvw_rows(label, case, tiny, dtype, kernel, advecs, {}, "cpu",
                      loops, 1.98, device="cpu")
    assert [(r["kernel"], r["advec"]) for r in rows] == [
        (kernel, a) for a in advecs]
    p = kmarch.plan(kernel, 40, 16, 12, 0, dtype, 396)
    for r in rows:
        assert r["function"] == key and r["dtype"] == str(dtype)[6:]
        assert (r["chunks"], r["waves"]) == (p.chunks, p.waves)
        assert r["blocks"] == 2 * 2 * p.chunks and r["blocks_per_sm"] == 3
        assert r["ms_one_chunk"] == 1.0
        assert r["instructions_a_point"] == 6
        assert r["gbytes"] == pytest.approx(
            (10 if acc else 13) * 40 * 16 * 12
            * torch.finfo(dtype).bits / 8 / 1e9)
    assert seen == [(c, a) for a in advecs for c in (None, 1)]
    # an earlier tree: no occupancy, no chunk count, no forced run
    monkeypatch.setattr(kernels, "INFO", ())
    del seen[:]
    rows = R.uvw_rows(label, case, tiny, dtype, kernel, advecs[:1], {},
                      "cpu", None, 1.98, device="cpu")
    assert "chunks" not in rows[0] and "issue_ms" not in rows[0]
    assert seen == [(None, advecs[0])]


# K1/K14's per-level loop around its barrier
EVISC_SASS = """
\t\tFunction : _ZN3mhh12evisc_kernelIfLi1EEEvNS_9EviscArgsIT_EE
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0030*/                   LDS R2, [R3] ;
        /*0040*/                   MUFU.RSQ R2, R3 ;
        /*0050*/                   STG.E desc[UR4][R2.64], R5 ;
        /*0060*/               @P3 BRA 0x10 ;
        /*0070*/                   EXIT ;
"""


@pytest.mark.parametrize("label,case,shape,dtype,step", R.EVISC_SHAPES,
                         ids=["%s %s" % (s[0], str(s[3])[6:])
                              for s in R.EVISC_SHAPES])
def test_evisc_rows_run_on_the_cpu(label, case, shape, dtype, step, one_call,
                                   monkeypatch):
    """K1's and K14's rows at a tiny shape of each of their cases: the
    kernel and mode the case takes (K14 on SBL_Smag, K1's clamped mode on
    drycblles), K7's time beside it, the plan's chunks, blocks and waves,
    the occupancy asked in the row's stratified mode, a forced one-chunk
    run and the SASS count of the per-level loop; an earlier tree's kernel
    (no info entry, evisc_kernel<T>) gets none of the k-march's columns."""
    from microhh_torch import kernels
    from microhh_torch.ops import fused as F
    from microhh_torch.ops import kmarch
    torch.manual_seed(3)
    asked = []
    monkeypatch.setattr(kernels.Kernel, "info",
                        lambda self, *a: asked.append(a[1]) or INFO)
    st = 2 if case == "SBL_Smag" else 1
    t = "float" if dtype == torch.float32 else "double"
    key = "evisc_kernel<%s,%d>" % (t, st)
    found = R.sass_loops(EVISC_SASS, R.EVISC)
    assert list(found) == ["evisc_kernel<float,1>"]
    loops = {key: found["evisc_kernel<float,1>"]}
    seen = []
    name = "evisc_n2" if st == 2 else "evisc"
    owner = F.FusedGeneric if name == "evisc_n2" else F.Fused
    real = getattr(owner, name)

    def call(self, *a, out=None, chunks=None):
        seen.append((chunks, self.ghosts))
        return real(self, *a, out=out, chunks=chunks)

    monkeypatch.setattr(owner, name, call)
    tiny = (40, 16, 12)
    (r,) = R.evisc_rows(label, case, tiny, dtype, step, {}, "cpu", loops,
                        1.98, device="cpu")
    p = kmarch.plan("evisc", 40, 16, 12, 0, dtype, 396)
    assert r["kernel"] == name and r["stratified"] == st
    assert r["ghosts"] == (case != "drycblles")
    assert r["function"] == key and r["dtype"] == str(dtype)[6:]
    assert (r["chunks"], r["waves"]) == (p.chunks, p.waves)
    assert r["blocks"] == 2 * 2 * p.chunks and r["blocks_per_sm"] == 3
    assert r["ms_one_chunk"] == 1.0 and r["limits_ms"] == 1.0
    assert r["instructions_a_point"] == 6
    assert r["gbytes"] == pytest.approx(
        5 * 40 * 16 * 12 * torch.finfo(dtype).bits / 8 / 1e9)
    assert seen == [(None, case != "drycblles"), (1, case != "drycblles")]
    assert set(asked) == {st}
    # an earlier tree: no occupancy, no chunk count, no forced run, the
    # ring's evisc_kernel<T>
    monkeypatch.setattr(kernels, "INFO", ())
    del seen[:]
    old = "evisc_kernel<%s>" % t
    (r,) = R.evisc_rows(label, case, tiny, dtype, step, {old: {}}, "cpu",
                        None, 1.98, device="cpu")
    assert "chunks" not in r and "issue_ms" not in r
    assert r["function"] == old and seen == [(None, case != "drycblles")]


# K7's per-level loop around its barrier
LIMITS_SASS = EVISC_SASS.replace("12evisc_kernelIfLi1EE", "13limits_kernelIfLi0EE")


@pytest.mark.parametrize("label,case,shape,dtype,step", R.LIMITS_SHAPES,
                         ids=["%s %s" % (s[0], str(s[3])[6:])
                              for s in R.LIMITS_SHAPES])
def test_limits_rows_run_on_the_cpu(label, case, shape, dtype, step, one_call,
                                    monkeypatch):
    """K7's rows at a tiny shape of each of its paths: the mode the case
    takes (SBL_Smag's N2 field, drycblles' and the neutral LES's clamped
    mode, the neutral LES unstratified), K1's or K14's time beside it, the
    plan's chunks, blocks and waves, the occupancy asked in the row's
    stratified mode, a forced one-chunk run and the SASS count of the
    per-level loop; an earlier tree's kernel (no info entry,
    limits_kernel<T>) gets none of the k-march's columns."""
    from microhh_torch import kernels
    from microhh_torch.ops import fused as F
    from microhh_torch.ops import kmarch
    torch.manual_seed(3)
    asked = []
    monkeypatch.setattr(kernels.Kernel, "info",
                        lambda self, *a: asked.append(a[1]) or INFO)
    st = {"SBL_Smag": 2, "andren1994": 0}.get(case, 1)
    t = "float" if dtype == torch.float32 else "double"
    key = "limits_kernel<%s,%d>" % (t, st)
    found = R.sass_loops(LIMITS_SASS, R.LIMITS)
    assert list(found) == ["limits_kernel<float,0>"]
    loops = {key: found["limits_kernel<float,0>"]}
    seen = []
    real = F.Fused.limits

    def call(self, u, v, w, th, chunks=None):
        seen.append((chunks, self.ghosts, th is u))
        return real(self, u, v, w, th, chunks=chunks)

    monkeypatch.setattr(F.Fused, "limits", call)
    tiny = (40, 16, 12)
    (r,) = R.limits_rows(label, case, tiny, dtype, step, {}, "cpu", loops,
                         1.98, device="cpu")
    p = kmarch.plan("limits", 40, 16, 12, 0, dtype, 396)
    ghosts = case in ("rico", "SBL_Smag")
    assert r["kernel"] == "limits" and r["stratified"] == st
    assert r["ghosts"] == ghosts
    assert r["evisc_kernel"] == ("evisc_n2" if st == 2 else "evisc")
    assert r["function"] == key and r["dtype"] == str(dtype)[6:]
    assert (r["chunks"], r["waves"]) == (p.chunks, p.waves)
    assert r["blocks"] == 2 * 2 * p.chunks and r["blocks_per_sm"] == 3
    assert r["ms_one_chunk"] == 1.0 and r["evisc_ms"] == 1.0
    assert r["instructions_a_point"] == 6
    assert r["gbytes"] == pytest.approx(
        (3 + (st > 0)) * 40 * 16 * 12 * torch.finfo(dtype).bits / 8 / 1e9)
    assert seen == [(None, ghosts, st == 0), (1, ghosts, st == 0)]
    assert set(asked) == {st}
    # an earlier tree: no occupancy, no chunk count, no forced run, the
    # ring's limits_kernel<T>
    monkeypatch.setattr(kernels, "INFO", ())
    del seen[:]
    old = "limits_kernel<%s>" % t
    (r,) = R.limits_rows(label, case, tiny, dtype, step, {old: {}}, "cpu",
                         None, 1.98, device="cpu")
    assert "chunks" not in r and "issue_ms" not in r
    assert r["function"] == old and seen == [(None, ghosts, st == 0)]
    assert R.limits_function(dtype, st, set()) == key


def test_scalar_rk_rows_run_on_the_cpu(one_call, monkeypatch):
    """K15's rows at a tiny SBL_Smag: the fold on and off with the case's
    advection, the sweep's key with its fold, the plan's chunks and waves,
    the occupancy asked in the fold's form and a forced one-chunk run."""
    from microhh_torch import kernels
    from microhh_torch.ops import fused as F
    from microhh_torch.ops import kmarch
    torch.manual_seed(3)
    asked = []
    monkeypatch.setattr(kernels.Kernel, "info",
                        lambda self, *a: asked.append(a[1:]) or INFO)
    seen = []
    real = F.FusedGeneric.tend_scalars

    def call(self, *a, **kw):
        seen.append((a[7], kw.get("chunks")))
        return real(self, *a, **kw)

    monkeypatch.setattr(F.FusedGeneric, "tend_scalars", call)
    tiny = (40, 16, 12)
    rows = R.scalar_rk_rows("SBL_Smag", "SBL_Smag", tiny, {}, "cpu",
                            device="cpu")
    p = kmarch.plan("tend_scalars", 40, 16, 12, 1, torch.float32, 396)
    assert [(r["fold"], r["advec"]) for r in rows] == [(True, True),
                                                       (False, True)]
    for r in rows:
        assert r["function"] == ("scalar_sweep_kernel<float,true,true,1,%s>"
                                 % str(r["fold"]).lower())
        assert (r["chunks"], r["waves"]) == (p.chunks, p.waves)
        assert r["blocks"] == 2 * 2 * p.chunks and r["blocks_per_sm"] == 3
        assert r["ms_one_chunk"] == 1.0
        assert r["gbytes"] == pytest.approx(8 * 40 * 16 * 12 * 4 / 1e9)
    assert seen == [(True, None), (True, 1), (False, None), (False, 1)]
    assert set(asked) == {(1, 1), (3, 1)}


@pytest.mark.parametrize("label,case,shape,dtype", R.TDMA_SHAPES,
                         ids=["%s %s" % (s[0], str(s[3])[6:])
                              for s in R.TDMA_SHAPES])
def test_tdma_rows_run_on_the_cpu(label, case, shape, dtype, one_call,
                                  monkeypatch):
    """K3's rows at a tiny shape of each of its cases: the plan's form and
    the sweep form beside it, the scan form's key with its chunk length,
    its chunks, threads, blocks and waves, the occupancy asked for the
    form launched, the bytes of one read of the spectrum and the pivots
    and one write."""
    from microhh_torch import kernels
    from microhh_torch.ops import pres_2 as P
    torch.manual_seed(3)
    asked = []
    monkeypatch.setattr(kernels.Kernel, "info",
                        lambda self, *a: asked.append(a[1:]) or INFO)
    seen = []
    real = P.Pres2.tdma

    def call(self, x, sweep=False):
        seen.append(sweep)
        return real(self, x, sweep)

    monkeypatch.setattr(P.Pres2, "tdma", call)
    tiny = (16, 8, 40)
    rows = R.tdma_rows(label, case, tiny, dtype, {}, "cpu", device="cpu")
    t = "float" if dtype == torch.float32 else "double"
    L = P.TD_L[dtype]
    chunks = -(-40 // L)
    assert [r["form"] for r in rows] == ["scan", "sweep"]
    assert rows[0]["function"] == "tdma_scan_kernel<%s,%d>" % (t, L)
    assert rows[1]["function"] == "tdma_kernel<%s>" % t
    assert (rows[0]["L"], rows[0]["chunks"], rows[0]["threads"]) == (
        L, chunks, 16 * chunks)
    assert rows[0]["blocks"] == -(-8 * 9 // 16)
    assert rows[1]["blocks"] == 1 and rows[1]["waves"] == 1
    for r in rows:
        assert r["gbytes"] == pytest.approx(
            2.5 * 40 * 8 * 9 * 2 * torch.finfo(dtype).bits / 8 / 1e9)
        assert r["bound_by"] == "bytes" and r["blocks_per_sm"] == 3
    assert seen == [False, True] and asked == [(0, chunks), (1, 1)]


@pytest.mark.parametrize("label,case,shape,dtype", R.TDMA_RI_SHAPES,
                         ids=[s[0] for s in R.TDMA_RI_SHAPES])
def test_tdma_ri_rows_run_on_the_cpu(label, case, shape, dtype, one_call,
                                     monkeypatch):
    """K21's row at a tiny shape of each of its cases: K3's launch in place
    on the spectrum, counted as K21 (the K21 wrapper called, K3's not), the
    plan's form, its key with its chunk length and the occupancy asked for
    it, the bytes of one read of the spectrum and the pivots and one
    write."""
    from microhh_torch import kernels
    from microhh_torch.ops import pres_2 as P
    torch.manual_seed(3)
    asked = []
    monkeypatch.setattr(kernels.Kernel, "info",
                        lambda self, *a: asked.append((self.name,) + a[1:])
                        or INFO)
    seen = []
    real = P.Pres2.tdma_ri
    monkeypatch.setattr(P.Pres2, "tdma", lambda *a, **k: seen.append("K3"))

    def call(self, x, sweep=False):
        seen.append(("K21", x.dtype, tuple(x.shape)))
        return real(self, x, sweep)

    monkeypatch.setattr(P.Pres2, "tdma_ri", call)
    rows = R.tdma_ri_rows(label, case, (16, 8, 40), dtype, {}, "cpu",
                          device="cpu")
    L = P.TD_L[dtype]
    chunks = -(-40 // L)
    assert [(r["kernel"], r["what"], r["form"]) for r in rows] == [
        ("tdma_ri", "kernel", "scan")]
    t = "float" if dtype == torch.float32 else "double"
    assert rows[0]["function"] == "tdma_scan_kernel<%s,%d>" % (t, L)
    assert (rows[0]["L"], rows[0]["chunks"]) == (L, chunks)
    assert rows[0]["gbytes"] == pytest.approx(
        2.5 * 40 * 8 * 9 * 2 * torch.finfo(dtype).bits / 8 / 1e9)
    assert seen == [("K21", P.COMPLEX[dtype], (40, 8, 9))]
    assert asked == [("tdma_ri", 0, chunks)]


@pytest.mark.parametrize("label,case,shape,dtype", R.DRY_SHAPES,
                         ids=["%s %dx%dx%d %s" % (s[0], *s[2], str(s[3])[6:])
                              for s in R.DRY_SHAPES])
def test_dry_rows_run_on_the_cpu(label, case, shape, dtype, one_call,
                                 monkeypatch):
    """K20's row at a tiny shape of each of its cases, on the substep
    without the RK fold: its thermo form (th on sullivan2011, none on the
    neutral Ekman LES), the function of that form, the plan's chunks and
    the occupancy asked in that form, the one-chunk time and the bytes:
    u, v, w, (th,) e read, the carries read and written."""
    from microhh_torch import kernels
    torch.manual_seed(3)
    asked = []
    monkeypatch.setattr(kernels.Kernel, "info",
                        lambda self, *a: asked.append((self.name,) + a[1:])
                        or INFO)
    rows = R.dry_rows(label, case, (16, 8, 12), dtype, {}, "cpu",
                      device="cpu")
    (r,) = rows
    thermo = case == "sullivan2011"
    t = "float" if dtype == torch.float32 else "double"
    assert r["kernel"] == "tendencies" and r["thermo"] == thermo
    assert r["function"] == "tend_uvw_kernel<%s,false,true,%s>" % (
        t, "true" if thermo else "false")
    assert r["blocks_per_sm"] == 3 and r["chunks"] >= 1
    assert r["ms_one_chunk"] == 1.0 and r["dtype"] == str(dtype)[6:]
    nf = 4 if thermo else 3
    assert r["gbytes"] == pytest.approx(
        (3 * nf + 1) * 16 * 8 * 12 * torch.finfo(dtype).bits / 8 / 1e9)
    assert set(asked) == {("tendencies", 0, int(thermo))}


@pytest.mark.parametrize("label,case,shape,dtype", R.RK_SHAPES,
                         ids=["%s %dx%dx%d %s" % (s[0], *s[2], str(s[3])[6:])
                              for s in R.RK_SHAPES])
def test_rk_rows_run_on_the_cpu(label, case, shape, dtype, one_call,
                                monkeypatch):
    """K2's row at a tiny shape of each of its cases, on the dry path's RK
    form without the folds: its thermo form (th on drycblles, none on the
    neutral Ekman LES), the function of that form, the plan's chunks and
    the occupancy asked in that form, the one-chunk time and the bytes of a
    middle substep (u, v, w, (th,) e read, the carries read and written,
    s* written) and of the first and last."""
    from microhh_torch import kernels
    torch.manual_seed(3)
    asked = []
    monkeypatch.setattr(kernels.Kernel, "info",
                        lambda self, *a: asked.append((self.name,) + a[1:])
                        or INFO)
    (r,) = R.rk_rows(label, case, (16, 8, 12), dtype, {}, "cpu",
                     device="cpu")
    thermo = case == "drycblles"
    t = "float" if dtype == torch.float32 else "double"
    assert r["kernel"] == "tend_rk" and r["thermo"] == thermo
    assert r["function"] == "tend_uvw_kernel<%s,true,true,%s>" % (
        t, "true" if thermo else "false")
    assert r["blocks_per_sm"] == 3 and r["chunks"] >= 1
    assert r["ms_one_chunk"] == r["ms_first"] == r["ms_last"] == 1.0
    nf = 4 if thermo else 3
    fb = 16 * 8 * 12 * torch.finfo(dtype).bits / 8
    assert r["gbytes"] == pytest.approx((4 * nf + 1) * fb / 1e9)
    assert r["bound_ms_first_last"] == pytest.approx(
        1e3 * (3 * nf + 1) * fb / R.PEAK_BYTES_S)
    assert set(asked) == {("tend_rk", 0, int(thermo))}


@pytest.mark.parametrize("label,case,shape,dtype", R.APPLY_SHAPES,
                         ids=["%s %dx%dx%d %s" % (s[0], *s[2], str(s[3])[6:])
                              for s in R.APPLY_SHAPES])
def test_apply_rows_run_on_the_cpu(label, case, shape, dtype, one_call,
                                   monkeypatch):
    """K4 apply's rows at a tiny shape of each of its cases: with the carry
    (13 values a point) and without (7), the function of each form, the
    plan's chunks and the occupancy asked in each form."""
    from microhh_torch import kernels
    torch.manual_seed(3)
    asked = []
    monkeypatch.setattr(kernels.Kernel, "info",
                        lambda self, *a: asked.append((self.name,) + a[1:])
                        or INFO)
    rows = R.apply_rows(label, case, (16, 8, 12), dtype, {}, "cpu",
                        device="cpu")
    t = "float" if dtype == torch.float32 else "double"
    fb = 16 * 8 * 12 * torch.finfo(dtype).bits / 8
    assert [r["carry"] for r in rows] == [True, False]
    for r, carry, values in zip(rows, (True, False), (13, 7)):
        assert r["kernel"] == "pres_apply" and r["bound_by"] == "bytes"
        assert r["function"] == "pres_apply_kernel<%s,%s>" % (
            t, "true" if carry else "false")
        assert r["gbytes"] == pytest.approx(values * fb / 1e9)
        assert r["blocks_per_sm"] == 3 and r["chunks"] >= 1
        assert r["ms_one_chunk"] == 1.0
    assert set(asked) == {("pres_apply", 1), ("pres_apply", 0)}


def test_step_rows_run_on_the_cpu():
    """The steps group's row on a tiny sullivan2011 without the RK fold on
    the CPU: the profiler holds no device time there, so busy is zero and
    every part is empty; the wall time is the steps'."""
    rows = R.step_rows("sullivan2011 unfolded", "build_sullivan", (16, 8),
                       8, {"unfolded": True}, "cpu", device="cpu")
    (r,) = rows
    assert r["kernel"] == "step" and r["shape"] == [16, 8, 8]
    assert r["busy_ms_per_step"] == 0. and r["parts_ms_per_step"] == {}
    assert r["wall_ms_per_step"] > 0. and r["idle_share"] == 1.


def test_step_cells_are_chip_smoke_builders():
    """The steps group builds its cells with chip_smoke.py's builders: on
    the substep without the RK fold (jaenschwalde's own, sullivan2011
    forced onto it), and drycblles on K22 and with fold=False (K2)."""
    import chip_smoke
    for label, builder, n, ktot, step in R.STEP_CELLS:
        assert callable(getattr(chip_smoke, builder))
        assert len(n) == 2 and ktot > 0
    assert [c[4] for c in R.STEP_CELLS] == [{}, {"unfolded": True}, {},
                                            {"fold": False}]
    assert {"dry", "steps", "tdma", "rk", "apply"} <= set(R.GROUPS)


@pytest.mark.parametrize("step", [{}, {"fold": False}])
def test_chunk_rows_run_on_the_cpu(step):
    """The chunked group's row on a tiny drycblles on the CPU: both loops
    ran their steps eagerly (no capture, no replay span), the profiler
    holds no device time there, so busy and the idle share are None."""
    (r,) = R.chunk_rows("drycblles", "build_drycblles", (8, 8), 8, step,
                        "cpu", nsteps=2, device="cpu")
    assert r["kernel"] == "chunked_step" and r["shape"] == [8, 8, 8]
    for key in ("graphs", "eager"):
        assert r[key]["wall_ms_per_step"] > 0.
        assert r[key]["busy_ms_per_step"] is None
        assert r[key]["idle_share"] is None
        assert "span_ms_per_step" not in r[key]
    assert r["graphs"]["captured"] is False


def test_chunk_cells_are_chip_smoke_builders():
    """The chunked group's cells are chip_smoke.py's [4d] dry RK cells,
    built by its builders: drycblles on K22 and with fold=False, and
    sullivan2011 and the neutral Ekman LES on K22."""
    import chip_smoke
    for label, builder, n, ktot, step in R.CHUNK_CELLS:
        assert callable(getattr(chip_smoke, builder))
        assert len(n) == 2 and ktot > 0
    assert [c[4] for c in R.CHUNK_CELLS] == [{}, {"fold": False}, {}, {}]
    assert "chunked" in R.GROUPS


def test_compare_digests_holds_two_builds():
    parent = {"scalar_sweep_kernel<float,true,false,4>": "a",
              "scalar_sweep_kernel<float,false,false,3>": "b",
              "tend_scalar_kernel<float>": "c", "tdma_kernel<float>": "d",
              "evisc_kernel<float,1>": "e"}
    change = {"scalar_sweep_kernel<float,true,false,4,true>": "a",
              "scalar_sweep_kernel<float,false,false,3,false>": "b",
              "scalar_sweep_kernel<float,true,false,1,false>": "f",
              "tdma_kernel<float>": "d", "tdma_scan_kernel<float,32>": "g",
              "evisc_kernel<float,1>": "x"}
    keymap = {"scalar_sweep_kernel<float,true,false,4,true>":
              "scalar_sweep_kernel<float,true,false,4>",
              "scalar_sweep_kernel<float,false,false,3,false>":
              "scalar_sweep_kernel<float,false,false,3>"}
    got = R.compare_digests(parent, change, keymap)
    assert got == {
        "same": ["scalar_sweep_kernel<float,false,false,3,false>",
                 "scalar_sweep_kernel<float,true,false,4,true>",
                 "tdma_kernel<float>"],
        "changed": ["evisc_kernel<float,1>"],
        "gone": ["tend_scalar_kernel<float>"],
        "new": ["scalar_sweep_kernel<float,true,false,1,false>",
                "tdma_scan_kernel<float,32>"]}
    # without the map a renamed instance is one gone and one new
    got = R.compare_digests(parent, change)
    assert (len(got["same"]), len(got["new"]), len(got["gone"])) == (1, 4, 3)
