"""Time the ring kernels K16, K17, K13 and the scalar sweep K10/K19 (and,
as a control, K12) on one card, the kernels that share the sweep's scalar
point function (K2, K22, K20, K15), and K11, the warm-rain column sweep.

    python3 -m microhh_torch.ring_timing [--out FILE] [--label NAME]
                                         [--groups rings,s_tend,fold,micro2]

At the four shapes of their main paths: weakscaling 512x256x1024 float32
(K16 in scheme 4, K17 with one scalar), moser180 256x192x128 float64 (both
in scheme 4m), rico 384^3 float32 with the four scalars of its 2i5 scheme
(K13, K12 and K10 with advection off, as rico runs, and on), and
jaenschwalde's 1024x256x256 float32 with its two (thl, qt) for K13 and K12
and its three (thl, qt, co2) for K19 without advection, as jaenschwalde
runs it: once a scalar (three launches) and every scalar in one launch
(the kernels run on the rico case at that shape: they see only the shape,
the scheme, the advec flag and the scalar count).  The kernels whose
scalar tendency is the one-call s_tend of csrc/les_math.cuh at the shapes
of their main paths: K2 and K22 at drycblles 512^3 float32, K20 at
sullivan2011 512x512x64 (the substep without the RK fold) and K15 at
SBL_Smag 256^3.  K22 also on its paths in both its forms (the eddy
viscosity computed, and read): drycblles 512^3, sullivan2011 512^3 with the
sponge and Coriolis folds, the neutral Ekman LES 768x384x288 (no th) in
float32 and drycblles 512^3 in float64; beside K22's time its registers,
shared memory and blocks an SM from the card, the plan's chunks, blocks
and waves, its time with one chunk and its issue time counted from the
SASS of its per-level loop (``fold_issue``); the same SASS count beside
K17.  K11 at rico 384^3 in float32 and float64 and at 16^2x24 in float64,
in two states: the cell's own (its initial fields, cloud-free
and without rain, as the cell's timed steps are) and heavy rain
(chip_smoke.py's: a saturated layer, rain shafts with qr x 50, drops
crossing 2.5 cells in one dt).  Each time is the mean of 10 launches by
CUDA events after one warm-up launch; the stencil kernels run on seeded
random fields.  Beside each time: the bound (each input and output once
over 3.35 TB/s, or the operations over 67 TFLOP/s, 33.5 in float64, where
larger), registers, spills and stack from the build log's ptxas lines and,
where the tree's kernels report them (the k-marching K13, K16, K17 and
scalar sweep, K11 and K22), shared memory a block and resident blocks an
SM; for the k-marching kernels the chunk count, blocks in the grid and
waves, and
their time with one chunk (no k-split); for K11 blocks and waves, and its
issue time counted from the SASS of its phases (``micro2_issue``).  One JSON
object per kernel and shape is printed and, with --out, all of them are
written to FILE.  --groups names the groups to time (GROUPS; all by
default).  Needs a CUDA device.

The script runs on an earlier checkout too (copy it into that tree's
``microhh_torch/``), so the same call can hold the trees in turns (parent,
this, this, parent); a kernel without an info entry there gets no
occupancy columns.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

from . import cases, kernels
from .config import Ini

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the timed groups: K16, K17, K13, K10, K19 and K12 (a control); the
# kernels that call s_tend; K22 on its paths; K11
GROUPS = ("rings", "s_tend", "fold", "micro2")
REPS = 10
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}
# operations a point (K13: a scalar and point; K17: a point with one
# scalar, the vertical weights' 49 included), counted from the sources
FLOPS = {"o4_mom": {"4": 560, "4m": 510}, "o4_scalars": {"4": 185, "4m": 140},
         "advec_mom": 400, "advec_scalars": 130, "tend_scalars": 110,
         "tend_scalar_acc": 100, "tend_rk": 700, "tend_rk_fold": 900,
         "tendencies": 700, "tend_scalar_rk": 110, "micro2": 300}
# K11 moves 13 passes over a field: qr, nr, qt, thl and ql read, four
# tendencies read and written
MICRO2_PASSES = 13
# cycles a warp instruction takes of one SM sub-partition (four an SM) of an
# H100: an issue slot; of the FP64 pipe (16 lanes); of the MUFU pipe (4
# special-function units)
PIPE_CYCLES = {"total": 1, "fp64": 2, "mufu": 8}
FP64_OPS = ("DADD", "DFMA", "DMUL", "DSETP")

# (label, case, (itot, jtot, ktot), dtype, S); a case built with
# build_step's defaults
SHAPES = [("weakscaling", "weakscaling", (512, 256, 1024), torch.float32, 1),
          ("moser180", "moser180", (256, 192, 128), torch.float64, 1),
          ("rico", "rico", (384, 384, 384), torch.float32, 4),
          ("jaenschwalde", "rico", (1024, 256, 256), torch.float32, 2)]
# the kernels that call s_tend: (label, case, shape, build_step options)
S_TEND_SHAPES = [("drycblles", "drycblles", (512, 512, 512), {}),
                 ("sullivan2011 unfolded", "sullivan2011", (512, 512, 64),
                  {"unfolded": True}),
                 ("SBL_Smag", "SBL_Smag", (256, 256, 256), {})]
# K22 on its paths: (label, case, shape, dtype)
FOLD_SHAPES = [("drycblles", "drycblles", (512, 512, 512), torch.float32),
               ("sullivan2011", "sullivan2011", (512, 512, 512), torch.float32),
               ("andren1994 less s", "andren1994", (768, 384, 288),
                torch.float32),
               ("drycblles", "drycblles", (512, 512, 512), torch.float64)]

# kernel name -> its CUDA function
FUNCTIONS = {"o4_mom": "o4_mom_kernel", "o4_scalars": "o4_scalars_kernel",
             "advec_mom": "advec_mom_kernel",
             "advec_scalars": "advec_scalars_kernel"}
# the scalar sweep's CUDA function
SWEEP = "scalar_sweep_kernel"
# K11's CUDA function
MICRO2 = "micro2_kernel"
# K11's shapes: (label, (itot, jtot, ktot), dtype)
MICRO2_SHAPES = [("rico", (384, 384, 384), torch.float32),
                 ("rico", (384, 384, 384), torch.float64),
                 ("rico 16^2x24", (16, 16, 24), torch.float64)]
# the CUDA functions of the kernels that call s_tend
S_TEND_FUNCTIONS = {"tend_rk": "tend_rk_kernel",
                    "tend_rk_fold": "tend_rk_fold_kernel",
                    "tendencies": "tendencies_kernel",
                    "tend_scalar_rk": "tend_scalar_kernel"}


def max_sm_clock_ghz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout
    return float(out.strip().splitlines()[0]) / 1e3


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _demangle(s):
    """(function, "template,arguments") of a mangled kernel name whose
    template arguments are types (f, d) and literals (L<type><value>E)."""
    if not s.startswith("_ZN"):
        return s, ""
    i, names = 3, []
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        n = int(s[i:j])
        names.append(s[j:j + n])
        i = j + n
    args = []
    if i < len(s) and s[i] == "I":
        i += 1
        while i < len(s) and s[i] != "E":
            if s[i] == "L":
                j = s.index("E", i)
                val = s[i + 2:j]
                args.append({"0": "false", "1": "true"}.get(val, val)
                            if s[i + 1] == "b" else val)
                i = j + 1
            else:
                args.append({"f": "float", "d": "double"}.get(s[i], s[i]))
                i += 1
    return names[-1] if names else s, ",".join(args)


def ptxas_info(build_log):
    """{"function<template arguments>": {registers, spill_stores,
    spill_loads, stack}} of every kernel from the ptxas lines of a build
    log (nvcc -Xptxas -v)."""
    out, cur = {}, None
    for line in build_log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name, args = _demangle(hit.group(1))
            cur = out.setdefault("%s<%s>" % (name, args), {})
            continue
        if cur is None:
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads", line)
        if hit:
            cur.update(stack=int(hit.group(1)), spill_stores=int(hit.group(2)),
                       spill_loads=int(hit.group(3)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            cur["registers"] = int(hit.group(1))
            cur = None
    return out


def sass_text(lib):
    """cuobjdump -sass of a built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def sass_sections(text, function):
    """{"function<template arguments>": [section, ...]} for each instance of
    the kernel `function` in a cuobjdump -sass listing: the instructions of
    its body (NOPs left out; the slow-path subroutines that the compiler
    places after the body, from the first target of a CALL on, are not
    counted) cut at each barrier, in program order, each section counted as
    {"total", "fp64", "mufu"} (a barrier ends its section)."""
    bodies, cur = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name, args = _demangle(hit.group(1))
            cur = None
            if name == function:
                cur = bodies.setdefault("%s<%s>" % (name, args), [])
            continue
        hit = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]\s+)?"
                       r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if cur is not None and hit:
            cur.append((int(hit.group(1), 16), hit.group(2).split(".")[0],
                        hit.group(3).strip()))
    out = {}
    for key, body in bodies.items():
        calls = [int(arg, 16) for _, op, arg in body
                 if op == "CALL" and re.fullmatch(r"0x[0-9a-f]+", arg)]
        end = min(calls, default=float("inf"))
        sections = [{"total": 0, "fp64": 0, "mufu": 0}]
        for addr, op, _ in body:
            if addr >= end:
                break
            if op == "NOP":
                continue
            sec = sections[-1]
            sec["total"] += 1
            sec["fp64"] += op in FP64_OPS
            sec["mufu"] += op == "MUFU"
            if op == "BAR":
                sections.append({"total": 0, "fp64": 0, "mufu": 0})
        out[key] = sections
    return out


def sass_loops(text, function):
    """{"function<template arguments>": [loop, ...]} for each instance of
    the kernel `function` in a cuobjdump -sass listing: every loop of its
    body (a backward branch and its target) that holds a barrier, in program
    order, each counted as {"total", "fp64", "mufu", "bar"} (NOPs left
    out): the per-level bodies of a k-march.  The body ends at its
    first unpredicated EXIT or at the first target of a CALL: what the
    compiler places after it (slow-path subroutines, the paths a barrier
    takes when a warp arrives diverged) is not counted."""
    bodies, cur = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name, args = _demangle(hit.group(1))
            cur = None
            if name == function:
                cur = bodies.setdefault("%s<%s>" % (name, args), [])
            continue
        hit = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-9]\s+)?"
                       r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if cur is not None and hit:
            cur.append((int(hit.group(1), 16), hit.group(3).split(".")[0],
                        hit.group(4).strip(), bool(hit.group(2))))
    out = {}
    for key, body in bodies.items():
        ends = [int(arg, 16) for _, op, arg, _ in body
                if op == "CALL" and re.fullmatch(r"0x[0-9a-f]+", arg)]
        ends += [addr + 1 for addr, op, _, pred in body
                 if op == "EXIT" and not pred]
        end = min(ends, default=float("inf"))
        body = [(addr, op, arg) for addr, op, arg, _ in body if addr < end]
        loops = []
        for addr, op, arg in body:
            tgt = re.match(r"(0x[0-9a-f]+)", arg)
            if op != "BRA" or not tgt or int(tgt.group(1), 16) >= addr:
                continue
            lo = int(tgt.group(1), 16)
            ops = [o for a_, o, _ in body if lo <= a_ <= addr and o != "NOP"]
            rec = {"total": len(ops), "fp64": sum(o in FP64_OPS for o in ops),
                   "mufu": ops.count("MUFU"), "bar": ops.count("BAR")}
            if rec["bar"]:
                loops.append(rec)
        out[key] = loops
    return out


def fold_issue(loops, shape, tile_j, clock_ghz, sms):
    """A k-march's (K22's, K17's) issue time from the SASS of its per-level
    loop, or None unless the kernel has one such loop (sass_loops): every
    warp of a (tile_j, 32) tile runs it once a level.  Every instruction of
    the loop counts as issued once a level, the branches that some warps or
    levels skip (the
    halo work of a few warps, the forms' flags, the first level's) too: an
    upper estimate.  A warp instruction takes PIPE_CYCLES of one of the four
    sub-partitions of an SM at the card's maximum SM clock."""
    if len(loops) != 1:
        return None
    itot, jtot, ktot = shape
    warps = -(-itot // 32) * -(-jtot // tile_j) * tile_j * ktot
    per = loops[0]
    ms = {key: 1e3 * warps * per[key] * cyc / (sms * 4 * clock_ghz * 1e9)
          for key, cyc in PIPE_CYCLES.items()}
    by = max(ms, key=ms.get)
    return {"issue_ms": ms[by], "issue_bound_by": by, "issue_ms_by_pipe": ms,
            "instructions_a_point": per["total"], "clock_ghz": clock_ghz}


def micro2_issue(sections, shape, nsed, clock_ghz, sms):
    """K11's issue time from the SASS of its phases, or None unless the
    kernel has the six sections of its window march (set-up, (a), (b)
    slopes, (b) gather, (c) scan, (d); csrc/micro2.cu).  Each warp of a
    block runs the loop of (a), (b) and (d) M2_RPT times a window, a level
    of 32 columns each; the gather's code holds NSED_MAX unrolled rows, of
    which nsed run; (c), two warps' serial scan of about a dozen
    instructions a level and species, is left out, and so is the set-up.
    Every instruction of a section counts as issued once, the inline slow
    paths that rarely run (IEEE division, the special cases of pow, exp
    and log) too: an upper estimate of the issue work.  A warp instruction
    takes PIPE_CYCLES of one of the card's four sub-partitions an SM at the
    card's maximum SM clock; the time is the largest of the issue, FP64 and
    MUFU times."""
    if len(sections) != 6:
        return None
    from .ops.microphys import M2_C, M2_NT, M2_RPT, M2_W, NSED_MAX
    _, a, slopes, gather, _, d = sections
    itot, jtot, ktot = shape
    warps = (-(-itot // M2_C) * jtot * -(-ktot // M2_W) * (M2_NT // 32)
             * M2_RPT)
    per = {key: a[key] + slopes[key] + gather[key] * nsed / NSED_MAX + d[key]
           for key in PIPE_CYCLES}
    ms = {key: 1e3 * warps * per[key] * cyc / (sms * 4 * clock_ghz * 1e9)
          for key, cyc in PIPE_CYCLES.items()}
    by = max(ms, key=ms.get)
    return {"issue_ms": ms[by], "issue_bound_by": by,
            "issue_ms_by_pipe": ms,
            "instructions_a_point": per["total"],
            "sass_sections": [sec["total"] for sec in sections],
            "clock_ghz": clock_ghz}


def variant(kernel, dtype, scheme, S):
    """The template arguments of the instance a launch takes (K17: the
    k-march's <T, M, S> where the tree reports its occupancy, else the
    earlier <T, M>)."""
    t = "float" if dtype == torch.float32 else "double"
    if kernel in ("o4_mom", "o4_scalars"):
        m = "true" if scheme == "4m" else "false"
        if kernel == "o4_scalars" and "o4_scalars" in kernels.INFO:
            return "%s,%s,%d" % (t, m, S)
        return "%s,%s" % (t, m)
    c4, up = {"2i4": ("true", "false"), "2i5": ("false", "true"),
              "2i53": ("false", "true"), "2i62": ("false", "false")}[scheme]
    if kernel == "advec_scalars":
        return "%s,%s,%s,%d" % (t, c4, up, S)
    return "%s,%s,%s" % (t, c4, up)


def sweep_function(name, dtype, advec, S):
    """The ptxas key of the scalar sweep's instance a launch takes,
    scalar_sweep_kernel<T, RK, ADV, S>."""
    t = "float" if dtype == torch.float32 else "double"
    rk = "true" if name == "tend_scalars" else "false"
    return "%s<%s,%s,%s,%d>" % (SWEEP, t, rk, "true" if advec else "false", S)


def sweep_rows(m, label, shape, dtype, S, ptx, card, rnd):
    """K10 (rico: S scalars, advection off and on) or K19 (jaenschwalde: S
    scalars without advection, once a scalar and in one launch) on the
    generic model m."""
    fz, ctx = m.fused, m.ctx
    n = shape[0] * shape[1] * shape[2]
    fb = n * torch.finfo(dtype).bits // 8
    names, sviscs = tuple(fz.names[:S]), list(fz.sviscs[:S])
    s = {nm: rnd() for nm in ("u", "v", "w") + names}
    e = rnd().abs()
    t = {nm: rnd(1e-3) for nm in names}
    cts = fz.base.repeat(S, 1, 1).contiguous()
    calls = []
    if label == "rico":
        for advec in (False, True):
            calls.append(("tend_scalars", advec, "one launch",
                          lambda **kw: fz.tend_scalars(s, t, e, cts, 0.5,
                                                       -5. / 9., True, **kw),
                          (1 + 4 * S + 3 * advec) * fb))
    else:
        calls.append(("tend_scalar_acc", False, "one launch a scalar",
                      lambda: [fz.tend_scalar_acc(s, t, e, nm)
                               for nm in names], (1 + 3 * S) * fb))
        calls.append(("tend_scalar_acc", False, "one launch",
                      lambda **kw: fz.tend_scalars_acc(s, t, e, **kw),
                      (1 + 3 * S) * fb))
    rows = []
    saved = (fz.names, fz.sviscs, fz.advec)
    try:
        fz.names, fz.sviscs = names, sviscs
        for name, advec, form, fn, nbytes in calls:
            fz.advec = advec
            flops = FLOPS[name] * S
            by_bytes = 1e3 * nbytes / PEAK_BYTES_S
            by_ops = 1e3 * flops * n / PEAK_FLOPS[dtype]
            launch_S = 1 if form == "one launch a scalar" else S
            key = sweep_function(name, dtype, advec, launch_S)
            row = {"label": label, "kernel": name, "form": form,
                   "shape": list(shape), "dtype": str(dtype)[6:], "S": S,
                   "advec": advec, "ms": events_ms(fn),
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                   "ops_per_point": flops, "gbytes": nbytes / 1e9,
                   "ptxas": ptx.get(key), "function": key, "card": card}
            kern = fz.k_scalars if name == "tend_scalars" else fz.k_scalar_acc
            pl = fz.plan(name, launch_S, dtype)
            row.update(kern.info(dtype, int(advec), launch_S))
            row.update(chunks=pl.chunks, blocks=pl.tiles_i * pl.tiles_j
                       * pl.chunks, waves=pl.waves)
            if form == "one launch":
                row["ms_one_chunk"] = events_ms(lambda: fn(chunks=1))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        fz.names, fz.sviscs, fz.advec = saved
    return rows


def micro2_state(m, heavy, seed=5):
    """K11's inputs on the rico model m: (state, ql, dt).  The cell's own
    state is its initial fields (cloud-free, no rain); heavy rain adds
    chip_smoke.py's moist layer between 500 and 1300 m and rain shafts below
    1500 m, qr x 50, with dt such that fall speeds near W_MAX cross 2.5
    cells."""
    from .model import NP_DTYPE
    ctx = m.ctx
    s, sfc = m.as_device_state(m.fields.create(m.input_nc,
                                               dtype=NP_DTYPE[m.dtype]))
    dt = 2.
    if heavy:
        ks, ke = ctx.ks, ctx.ke
        gen = torch.Generator(device=ctx.device).manual_seed(seed)

        def rand():
            return torch.rand((ctx.ktot, ctx.jtot, ctx.itot), generator=gen,
                              dtype=ctx.dtype, device=ctx.device)

        zc = ctx.tensor(m.grid.z[ks:ke])[:, None, None]
        s["qt"][ks:ke] += torch.where((zc > 500.) & (zc < 1300.), 0.004,
                                      0.) * rand()
        rain = (rand() > 0.4) & (zc < 1500.)
        qr = torch.where(rain, 10. ** (3. * rand() - 6.), 0.)
        s["nr"][ks:ke] = qr * 10. ** (rand() + 6.5)
        s["qr"][ks:ke] = 50. * qr
        dt = 2.5 * float(m.grid.dz.min()) / 9.65
    s = m.boundary.set_ghost_cells(ctx, s, sfc)
    return s, m.thermo.get_ql(ctx, s), dt


def micro2_rows(m, label, shape, dtype, ptx, card, sections=None,
                clock_ghz=None):
    """K11 on the rico model m in the cell's own state and in heavy rain:
    its time, bounds, ptxas line and, where the tree reports them, shared
    memory, blocks an SM, blocks, waves and the issue time."""
    from .ops.microphys import MICRO_FIELDS
    mic, ctx = m.micro, m.ctx
    pref, exnref, _, _ = m.thermo._p_profiles(ctx, {})
    n = shape[0] * shape[1] * shape[2]
    nbytes = MICRO2_PASSES * n * torch.finfo(dtype).bits // 8
    by_bytes = 1e3 * nbytes / PEAK_BYTES_S
    by_ops = 1e3 * FLOPS["micro2"] * n / PEAK_FLOPS[dtype]
    key = "%s<%s>" % (MICRO2, "float" if dtype == torch.float32 else "double")
    rows = []
    for state in ("cell", "heavy rain"):
        s, ql, dt = micro2_state(m, state == "heavy rain")
        t = {nm: torch.zeros_like(s[nm]) for nm in MICRO_FIELDS}
        row = {"label": label, "kernel": "micro2", "state": state,
               "shape": list(shape), "dtype": str(dtype)[6:],
               "nsed": mic.nsed,
               "ms": events_ms(lambda: mic.micro2(ctx, s, t, ql, pref,
                                                  exnref, dt)),
               "bound_ms": max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "ops_per_point": FLOPS["micro2"], "gbytes": nbytes / 1e9,
               "ptxas": ptx.get(key), "function": key, "card": card}
        if "micro2" in kernels.INFO:
            from .ops.microphys import M2_C
            info = mic.k_micro.info(dtype, 0)
            blocks = -(-shape[0] // M2_C) * shape[1]
            row.update(info, blocks=blocks,
                       waves=blocks / (info["blocks_per_sm"] * info["sms"]))
            if sections and key in sections:
                row.update(micro2_issue(sections[key], shape, mic.nsed,
                                        clock_ghz, info["sms"]) or {})
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del s, ql, t
    return rows


def case_text(case, itot, jtot, ktot):
    name = "SBL" if case == "SBL_Smag" else case
    with open(os.path.join(ROOT, "cases", case, "%s.ini" % name)) as f:
        text = f.read()
    over = {"itot": itot, "jtot": jtot, "ktot": ktot}
    if case == "weakscaling":
        mem, zsize = cases.weakscaling_input(ktot)
        over["zsize"] = "%.17g" % zsize
    elif case == "moser180":
        mem = cases.moser180_input(ktot, 2.)
        over.update(swstats=0, swbudget=0)
    elif case == "drycblles":
        mem = None
        over["swstats"] = 0
    elif case == "sullivan2011":
        mem = cases.sullivan2011_input(ktot)
        over["swstats"] = 0
    elif case == "andren1994":
        # less its passive scalar, as chip_smoke.py andren_ini
        mem = cases.andren1994_input(ktot)
        text = re.sub(r"(?m)^(slist=s|sbot\[s\]=.*|stop\[s\]=.*)\n", "",
                      text)
    elif case == "SBL_Smag":
        zsize = float(re.search(r"(?m)^zsize=(.*)$", text).group(1))
        mem = cases.sbl_input(ktot, zsize)
        over.update(swstats=0, swdump=0)
    else:
        mem = cases.rico_input(ktot, 4000.)
        over["swadvec"] = "2i5"
    for key, val in over.items():
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    return text, mem


def build(case, itot, jtot, ktot, dtype, workdir, device="cuda", **step):
    from .model import Model
    text, mem = case_text(case, itot, jtot, ktot)
    m = Model(Ini(text), "run", case, workdir=workdir, dtype=dtype,
              device=device, input_nc=mem)
    m.finish_setup()
    m.build_step(**step)
    return m


def events_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_shape(label, case, shape, dtype, S, ptx, card, loops=None,
               clock_ghz=None, device="cuda"):
    """K16 and K17 (a 4th-order case) or K13, K12 and the scalar sweep at
    one shape on seeded random fields; K17's row also takes the issue time
    of its per-level loop (loops: sass_loops of the build)."""
    itot, jtot, ktot = shape
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        m = build(case, itot, jtot, ktot, dtype, workdir, device)
        ctx = m.ctx
        gen = torch.Generator(device=device).manual_seed(itot + ktot)
        full = (ctx.kcells, jtot, itot)

        def rnd(scale=1.):
            return scale * torch.randn(full, dtype=dtype, device=device,
                                       generator=gen)

        n = itot * jtot * ktot
        fb = n * torch.finfo(dtype).bits // 8
        u, v, wc, wd = rnd(), rnd(), rnd(0.3), rnd(0.3)
        calls = {}
        if m.o4 is not None:
            o4, scheme = m.o4, m.o4.scheme
            t = [rnd(0.1) for _ in range(3 + S)]
            a = [rnd() for _ in range(S)]
            calls["o4_mom"] = (lambda **kw: o4.momentum(u, v, wc, wd, *t[:3], **kw),
                               10 * fb, FLOPS["o4_mom"][scheme], o4, scheme)
            names = list(ctx.scalar_names)[:S]
            # the k-march of K17 reports its occupancy and takes chunks=
            k17 = o4 if "o4_scalars" in kernels.INFO else None
            calls["o4_scalars"] = (
                lambda **kw: o4.scalars(u, v, wc, names, a, t[3:], **kw),
                (3 + 3 * S) * fb, FLOPS["o4_scalars"][scheme] * S, k17,
                scheme)
        else:
            adv, scheme = m.advec_fused, m.advec_fused.scheme
            t = [rnd(1e-3) for _ in range(3 + S)]
            a = [rnd() for _ in range(S)]
            calls["advec_scalars"] = (
                lambda **kw: adv.scalars(u, v, wc, a, t[3:], **kw),
                (3 + 3 * S) * fb, FLOPS["advec_scalars"] * S, adv, scheme)
            calls["advec_mom"] = (lambda: adv.momentum(u, v, wc, *t[:3]),
                                  9 * fb, FLOPS["advec_mom"], None, scheme)
        for name, (fn, nbytes, flops, owner, scheme) in calls.items():
            by_bytes = 1e3 * nbytes / PEAK_BYTES_S
            by_ops = 1e3 * flops * n / PEAK_FLOPS[dtype]
            key = "%s<%s>" % (FUNCTIONS[name], variant(name, dtype, scheme, S))
            row = {"label": label, "kernel": name, "shape": list(shape),
                   "dtype": str(dtype)[6:], "S": S, "scheme": scheme,
                   "ms": events_ms(fn), "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                   "ops_per_point": flops, "gbytes": nbytes / 1e9,
                   "ptxas": ptx.get(key), "function": key, "card": card}
            if owner is not None:
                if name == "o4_mom":
                    pl, kern, info_s = owner.plan(dtype), owner.k_mom, 0
                elif name == "o4_scalars":
                    pl, kern, info_s = (owner.scalar_plan(S, dtype),
                                        owner.k_scal, S)
                else:
                    pl, kern, info_s = owner.plan(S, dtype), owner.k_scal, S
                sid = {"4": 0, "4m": 1, "2i4": 0, "2i5": 1, "2i53": 2,
                       "2i62": 3}[scheme]
                row.update(kern.info(dtype, sid, info_s))
                row.update(chunks=pl.chunks, blocks=pl.tiles_i * pl.tiles_j
                           * pl.chunks, waves=pl.waves,
                           ms_one_chunk=events_ms(lambda: fn(chunks=1)))
            if name == "o4_scalars" and loops and key in loops:
                from .ops import kmarch
                row.update(fold_issue(loops[key], shape,
                                      getattr(kmarch, "K17_TJ", 16),
                                      clock_ghz, sms_of(device)) or {})
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
        del u, v, wc, wd, t, a, calls
        if m.o4 is None:
            torch.cuda.empty_cache()
            rows += sweep_rows(m, label, shape, dtype,
                               4 if label == "rico" else 3, ptx, card, rnd)
        del m
    if device == "cuda":
        torch.cuda.empty_cache()
    return rows


def sms_of(device):
    """SMs of the card (132, an H100's, off the card)."""
    if device == "cuda":
        return torch.cuda.get_device_properties(0).multi_processor_count
    return 132


def fold_function(dtype, thermo, known):
    """The ptxas and SASS key of the K22 instance a launch takes: the
    k-march's tend_rk_fold_kernel<T, THERMO>, or the PR-6 form's
    tend_rk_fold_kernel<T> where `known` (keys of a build) holds that."""
    t = "float" if dtype == torch.float32 else "double"
    name = S_TEND_FUNCTIONS["tend_rk_fold"]
    old = "%s<%s>" % (name, t)
    return old if old in known else "%s<%s,%s>" % (
        name, t, "true" if thermo else "false")


def fold_extra(row, fz, dtype, shape, fn, loops, clock_ghz, device):
    """K22's row completed: where the tree's K22 is the k-march (it reports
    its occupancy), its registers, shared memory and blocks an SM from the
    card, chunks, blocks and waves of the plan, and its time with one
    chunk; where the SASS of the tree holds K22's loops, its issue time
    (fold_issue)."""
    from .ops import kmarch
    # the PR-6 form's tile has common.cuh's eight rows too
    tile_j = getattr(kmarch, "K22_TJ", 8)
    if "tend_rk_fold" in kernels.INFO:
        pl = fz.fold_plan(dtype)
        row.update(fz.k_tend_fold.info(dtype, int(fz.has_thermo)),
                   chunks=pl.chunks,
                   blocks=pl.tiles_i * pl.tiles_j * pl.chunks, waves=pl.waves,
                   ms_one_chunk=events_ms(lambda: fn(chunks=1)))
    if loops and row["function"] in loops:
        row.update(fold_issue(loops[row["function"]], shape, tile_j,
                              clock_ghz, sms_of(device)) or {})
    return row


def fold_rows(label, case, shape, dtype, ptx, card, loops=None,
              clock_ghz=None, device="cuda"):
    """K22 on a dry RK-folded model on seeded random fields, in its two
    forms: the eddy viscosity computed (the main path's) and read (e_in)."""
    itot, jtot, ktot = shape
    n = itot * jtot * ktot
    fb = n * torch.finfo(dtype).bits // 8
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        m = build(case, itot, jtot, ktot, dtype, workdir, device)
        fz, ctx = m.fused, m.ctx
        gen = torch.Generator(device=device).manual_seed(itot + ktot)

        def rnd(scale=1., k=ctx.kcells):
            return scale * torch.randn((k, jtot, itot), dtype=dtype,
                                       device=device, generator=gen)

        names = list(m.fields.prognostic_names)
        s = {nm: rnd() for nm in names}
        t = {nm: rnd(1e-3) for nm in names}
        e = rnd(k=ktot).abs()
        nbytes = (4 * len(names) + 2) * fb
        by_bytes = 1e3 * nbytes / PEAK_BYTES_S
        by_ops = 1e3 * FLOPS["tend_rk_fold"] * n / PEAK_FLOPS[dtype]
        key = fold_function(dtype, fz.has_thermo, set(ptx) | set(loops or ()))
        for form, e_in in (("evisc", None), ("e_in", e)):
            def fn(e_in=e_in, **kw):
                return fz.tend_rk_fold(s, t, None, 0.5, -5. / 9., 2., False,
                                       True, e=e_in, **kw)
            row = {"label": label, "kernel": "tend_rk_fold", "form": form,
                   "shape": list(shape), "dtype": str(dtype)[6:],
                   "ms": events_ms(fn), "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                   "ops_per_point": FLOPS["tend_rk_fold"],
                   "gbytes": nbytes / 1e9, "ptxas": ptx.get(key),
                   "function": key, "card": card}
            fold_extra(row, fz, dtype, shape, fn, loops, clock_ghz, device)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
        del m, s, t, e
    if device == "cuda":
        torch.cuda.empty_cache()
    return rows


def s_tend_rows(label, case, shape, step, ptx, card, device="cuda",
                loops=None, clock_ghz=None):
    """K2 and K22 (the dry RK-folded model), K20 (the substep without the RK
    fold) or K15 (the generic model with one scalar) on seeded random
    fields: the kernels whose scalar tendency is s_tend.  K22's row takes
    fold_extra's columns (loops: sass_loops of the build)."""
    dtype = torch.float32
    itot, jtot, ktot = shape
    n = itot * jtot * ktot
    fb = n * torch.finfo(dtype).bits // 8
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        m = build(case, itot, jtot, ktot, dtype, workdir, device, **step)
        fz, ctx = m.fused, m.ctx
        gen = torch.Generator(device=device).manual_seed(itot + ktot)

        def rnd(scale=1., k=ctx.kcells):
            return scale * torch.randn((k, jtot, itot), dtype=dtype,
                                       device=device, generator=gen)

        names = list(m.fields.prognostic_names)
        s = {nm: rnd() for nm in names}
        t = {nm: rnd(1e-3) for nm in names}
        nf = len(names)
        if m.generic:
            e = rnd().abs()
            calls = [("tend_scalar_rk", lambda: fz.tend_scalar_rk(
                s, t, e, fz.base, 0.5, -5. / 9., True), 8 * fb)]
        elif m.unfolded:
            e = rnd().abs()
            calls = [("tendencies", lambda: fz.tendencies(s, t, e),
                      13 * fb)]
        else:
            e = rnd(k=ktot).abs()
            calls = [("tend_rk", lambda: fz.tend_rk(s, t, e, 0.5, -5. / 9.,
                                                    False, True),
                      (4 * nf + 1) * fb),
                     ("tend_rk_fold", lambda **kw: fz.tend_rk_fold(
                         s, t, None, 0.5, -5. / 9., 2., False, True, **kw),
                      (4 * nf + 2) * fb)]
        for name, fn, nbytes in calls:
            by_bytes = 1e3 * nbytes / PEAK_BYTES_S
            by_ops = 1e3 * FLOPS[name] * n / PEAK_FLOPS[dtype]
            key = "%s<float>" % S_TEND_FUNCTIONS[name]
            if name == "tend_rk_fold":
                key = fold_function(dtype, fz.has_thermo,
                                    set(ptx) | set(loops or ()))
            row = {"label": label, "kernel": name, "shape": list(shape),
                   "dtype": "float32", "ms": events_ms(fn),
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                   "ops_per_point": FLOPS[name], "gbytes": nbytes / 1e9,
                   "ptxas": ptx.get(key), "function": key, "card": card}
            if name == "tend_rk_fold":
                fold_extra(row, fz, dtype, shape, fn, loops, clock_ghz,
                           device)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
        del m, s, t, e
    if device == "cuda":
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma list of the groups to time, of %s"
                    % ", ".join(GROUPS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ring_timing: no CUDA device")
    card = card_line()
    print("card: %s; tree: %s" % (card, args.label), flush=True)
    lib, _, log = kernels.build()
    ptx = ptxas_info(log)
    sass = sass_text(lib)
    sections = sass_sections(sass, MICRO2)
    loops = sass_loops(sass, S_TEND_FUNCTIONS["tend_rk_fold"])
    loops.update(sass_loops(sass, FUNCTIONS["o4_scalars"]))
    clock = max_sm_clock_ghz()
    rows = []
    groups = set(args.groups.split(","))
    for label, case, shape, dtype, S in SHAPES if "rings" in groups else ():
        rows += time_shape(label, case, shape, dtype, S, ptx, card, loops,
                           clock)
    for label, case, shape, step in S_TEND_SHAPES if "s_tend" in groups else ():
        rows += s_tend_rows(label, case, shape, step, ptx, card,
                            loops=loops, clock_ghz=clock)
    for label, case, shape, dtype in FOLD_SHAPES if "fold" in groups else ():
        rows += fold_rows(label, case, shape, dtype, ptx, card, loops, clock)
    for label, shape, dtype in MICRO2_SHAPES if "micro2" in groups else ():
        with tempfile.TemporaryDirectory() as workdir:
            m = build("rico", *shape, dtype, workdir)
            rows += micro2_rows(m, label, shape, dtype, ptx, card, sections,
                                clock)
            del m
        torch.cuda.empty_cache()
    for row in rows:
        row["tree"] = args.label
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
