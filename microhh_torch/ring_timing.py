"""Time the ring kernels K16, K17, K12, K13, the scalar sweep K10/K19 and
the momentum sweep K8/K9/K18 on one card, the kernels that share the
sweep's scalar point function (K2, K22, K20), K11, the warm-rain
column sweep, the eddy viscosity K1/K14, the limits pass K7, K15 (the
scalar sweep at one scalar) and the Thomas solve K3.

    python3 -m microhh_torch.ring_timing [--out FILE] [--label NAME]
        [--groups rings,s_tend,fold,micro2,evisc,limits,scalar_rk,tdma]
    python3 -m microhh_torch.ring_timing --compare PARENT_FILE FILE

At the four shapes of their main paths: weakscaling 512x256x1024 float32
(K16 in scheme 4, K17 with one scalar), moser180 256x192x128 float64 (both
in scheme 4m), rico 384^3 float32 with the four scalars of its 2i5 scheme
(K13, K12 and K10 with advection off, as rico runs, and on), and
jaenschwalde's 1024x256x256 float32 with its two (thl, qt) for K13 and K12
(and K12 alone at rico 384^3 in float64) and its three (thl, qt, co2) for
K19 without advection, as jaenschwalde
runs it: once a scalar (three launches) and every scalar in one launch
(the kernels run on the rico case at that shape: they see only the shape,
the scheme, the advec flag and the scalar count).  The momentum sweep
(``uvw_rows``): K8/K9 at rico 384^3 in float32 and float64 with advection
on (swadvec=2) and off (2i5), and at SBL_Smag 256^3 with its Coriolis
term; K18 at jaenschwalde's 1024x256x256 without advection, as
jaenschwalde runs it, each with its plan, occupancy, one-chunk time and
the SASS count of its per-level loop.  The kernels whose
scalar tendency is the one-call s_tend of csrc/les_math.cuh at the shapes
of their main paths: K2 and K22 at drycblles 512^3 float32 and K20 at
sullivan2011 512x512x64 (the substep without the RK fold).  K22 also on
its paths in both its forms (the eddy
viscosity computed, and read): drycblles 512^3, sullivan2011 512^3 with the
sponge and Coriolis folds, the neutral Ekman LES 768x384x288 (no th) in
float32 and drycblles 512^3 in float64; beside K22's time its registers,
shared memory and blocks an SM from the card, the plan's chunks, blocks
and waves, its time with one chunk and its issue time counted from the
SASS of its per-level loop (``fold_issue``); the same SASS count beside
K12 and K17.  K11 at rico 384^3 in float32 and float64 and at 16^2x24 in
float64, in two states: the cell's own (its initial fields, cloud-free
and without rain, as the cell's timed steps are) and heavy rain
(chip_smoke.py's: a saturated layer, rain shafts with qr x 50, drops
crossing 2.5 cells in one dt).  K1/K14 (the ``evisc`` group,
``evisc_rows``): K1 at rico 384^3 in float32 and float64 and at
jaenschwalde's 1024x256x256 in ghost mode with the moist N2, at drycblles
512^3 in clamped mode (``build_step(fold=False)``), at sullivan2011
512x512x64 in ghost mode (the substep without the RK fold) and K14 at
SBL_Smag 256^3, each with its plan, occupancy, one-chunk time, the SASS
count of its per-level loop and K7's time at the same shape beside it.
K7 (the ``limits`` group, ``limits_rows``) in the mode of each of its
paths: drycblles 512^3 clamped (the RK-folded path's own mode), rico 384^3
in float32 and float64 and jaenschwalde's 1024x256x256 in ghost mode with
the moist N2, SBL_Smag 256^3 with its N2 field and the neutral Ekman LES
768x384x288 clamped and unstratified (no th read; the earlier kernel reads
u in its place, as ``Model.limits`` passes it), each with its plan,
occupancy, one-chunk time, the SASS count of its per-level loop
(``limits_function``: the k-march's limits_kernel<T, ST> or an earlier
tree's limits_kernel<T>) and K1's (K14's) time at the same shape beside it.
K15 (the ``scalar_rk`` group, ``scalar_rk_rows``) at SBL_Smag 256^3 with
its advection, the column fold on (its path's form) and off, with the
sweep's columns: its plan, occupancy and one-chunk time.  K3 (the ``tdma``
group, ``tdma_rows``) at the shapes of the paths that solve with it:
drycblles and sullivan2011 512^3, rico 384^3, the neutral Ekman LES
768x384x288 and SBL_Smag 256^3 in float32 and drycblles 512^3 in float64,
in the form its plan takes, with the form, chunk length, chunks, threads,
occupancy and waves and, beside it, the time of the sweep form at the same
shape.
Each time is the mean of 10 launches by
CUDA events after one warm-up launch; the stencil kernels run on seeded
random fields.  Beside each time: the bound (each input and output once
over 3.35 TB/s, or the operations over 67 TFLOP/s, 33.5 in float64, where
larger), registers, spills and stack from the build log's ptxas lines and,
where the tree's kernels report them (the k-marching K8/K9/K18, K12, K13,
K16, K17 and scalar sweep, K11 and K22), shared memory a block and resident blocks
an SM; for the k-marching kernels the chunk count, blocks in the grid and
waves, and
their time with one chunk (no k-split); for K11 blocks and waves, and its
issue time counted from the SASS of its phases (``micro2_issue``).  One JSON
object per kernel and shape is printed and, with --out, all of them are
written to FILE, with a digest of the SASS of every kernel instance of the
build (``sass_digests``), so that two trees' listings can be held
together; --compare holds two such files against each other
(``compare_digests``) and prints which instances kept their code, with
--keymap a JSON object of the second file's keys to the first's where an
instance was renamed.
--groups names the groups to time (GROUPS; all by default).  Needs a
CUDA device.

The script runs on an earlier checkout too (copy it into that tree's
``microhh_torch/``), so the same call can hold the trees in turns (parent,
this, this, parent); a kernel without an info entry there gets no
occupancy columns.  The scalar_rk and tdma groups need this tree's
wrappers.
"""

import argparse
import hashlib
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
# the timed groups: K16, K17, K12, K13, K10, K19, K8/K9 and K18; the
# kernels that call s_tend; K22 on its paths; K11; K1/K14 (with K7); K7
# (with K1/K14); K15; K3
GROUPS = ("rings", "s_tend", "fold", "micro2", "evisc", "limits",
          "scalar_rk", "tdma")
REPS = 10
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 33.5e12}
# operations a point (K13: a scalar and point; K17: a point with one
# scalar, the vertical weights' 49 included), counted from the sources
FLOPS = {"o4_mom": {"4": 560, "4m": 510}, "o4_scalars": {"4": 185, "4m": 140},
         "advec_mom": 400, "advec_scalars": 130, "tend_scalars": 110,
         "tend_scalar_acc": 100, "tend_rk": 700, "tend_rk_fold": 900,
         "tendencies": 700, "tend_scalar_rk": 110, "micro2": 300,
         "tdma": 16,
         "tend_uvw": 450, "tend_uvw_acc": 430, "evisc": 100, "evisc_n2": 100,
         "limits": 110}
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
# K12 alone in float64 at rico's shape (label, case, shape, dtype, S)
MOM_F64 = ("rico", "rico", (384, 384, 384), torch.float64, 4)
# the kernels that call s_tend: (label, case, shape, build_step options)
S_TEND_SHAPES = [("drycblles", "drycblles", (512, 512, 512), {}),
                 ("sullivan2011 unfolded", "sullivan2011", (512, 512, 64),
                  {"unfolded": True})]
# K15's shape: (label, case, shape)
SCALAR_RK_SHAPE = ("SBL_Smag", "SBL_Smag", (256, 256, 256))
# K3's shapes: (label, case, shape, dtype); its two forms' CUDA functions
TDMA_SHAPES = [("drycblles", "drycblles", (512, 512, 512), torch.float32),
               ("sullivan2011", "sullivan2011", (512, 512, 512),
                torch.float32),
               ("rico", "rico", (384, 384, 384), torch.float32),
               ("andren1994 less s", "andren1994", (768, 384, 288),
                torch.float32),
               ("SBL_Smag", "SBL_Smag", (256, 256, 256), torch.float32),
               ("drycblles", "drycblles", (512, 512, 512), torch.float64)]
TDMA = {"scan": "tdma_scan_kernel", "sweep": "tdma_kernel"}
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
# the momentum sweep's CUDA function, K8/K9 (RK) and K18 (no RK)
UVW = "tend_uvw_kernel"
# its shapes: (label, case, shape, dtype, kernel, advec flags timed)
UVW_SHAPES = [("rico", "rico", (384, 384, 384), torch.float32, "tend_uvw",
               (True, False)),
              ("rico", "rico", (384, 384, 384), torch.float64, "tend_uvw",
               (True, False)),
              ("SBL_Smag", "SBL_Smag", (256, 256, 256), torch.float32,
               "tend_uvw", (True,)),
              ("jaenschwalde", "rico", (1024, 256, 256), torch.float32,
               "tend_uvw_acc", (False,))]
# K11's shapes: (label, (itot, jtot, ktot), dtype)
MICRO2_SHAPES = [("rico", (384, 384, 384), torch.float32),
                 ("rico", (384, 384, 384), torch.float64),
                 ("rico 16^2x24", (16, 16, 24), torch.float64)]
# K1/K14's CUDA function, evisc_kernel<T, ST> (an earlier tree's
# evisc_kernel<T>), and its shapes: (label, case, shape, dtype, build_step
# options); the kernel sees only the shape, its ghost mode and its
# stratified mode (jaenschwalde's, moist in ghost mode, runs on the rico
# case at its shape)
EVISC = "evisc_kernel"
EVISC_SHAPES = [("rico", "rico", (384, 384, 384), torch.float32, {}),
                ("rico", "rico", (384, 384, 384), torch.float64, {}),
                ("jaenschwalde", "rico", (1024, 256, 256), torch.float32, {}),
                ("drycblles clamped", "drycblles", (512, 512, 512),
                 torch.float32, {"fold": False}),
                ("sullivan2011 unfolded", "sullivan2011", (512, 512, 64),
                 torch.float32, {"unfolded": True}),
                ("SBL_Smag", "SBL_Smag", (256, 256, 256), torch.float32, {})]
# K7's CUDA function, limits_kernel<T, ST> (an earlier tree's
# limits_kernel<T>), and its shapes in the mode of each path: (label, case,
# shape, dtype, build_step options); jaenschwalde's, moist in ghost mode,
# runs on the rico case at its shape
LIMITS = "limits_kernel"
LIMITS_SHAPES = [("drycblles", "drycblles", (512, 512, 512), torch.float32,
                  {}),
                 ("rico", "rico", (384, 384, 384), torch.float32, {}),
                 ("rico", "rico", (384, 384, 384), torch.float64, {}),
                 ("jaenschwalde", "rico", (1024, 256, 256), torch.float32,
                  {}),
                 ("SBL_Smag", "SBL_Smag", (256, 256, 256), torch.float32,
                  {}),
                 ("andren1994 less s", "andren1994", (768, 384, 288),
                  torch.float32, {})]
# the CUDA functions of the kernels that call s_tend
S_TEND_FUNCTIONS = {"tend_rk": "tend_rk_kernel",
                    "tend_rk_fold": "tend_rk_fold_kernel",
                    "tendencies": "tendencies_kernel"}


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


def compare_digests(parent, change, keymap=None):
    """Which kernel instances of two builds' sass_digests kept their code:
    {"same", "changed", "gone", "new"}, each a sorted list of the change's
    keys (gone: the parent's).  keymap: the change's key -> the parent's,
    for an instance that was renamed."""
    keymap = keymap or {}
    out = {"same": [], "changed": [], "gone": [], "new": []}
    matched = set()
    for key, digest in change.items():
        old = keymap.get(key, key)
        if old in parent:
            matched.add(old)
            out["same" if parent[old] == digest else "changed"].append(key)
        else:
            out["new"].append(key)
    out["gone"] = [key for key in parent if key not in matched]
    return {k: sorted(v) for k, v in out.items()}


def sass_digests(text):
    """{"function<template arguments>": sha1 of its instructions} of every
    kernel instance in a cuobjdump -sass listing (addresses left out), so
    that two builds' kernels can be shown to be the same code."""
    bodies, cur = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            name, args = _demangle(hit.group(1))
            cur = bodies.setdefault("%s<%s>" % (name, args), [])
            continue
        hit = re.match(r"\s*/\*[0-9a-f]+\*/\s+([^;]*;)", line)
        if cur is not None and hit:
            cur.append(hit.group(1))
    return {key: hashlib.sha1("\n".join(body).encode()).hexdigest()
            for key, body in bodies.items()}


def fold_issue(loops, shape, tile_j, clock_ghz, sms):
    """A k-march's (K22's, K17's, K12's, K8/K9's) issue time from the SASS of its
    per-level loop, or None unless the kernel has one such loop
    (sass_loops): every warp of a (tile_j, 32) tile runs it once a level.  Every instruction of
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


def sweep_function(name, dtype, advec, S, fold=True):
    """The ptxas key of the scalar sweep's instance a launch takes,
    scalar_sweep_kernel<T, RK, ADV, S, FOLD> (K10 and K15: RK, FOLD its
    fold flag; K19: neither)."""
    t = "float" if dtype == torch.float32 else "double"
    rk = name != "tend_scalar_acc"
    return "%s<%s,%s,%s,%d,%s>" % (SWEEP, t, str(rk).lower(),
                                   str(advec).lower(), S,
                                   str(rk and fold).lower())


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


def uvw_rows(label, case, shape, dtype, kernel, advecs, ptx, card,
             loops=None, clock_ghz=None, device="cuda"):
    """K8/K9 ("tend_uvw": s* and the carry written) or K18 ("tend_uvw_acc":
    the carry added onto) on the generic model of case at shape, on seeded
    random fields, once for each advec flag, the model's own Coriolis flag.
    Where the tree's kernel is the k-march (it reports its occupancy) the
    row takes its plan's chunks, blocks and waves, its occupancy and its
    time with one chunk; where the SASS holds its per-level loop (loops:
    sass_loops of the build), the loop's count and issue time
    (fold_issue)."""
    from .ops import kmarch
    itot, jtot, ktot = shape
    n = itot * jtot * ktot
    fb = n * torch.finfo(dtype).bits // 8
    acc = kernel == "tend_uvw_acc"
    nbytes = (10 if acc else 13) * fb
    t_name = "float" if dtype == torch.float32 else "double"
    key = "%s<%s,%s>" % (UVW, t_name, "false" if acc else "true")
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        m = build(case, itot, jtot, ktot, dtype, workdir, device)
        fz, ctx = m.fused, m.ctx
        gen = torch.Generator(device=device).manual_seed(itot + ktot)
        full = (ctx.kcells, jtot, itot)

        def rnd(scale=1.):
            return scale * torch.randn(full, dtype=dtype, device=device,
                                       generator=gen)

        s = {nm: rnd() for nm in ("u", "v", "w")}
        e = rnd().abs()
        t = {nm: rnd(1e-3) for nm in s}
        ct = fz.base.clone()
        if acc:
            def fn(**kw):
                fz.tend_uvw_acc(s, t, e, **kw)
        else:
            def fn(**kw):
                fz.tend_uvw(s, t, e, ct, 0.5, -5. / 9., True, **kw)
        saved = fz.advec
        try:
            for advec in advecs:
                fz.advec = advec
                by_bytes = 1e3 * nbytes / PEAK_BYTES_S
                by_ops = 1e3 * FLOPS[kernel] * n / PEAK_FLOPS[dtype]
                row = {"label": label, "kernel": kernel, "shape": list(shape),
                       "dtype": str(dtype)[6:], "advec": advec,
                       "coriolis": bool(fz.fold_force if acc
                                        else fz.coriolis),
                       "ms": events_ms(fn), "bound_ms": max(by_bytes, by_ops),
                       "bound_by": ("bytes" if by_bytes >= by_ops
                                    else "operations"),
                       "ops_per_point": FLOPS[kernel], "gbytes": nbytes / 1e9,
                       "ptxas": ptx.get(key), "function": key, "card": card}
                if kernel in kernels.INFO:
                    pl = fz.uvw_plan(dtype, acc)
                    kern = fz.k_uvw_acc if acc else fz.k_uvw
                    row.update(kern.info(dtype, 0))
                    row.update(chunks=pl.chunks,
                               blocks=pl.tiles_i * pl.tiles_j * pl.chunks,
                               waves=pl.waves,
                               ms_one_chunk=events_ms(lambda: fn(chunks=1)))
                if loops and key in loops:
                    # the parent's tile has common.cuh's eight rows too
                    row.update(fold_issue(
                        loops[key], shape, getattr(kmarch, "UVW_TJ", 8),
                        clock_ghz, sms_of(device)) or {})
                row["bound_share"] = row["bound_ms"] / row["ms"]
                print(json.dumps(row), flush=True)
                rows.append(row)
        finally:
            fz.advec = saved
        del m, s, t, e
    if device == "cuda":
        torch.cuda.empty_cache()
    return rows


def evisc_function(dtype, stratified, known):
    """The ptxas and SASS key of the K1/K14 instance a launch takes: the
    k-march's evisc_kernel<T, ST>, or the ring's evisc_kernel<T> where
    `known` (keys of a build) holds that."""
    t = "float" if dtype == torch.float32 else "double"
    old = "%s<%s>" % (EVISC, t)
    return old if old in known else "%s<%s,%d>" % (EVISC, t, stratified)


def evisc_rows(label, case, shape, dtype, step, ptx, card, loops=None,
               clock_ghz=None, device="cuda"):
    """K1 (Fused.evisc in the model's ghost or clamped mode, its N2 from a
    scalar) or K14 (FusedGeneric.evisc_n2, SBL_Smag's N2 field) on the
    model of case at shape on seeded random fields (th around 300 K), with
    K7's time at the same shape beside it.  Where the tree's kernel is the
    k-march (it reports its occupancy) the row takes its plan's chunks,
    blocks and waves, its occupancy and its time with one chunk; where the
    SASS holds its per-level loop (loops: sass_loops of the build), the
    loop's count and issue time (fold_issue)."""
    from .ops import kmarch
    itot, jtot, ktot = shape
    n = itot * jtot * ktot
    fb = n * torch.finfo(dtype).bits // 8
    with tempfile.TemporaryDirectory() as workdir:
        m = build(case, itot, jtot, ktot, dtype, workdir, device, **step)
        fz, ctx = m.fused, m.ctx
        st = fz.stratified
        kernel = "evisc_n2" if st == 2 else "evisc"
        gen = torch.Generator(device=device).manual_seed(itot + ktot)

        def rnd(scale=1., k=ctx.kcells):
            return scale * torch.randn((k, jtot, itot), dtype=dtype,
                                       device=device, generator=gen)
        u, v, w = rnd(), rnd(), rnd(0.3)
        a = rnd(1e-4, ktot) if st == 2 else 300. + rnd()
        if st == 2:
            def fn(**kw):
                return fz.evisc_n2(u, v, w, a, **kw)
        else:
            def fn(**kw):
                return fz.evisc(u, v, w, a, **kw)
        nbytes = (4 + (st > 0)) * fb
        by_bytes = 1e3 * nbytes / PEAK_BYTES_S
        by_ops = 1e3 * FLOPS[kernel] * n / PEAK_FLOPS[dtype]
        key = evisc_function(dtype, st, set(ptx) | set(loops or ()))
        row = {"label": label, "kernel": kernel, "shape": list(shape),
               "dtype": str(dtype)[6:], "ghosts": bool(fz.ghosts),
               "stratified": st, "ms": events_ms(fn),
               "bound_ms": max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "ops_per_point": FLOPS[kernel], "gbytes": nbytes / 1e9,
               "ptxas": ptx.get(key), "function": key, "card": card,
               "limits_ms": events_ms(lambda: fz.limits(u, v, w, a))}
        if "evisc" in kernels.INFO:
            pl = fz.evisc_plan(dtype, st)
            row.update(fz.k_evisc.info(dtype, st), chunks=pl.chunks,
                       blocks=pl.tiles_i * pl.tiles_j * pl.chunks,
                       waves=pl.waves,
                       ms_one_chunk=events_ms(lambda: fn(chunks=1)))
        if loops and key in loops:
            # the parent's tile has common.cuh's eight rows too
            row.update(fold_issue(loops[key], shape,
                                  getattr(kmarch, "EV_TJ", 8), clock_ghz,
                                  sms_of(device)) or {})
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        del m, u, v, w, a
    if device == "cuda":
        torch.cuda.empty_cache()
    return [row]


def limits_function(dtype, stratified, known):
    """The ptxas and SASS key of the K7 instance a launch takes: the
    k-march's limits_kernel<T, ST>, or the ring's limits_kernel<T> where
    `known` (keys of a build) holds that."""
    t = "float" if dtype == torch.float32 else "double"
    old = "%s<%s>" % (LIMITS, t)
    return old if old in known else "%s<%s,%d>" % (LIMITS, t, stratified)


def limits_rows(label, case, shape, dtype, step, ptx, card, loops=None,
                clock_ghz=None, device="cuda"):
    """K7 (Fused.limits) in the mode of the model of case at shape (ghost
    or clamped; its N2 from a scalar, an N2 field, or none) on seeded
    random fields (th around 300 K; u in th's place unstratified, as
    Model.limits passes it), with K1's (K14's) time at the same shape
    beside it.  Where the tree's K7 is the k-march (it reports its
    occupancy) the row takes its plan's chunks, blocks and waves, its
    occupancy and its time with one chunk; where the SASS holds its
    per-level loop (loops: sass_loops of the build), the loop's count and
    issue time (fold_issue)."""
    from .ops import kmarch
    itot, jtot, ktot = shape
    n = itot * jtot * ktot
    fb = n * torch.finfo(dtype).bits // 8
    with tempfile.TemporaryDirectory() as workdir:
        m = build(case, itot, jtot, ktot, dtype, workdir, device, **step)
        fz, ctx = m.fused, m.ctx
        st = fz.stratified
        gen = torch.Generator(device=device).manual_seed(itot + ktot)

        def rnd(scale=1., k=ctx.kcells):
            return scale * torch.randn((k, jtot, itot), dtype=dtype,
                                       device=device, generator=gen)
        u, v, w = rnd(), rnd(), rnd(0.3)
        if st == 0:
            a = u
        else:
            a = rnd(1e-4, ktot) if st == 2 else 300. + rnd()

        def fn(**kw):
            return fz.limits(u, v, w, a, **kw)
        if st == 2:
            def ev():
                return fz.evisc_n2(u, v, w, a)
        else:
            def ev():
                return fz.evisc(u, v, w, a)
        # u, v, w and th or N2 read once; the partials and maxima are small
        nbytes = (3 + (st > 0)) * fb
        by_bytes = 1e3 * nbytes / PEAK_BYTES_S
        by_ops = 1e3 * FLOPS["limits"] * n / PEAK_FLOPS[dtype]
        key = limits_function(dtype, st, set(ptx) | set(loops or ()))
        row = {"label": label, "kernel": "limits", "shape": list(shape),
               "dtype": str(dtype)[6:], "ghosts": bool(fz.ghosts),
               "stratified": st, "ms": events_ms(fn),
               "bound_ms": max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "ops_per_point": FLOPS["limits"], "gbytes": nbytes / 1e9,
               "ptxas": ptx.get(key), "function": key, "card": card,
               "evisc_kernel": "evisc_n2" if st == 2 else "evisc",
               "evisc_ms": events_ms(ev)}
        if "limits" in kernels.INFO:
            pl = fz.limits_plan(dtype, st)
            row.update(fz.k_limits.info(dtype, st), chunks=pl.chunks,
                       blocks=pl.tiles_i * pl.tiles_j * pl.chunks,
                       waves=pl.waves,
                       ms_one_chunk=events_ms(lambda: fn(chunks=1)))
        if loops and key in loops:
            # the parent's tile has common.cuh's eight rows too
            row.update(fold_issue(loops[key], shape,
                                  getattr(kmarch, "EV_TJ", 8), clock_ghz,
                                  sms_of(device)) or {})
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        del m, u, v, w, a
    if device == "cuda":
        torch.cuda.empty_cache()
    return [row]


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
               clock_ghz=None, device="cuda", only=None):
    """K16 and K17 (a 4th-order case) or K13, K12 and the scalar sweep at
    one shape on seeded random fields; K17's and K12's rows also take the
    issue time of their per-level loops (loops: sass_loops of the build).
    only: the names of the kernels to time (the scalar sweep then not)."""
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
            # the k-march of K12 reports its occupancy and takes chunks=
            k12 = adv if "advec_mom" in kernels.INFO else None
            calls["advec_mom"] = (
                lambda **kw: adv.momentum(u, v, wc, *t[:3], **kw), 9 * fb,
                FLOPS["advec_mom"], k12, scheme)
        for name, (fn, nbytes, flops, owner, scheme) in calls.items():
            if only is not None and name not in only:
                continue
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
                elif name == "advec_mom":
                    pl, kern, info_s = owner.mom_plan(dtype), owner.k_mom, 0
                else:
                    pl, kern, info_s = owner.plan(S, dtype), owner.k_scal, S
                sid = {"4": 0, "4m": 1, "2i4": 0, "2i5": 1, "2i53": 2,
                       "2i62": 3}[scheme]
                row.update(kern.info(dtype, sid, info_s))
                row.update(chunks=pl.chunks, blocks=pl.tiles_i * pl.tiles_j
                           * pl.chunks, waves=pl.waves,
                           ms_one_chunk=events_ms(lambda: fn(chunks=1)))
            if (name in ("o4_scalars", "advec_mom") and loops
                    and key in loops):
                from .ops import kmarch
                tile_j = getattr(kmarch, "K17_TJ" if name == "o4_scalars"
                                 else "K12_TJ", 16)
                row.update(fold_issue(loops[key], shape, tile_j, clock_ghz,
                                      sms_of(device)) or {})
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
        del u, v, wc, wd, t, a, calls
        if m.o4 is None and only is None:
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
    """K2 and K22 (the dry RK-folded model) or K20 (the substep without the
    RK fold) on seeded random fields: the kernels whose scalar tendency is
    s_tend.  K22's row takes
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
        if m.unfolded:
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


def scalar_rk_rows(label, case, shape, ptx, card, device="cuda"):
    """K15 (FusedGeneric.tend_scalars in a case of one scalar) on seeded
    random fields: the column fold on (the path's form) and off, the
    case's advection flag, with its plan, occupancy and one-chunk time."""
    dtype = torch.float32
    itot, jtot, ktot = shape
    n = itot * jtot * ktot
    fb = n * torch.finfo(dtype).bits // 8
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        m = build(case, itot, jtot, ktot, dtype, workdir, device)
        fz, ctx = m.fused, m.ctx
        gen = torch.Generator(device=device).manual_seed(itot + ktot)

        def rnd(scale=1.):
            return scale * torch.randn((ctx.kcells, jtot, itot), dtype=dtype,
                                       device=device, generator=gen)

        (name,) = fz.names
        s = {nm: rnd() for nm in ("u", "v", "w", name)}
        t = {name: rnd(1e-3)}
        e = rnd().abs()
        # e, the scalar and its carry read, s* and the carry written, and
        # u, v, w read with advection
        nbytes = (5 + 3 * fz.advec) * fb
        by_bytes = 1e3 * nbytes / PEAK_BYTES_S
        by_ops = 1e3 * FLOPS["tend_scalar_rk"] * n / PEAK_FLOPS[dtype]
        for fold in (True, False):
            def fn(fold=fold, **kw):
                return fz.tend_scalars(s, t, e, fz.base[None], 0.5, -5. / 9.,
                                       True, fold, **kw)
            key = sweep_function("tend_scalars", dtype, fz.advec, 1, fold)
            pl = fz.plan("tend_scalars", 1, dtype, fold=fold)
            row = {"label": label, "kernel": "tend_scalar_rk", "fold": fold,
                   "advec": fz.advec, "shape": list(shape),
                   "dtype": "float32", "ms": events_ms(fn),
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                   "ops_per_point": FLOPS["tend_scalar_rk"],
                   "gbytes": nbytes / 1e9, "ptxas": ptx.get(key),
                   "function": key, "card": card}
            row.update(fz.k_scalar.info(dtype, int(fz.advec) + 2 * (not fold),
                                        1))
            row.update(chunks=pl.chunks, blocks=pl.tiles_i * pl.tiles_j
                       * pl.chunks, waves=pl.waves,
                       ms_one_chunk=events_ms(lambda: fn(chunks=1)))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
        del m, s, t, e
    if device == "cuda":
        torch.cuda.empty_cache()
    return rows


def tdma_rows(label, case, shape, dtype, ptx, card, device="cuda"):
    """K3 on a model's pivots and the spectrum of a seeded random field, in
    the form its plan takes and in the sweep form beside it: the spectrum
    read and written once and the pivots read once (20 B a mode and level
    in float32)."""
    itot, jtot, ktot = shape
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        m = build(case, itot, jtot, ktot, dtype, workdir, device)
        pr = m.pres
        gen = torch.Generator(device=device).manual_seed(itot + ktot)
        x = torch.randn((ktot, jtot, itot), dtype=dtype, device=device,
                        generator=gen)
        spec = torch.fft.rfft2(x, dim=(-2, -1))
        del x
        modes = spec.shape[1] * spec.shape[2]
        nbytes = 5 * spec.numel() * spec.element_size() // 2
        by_bytes = 1e3 * nbytes / PEAK_BYTES_S
        by_ops = 1e3 * FLOPS["tdma"] * itot * jtot * ktot / PEAK_FLOPS[dtype]
        t = "float" if dtype == torch.float32 else "double"
        for sweep in (False, True):
            form = pr.tdma_form(ktot, dtype, sweep)
            key = ("%s<%s,%d>" % (TDMA["scan"], t, form.L)
                   if form.form == "scan" else "%s<%s>" % (TDMA["sweep"], t))
            info = pr.k_tdma.info(dtype, int(form.form == "sweep"),
                                  form.chunks)
            blocks = -(-modes // (form.threads // form.chunks))
            row = {"label": label, "kernel": "tdma", "form": form.form,
                   "shape": list(shape), "dtype": str(dtype)[6:],
                   "ms": events_ms(lambda: pr.tdma(spec, sweep)),
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                   "ops_per_point": FLOPS["tdma"], "gbytes": nbytes / 1e9,
                   "ptxas": ptx.get(key), "function": key, "card": card}
            row.update(info, L=form.L, chunks=form.chunks,
                       threads=form.threads, blocks=blocks,
                       waves=-(-blocks // (info["blocks_per_sm"]
                                           * info["sms"])))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
        del m, spec
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
    ap.add_argument("--compare", nargs=2, metavar=("PARENT", "FILE"),
                    help="hold the sass_digests of two --out files")
    ap.add_argument("--keymap", default=None,
                    help="with --compare: a JSON file of FILE's instance "
                    "names to PARENT's, for renamed instances")
    args = ap.parse_args()
    if args.compare:
        digests = []
        for path in args.compare:
            with open(path) as f:
                digests.append(next(r["digests"] for r in json.load(f)
                                    if r.get("kind") == "sass_digests"))
        keymap = None
        if args.keymap:
            with open(args.keymap) as f:
                keymap = json.load(f)
        out = compare_digests(*digests, keymap)
        print(json.dumps({k: len(v) for k, v in out.items()}))
        print(json.dumps({k: v for k, v in out.items() if k != "same"},
                         indent=1))
        return
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
    loops.update(sass_loops(sass, FUNCTIONS["advec_mom"]))
    loops.update(sass_loops(sass, UVW))
    loops.update(sass_loops(sass, EVISC))
    loops.update(sass_loops(sass, LIMITS))
    clock = max_sm_clock_ghz()
    rows = [{"kind": "sass_digests", "digests": sass_digests(sass)}]
    groups = set(args.groups.split(","))
    for label, case, shape, dtype, S in SHAPES if "rings" in groups else ():
        rows += time_shape(label, case, shape, dtype, S, ptx, card, loops,
                           clock)
    if "rings" in groups:
        rows += time_shape(*MOM_F64, ptx, card, loops, clock,
                           only=("advec_mom",))
    for label, case, shape, dtype, kernel, advecs in (
            UVW_SHAPES if "rings" in groups else ()):
        rows += uvw_rows(label, case, shape, dtype, kernel, advecs, ptx, card,
                         loops, clock)
    for label, case, shape, step in S_TEND_SHAPES if "s_tend" in groups else ():
        rows += s_tend_rows(label, case, shape, step, ptx, card,
                            loops=loops, clock_ghz=clock)
    for label, case, shape, dtype in FOLD_SHAPES if "fold" in groups else ():
        rows += fold_rows(label, case, shape, dtype, ptx, card, loops, clock)
    for label, case, shape, dtype, step in (
            EVISC_SHAPES if "evisc" in groups else ()):
        rows += evisc_rows(label, case, shape, dtype, step, ptx, card, loops,
                           clock)
    for label, case, shape, dtype, step in (
            LIMITS_SHAPES if "limits" in groups else ()):
        rows += limits_rows(label, case, shape, dtype, step, ptx, card,
                            loops, clock)
    if "scalar_rk" in groups:
        rows += scalar_rk_rows(*SCALAR_RK_SHAPE, ptx, card)
    for label, case, shape, dtype in TDMA_SHAPES if "tdma" in groups else ():
        rows += tdma_rows(label, case, shape, dtype, ptx, card)
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
