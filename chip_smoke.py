#!/usr/bin/env python3
"""Smoke test of the PyTorch port (microhh_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the hand-written CUDA kernels from microhh_torch/csrc;
  3. each kernel against its plain-torch version on the card, at 45^2x8 (odd:
     the unpacked DFT path, radices 3 and 5) and 48^2x8 (radices 8, 2, 3),
     both with partial tiles, 64^2x32 and 512^2x32, in
     float64 (max error <= 1e-12 of each output's maximum) and float32
     (<= 1e-5); the Thomas solve's error is taken relative to each mode's
     own maximum over k (<= 1e-12 and 1e-4: its k-march accumulates);
  4. two whole RK3 steps of a 32^3 float64 case on the card against the same
     two steps on the CPU (plain versions), <= 1e-10;
  5. the drycblles LES at 512^3 float32 through Model.run(max_iters=12): every
     kernel launched, finite fields, status DIV <= 1e-4; then the step time
     (median of 10 steps after 2 warm-up steps) and the peak memory;
  6. at the 512^3 float32 shapes of that run, each kernel against its plain
     version (the float32 tolerances of phase 3), then both timed.
With --profile FILE, a 7th phase traces two steps with torch.profiler and
prints the device time per kernel, the step's device idle share (one minus
the device time over the wall time of the same profiled steps, with the
unprofiled wall time beside it) and the limits and status-line times, and
writes them with the profiler's table to FILE.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel results.  Without a CUDA device, or without the microhh_torch
package beside this file, it exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

DRYCBL_INI = """
[grid]
itot=%(n)d
jtot=%(n)d
ktot=%(k)d
xsize=3200.
ysize=3200.
zsize=1200.
swspatialorder=2

[advec]
swadvec=2
cflmax=1.2

[diff]
swdiff=smag2
dnmax=0.3

[thermo]
swthermo=dry
swbasestate=boussinesq
thref0=300.
pbot=100000.

[boundary]
mbcbot=noslip
mbctop=freeslip
sbcbot=flux
sbctop=neumann
sbot=0.1
stop=0.003
swboundary=surface
z0m=0.1
z0h=0.1

[fields]
visc=1.e-5
svisc=1.e-5
rndseed=2
rndamp[th]=0.1
rndz=300.
rndexp=2.

[buffer]
swbuffer=1
zstart=1000.
sigma=0.00223
beta=2.

[time]
endtime=3600
savetime=3600
dt=6.
dtmax=60.
outputiter=1
starttime=0
"""


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_model(torch, n, k, dtype, device, mode="run", workdir="."):
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    m = Model(Ini(DRYCBL_INI % {"n": n, "k": k}), mode, "drycblles",
              workdir=workdir, dtype=dtype, device=device)
    m.finish_setup()
    return m


def initial_state(m, seed=None):
    """Fields.create's seeded perturbation plus the analytic th profile of
    cases/drycblles/drycblles_input.py; with a seed, also random velocities
    (for kernel checks that need non-trivial flow)."""
    from microhh_torch.model import NP_DTYPE
    st = m.fields.create(None, dtype=NP_DTYPE[m.dtype])
    g = m.grid
    ks, ke = g.kstart, g.kend
    st["th"][ks:ke] += (300. + 0.003 * g.z[ks:ke])[:, None, None]
    if seed is not None:
        rng = np.random.RandomState(seed)
        for n in ("u", "v"):
            st[n][ks:ke] += rng.randn(g.ktot, g.jtot, g.itot)
        st["w"][ks + 1:ke] += 0.3 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    return st


def rel_err(a, b):
    """max |a - b| over the maximum of |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def mode_rel_err(a, b):
    """For spectra viewed as real (k, j, mode, 2): the largest over the
    modes of max_k |a - b| / max_k |b|, so that a small high-wavenumber
    mode is held to its own size and not to the largest mode's."""
    a, b = a.double(), b.double()
    num = (a - b).abs().amax(dim=(0, 3))
    den = b.abs().amax(dim=(0, 3)).clamp_min(1e-300)
    return float((num / den).max())


TOLS = {"float64": {"field": 1e-12, "mode": 1e-12},
        "float32": {"field": 1e-5, "mode": 1e-4}}
ERR = {"field": rel_err, "mode": mode_rel_err}


# --------------------------------------------------------------------------
#  phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_cases(torch, m, seed):
    """(name, kernel call, plain call, error kind) for every kernel on a
    model's wrappers with seeded random inputs; each call returns a list of
    tensors to compare."""
    from microhh_torch.ops import fused as F
    from microhh_torch.ops.pres_2 import tdma_plain
    ctx = m.ctx
    s, sfc = m.as_device_state(initial_state(m, seed))
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, scale=1.):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    interior = (ctx.ktot, ctx.jtot, ctx.itot)
    e = rnd(*interior).abs() * 10.
    t0 = {n: rnd(*shape, scale=0.1) for n in F.PROGNOSTIC}
    fz, gl, pr = m.fused, m.glue, m.pres
    cases = []

    cases.append(("evisc",
                  lambda: [fz.evisc(s["u"], s["v"], s["w"], s["th"])],
                  lambda: [F.evisc_plain(s["u"], s["v"], s["w"], s["th"],
                                         fz.ce, ctx.ks, ctx.dxi, ctx.dyi,
                                         fz.tPr, True)], "field"))
    cases.append(("limits",
                  lambda: list(fz.limits(s["u"], s["v"], s["w"], s["th"])),
                  lambda: list(F.limits_plain(s["u"], s["v"], s["w"], s["th"],
                                              fz.ce, ctx.ks, ctx.dxi, ctx.dyi,
                                              fz.tPr, True)), "field"))
    for first, can in ((True, -5. / 9.), (False, -153. / 128.), (False, 0.)):
        carry = can != 0.

        def run(kernel, first=first, can=can, carry=carry):
            t = {n: a.clone() for n, a in t0.items()}
            args = (ctx.ks, ctx.dxi, ctx.dyi, fz.visc, fz.svisc, fz.tPr,
                    0.7, can, first, carry)
            if kernel:
                out = fz.tend_rk(s, t, e, *args[6:])
            else:
                out = F.tend_rk_plain(s, e, t, fz.ct, *args)
            return ([out[n][ctx.ks:ctx.ke] for n in F.PROGNOSTIC]
                    + [t[n][ctx.ks:ctx.ke] for n in F.PROGNOSTIC])
        cases.append(("tend_rk", lambda run=run: run(True),
                      lambda run=run: run(False), "field"))
    cases.append(("pres_rhs",
                  lambda: [gl.rhs(s["u"], s["v"], s["w"], 2.5)],
                  lambda: [F.pres_rhs_plain(s["u"], s["v"], s["w"], gl.pc,
                                            ctx.ks, ctx.dxi, ctx.dyi, 2.5)],
                  "field"))
    p = rnd(*interior)
    for carry in (True, False):
        def apply(kernel, carry=carry):
            st = {n: s[n].clone() for n in ("u", "v", "w")}
            t = {n: t0[n].clone() for n in ("u", "v", "w")}
            can = -5. / 9. if carry else 0.
            if kernel:
                gl.apply(p, st, t, 0.4, can, carry)
            else:
                F.pres_apply_plain(p, st, t, gl.pc, ctx.ks, ctx.dxi, ctx.dyi,
                                   0.4, can, carry)
            return [st[n] for n in st] + [t[n] for n in t]
        cases.append(("pres_apply", lambda apply=apply: apply(True),
                      lambda apply=apply: apply(False), "field"))
    x = rnd(*interior)
    cases.append(("dft_fwd",
                  lambda: [torch.view_as_real(pr.rfft2(x))],
                  lambda: [torch.view_as_real(torch.fft.rfft2(x, dim=(-2, -1)))],
                  "field"))
    spec = torch.fft.rfft2(x, dim=(-2, -1))
    cases.append(("dft_inv",
                  lambda: [pr.irfft2(spec.clone(), ctx.itot)],
                  lambda: [torch.fft.irfft2(spec, s=x.shape[-2:],
                                            dim=(-2, -1))], "field"))
    cases.append(("tdma",
                  lambda: [torch.view_as_real(pr.tdma(spec.clone()))],
                  lambda: [torch.view_as_real(tdma_plain(spec.clone(), pr.winv,
                                                         pr.tab))],
                  "mode"))
    return cases


def compare(torch, name, kern, plain, kind, dtype, where):
    """Run a kernel and its plain version, fail unless every output agrees
    to the tolerance; returns the largest absolute difference."""
    a, b = kern(), plain()
    torch.cuda.synchronize()
    err = max(ERR[kind](x, y) for x, y in zip(a, b))
    abs_err = max(float((x.double() - y.double()).abs().max())
                  for x, y in zip(a, b))
    tol = TOLS[str(dtype)[6:]][kind]
    ok = err <= tol
    log("  %-10s %-12s %-7s %s rel err %.3e (tol %.0e), abs %.3e %s"
        % (name, where, str(dtype)[6:], kind, err, tol, abs_err,
           "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("kernel %s disagrees with its plain version"
                             % name)
    return abs_err


def check_kernels(torch):
    for n, k in ((45, 8), (48, 8), (64, 32), (512, 32)):
        for dtype in (torch.float64, torch.float32):
            m = build_model(torch, n, k, dtype, "cuda")
            m.build_step()
            for name, kern, plain, kind in kernel_cases(torch, m, seed=n + k):
                compare(torch, name, kern, plain, kind, dtype,
                        "%d^2x%d" % (n, k))


# --------------------------------------------------------------------------
#  phase 4: whole step on the card against the CPU
# --------------------------------------------------------------------------

def check_step(torch):
    out = {}
    for device in ("cuda", "cpu"):
        m = build_model(torch, 32, 32, torch.float64, device)
        m.build_step()
        s, sfc = m.as_device_state(initial_state(m, seed=7))
        for _ in range(2):
            s, sfc, aux = m.step(s, sfc, 2.0)
        out[device] = (m, s, aux)
    m, s_gpu, aux_gpu = out["cuda"]
    _, s_cpu, aux_cpu = out["cpu"]
    ks, ke = m.ctx.ks, m.ctx.ke
    worst = 0.
    for n in ("u", "v", "w", "th"):
        worst = max(worst, rel_err(s_gpu[n][ks:ke].cpu(), s_cpu[n][ks:ke]))
    worst = max(worst, rel_err(aux_gpu["p"].cpu(), aux_cpu["p"]))
    log("  2 RK3 steps 32^3 float64, card vs CPU: max rel err %.3e" % worst)
    if not worst <= 1e-10:
        raise AssertionError("whole step on the card disagrees with the CPU")


# --------------------------------------------------------------------------
#  phase 5: the main path at 512^3
# --------------------------------------------------------------------------

def run_main_path(torch, workdir, n=512, device="cuda"):
    init = build_model(torch, n, n, torch.float32, device, "init", workdir)
    init.save_initial_state(initial_state(init))
    m = build_model(torch, n, n, torch.float32, device, "run", workdir)
    m.build_step()
    for kern in m.kernels():
        kern.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = m.run(max_iters=12)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in m.kernels()}
    peak = torch.cuda.max_memory_allocated()
    log("  Model.run(max_iters=12) at 512^3 float32: %.3f s wall, launches %s"
        % (run_s, launches))
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        raise AssertionError("main path did not launch %s" % missing)
    ks, ke = m.ctx.ks, m.ctx.ke
    for name in ("u", "v", "w", "th"):
        if not bool(torch.isfinite(s[name][ks:ke]).all()):
            raise AssertionError("non-finite %s after the run" % name)
    with open(os.path.join(workdir, "drycblles.out")) as f:
        rows = [line.split() for line in f if line.split()[0].isdigit()]
    divs = [float(r[6]) for r in rows]
    final = {kk: float(v) for kk, v in m.diagnostics(s, m.final_sfc).items()}
    log("  status rows %d, max DIV %.3e, final DIV %.3e, TKE %.6e"
        % (len(rows), max(divs), final["div"], final["tke"]))
    if not (len(rows) >= 12 and max(divs) <= 1e-4 and final["div"] <= 1e-4
            and np.isfinite(final["tke"])):
        raise AssertionError("divergence or status check failed")

    # step time: median of 10 steps after 2 warm-up steps
    sfc = m.final_sfc
    dt = m.timeloop.dt
    times = []
    for it in range(12):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s, sfc, _ = m.step(s, sfc, dt)
        torch.cuda.synchronize()
        if it >= 2:
            times.append(time.perf_counter() - t1)
    step_s = statistics.median(times)
    log("  s/step 512^3 float32: median %.6f (min %.6f, max %.6f) of 10; "
        "peak memory %.3f GB" % (step_s, min(times), max(times), peak / 1e9))
    return m, s, launches, step_s, peak, run_s


# --------------------------------------------------------------------------
#  phase 6: kernels against their plain versions, and their times, at 512^3
# --------------------------------------------------------------------------

def time_call(torch, fn, reps):
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


def check_kernels_full(torch, m):
    """Each kernel against its plain version on seeded inputs at the main
    path's shapes; returns the largest absolute difference per kernel."""
    errs = {}
    for name, kern, plain, kind in kernel_cases(torch, m, seed=512):
        err = compare(torch, name, kern, plain, kind, m.dtype, "%d^3" % m.ctx.itot)
        errs[name] = max(errs.get(name, 0.), err)
    torch.cuda.empty_cache()
    return errs


def time_kernels(torch, m, s):
    from microhh_torch.ops import fused as F
    from microhh_torch.ops.pres_2 import tdma_plain
    ctx, fz, gl, pr = m.ctx, m.fused, m.glue, m.pres
    e = fz.evisc(s["u"], s["v"], s["w"], s["th"])
    t = m.t
    rhs = gl.rhs(s["u"], s["v"], s["w"], 1.)
    p = pr.solve(rhs)
    spec = torch.fft.rfft2(p, dim=(-2, -1))
    tend_args = (ctx.ks, ctx.dxi, ctx.dyi, fz.visc, fz.svisc, fz.tPr, 0.5,
                 -5. / 9., False, True)
    uvwth = [s[n] for n in ("u", "v", "w", "th")]
    pairs = {
        "evisc": (lambda: fz.evisc(*uvwth),
                  lambda: F.evisc_plain(*uvwth, fz.ce, ctx.ks, ctx.dxi,
                                        ctx.dyi, fz.tPr, True)),
        "tend_rk": (lambda: fz.tend_rk(s, t, e, *tend_args[6:]),
                    lambda: F.tend_rk_plain(s, e, t, fz.ct, *tend_args)),
        "pres_rhs": (lambda: gl.rhs(s["u"], s["v"], s["w"], 1.),
                     lambda: F.pres_rhs_plain(s["u"], s["v"], s["w"], gl.pc,
                                              ctx.ks, ctx.dxi, ctx.dyi, 1.)),
        "dft_fwd": (lambda: pr.rfft2(rhs),
                    lambda: torch.fft.rfft2(rhs, dim=(-2, -1))),
        "tdma": (lambda: pr.tdma(spec),
                 lambda: tdma_plain(spec, pr.winv, pr.tab)),
        # the kernel overwrites its input: both sides time one copy of it
        "dft_inv": (lambda: pr.irfft2(spec.clone(), ctx.itot),
                    lambda: torch.fft.irfft2(spec.clone(), s=p.shape[-2:],
                                             dim=(-2, -1))),
        "pres_apply": (lambda: gl.apply(p, s, t, 0.0, 0.0, True),
                       lambda: F.pres_apply_plain(p, s, t, gl.pc, ctx.ks,
                                                  ctx.dxi, ctx.dyi, 0.0, 0.0,
                                                  True)),
        "limits": (lambda: fz.limits(*uvwth),
                   lambda: F.limits_plain(*uvwth, fz.ce, ctx.ks, ctx.dxi,
                                          ctx.dyi, fz.tPr, True)),
    }
    out = {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: both measured twice, in turns
        p1 = time_call(torch, plain, 3)
        k1 = time_call(torch, kern, 10)
        k2 = time_call(torch, kern, 10)
        p2 = time_call(torch, plain, 3)
        out[name] = (min(k1, k2), min(p1, p2))
        log("  %-10s kernel %.3f ms  plain %.3f ms  (runs %.3f/%.3f, %.3f/%.3f)"
            % (name, out[name][0], out[name][1], k1, k2, p1, p2))
    return out


# --------------------------------------------------------------------------
#  phase 7 (--profile): where the step's device time goes
# --------------------------------------------------------------------------

# kernel-name fragment -> part of the step
PARTS = [("evisc_kernel", "K1 evisc"), ("tend_rk_kernel", "K2 tend_rk"),
         ("pres_rhs_kernel", "K4 pres_rhs"), ("dft_r2c_x", "K5 dft_fwd (i pass)"),
         ("dft_c2c_y", "K5/K6 dft (j passes)"), ("tdma_kernel", "K3 tdma"),
         ("dft_c2r_x", "K6 dft_inv (i pass)"),
         ("pres_apply_kernel", "K4 pres_apply")]


def device_us(evt):
    """Device time of a device-side event (kernel, copy, fill); 0 for a
    host-side op, whose device time its kernels' own events already hold."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.


def wall_and_device(torch, fn, reps):
    """Median host wall time (synchronised) and mean CUDA-event time, ms."""
    walls = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    end.record()
    torch.cuda.synchronize()
    return statistics.median(walls), start.elapsed_time(end) / reps


def profile_steps(torch, m, s, path, nsteps=2):
    from torch.profiler import profile, ProfilerActivity
    sfc, dt = m.final_sfc, m.timeloop.dt
    state = {"s": s, "sfc": sfc}

    def steps():
        for _ in range(nsteps):
            state["s"], state["sfc"], _ = m.step(state["s"], state["sfc"], dt)

    plain_wall, _ = wall_and_device(torch, steps, 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    parts = {label: 0. for _, label in PARTS}
    other, other_n = 0., 0
    for evt in avgs:
        us = device_us(evt)
        if us <= 0.:
            continue
        label = next((lb for frag, lb in PARTS if frag in evt.key), None)
        if label is None:
            other += us
            other_n += evt.count
        else:
            parts[label] += us
    busy_ms = (sum(parts.values()) + other) / 1e3
    if busy_ms <= 0.:
        raise RuntimeError("the profiler recorded no device time")
    lines = ["%d steps of drycblles %d^3 %s, card: %s"
             % (nsteps, m.ctx.itot, str(m.dtype)[6:], card_line()),
             "profiled wall %.3f ms/step, device busy %.3f ms/step, device "
             "idle share %.3f (same profiled steps); unprofiled wall %.3f "
             "ms/step" % (wall_ms / nsteps, busy_ms / nsteps,
                          1. - busy_ms / wall_ms, plain_wall / nsteps),
             "%-28s %10s %7s" % ("part", "ms/step", "share")]
    for label, us in list(parts.items()) + [
            ("other (%d device ops)" % (other_n // nsteps), other)]:
        lines.append("%-28s %10.3f %7.3f" % (label, us / 1e3 / nsteps,
                                             us / 1e3 / busy_ms))
    for name, fn in (("limits", lambda: {k: float(v) for k, v in
                                         m.limits(state["s"], state["sfc"]).items()}),
                     ("diagnostics", lambda: {k: float(v) for k, v in
                                              m.diagnostics(state["s"], state["sfc"]).items()})):
        w, d = wall_and_device(torch, fn, 5)
        lines.append("%s per call: wall %.3f ms (median of 5), CUDA events "
                     "%.3f ms" % (name, w, d))
    sort = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(avgs.table(sort_by=sort, row_limit=40))
    for line in lines:
        log("  " + line)
    log("  full table: %s" % path)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from microhh_torch import kernels
    except ImportError as e:
        sys.exit("chip_smoke: microhh_torch is not beside this script (%s)" % e)
    args = sys.argv[1:]
    profile_path = None
    if args:
        if len(args) != 2 or args[0] != "--profile":
            sys.exit("usage: chip_smoke.py [--profile FILE]")
        profile_path = args[1]

    log("[1] card: %s" % card_line())
    log("    torch %s, CUDA %s, device %s, python %s"
        % (torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
           sys.version.split()[0]))

    t0 = time.perf_counter()
    path, build_s, build_log = kernels.build()
    kernels.load()
    log("[2] kernels built in %.1f s (%.1f s wall): %s"
        % (build_s, time.perf_counter() - t0, os.path.basename(path)))
    for line in build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("    " + line.strip())

    log("[3] kernels against their plain versions")
    check_kernels(torch)

    log("[4] whole step, card against CPU")
    check_step(torch)

    log("[5] drycblles 512^3 float32 through Model.run")
    with tempfile.TemporaryDirectory() as workdir:
        m, s, launches, step_s, peak, run_s = run_main_path(torch, workdir)

        log("[6] kernels at 512^3 float32: against their plain versions, "
            "then timed")
        errs = check_kernels_full(torch, m)
        times = time_kernels(torch, m, s)

        if profile_path:
            log("[7] profile of two steps at 512^3 float32")
            os.makedirs(os.path.dirname(os.path.abspath(profile_path)),
                        exist_ok=True)
            profile_steps(torch, m, s, profile_path)

    log(json.dumps({"drycblles_512_f32": {
        "step_s_median": step_s, "run12_wall_s": run_s,
        "peak_mem_gb": peak / 1e9, "kernel_build_s": build_s}}))
    log("card: %s" % card_line())
    log(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": errs[k.name], "ms": times[k.name][0],
         "plain_ms": times[k.name][1]} for k in m.kernels()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
