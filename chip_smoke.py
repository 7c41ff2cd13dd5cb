#!/usr/bin/env python3
"""Smoke test of the PyTorch port (microhh_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the hand-written CUDA kernels from microhh_torch/csrc;
  3a. K5 and K6 in both forms against torch.fft.rfft2/irfft2 (float64 <=
     1e-12, float32 <= 1e-5 of the output's maximum): through the wrappers
     (the form Pres2.dft_form picks) and with every (C, F) of DFT_FORCED on
     the cluster entries and the split entries called directly, at odd,
     prime and rectangular planes, jtot not divisible by C, itot/2 not
     divisible by C*F and kt = 1; a float64 512^2 x 4 stack through the
     wrappers, which takes the split form; irfft2(rfft2(x)) against x; K6's
     input unchanged; K3 against tdma_plain (each mode held to its own
     maximum: float64 <= 1e-12, float32 <= 1e-4) in every form (check_tdma:
     the plan's and, where that is the scan form, the sweep form) on
     drycblles planes of 45^2, 17^2, 16^2 and 8^2 (partial mode tiles) at
     kmax 6, 24, 100, 130, 500 and 1000 (32 chunks in one type) and, where
     the plan takes the sweep form, 1040 and 520;
  3. each kernel against its plain-torch version on the card, in float64
     (max error <= 1e-12 of each output's maximum) and float32 (<= 1e-5,
     K11's running column sums and pow/exp/log chain included): the dry
     path's kernels at 45^2x8 (odd: the unpacked DFT path, radices 3 and 5)
     and 48^2x8 (radices 8, 2, 3), both with partial tiles, 64^2x32 and
     512^2x32, K22 among them (first x carry, the surface row given or
     not, the sponge and Coriolis folds each on and off, the evisc fold
     off, the carries random; its rhs also against K4 rhs of its own
     patched s*) and K2 with its Coriolis flag; the same on the
     sullivan2011 case and, without thermo (K1 and K7 unstratified, K2 and
     K22 with no th), on the neutral Ekman LES at 45^2x8 and 48^2x32; the
     Thomas solve's error is taken relative to each mode's
     own maximum over k (<= 1e-12 and 1e-4: its k-march accumulates), in
     every form (as in every phase that holds K3); the
     generic path's kernels (K1 and K7 on ghost-filled fields, K8/K9, K10
     with and without the carry, K11 rainy, with strong sedimentation and
     cloud-free) at 45^2x24 and 48^2x32 of the rico case with swadvec=2;
     K12 and K13 and the no-advection modes of K8/K9 and K10 on the rico
     case with each of swadvec=2i4, 2i5, 2i53, 2i62 at 45^2x24; K14, K15
     (advection on and off, carry and column fold on and off) and K7 in
     its external-N2 mode on the SBL_Smag case at 45^2x24 and 48^2x32; K16
     and K17 on random fields with random ghost levels, in the 4m scheme on
     the moser180 case at 45x40 and in the 4 scheme on the weakscaling case
     at 48x20, both on their stretched levels, at ktot 16 and 6 (the short
     column makes every ladder row a wall row); K18 (advection and the
     Coriolis fold each on and off), K19 (advection on and off, one scalar
     and every scalar in one launch) and K21 (K3's launch in place on a
     random complex spectrum, in every form of K3) on
     the jaenschwalde case at 45x40x24 and 48x16x32, K20 (sponge and
     Coriolis folds each on and off), K1 and K7 on ghost-filled dry fields
     and K21 on the sullivan2011 case at 45^2x24 and 48^2x32 and, without
     thermo, on the neutral Ekman LES at 45^2x8 and 48^2x32, the carries
     random;
  3b. K16 and K17 (schemes 4 and 4m; K17 with 1, 2, 3 and K17_MAXS + 1
     scalars, the last over two launches), K13 (2i4, 2i5, 2i53, 2i62; 1, 2
     and 4 scalars and max_scalars + 2, which the wrapper splits over two
     launches) and the scalar sweep K10/K19 (with and without the RK fold,
     advection on and off, 1, 2, 3, 4 and 6 scalars, the last over two
     launches), and K15 (the sweep at one scalar, its column fold and the
     advection each on and off) against their plain versions with the
     k-split forced to 1,
     2, 3, 4 and 5 chunks and to one level a chunk (K16 and K17 also to
     K17's plan), at ktot 16 and 6 (chunks of one to three levels that touch
     both walls), on partial tiles: K16 and K17 on
     the moser180 case at 45x40 and the weakscaling case at 48x20, K13 and
     the sweep on the rico case at 45x24 and 48x20, float64 and float32;
     K12 (2i4, 2i5, 2i53, 2i62) on the same rico grids forced to those
     counts and to its plan's, with its 16-byte copies where the grid
     allows them (48x20) and with u, v and w shifted one value past a
     16-byte boundary, their ghost levels NaN (never read); the momentum
     sweep K8/K9 and K18 on the same rico grids forced to those counts and
     to both plans' counts, aligned and shifted, with advection, the
     Coriolis term and the carry each on and off, the fields' levels outside
     ks-1..ke NaN (never read);
     and K22 in every form of phase 3 (first x carry, the surface row given
     or not, the sponge and Coriolis folds each on and off, the evisc fold
     off) with its k-split forced to 1, 2 and 3 chunks, the plan's count and
     one level a chunk, on drycblles at 512^2x32 and on the neutral Ekman
     LES at 45^2x8 (a partial tile, no th), float64 and float32; K20
     (dry_cases) forced to 1-5 chunks, its plan's count and one level a
     chunk at ktot 16 and 6 on 45^2 and 48x20 planes, aligned and shifted,
     the sponge and Coriolis term each on and off, the levels never read
     NaN, with th on sullivan2011 and without on the neutral Ekman LES, both
     on the substep without the RK fold, float64 and float32; K1 and K14
     (evisc_cases) forced to 1-5 chunks, the plan's count and one level a
     chunk, aligned and with u, v and w shifted one value past a 16-byte
     boundary, in the model's stratified mode (an unstable and a strongly
     stable N2, EVISC_REGIMES) and unstratified, the levels never read NaN
     and the output an interior view whose ghost levels stay NaN: ghost mode
     on rico at 45^2x24 and 48^2x32 (the moist N2), K14 on SBL_Smag at the
     same grids, the ghost mode of sullivan2011's substep without the RK
     fold at 45^2x24 and 48^2x32, the clamped mode on drycblles at 45^2x8
     and 64^2x32 and, without th, on the neutral Ekman LES at 45^2x8 and
     48^2x32, float64 and float32; K7 (limits_cases) on the same models in
     the same way (its plan's count), and at each count with one NaN
     planted in u that must show in its level's CFL maximum alone (both
     rates' NaN levels held to the plain version's);
  3c. K11 against its plain version at ring depths nsed 3, 4 and 8 (the
     rain states of phase 3 and heavy rain mirrored into the top levels
     with drops crossing nsed - 1.5 cells), on rico grids of 12, 32, 45 and
     70 levels (shorter than K11's 16-level window, two windows, not a
     multiple of it) with ragged i edges, float64 and float32;
  3d. K1 (clamped, th), K14 and K7 where N2/tPr is each level's mean
     strain rate squared (times 0.7 to 1.3; EVISC_CRITICAL), on drycblles
     and SBL_Smag at 48^2x16: the float32 kernel and the float32 plain
     version each against the float64 plain version on the same inputs,
     every point within CRIT_ROUNDINGS eps32 (1 + cond) of its value, cond
     its strain2 / |strain2 - N2/tPr| (check_evisc_critical);
  4. two whole RK3 steps on the card against the same two steps on the CPU
     (plain versions), <= 1e-10, float64, eleven cases: a 32^3 drycblles on
     K22 and with build_step(fold=False), a 16^2x24 rico (swadvec=2), a
     16^2x24 rico as its ini is written (swadvec=2i5), a 16^2x24 SBL_Smag, a
     16^3 moser180, a 16x8x32 weakscaling, a 32x16x24 jaenschwalde, a 32^3
     sullivan2011 on K22 and with build_step(unfolded=True), and a 48x24x24
     neutral Ekman LES;
  4b. statistics and budgets (check_stats): drycblles 32^3 as its ini is
     written (endtime cut to 900 s: four samples) and moser180 at 16^3 with
     its swbudget=4 (endtime 120 s: three samples) through run_case in
     float64 (the chunked loop: drycblles captured on the card, moser180
     eager), on the card and on the CPU: the two statistics files hold the
     same samples, variables, groups and dims and agree to 1e-10 of each
     profile's scale (stats_agree, stats_scales); the writer the machine
     has (netCDF-4 with h5py, else netCDF-3 through scipy) is printed;
  4c. the ms of one Stats.maybe_exec (CUDA events, median of 5) for
     drycblles 512^3 float32 and moser180 256x192x128 float64 with its
     budget (time_stats); the timed phases below run with output off;
  4d. the chunked loop (Model.run() without max_iters), its dry RK step
     captured as two CUDA graphs: drycblles 64^3 from one seeded state, 8
     steps of the captured chunk body against the same body run eagerly on
     the card, float32 and float64 (the same dt at every step, fields
     within 1e-5 and 1e-12 of their maxima); drycblles 32^3 float64 with
     random velocities to 25 s (at least 8 steps; a status line every 4,
     so that chunks end at both) through Model.run on
     the card (captured) and on the CPU (eager): the same status ITER and
     TIME columns, restart fields within 1e-10 of their scale; the same
     case to 300 s (at least 200 steps in chunks of 4) on the card,
     captured and with the body run eagerly: every status column but CPUDT
     the same and the restart fields bit for bit; and inside phases 5, 5b,
     19 and 21, from the restart
     of their run (drycblles from a state with random velocities, so that
     the CFL limit sets dt from the first step), drycblles 512^3 to 15 s
     (at least 24 steps; also the per-step loop, MICROHH_CHUNK=0, on the
     same build), drycblles 256^3 with build_step(fold=False) to 15 s,
     sullivan2011 512^3 to 20 s and the neutral Ekman LES to 24 s through
     Model.run(), at least 8 steps each, the replays
     under torch.cuda.set_sync_debug_mode("error"): every kernel of the
     step launched in replays, finite fields, DIV <= 1e-4; s/step of the
     loop (its capture and status lines included) and of its chunks alone,
     the warm-up, capture and instantiation seconds, the peak memory and
     the host-side idle share of the loop's steps and of the same body run
     eagerly over 4 steps (one minus a replay's span between two CUDA
     events, median of 4, over the wall a step: the span counts the gaps
     between the graph's nodes as busy; torch.profiler stays out, its
     tracing would slow every later launch, and ring_timing's chunked group
     measures the device time);
  5. the drycblles LES at 512^3 float32 through Model.run(max_iters=12), on
     the folded dry sweep K22: its kernels launched, finite fields, status
     DIV <= 1e-4; then the step time (median of 10 steps after 2 warm-up
     steps) and the peak memory;
  6. at the 512^3 float32 shapes of that run, each of its kernels against
     its plain version (the float32 tolerances of phase 3), then both timed,
     and beside K22 the three kernels it stands in for (K1, K2, K4 rhs);
  5b. and 6b. the same with build_step(fold=False) at 256^3, so that K1, K2
     and K4 rhs stay launched on a path and held; K1 also with its k-split
     forced to 1, 2, 3 chunks, its plan's count and one level a chunk,
     aligned and shifted (check_evisc_forced), as in phases 8, 12, 18 and
     20b (K14 in 12); K7 so in every run's phase (check_limits_forced: its
     own mode, and a planted NaN);
  7. the rico LES at 384^3 float32 (cases/rico/rico.ini with bench.py's
     swadvec=2 override) through Model(..., input_nc=), save_initial_state
     and Model.run(max_iters=12): its kernels launched, finite fields,
     status DIV <= 1e-4, qt, qr, nr >= 0; then the step time and the peak
     memory as in phase 5;
  8. at the 384^3 float32 shapes of that run, each of its kernels against
     its plain version, then both timed; K8/K9 also with its k-split forced
     to 1, 2, 3 chunks, its plan's count and one level a chunk, aligned and
     shifted (check_uvw_forced), as in phases 10, 12 and 18 (K18 there),
     and K1 so (check_evisc_forced);
  9. and 10. the same two phases for rico as its ini is written
     (swadvec=2i5) at 384^3 float32: K12, K13 and K8-K10 without advection;
     K12 also with its k-split forced to 1, 2, 3 chunks, its plan's count
     and one level a chunk, aligned and shifted (check_mom_forced), as in
     phase 18;
 11. and 12. the same for SBL_Smag (cases/SBL_Smag/SBL.ini, thermo buoy) at
     256^3 float32 with dt scaled with the grid: K14 (also forced as in
     phase 6b), K15 (also forced to 1, 2, 3 chunks, its plan's count and
     one level a chunk, the column fold on and off: check_scalar_rk_forced)
     and K8/K9 with the Coriolis term;
 13. and 14. the same for the weak-scaling unit (cases/weakscaling/
     weakscaling.ini, advec 4, thermo buoy) assembled for npx = npy = 8 as
     python/scaling.py does, 512x256x1024 float32: K16 and K17; its DIV is
     held to 16 times the floor that one rounding of the hydrostatic
     pressure to float32 leaves on this grid (eps |p| dzhi4 dzi4 dt, about
     3e-3: the 1024 stretched levels reach dz = 5e-4) instead of to 1e-4;
     and the
     pres_4 solve timed by its parts (rfft2, the two k-axis matrix products,
     irfft2: library calls, as in the JAX package);
 15. and 16. the same for moser180 as its ini is written (advec 4m, uflux,
     the scalar s) with stats and budget off, 256x192x128 float64, DIV <=
     1e-10: K16 and K17 in their 4m scheme and float64 build;
 17. and 18. the same for jaenschwalde as its ini is written (thermo moist,
     swadvec=2i5 with the flux limiter on co2, nine sources, open edges)
     at 1024x256x256 float32, on the substep without the RK fold: K18, K19
     and K21 (and K12 and K18 forced as in phase 10, K1 as in 6b); also
     qt >= 0, co2 >= -1e-6 of its maximum, and the co2 inventory grown at
     the nine sources' rate;
 19. and 20. the same for sullivan2011 as its ini is written (thermo dry,
     geostrophic forcing) with stats off at 512^3 float32, on the RK path:
     K22 with the sponge and Coriolis folds;
 19b. and 20b. the same with build_step(unfolded=True) at 512^2x64: K20
     (also forced to 1, 2, 3 chunks, its plan's count and one level a chunk
     in the path's form, aligned and shifted: check_dry_forced), K21 and
     K1 (also forced as in phase 6b), K7 in their ghost mode; then two
     steps of both forms from one state, every field within 1e-3 of its
     maximum (float32 roundoff);
 21. and 22. the same for the neutral Ekman LES (cases/andren1994/
     andren1994.ini less its passive scalar: thermo 0, no scalar) at
     768x384x288 float32 on the ini's domain, 5.2 m isotropic: K22, K7 and
     the projection without th.
Beside each kernel's time stands its bound: the bytes its inputs and outputs
hold, each once, over 3.35 TB/s, or its operations over 67 TFLOP/s (float32
outside the tensor cores; half that for float64) where that is larger; and, where one PyTorch call
computes the same function (the two DFTs), that call's time; beside K5
and K6 also their form, C, F, shared memory and registers per CTA, GB/s
and share of the bound; beside K1/K14, K7, K8/K9, K12, K13, K16, K17 and
K18 their registers, local bytes a thread (spills and stack), shared
memory a block, resident blocks an SM (as the card reports them), chunk
count, blocks and waves at the path's shape, and the same beside the
scalar sweep K10/K19, K20 and K22; beside K3 and K21 their form.
With --profile FILE, a last phase traces two steps of each LES with
torch.profiler and prints the device time per kernel, the step's device
idle share (one minus the device time over the wall time of the same
profiled steps, with the unprofiled wall time beside it) and the limits and
status-line times, and writes them with the profiler's tables to FILE.
With --drift FILE it builds the kernels and runs only chunked_drift:
drycblles 32^3 float64 to 900 s through Model.run with a restart every 60 s,
on the card captured, on the card with the body run eagerly and on the
CPU, and writes the error of each against the others at every restart to
FILE.
The last line is {"ok": true, "device": {...}}; the line before it holds the
per-kernel results.  Without a CUDA device, or without the microhh_torch
package beside this file, it exits non-zero.
"""

import gc
import json
import os
import re
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


_T0 = time.perf_counter()


def log(*a):
    """Print a line; a phase's header ("[n] ...") with the seconds since
    the script began."""
    if a and str(a[0]).startswith("["):
        a = a + ("(at %.0f s)" % (time.perf_counter() - _T0),)
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


RICO_ZSIZE = 4000.


def case_ini(case, name=None, **over):
    """cases/<case>/<name or case>.ini with the given options replaced."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cases",
                        case, "%s.ini" % (name or case))
    with open(path) as f:
        text = f.read()
    for key, val in over.items():
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    return text


def rico_ini(n, k, swadvec="2"):
    """cases/rico/rico.ini at n^2 x k (or n = (itot, jtot)); by default with
    swadvec 2 instead of 2i5, the override bench.py's _run_moist_size
    (bench.py:124-137) times."""
    itot, jtot = n if isinstance(n, tuple) else (n, n)
    return case_ini("rico", itot=itot, jtot=jtot, ktot=k, swadvec=swadvec)


def build_rico(torch, n, k, dtype, device, mode="run", workdir=".",
               swadvec="2"):
    """A rico Model on the profiles of cases/rico/rico_input.py, computed in
    memory (microhh_torch/cases.py)."""
    from microhh_torch.cases import rico_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    m = Model(Ini(rico_ini(n, k, swadvec)), mode, "rico", workdir=workdir,
              dtype=dtype, device=device, input_nc=rico_input(k, RICO_ZSIZE))
    m.finish_setup()
    return m


SBL_ZSIZE = 18.074844397670482


def sbl_ini(n, k):
    """cases/SBL_Smag/SBL.ini at n^2 x k with stats and dumps off and its
    fixed dt (1 s at 32 points) scaled with the horizontal grid spacing."""
    return case_ini("SBL_Smag", "SBL", itot=n, jtot=n, ktot=k, swstats=0,
                    swdump=0, dt=32. / max(n, 32))


def build_sbl(torch, n, k, dtype, device, mode="run", workdir="."):
    """An SBL_Smag Model on the profiles of cases/SBL_Smag/SBL_input.py,
    computed in memory."""
    from microhh_torch.cases import sbl_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    m = Model(Ini(sbl_ini(n, k)), mode, "SBL", workdir=workdir, dtype=dtype,
              device=device, input_nc=sbl_input(k, SBL_ZSIZE))
    m.finish_setup()
    return m


def build_moser(torch, n, k, dtype, device, mode="run", workdir="."):
    """cases/moser180/moser180.ini (advec 4m, diff 4, uflux, the scalar s,
    vortex pairs) with stats and budget off, at n = (itot, jtot) and k
    levels, on the tanh levels of moser180_input.py computed in memory."""
    from microhh_torch.cases import moser180_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    text = case_ini("moser180", itot=n[0], jtot=n[1], ktot=k, swstats=0,
                    swbudget=0)
    m = Model(Ini(text), mode, "moser180", workdir=workdir, dtype=dtype,
              device=device, input_nc=moser180_input(k, 2.))
    m.finish_setup()
    return m


def build_weakscaling(torch, n, k, dtype, device, mode="run", workdir="."):
    """cases/weakscaling/weakscaling.ini (advec 4, diff 4, thermo buoy,
    sponge) at n = (itot, jtot) with xsize and ysize kept, as
    python/scaling.py assembles the 64 x 32 unit for a process grid; the
    stretched levels of weakscaling_input.py (scaled to k levels when k is
    not its 1024) and the zsize they give."""
    from microhh_torch.cases import weakscaling_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    mem, zsize = weakscaling_input(k)
    text = case_ini("weakscaling", itot=n[0], jtot=n[1], ktot=k,
                    zsize="%.17g" % zsize)
    m = Model(Ini(text), mode, "weakscaling", workdir=workdir, dtype=dtype,
              device=device, input_nc=mem)
    m.finish_setup()
    return m


def build_jaenschwalde(torch, n, k, dtype, device, mode="run", workdir="."):
    """cases/jaenschwalde/jaenschwalde.ini (thermo moist, swadvec=2i5 with
    the flux limiter on co2, nine swvmr sources, open north, east and south
    edges and a west inflow for co2, sponge, limiter on qt) at n = (itot,
    jtot) and k levels with xsize, ysize and zsize kept, on the profiles of
    jaenschwalde_input.py computed in memory."""
    from microhh_torch.cases import jaenschwalde_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    text = case_ini("jaenschwalde", itot=n[0], jtot=n[1], ktot=k)
    m = Model(Ini(text), mode, "jaenschwalde", workdir=workdir, dtype=dtype,
              device=device, input_nc=jaenschwalde_input(k))
    m.finish_setup()
    return m


def build_sullivan(torch, n, k, dtype, device, mode="run", workdir="."):
    """cases/sullivan2011/sullivan2011.ini (thermo dry, swlspres=geo, surface
    flux 0.24, sponge) with stats off, at n = (itot, jtot) and k levels, on
    the profiles of sullivan2011_input.py computed in memory."""
    from microhh_torch.cases import sullivan2011_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    text = case_ini("sullivan2011", itot=n[0], jtot=n[1], ktot=k, swstats=0)
    m = Model(Ini(text), mode, "sullivan2011", workdir=workdir, dtype=dtype,
              device=device, input_nc=sullivan2011_input(k))
    m.finish_setup()
    return m


def andren_ini(n, k):
    """cases/andren1994/andren1994.ini without its passive scalar (the
    slist line and s's boundary values): the neutral Ekman LES, thermo 0,
    on which the dry kernels run their has_thermo=False form."""
    text = case_ini("andren1994", itot=n[0], jtot=n[1], ktot=k)
    return re.sub(r"(?m)^(slist=s|sbot\[s\]=.*|stop\[s\]=.*)\n", "", text)


def build_andren(torch, n, k, dtype, device, mode="run", workdir="."):
    """The neutral Ekman LES of andren_ini at n = (itot, jtot) and k levels
    with xsize, ysize and zsize kept, on the profiles of andren1994_input.py
    computed in memory."""
    from microhh_torch.cases import andren1994_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    m = Model(Ini(andren_ini(n, k)), mode, "andren1994", workdir=workdir,
              dtype=dtype, device=device, input_nc=andren1994_input(k))
    m.finish_setup()
    return m


def unfolded_state(m, seed):
    """Fields.create's state of a jaenschwalde or sullivan2011 model with
    seeded velocities and, for the plume, a patchy co2 field and moisture
    noise that dips below zero, so that the open edges and the limiter
    act."""
    from microhh_torch.model import NP_DTYPE
    st = m.fields.create(m.input_nc, dtype=NP_DTYPE[m.dtype])
    g = m.grid
    ks, ke = g.kstart, g.kend
    rng = np.random.RandomState(seed)
    sh = (g.ktot, g.jtot, g.itot)
    for n in ("u", "v"):
        st[n][ks:ke] += 0.5 * rng.randn(*sh)
    st["w"][ks + 1:ke] += 0.2 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    if "co2" in st:
        st["co2"][ks:ke] += rng.rand(*sh)
        st["qt"][ks:ke] *= np.clip(1. + 0.5 * rng.randn(*sh), -0.2, None)
    return st


def o4_state(m, seed):
    """Fields.create's state of a 4th-order case with seeded velocity
    noise."""
    from microhh_torch.model import NP_DTYPE
    st = m.fields.create(m.input_nc, dtype=NP_DTYPE[m.dtype])
    g = m.grid
    ks, ke = g.kstart, g.kend
    rng = np.random.RandomState(seed)
    for n in ("u", "v"):
        st[n][ks:ke] += 0.01 * rng.randn(g.ktot, g.jtot, g.itot)
    st["w"][ks + 1:ke] += 0.003 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    return st


def shape_str(m):
    c = m.ctx
    if c.itot == c.jtot == c.ktot:
        return "%d^3" % c.itot
    return "%dx%dx%d" % (c.itot, c.jtot, c.ktot)


def sbl_state(m, seed):
    """Fields.create's SBL state with seeded velocity and buoyancy noise."""
    from microhh_torch.model import NP_DTYPE
    st = m.fields.create(m.input_nc, dtype=NP_DTYPE[m.dtype])
    g = m.grid
    ks, ke = g.kstart, g.kend
    rng = np.random.RandomState(seed)
    sh = (g.ktot, g.jtot, g.itot)
    for n in ("u", "v"):
        st[n][ks:ke] += 0.01 * rng.randn(*sh)
    st["w"][ks + 1:ke] += 0.003 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    st["b"][ks:ke] += 2e-4 * rng.randn(*sh)
    return st


def rico_state(m, seed):
    """Fields.create's rico state with seeded velocities, thl noise, a moist
    layer that saturates and rain shafts below it, so that every term of
    the generic step, the microphysics included, is active."""
    from microhh_torch.model import NP_DTYPE
    st = m.fields.create(m.input_nc, dtype=NP_DTYPE[m.dtype])
    g = m.grid
    ks, ke = g.kstart, g.kend
    rng = np.random.RandomState(seed)
    sh = (g.ktot, g.jtot, g.itot)
    zc = g.z[ks:ke][:, None, None]
    for n in ("u", "v"):
        st[n][ks:ke] += 0.5 * rng.randn(*sh)
    st["w"][ks + 1:ke] += 0.2 * rng.randn(g.ktot - 1, g.jtot, g.itot)
    st["thl"][ks:ke] += 0.2 * rng.randn(*sh)
    st["qt"][ks:ke] += np.where((zc > 500.) & (zc < 1300.), 0.004, 0.) * rng.rand(*sh)
    rain = (rng.rand(*sh) > 0.4) & (zc < 1500.)
    st["qr"][ks:ke] = np.where(rain, 10. ** rng.uniform(-6, -3, sh), 0.)
    st["nr"][ks:ke] = np.where(rain, st["qr"][ks:ke] * 10. ** rng.uniform(6.5, 7.5, sh), 0.)
    return st


def rel_err(a, b):
    """max |a - b| over the maximum of |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def read_stats(path):
    """A statistics file as {"time", "iter", (group, name): array}, in
    either of the port's formats (``microhh_torch.stats.open_stats``)."""
    from microhh_torch.stats import open_stats
    f = open_stats(path)
    out = {"time": np.asarray(f.variables["time"][:]),
           "iter": np.asarray(f.variables["iter"][:]),
           "z": np.asarray(f.variables["z"][:])}
    for gname, g in f.groups.items():
        for name, v in g.variables.items():
            out[gname, name] = (tuple(v.dimensions),
                                np.asarray(v[:], dtype=np.float64))
    f.close()
    return out


FILL = 9.969209968386869e+36


def stats_scales(ref):
    """Each profile's scale: the magnitude of the values its horizontal
    mean sums, from the reference file itself.  A field f's scale F is
    max(|<f>| + sqrt(<f'2>)) over levels and samples, its fluctuation's G =
    max sqrt(<f'2>), at least 1e-5 F; a moment n scales as G^n, a resolved flux f_w as F_f
    F_w, a gradient as F_f / min dz, a diffusive flux as that times the
    largest eddy viscosity (or its own maximum), a total flux as the larger
    of its two parts.  Anything else (budget terms by their group's largest
    term, surface series, cloud diagnostics) by its own maximum.  Means of
    raw fields (th ~ 300 K) and odd moments cancel in the sum, so the
    scale of their summands, not of the result, measures rounding."""
    items = {k: v[1] for k, v in ref.items() if isinstance(k, tuple)}
    vals = {name: a for (_, name), a in items.items()}

    def amax(a):
        a = a[np.abs(a) < 1e30]
        return float(np.abs(a).max()) if a.size else 0.

    F, G = {}, {}
    for name, a in vals.items():
        if name + "_2" in vals:
            var = np.clip(vals[name + "_2"], 0., None)
            var = np.where(np.abs(var) < 1e30, var, 0.)
            F[name] = amax(np.abs(a) + np.sqrt(var))
            # a fluctuation under 1e-5 of its field is the field's rounding
            G[name] = max(float(np.sqrt(var).max()), 1e-5 * F[name])
    dzi = 1. / np.diff(ref["z"]).min() if len(ref["z"]) > 1 else 1.
    evisc = amax(vals["evisc"]) if "evisc" in vals else None
    budget = max([amax(a) for (g, n), a in items.items()
                  if g == "budget" and n not in ("ke", "tke", "b_sort")]
                 or [0.])
    scales = {}
    for key in items:
        g, name = key
        base, _, sfx = name.rpartition("_")
        own = amax(vals[name])
        if name in F:
            sc = F[name]
        elif base in G and sfx in ("2", "3", "4"):
            sc = G[base] ** int(sfx)
        elif base in F and sfx == "w":
            sc = F[base] * F.get("w", 0.)
        elif base in F and sfx == "grad":
            sc = F[base] * dzi
        elif base in F and sfx == "diff":
            sc = F[base] * dzi * evisc if evisc else own
        elif base in F and sfx == "flux":
            sc = max(F[base] * F.get("w", 0.),
                     F[base] * dzi * evisc if evisc else amax(vals[base + "_diff"]))
        elif g == "budget" and name not in ("ke", "tke", "b_sort"):
            sc = budget
        else:
            sc = own
        scales[key] = max(sc, own, 1e-300)
    return scales


def stats_agree(a, b, what):
    """Two statistics files (read_stats) of one run: the same iterations
    and sample times (the time a sum of float dt, so to 1e-12 of the last),
    the same variables, groups, dims and shapes, the same fill where
    nothing was written, and each variable's largest difference over its
    scale (stats_scales of b).  Returns {name: error}."""
    ta, tb = a["time"], b["time"]
    if not (np.array_equal(a["iter"], b["iter"]) and ta.shape == tb.shape
            and np.abs(ta - tb).max() <= 1e-12 * max(np.abs(tb).max(), 1.)):
        raise AssertionError("%s: sample times %r / %r, iterations %s / %s"
                             % (what, list(ta), list(tb), a["iter"],
                                b["iter"]))
    keys_a = {k for k in a if isinstance(k, tuple)}
    keys_b = {k for k in b if isinstance(k, tuple)}
    if keys_a != keys_b:
        raise AssertionError("%s: variables differ: %s" % (
            what, sorted(keys_a ^ keys_b)))
    scales = stats_scales(b)
    errs = {}
    for key in sorted(keys_b):
        (da, x), (db, y) = a[key], b[key]
        if da != db or x.shape != y.shape:
            raise AssertionError("%s: %s has dims %s %s and %s %s"
                                 % (what, key, da, x.shape, db, y.shape))
        fx, fy = x == FILL, y == FILL
        if not np.array_equal(fx, fy):
            raise AssertionError("%s: %s filled in one file only"
                                 % (what, key))
        d = np.abs(np.where(fy, 0., x - y))
        errs["%s/%s" % key] = float(d.max() / scales[key]) if d.size else 0.
    return errs


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

def dry_state(m, seed):
    """The seeded test state of a dry-path model's case."""
    if m.casename == "drycblles":
        return initial_state(m, seed)
    return unfolded_state(m, seed)


def kernel_cases(torch, m, seed, chunks=None, fold_only=False):
    """(name, kernel call, plain call, error kind) for every kernel on a dry
    RK-folded model's wrappers (drycblles, sullivan2011, the neutral Ekman
    LES) with seeded random inputs; each call returns a list of tensors to
    compare.  K1, K7, K2 (with and without the Coriolis term) and K22 run
    in the model's own thermo mode.  chunks: K22's k-split forced;
    fold_only: K22's cases alone."""
    from microhh_torch.ops import fused as F
    ctx = m.ctx
    s, sfc = m.as_device_state(dry_state(m, seed))
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, scale=1.):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    interior = (ctx.ktot, ctx.jtot, ctx.itot)
    fz = m.fused
    names = fz.prognostic
    e = rnd(*interior).abs() * 10.
    t0 = {n: rnd(*shape, scale=0.1) for n in F.PROGNOSTIC}
    uvwa = [s["u"], s["v"], s["w"], s["th"] if fz.has_thermo else s["u"]]
    grid_args = (ctx.ks, ctx.dxi, ctx.dyi)
    cases = []

    if not fold_only:
        cases.append(("evisc",
                      lambda: [fz.evisc(*uvwa)],
                      lambda: [F.evisc_plain(*uvwa, fz.ce, *grid_args,
                                             fz.tPr, fz.has_thermo)],
                      "field"))
        cases.append(("limits",
                      lambda: list(fz.limits(*uvwa)),
                      lambda: list(F.limits_plain(*uvwa, fz.ce, *grid_args,
                                                  fz.tPr, fz.has_thermo)),
                      "field"))
    # a table with noise on ug, vg for the Coriolis term, and one without
    # the sponge's columns
    noisy = fz.ct.clone()
    noisy[:, F.T_UG] += rnd(ctx.ktot)
    noisy[:, F.T_VG] += rnd(ctx.ktot)
    bare = noisy.clone()
    for col in (F.T_FACZ, F.T_FACZH):
        bare[:, col] = 0.
    steps = ((True, -5. / 9.), (False, -153. / 128.), (False, 0.))
    for first, can, table, coriolis in (
            [] if fold_only else
            [(f, c, fz.ct, fz.coriolis) for f, c in steps]
            + [(False, -153. / 128., noisy, not fz.coriolis)]):
        carry = can != 0.

        def run(kernel, first=first, can=can, carry=carry, table=table,
                coriolis=coriolis):
            t = {n: t0[n].clone() for n in names}
            with attrs(fz, ct=table, coriolis=coriolis, fc=1e-2):
                if kernel:
                    out = fz.tend_rk(s, t, e, 0.7, can, first, carry)
                else:
                    out = F.tend_rk_plain(s, e, t, table, *grid_args, fz.visc,
                                          fz.svisc, fz.tPr, 0.7, can, first,
                                          carry, *fz._sweep_args())
            return ([out[n][ctx.ks:ctx.ke] for n in names]
                    + [t[n][ctx.ks:ctx.ke] for n in names])
        cases.append(("tend_rk", lambda run=run: run(True),
                      lambda run=run: run(False), "field"))

    # K22: first x carry, the surface row given or not, the sponge and
    # Coriolis folds each on and off, the evisc fold off; the carries random
    se_row = F.surface_evisc_row(fz.smag, ctx, s, sfc, fz.has_thermo)
    se_row = se_row * (1. + 0.1 * rnd(ctx.jtot, ctx.itot)).abs()
    mid = (False, -153. / 128.)
    for first, can, table, coriolis, row, e_in in (
            [(f, c, fz.ct, fz.coriolis, se_row, None) for f, c in steps]
            + [mid + (fz.ct, fz.coriolis, None, None),
               mid + (noisy, True, se_row, None),
               mid + (noisy, False, se_row, None),
               mid + (bare, True, se_row, None),
               mid + (bare, False, None, None),
               mid + (fz.ct, fz.coriolis, None, e)]):
        carry = can != 0.

        def fold(kernel, first=first, can=can, carry=carry, table=table,
                 coriolis=coriolis, row=row, e_in=e_in):
            t = {n: t0[n].clone() for n in names}
            with attrs(fz, ct=table, coriolis=coriolis, fc=1e-2):
                if kernel:
                    out, ev, rhs = fz.tend_rk_fold(s, t, row, 0.7, can, 1.3,
                                                   first, carry, e=e_in,
                                                   chunks=chunks)
                else:
                    out, ev, rhs = F.tend_rk_fold_plain(
                        s, t, table, fz.ce, *grid_args, fz.visc, fz.svisc,
                        fz.tPr, 0.7, can, 1.3, first, carry, row, e_in,
                        *fz._sweep_args())
            return ([out[n][ctx.ks:ctx.ke] for n in names]
                    + [t[n][ctx.ks:ctx.ke] for n in names] + [ev, rhs])
        cases.append(("tend_rk_fold", lambda f=fold: f(True),
                      lambda f=fold: f(False), "field"))
    if fold_only:
        return cases

    def rhs_of_patched(kernel):
        """K22's rhs with the wall rows' correction against K4 rhs of the
        patched s* that the same call returned."""
        t = {n: t0[n].clone() for n in names}
        s_star, _, rhs = F.tendencies_rk_fold(fz, ctx, s, t, {}, sfc, 0.7,
                                              -5. / 9., False)
        if kernel:
            return [rhs]
        return [m.glue.rhs(s_star["u"], s_star["v"], s_star["w"], 1. / 0.7)]
    cases.append(("tend_rk_fold", lambda: rhs_of_patched(True),
                  lambda: rhs_of_patched(False), "field"))
    return cases + pres_cases(torch, m, s, t0, rnd)


def pres_cases(torch, m, s, t0, rnd):
    """The projection's kernels (K3-K6) on a model's wrappers, K3 in every
    form."""
    from microhh_torch.ops import fused as F
    ctx, gl, pr = m.ctx, m.glue, m.pres
    interior = (ctx.ktot, ctx.jtot, ctx.itot)
    cases = []
    if m.unfolded:
        return dft_cases(torch, m, rnd) + tdma_ri_cases(torch, m, rnd)
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
    spec = torch.fft.rfft2(rnd(*interior), dim=(-2, -1))
    return cases + tdma_cases(torch, pr, spec) + dft_cases(torch, m, rnd)


def tdma_forms(kmax, dtype):
    """The sweep flags check_tdma and pres_cases give K3 at kmax levels:
    False (the plan's form) and, where the plan takes the scan form, True
    (the sweep form)."""
    from microhh_torch.ops.pres_2 import tdma_form
    return [False] + ([True] if tdma_form(kmax, dtype).form == "scan"
                      else [])


def tdma_cases(torch, pr, spec):
    """K3 on a Pres2's pivots in every form (tdma_forms) against
    tdma_plain, each mode held to its own maximum."""
    from microhh_torch.ops.pres_2 import tdma_plain
    real = pr.winv.dtype
    return [("tdma",
             lambda sw=sw: [torch.view_as_real(pr.tdma(spec.clone(), sw))],
             lambda: [torch.view_as_real(tdma_plain(spec.clone(), pr.winv,
                                                    pr.tab))],
             "mode") for sw in tdma_forms(spec.shape[0], real)]


def dft_cases(torch, m, rnd):
    """K5 and K6 against torch.fft on a model's wrappers; K6's input is
    compared with a copy taken before the call (it must not be written)."""
    ctx, pr = m.ctx, m.pres
    fwd, inv = pr.dft_kernels(m.dtype)
    x = rnd(ctx.ktot, ctx.jtot, ctx.itot)
    spec = torch.fft.rfft2(x, dim=(-2, -1))
    spec0 = spec.clone()

    def inv_pair(kernel):
        out = (pr.irfft2(spec, ctx.itot) if kernel else
               torch.fft.irfft2(spec0, s=x.shape[-2:], dim=(-2, -1)))
        return [out, torch.view_as_real(spec)]
    return [(fwd.name,
             lambda: [torch.view_as_real(pr.rfft2(x))],
             lambda: [torch.view_as_real(torch.fft.rfft2(x, dim=(-2, -1)))],
             "field"),
            (inv.name, lambda: inv_pair(True), lambda: inv_pair(False),
             "field")]


# (n, kmax) of the K3 checks beyond the models' own shapes (drycblles on
# n^2 planes): partial mode tiles (45^2 and 17^2 make 1035 and 153 modes),
# kmax under one chunk, not a multiple of the chunk length, and, at 8^2,
# TD_NCMAX chunks with the last one partial (1000 in float32, 500 in
# float64) and the sweep form the plan takes where no TD_NCMAX chunks hold
# the column (1040, and 520 in float64)
TDMA_SHAPES = ((45, 6), (45, 24), (17, 100), (16, 130), (8, 1040),
               (8, 1000), (8, 520), (8, 500))


def check_tdma(torch):
    """K3 in every form (tdma_forms) against tdma_plain at TDMA_SHAPES,
    float64 (per mode <= 1e-12) and float32 (<= 1e-4), on the pivots of a
    drycblles grid and the spectrum of a seeded random field."""
    from microhh_torch.ops.pres_2 import tdma_form
    for n, k in TDMA_SHAPES:
        for dtype in (torch.float64, torch.float32):
            m = build_model(torch, n, k, dtype, "cuda")
            m.build_step()
            gen = torch.Generator(device="cpu").manual_seed(n + k)
            x = torch.randn(k, n, n, generator=gen, dtype=torch.float64)
            spec = torch.fft.rfft2(x.to(dtype).cuda(), dim=(-2, -1))
            for (name, kern, plain, kind), sw in zip(
                    tdma_cases(torch, m.pres, spec), tdma_forms(k, dtype)):
                form = tdma_form(k, dtype, sw)
                compare(torch, name, kern, plain, kind, dtype,
                        "%d^2x%d %s L=%d" % (n, k, form.form, form.L))
            del m
            torch.cuda.empty_cache()


# (itot, jtot, kt) of the DFT checks beyond the models' own shapes: jtot not
# divisible by C, odd and prime sides, itot/2 not divisible by C*F, kt = 1
DFT_SHAPES = ((48, 45, 3), (45, 48, 3), (30, 18, 2), (17, 13, 2), (13, 17, 1),
              (100, 36, 1), (64, 7, 2), (14, 21, 2), (2, 9, 2), (96, 50, 5))
# (C, F) forced on the cluster entries at those shapes
DFT_FORCED = ((2, 1), (2, 16), (4, 3), (8, 4), (8, 16))


def check_dft(torch):
    """K5 and K6 in both forms against torch.fft.rfft2/irfft2 (float32 <=
    1e-5, float64 <= 1e-12 of the output's maximum): through the wrappers
    (the form dft_form picks) and with every (C, F) of DFT_FORCED on the
    cluster entries and the split entries called directly, at DFT_SHAPES;
    and through the wrappers on a float64 512^2 x 4 stack, which takes the
    split form.  Also irfft2(rfft2(x)) against x, and K6's input unchanged."""
    from microhh_torch.dft_timing import make_pres
    from microhh_torch.ops.pres_2 import COMPLEX, dft_form
    gen = np.random.RandomState(11)
    worst = {}

    def hold(name, got, want, dtype, where):
        err = rel_err(got, want)
        tol = TOLS[str(dtype)[6:]]["field"]
        if not err <= tol:
            log("  %s %s %s: rel err %.3e (tol %.0e) FAIL"
                % (name, where, str(dtype)[6:], err, tol))
            raise AssertionError("%s disagrees with torch.fft at %s"
                                 % (name, where))
        worst[name] = max(worst.get(name, 0.), err)

    def one(itot, jtot, kt, dtype):
        pr = make_pres(itot, jtot, kt)
        x = torch.as_tensor(gen.randn(kt, jtot, itot), dtype=dtype,
                            device="cuda")
        spec = torch.as_tensor(
            gen.randn(kt, jtot, itot // 2 + 1)
            + 1j * gen.randn(kt, jtot, itot // 2 + 1),
            dtype=COMPLEX[dtype], device="cuda")
        # a Hermitian spectrum (that of a real field), as the solver gives
        spec = torch.fft.rfft2(torch.fft.irfft2(spec, s=(jtot, itot)))
        spec0 = spec.clone()
        ref_f = torch.view_as_real(torch.fft.rfft2(x))
        ref_i = torch.fft.irfft2(spec, s=(jtot, itot))
        form = dft_form(jtot, itot, dtype)
        where = "%dx%dx%d %s" % (itot, jtot, kt, form.form)
        names = ("dft_fwd", "dft_inv") if form.form == "cluster" else (
            "dft_fwd_split", "dft_inv_split")
        hold(names[0], torch.view_as_real(pr.rfft2(x)), ref_f, dtype, where)
        hold(names[1], pr.irfft2(spec, itot), ref_i, dtype, where)
        hold(names[1] + " in", torch.view_as_real(spec),
             torch.view_as_real(spec0), dtype, where)
        hold("round trip", pr.irfft2(pr.rfft2(x), itot), x, dtype, where)
        if form.form == "split":
            return form
        args = (kt, jtot, itot)
        for C, F in DFT_FORCED:
            y = torch.empty_like(spec)
            out = torch.empty_like(x)
            pr.k_dft_fwd(dtype, x, y, *args, C, F)
            pr.k_dft_inv(dtype, spec, out, *args, C, F)
            w = "%dx%dx%d C=%d F=%d" % (itot, jtot, kt, C, F)
            hold("dft_fwd", torch.view_as_real(y), ref_f, dtype, w)
            hold("dft_inv", out, ref_i, dtype, w)
        y = torch.empty_like(spec)
        out = torch.empty_like(x)
        pr.k_dft_fwd_split(dtype, x, y, *args)
        pr.k_dft_inv_split(dtype, spec, torch.empty_like(spec), out, *args)
        w = "%dx%dx%d split" % (itot, jtot, kt)
        hold("dft_fwd_split", torch.view_as_real(y), ref_f, dtype, w)
        hold("dft_inv_split", out, ref_i, dtype, w)
        hold("dft_inv_split in", torch.view_as_real(spec),
             torch.view_as_real(spec0), dtype, w)
        return form

    def run(itot, jtot, kt, dtype):
        worst.clear()
        form = one(itot, jtot, kt, dtype)
        log("  %dx%dx%d %s (%s C=%d F=%d)%s: rel err %s, tol %.0e ok"
            % (itot, jtot, kt, str(dtype)[6:], form.form, form.C, form.F,
               "" if form.form == "split" else ", forced (C, F) %s and split"
               % (DFT_FORCED,), ", ".join("%s %.1e" % kv
                                          for kv in sorted(worst.items())),
               TOLS[str(dtype)[6:]]["field"]))
        return form

    for itot, jtot, kt in DFT_SHAPES:
        for dtype in (torch.float64, torch.float32):
            run(itot, jtot, kt, dtype)
    form = run(512, 512, 4, torch.float64)
    if form.form != "split":
        raise AssertionError("a float64 512^2 plane took the %s form"
                             % form.form)


def tdma_ri_cases(torch, m, rnd):
    """K21 (K3's launch in place on K5's spectrum, counted under its own
    name) against tdma_plain on a random complex spectrum, in every form
    (tdma_forms); the error is taken per mode, as K3's."""
    from microhh_torch.ops.pres_2 import tdma_plain
    pr = m.pres
    spec = torch.complex(rnd(*pr.winv.shape), rnd(*pr.winv.shape))
    return [("tdma_ri",
             lambda sw=sw: [torch.view_as_real(pr.tdma_ri(spec.clone(), sw))],
             lambda: [torch.view_as_real(tdma_plain(spec.clone(), pr.winv,
                                                    pr.tab))], "mode")
            for sw in tdma_forms(spec.shape[0], pr.winv.dtype)]


class attrs:
    """Set attributes of an object for the length of a with block."""

    def __init__(self, obj, **values):
        self.obj, self.values = obj, values

    def __enter__(self):
        self.saved = {k: getattr(self.obj, k) for k in self.values}
        for k, v in self.values.items():
            setattr(self.obj, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.obj, k, v)


def unfolded_sweep_cases(torch, m, s, e, t0, rnd):
    """K18 and K19 (a generic model) or K20 (a dry one) against their plain
    versions: the carries random, advection and the folds each on and
    off."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    grid_args = (ctx.ks, ctx.dxi, ctx.dyi)
    cases = []
    if not m.generic:
        # K20: a table without the sponge columns, and ug, vg with noise
        ct = fz.ct.clone()
        ct[:, F.T_UG] += rnd(ctx.ktot)
        ct[:, F.T_VG] += rnd(ctx.ktot)
        bare = ct.clone()
        for col in (F.T_FACZ, F.T_FACZH):
            bare[:, col] = 0.
        for table, coriolis in ((ct, True), (ct, False), (bare, True),
                                (bare, False)):
            def dry(kernel, table=table, coriolis=coriolis):
                t = {n: t0[n].clone() for n in fz.prognostic}
                with attrs(fz, ct=table, coriolis=coriolis, fc=1e-2):
                    if kernel:
                        fz.tendencies(s, t, e)
                    else:
                        F.tendencies_plain(s, e, t, table, *grid_args,
                                           fz.visc, fz.svisc, fz.tPr, fz.fc,
                                           ctx.utrans, ctx.vtrans, coriolis,
                                           fz.has_thermo)
                return [t[n] for n in fz.prognostic]
            cases.append(("tendencies", lambda f=dry: f(True),
                          lambda f=dry: f(False), "field"))
        return cases
    ct = fz.ct_static.clone()
    ct[:, F.T_UG] += rnd(ctx.ktot)
    ct[:, F.T_VG] += rnd(ctx.ktot)
    for advec in (fz.advec, not fz.advec):
        for coriolis in (False, True):
            def uvw(kernel, advec=advec, coriolis=coriolis):
                t = {n: t0[n].clone() for n in ("u", "v", "w")}
                with attrs(fz, ct_static=ct, fold_force=coriolis, fc=1e-2,
                           advec=advec):
                    if kernel:
                        fz.tend_uvw_acc(s, t, e)
                    else:
                        F.tend_uvw_acc_plain(s, e, t, ct, *grid_args, fz.visc,
                                             fz.fc, ctx.utrans, ctx.vtrans,
                                             coriolis, advec)
                return [t[n] for n in t]
            cases.append(("tend_uvw_acc", lambda f=uvw: f(True),
                          lambda f=uvw: f(False), "field"))
        for name, svisc in list(zip(fz.names, fz.sviscs))[::2]:
            def scalar(kernel, advec=advec, name=name, svisc=svisc):
                t = {name: t0[name].clone()}
                with attrs(fz, advec=advec):
                    if kernel:
                        fz.tend_scalar_acc(s, t, e, name)
                    else:
                        F.tend_scalar_acc_plain(s, name, e, t, ct, svisc,
                                                *grid_args, fz.tPr, advec)
                return [t[name]]
            cases.append(("tend_scalar_acc", lambda f=scalar: f(True),
                          lambda f=scalar: f(False), "field"))

        def scalars(kernel, advec=advec):
            # every scalar in one launch, as generic_tendencies calls it
            t = {n: t0[n].clone() for n in fz.names}
            with attrs(fz, advec=advec):
                if kernel:
                    fz.tend_scalars_acc(s, t, e)
                else:
                    F.tend_scalars_acc_plain(s, fz.names, e, t, ct, fz.sviscs,
                                             *grid_args, fz.tPr, advec)
            return [t[n] for n in fz.names]
        cases.append(("tend_scalar_acc", lambda f=scalars: f(True),
                      lambda f=scalars: f(False), "field"))
    return cases


def generic_state(m, seed):
    """The seeded test state of a generic-path or unfolded model's case."""
    if m.unfolded:
        return dry_state(m, seed) if not m.generic else unfolded_state(m, seed)
    return (sbl_state if "b" in m.fields.sp else rico_state)(m, seed)


def generic_kernel_cases(torch, m, seed, only=None):
    """(name, kernel call, plain call, error kind) for the generic path's
    kernels on a rico or SBL model with a seeded state; the tables get
    seeded noise in every column so that each term is exercised.  Which
    kernels a model has follows its case: K1 or K14, K10 or K15, K11 with
    the warm-rain scheme, K12/K13 with an interpolated advection scheme (the
    sweeps K8-K10/K15 then run without advection).  only: a name prefix
    that restricts the cases."""
    from microhh_torch.ops import advec_interp_fused as A
    from microhh_torch.ops import fused as F
    from microhh_torch.ops.microphys import Microphys2momWarm
    ctx, fz, mic, adv = m.ctx, m.fused, m.micro, m.advec_fused
    s, sfc = m.as_device_state(generic_state(m, seed))
    s = m.boundary.set_ghost_cells(ctx, s, sfc)
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, scale=1.):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    names = ("u", "v", "w") + tuple(fz.names)
    e = F.generic_viscosity(fz, ctx, s, sfc, {})["evisc"]
    t0 = {n: rnd(*shape, scale=1e-3) for n in names}
    if not m.unfolded:
        ct, cts = F.generic_col_tables(fz, ctx, s, m.force, m.buffer)
        ct = ct + rnd(*ct.shape, scale=1e-3)
        cts = cts + rnd(*cts.shape, scale=1e-3)
    uvw = [s[n] for n in ("u", "v", "w")]
    args = (ctx.ks, ctx.dxi, ctx.dyi, fz.tPr)
    if fz.stratified == 2:
        n2 = m.thermo.get_n2(ctx, s).contiguous()
        cases = [
            ("evisc_n2", lambda: [fz.evisc_n2(*uvw, n2)],
             lambda: [F.evisc_plain(*uvw, None, fz.ce, *args, True, True, n2)],
             "field"),
            ("limits", lambda: list(fz.limits(*uvw, n2)),
             lambda: list(F.limits_plain(*uvw, None, fz.ce, *args, True, True,
                                         n2)), "field")]
    else:
        # unstratified (the neutral set), the th argument is not read
        strat = bool(fz.stratified)
        uvwa = uvw + [s[fz.n2_scalar] if strat else s["u"]]
        cases = [
            ("evisc", lambda: [fz.evisc(*uvwa)],
             lambda: [F.evisc_plain(*uvwa, fz.ce, *args, strat, True)],
             "field"),
            ("limits", lambda: list(fz.limits(*uvwa)),
             lambda: list(F.limits_plain(*uvwa, fz.ce, *args, strat, True)),
             "field")]
    if adv is not None:
        def mom(kernel):
            t = [t0[n].clone() for n in ("u", "v", "w")]
            if kernel:
                adv.momentum(*uvw, *t)
            else:
                A.momentum_plain(adv.scheme, *uvw, *t, adv.table(), ctx.ks,
                                 ctx.dxi, ctx.dyi)
            return t

        def scal(kernel):
            t = [t0[n].clone() for n in fz.names]
            a = [s[n] for n in fz.names]
            if kernel:
                adv.scalars(*uvw, a, t)
            else:
                A.scalars_plain(adv.scheme, *uvw, a, t, adv.table(), ctx.ks,
                                ctx.dxi, ctx.dyi)
            return t

        cases.append(("advec_mom", lambda: mom(True), lambda: mom(False),
                      "field"))
        cases.append(("advec_scalars", lambda: scal(True), lambda: scal(False),
                      "field"))
    if m.unfolded:
        cases += unfolded_sweep_cases(torch, m, s, e, t0, rnd)
    for can in (() if m.unfolded else (-153. / 128., 0.)):
        carry = can != 0.

        def uvw_sweep(kernel, can=can, carry=carry):
            t = {n: t0[n].clone() for n in ("u", "v", "w")}
            if kernel:
                out = fz.tend_uvw(s, t, e, ct, 0.7, can, carry)
            else:
                out = F.tend_uvw_plain(s, e, t, ct, ctx.ks, ctx.dxi, ctx.dyi,
                                       fz.visc, fz.fc, ctx.utrans, ctx.vtrans,
                                       0.7, can, fz.coriolis, carry, fz.advec)
            return [out[n] for n in out] + [t[n] for n in t]

        def scalars(kernel, can=can, carry=carry):
            t = {n: t0[n].clone() for n in fz.names}
            if kernel:
                out = fz.tend_scalars(s, t, e, cts, 0.7, can, carry)
            else:
                out = F.tend_scalars_plain(s, fz.names, e, t, cts, fz.sviscs,
                                           ctx.ks, ctx.dxi, ctx.dyi, fz.tPr,
                                           0.7, can, carry, fz.advec)
            return [out[n] for n in out] + [t[n] for n in t]

        def scalar(kernel, fold, advec, can=can, carry=carry):
            # K15 with the column fold and the advection each on or off
            t = {n: t0[n].clone() for n in fz.names}
            saved = fz.advec
            fz.advec = advec
            try:
                if kernel:
                    out = fz.tend_scalars(s, t, e, cts, 0.7, can, carry, fold)
                else:
                    out = F.tend_scalars_plain(
                        s, fz.names, e, t, cts, fz.sviscs, ctx.ks, ctx.dxi,
                        ctx.dyi, fz.tPr, 0.7, can, carry, advec, fold)
            finally:
                fz.advec = saved
            return [out[n] for n in out] + [t[n] for n in t]

        cases.append(("tend_uvw", lambda f=uvw_sweep: f(True),
                      lambda f=uvw_sweep: f(False), "field"))
        if len(fz.names) == 1:
            for fold, advec in ((True, fz.advec), (True, not fz.advec),
                                (False, fz.advec)):
                cases.append(("tend_scalar_rk",
                              lambda f=scalar, a=(fold, advec): f(True, *a),
                              lambda f=scalar, a=(fold, advec): f(False, *a),
                              "field"))
        else:
            cases.append(("tend_scalars", lambda f=scalars: f(True),
                          lambda f=scalars: f(False), "field"))
    if isinstance(mic, Microphys2momWarm) and only is None:
        cases += micro_cases(torch, m, s)
    if only is not None:
        return [c for c in cases if c[0].startswith(only)]
    return cases + pres_cases(torch, m, s, t0, rnd)


def micro_cases(torch, m, s, deep=False):
    """(name, kernel call, plain call, error kind) of K11 on a rico model's
    ghost-filled state s: rainy as it is, with heavy rain (qr x 50, dt such
    that fall speeds near W_MAX cross ~2.5 cells) and cloud-free (qt
    halved); with deep, also heavy rain mirrored into the top levels and a
    dt that takes drops across nsed - 1.5 cells, so that the gather reaches
    its last row and above the top."""
    from microhh_torch.ops.microphys import MICRO_FIELDS
    ctx, mic = m.ctx, m.micro
    pref, exnref, _, _ = m.thermo._p_profiles(ctx, {})
    dry = dict(s)
    dry["qt"] = 0.5 * s["qt"]
    heavy = dict(s)
    heavy["qr"] = 50. * s["qr"]
    dz_min = float(m.grid.dz.min())
    states = [(s, 2.), (heavy, 2.5 * dz_min / 9.65), (dry, 2.)]
    if deep:
        mirrored = dict(heavy)
        for n in ("qr", "nr"):
            mirrored[n] = heavy[n] + torch.flip(heavy[n], [0])
        states.append((mirrored, (mic.nsed - 1.5) * dz_min / 9.65))
    cases = []
    for state, dt in states:
        ql = m.thermo.get_ql(ctx, state)

        def micro(kernel, state=state, dt=dt, ql=ql):
            t = {n: torch.zeros_like(state[n]) for n in MICRO_FIELDS}
            call = mic.micro2 if kernel else mic.apply_plain
            rr = call(ctx, state, t, ql, pref, exnref, dt)
            return [t[n][ctx.ks:ctx.ke] for n in MICRO_FIELDS] + [rr]

        cases.append(("micro2", lambda f=micro: f(True),
                      lambda f=micro: f(False), "field"))
    return cases


def check_micro2(torch):
    """K11 against its plain version at ring depths nsed 3, 4 and 8 (rico's
    cflmax gives 4, NSED_MAX is 8) in the states of micro_cases (deep
    included), on rico grids whose columns are shorter than a window (12
    levels), two windows (32) and not a multiple of one (45, 70), each with
    a ragged i edge, float64 and float32."""
    for n, k in (((45, 20), 12), ((40, 24), 32), ((45, 20), 45),
                 ((40, 16), 70)):
        for dtype in (torch.float64, torch.float32):
            m = build_rico(torch, n, k, dtype, "cuda")
            m.build_step()
            s, sfc = m.as_device_state(rico_state(m, n[0] + k))
            s = m.boundary.set_ghost_cells(m.ctx, s, sfc)
            for nsed in (3, 4, 8):
                m.micro.nsed = nsed
                for name, kern, plain, kind in micro_cases(torch, m, s,
                                                           deep=True):
                    compare(torch, name, kern, plain, kind, dtype,
                            "rico %dx%dx%d nsed=%d" % (n[0], n[1], k, nsed))


def o4_kernel_cases(torch, m, seed, chunks=None, counts=None):
    """(name, kernel call, plain call, error kind) for K16 and K17 on a
    4th-order model: random fields, ghost levels included, with distinct w
    arrays under the two ghost types, and random carries; K17 with the
    model's scalars or, with counts, with each count of scalars of their
    own viscosities (more than max_scalars go over two launches); chunks:
    the k-split of both forced."""
    ctx, o4 = m.ctx, m.o4
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)

    def rnd(scale=1.):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=torch.float32)).to(ctx.dtype).to(ctx.device)

    if counts is None:
        groups = [list(ctx.scalar_names)] if ctx.scalar_names else []
    else:
        extra = ["k17_s%d" % n for n in range(max(counts))]
        o4.diff.viscs.update({nm: 1e-4 * (n + 1)
                              for n, nm in enumerate(extra)})
        groups = [extra[:S] for S in counts]
    most = max((len(g) for g in groups), default=0)
    u, v, wc, wd = rnd(), rnd(), rnd(), rnd()
    a = [rnd() for _ in range(most)]
    t0 = [rnd(0.1) for _ in range(3 + most)]

    def mom(kernel):
        t = [x.clone() for x in t0[:3]]
        if kernel:
            o4.momentum(u, v, wc, wd, *t, chunks=chunks)
        else:
            o4.momentum_plain(u, v, wc, wd, *t)
        return t

    def scal(kernel, names):
        S = len(names)
        t = [x.clone() for x in t0[3:3 + S]]
        if kernel:
            o4.scalars(u, v, wc, names, a[:S], t, chunks=chunks)
        else:
            o4.scalars_plain(u, v, wc, names, a[:S], t)
        return t

    cases = [("o4_mom", lambda: mom(True), lambda: mom(False), "field")]
    for names in groups:
        cases.append(("o4_scalars", lambda g=names: scal(True, g),
                      lambda g=names: scal(False, g), "field"))
    return cases


def advec_scalar_cases(torch, m, seed, chunks):
    """(name, kernel call, plain call, error kind) for K13 on a model with
    an interpolated scheme, its k-split forced: 1, 2 and 4 scalars and
    max_scalars + 2 (two launches), seeded fields and random carries."""
    from microhh_torch.ops import advec_interp_fused as A
    ctx, adv = m.ctx, m.advec_fused
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)

    def rnd(scale=1.):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    u, v, w = rnd(), rnd(), rnd(0.3)
    most = A.max_scalars(ctx.dtype) + 2
    a = [rnd() for _ in range(most)]
    t0 = [rnd(1e-3) for _ in range(most)]
    cases = []
    for S in (1, 2, 4, most):
        def scal(kernel, S=S):
            t = [x.clone() for x in t0[:S]]
            if kernel:
                adv.scalars(u, v, w, a[:S], t, chunks=chunks)
            else:
                A.scalars_plain(adv.scheme, u, v, w, a[:S], t, adv.table(),
                                ctx.ks, ctx.dxi, ctx.dyi)
            return t
        cases.append(("advec_scalars", lambda f=scal: f(True),
                      lambda f=scal: f(False), "field"))
    return cases


def shifted(torch, x):
    """The values of x one element past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def advec_mom_cases(torch, m, seed, chunk_counts):
    """(name, kernel call, plain call, error kind) for K12 on a model with an
    interpolated scheme at each forced chunk count (None: the plan's),
    16-byte copies where the grid allows them and with u, v and w one value
    past a 16-byte boundary (single-value copies only): seeded u, v, w
    whose ghost levels, which K12 never reads (u, v clamped to [ks, ke-1],
    w to [ks, ke]), are NaN, and random carries.  The kernel call fails on a
    non-finite output."""
    from microhh_torch.ops import advec_interp_fused as A
    ctx, adv = m.ctx, m.advec_fused
    ks, ke = ctx.ks, ctx.ke
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)

    def rnd(scale=1.):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=torch.float32)).to(ctx.dtype).to(ctx.device)

    u, v, w = rnd(), rnd(), rnd(0.3)
    for x, top in ((u, ke), (v, ke), (w, ke + 1)):
        x[:ks] = float("nan")
        x[top:] = float("nan")
    t0 = [rnd(1e-3) for _ in range(3)]
    forms = {"aligned": (u, v, w), "shifted": tuple(shifted(torch, x)
                                                    for x in (u, v, w))}
    cases = []
    for chunks in chunk_counts:
        for form, uvw in forms.items():
            def mom(kernel, uvw=uvw, chunks=chunks):
                t = [x.clone() for x in t0]
                if kernel:
                    adv.momentum(*uvw, *t, chunks=chunks)
                    if not all(bool(torch.isfinite(x).all()) for x in t):
                        raise AssertionError("K12 wrote a non-finite value")
                else:
                    A.momentum_plain(adv.scheme, *uvw, *t, adv.table(), ks,
                                     ctx.dxi, ctx.dyi)
                return t
            cases.append(("advec_mom", lambda f=mom: f(True),
                          lambda f=mom: f(False), "field"))
    return cases


def mom_chunks(m, dtype):
    """The k-splits check_kmarch and the runs' phases force on K12: 1, 2
    and 3 chunks, the plan's count and one level a chunk."""
    k = m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {m.advec_fused.mom_plan(dtype).chunks, k})


def check_mom_forced(torch, m):
    """K12 at a run's shapes with its k-split forced (mom_chunks), aligned
    and shifted by one value; returns the largest absolute difference."""
    worst = 0.
    for name, kern, plain, kind in advec_mom_cases(
            torch, m, m.ctx.itot + 1, mom_chunks(m, m.dtype)):
        worst = max(worst, compare(torch, name, kern, plain, kind, m.dtype,
                                   "%s forced" % shape_str(m)))
        torch.cuda.empty_cache()
    return worst


# the forms (advection, Coriolis term, carry written) uvw_cases takes by
# default: each flag on and off
UVW_FORMS = ((True, True, False), (False, False, True))


def uvw_cases(torch, m, seed, chunk_counts, acc=None, forms=UVW_FORMS):
    """(name, kernel call, plain call, error kind) for the momentum sweep on
    a generic model at each forced chunk count (None: the plan's): K8/K9
    (acc False or None) and K18 (acc True or None), aligned and with u, v,
    w and e one value past a 16-byte boundary (single-value copies only),
    in each of forms (advection, the Coriolis term, the carry written; K18
    reads the first two).  Seeded u, v, w, a positive eddy viscosity, random
    carries and tables with noise in every column; the fields' levels
    outside ks-1..ke, which the sweep never reads, are NaN.  The kernel
    call fails on a non-finite output."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    ks, ke = ctx.ks, ctx.ke
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)

    def rnd(*sh, scale=1.):
        return (scale * torch.randn(*(sh or shape), generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    s = {"u": rnd(), "v": rnd(), "w": rnd(scale=0.3)}
    e = rnd().abs()
    for x in list(s.values()) + [e]:
        x[:ks - 1] = float("nan")
        x[ke + 1:] = float("nan")
    t0 = {n: rnd(scale=1e-3) for n in s}
    ct = fz.base + rnd(ctx.ktot, F.NTG, scale=1e-3)
    ct_acc = fz.ct_static + rnd(ctx.ktot, F.NTG, scale=1e-3)
    layouts = {"aligned": (s, e),
               "shifted": ({n: shifted(torch, x) for n, x in s.items()},
                           shifted(torch, e))}
    grid_args = (ks, ctx.dxi, ctx.dyi)

    def finite(arrays, name):
        if not all(bool(torch.isfinite(x).all()) for x in arrays):
            raise AssertionError("%s wrote a non-finite value" % name)
        return arrays

    cases = []
    for chunks in chunk_counts:
        for sf, ef in layouts.values():
            for advec, coriolis, carry in forms:
                def rk(kernel, sf=sf, ef=ef, advec=advec, coriolis=coriolis,
                       carry=carry, chunks=chunks):
                    t = {n: t0[n].clone() for n in t0}
                    can = -153. / 128. if carry else 0.
                    with attrs(fz, advec=advec, coriolis=coriolis, fc=1e-2):
                        if kernel:
                            out = fz.tend_uvw(sf, t, ef, ct, 0.7, can, carry,
                                              chunks=chunks)
                        else:
                            out = F.tend_uvw_plain(
                                sf, ef, t, ct, *grid_args, fz.visc, fz.fc,
                                ctx.utrans, ctx.vtrans, 0.7, can, coriolis,
                                carry, advec)
                    got = [out[n] for n in out] + [t[n] for n in t]
                    return finite(got, "K8/K9") if kernel else got

                def unf(kernel, sf=sf, ef=ef, advec=advec, coriolis=coriolis,
                        chunks=chunks):
                    t = {n: t0[n].clone() for n in t0}
                    with attrs(fz, advec=advec, fold_force=coriolis, fc=1e-2,
                               ct_static=ct_acc):
                        if kernel:
                            fz.tend_uvw_acc(sf, t, ef, chunks=chunks)
                        else:
                            F.tend_uvw_acc_plain(
                                sf, ef, t, ct_acc, *grid_args, fz.visc,
                                fz.fc, ctx.utrans, ctx.vtrans, coriolis,
                                advec)
                    got = [t[n] for n in t]
                    return finite(got, "K18") if kernel else got

                if acc is not True:
                    cases.append(("tend_uvw", lambda f=rk: f(True),
                                  lambda f=rk: f(False), "field"))
                if acc is not False:
                    cases.append(("tend_uvw_acc", lambda f=unf: f(True),
                                  lambda f=unf: f(False), "field"))
    return cases


def uvw_chunks(m, dtype, acc=False):
    """The k-splits the runs' phases force on K8/K9 (K18 when acc): 1, 2
    and 3 chunks, the plan's count and one level a chunk."""
    k = m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {m.fused.uvw_plan(dtype, acc).chunks, k})


def check_uvw_forced(torch, m):
    """The momentum sweep of a run's path (K18 on the substep without the
    RK fold, else K8/K9) at the run's shapes in the path's form (its
    advection and Coriolis flags, the carry written) with its k-split
    forced (uvw_chunks), aligned and shifted by one value; returns the
    largest absolute difference."""
    fz = m.fused
    acc = bool(m.unfolded)
    form = (fz.advec, fz.fold_force if acc else fz.coriolis, True)
    worst = 0.
    for name, kern, plain, kind in uvw_cases(
            torch, m, m.ctx.itot + 2, uvw_chunks(m, m.dtype, acc), acc,
            (form,)):
        worst = max(worst, compare(torch, name, kern, plain, kind, m.dtype,
                                   "%s forced" % shape_str(m)))
        torch.cuda.empty_cache()
    return worst


# the forms (the sponge columns of the table, the Coriolis term) dry_cases
# takes by default: each on and off
DRY_FORMS = ((True, True), (False, False))


def dry_cases(torch, m, seed, chunk_counts, forms=DRY_FORMS):
    """(name, kernel call, plain call, error kind) for K20 on a dry model
    on the substep without the RK fold at each forced chunk count (None:
    the plan's), aligned and with u, v, w, th and e one value past a
    16-byte boundary (single-value copies only), in each of forms (the
    table's sponge columns, the Coriolis term).  Seeded u, v, w, th around
    300 K (the model's thermo form), a positive eddy viscosity, random
    carries, the table with noise in ug and vg; the fields' levels outside
    ks-1..ke, which K20 never reads, are NaN.  The kernel call fails on a
    non-finite output."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    ks, ke = ctx.ks, ctx.ke
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)

    def rnd(*sh, scale=1.):
        return (scale * torch.randn(*(sh or shape), generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    s = {"u": rnd(), "v": rnd(), "w": rnd(scale=0.3)}
    if fz.has_thermo:
        s["th"] = 300. + rnd()
    e = rnd().abs()
    for x in list(s.values()) + [e]:
        x[:ks - 1] = float("nan")
        x[ke + 1:] = float("nan")
    t0 = {n: rnd(scale=1e-3) for n in s}
    ct = fz.ct.clone()
    ct[:, F.T_UG] += rnd(ctx.ktot)
    ct[:, F.T_VG] += rnd(ctx.ktot)
    bare = ct.clone()
    for col in (F.T_FACZ, F.T_FACZH):
        bare[:, col] = 0.
    layouts = {"aligned": (s, e),
               "shifted": ({n: shifted(torch, x) for n, x in s.items()},
                           shifted(torch, e))}
    grid_args = (ks, ctx.dxi, ctx.dyi)
    cases = []
    for chunks in chunk_counts:
        for sf, ef in layouts.values():
            for sponge, coriolis in forms:
                def dry(kernel, sf=sf, ef=ef, table=ct if sponge else bare,
                        coriolis=coriolis, chunks=chunks):
                    t = {n: t0[n].clone() for n in t0}
                    with attrs(fz, ct=table, coriolis=coriolis, fc=1e-2):
                        if kernel:
                            fz.tendencies(sf, t, ef, chunks=chunks)
                        else:
                            F.tendencies_plain(
                                sf, ef, t, table, *grid_args, fz.visc,
                                fz.svisc, fz.tPr, fz.fc, ctx.utrans,
                                ctx.vtrans, coriolis, fz.has_thermo)
                    got = [t[n] for n in fz.prognostic]
                    if kernel and not all(bool(torch.isfinite(x).all())
                                          for x in got):
                        raise AssertionError("K20 wrote a non-finite value")
                    return got
                cases.append(("tendencies", lambda f=dry: f(True),
                              lambda f=dry: f(False), "field"))
    return cases


def dry_chunks(m, dtype):
    """The k-splits the runs' phases force on K20: 1, 2 and 3 chunks, the
    plan's count and one level a chunk."""
    k = m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {m.fused.tendencies_plan(dtype).chunks, k})


def check_dry_forced(torch, m):
    """K20 at a run's shapes in the path's form (its sponge and Coriolis
    term) with its k-split forced (dry_chunks), aligned and shifted by one
    value; returns the largest absolute difference."""
    worst = 0.
    for name, kern, plain, kind in dry_cases(
            torch, m, m.ctx.itot + 3, dry_chunks(m, m.dtype),
            ((True, m.fused.coriolis),)):
        worst = max(worst, compare(torch, name, kern, plain, kind, m.dtype,
                                   "%s forced" % shape_str(m)))
        torch.cuda.empty_cache()
    return worst


def check_dry_kmarch(torch):
    """K20 (dry_cases) against its plain version with the k-split forced
    (forced_chunks and the plan's count) at ktot 16 and 6, on partial
    tiles, aligned and shifted, the sponge and Coriolis term each on and
    off: with th on sullivan2011 and without on the neutral Ekman LES, both
    on the substep without the RK fold, float64 and float32."""
    for label, build in (("sullivan2011", build_sullivan),
                         ("andren1994", build_andren)):
        for n in ((45, 45), (48, 20)):
            for k in (16, 6):
                for dtype in (torch.float64, torch.float32):
                    m = build(torch, n, k, dtype, "cuda")
                    m.build_step(unfolded=True)
                    counts = sorted(set(forced_chunks(k))
                                    | set(dry_chunks(m, dtype)))
                    for name, kern, plain, kind in dry_cases(
                            torch, m, n[1] + k, counts):
                        compare(torch, name, kern, plain, kind, dtype,
                                "%s unfolded %s chunks %s"
                                % (label, shape_str(m), counts))
                    del m
                    torch.cuda.empty_cache()


# the forms rk_cases takes by default: (first, carry, the table's sponge
# columns, the Coriolis term)
RK_FORMS = ((True, True, True, True), (False, True, True, True),
            (False, False, False, False), (True, False, False, False))


def rk_cases(torch, m, seed, chunk_counts, forms=RK_FORMS):
    """(name, kernel call, plain call, error kind) for K2 on a dry RK-folded
    model at each forced chunk count (None: the plan's), aligned and with
    u, v, w, th and e one value past a 16-byte boundary (single-value
    copies only), in each of forms (first, carry, the table's sponge
    columns, the Coriolis term).  Seeded u, v, w, th around 300 K (the
    model's thermo form), the interior eddy viscosity, random carries, the
    table with noise in ug and vg; the planes K2 never reads are NaN: u's,
    v's and th's ghost planes (ks-1 and ke among them), w's below ks and
    past ke, and every carry on the first substep.  s* is compared whole
    (its ghost planes zero), the carries on the interior where they are
    written.  The kernel call fails on a non-finite output."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    ks, ke = ctx.ks, ctx.ke
    # drawn on the model's device: at a run's shapes on the CPU they took
    # seconds an array
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    nan = float("nan")

    def rnd(*sh, scale=1.):
        return (scale * torch.randn(*(sh or shape), generator=gen,
                                    dtype=torch.float64,
                                    device=ctx.device)).to(ctx.dtype)

    s = {"u": rnd(), "v": rnd(), "w": rnd(scale=0.3)}
    if fz.has_thermo:
        s["th"] = 300. + rnd()
    for n, x in s.items():
        x[:ks] = nan
        x[ke + (1 if n == "w" else 0):] = nan
    e = rnd(ctx.ktot, ctx.jtot, ctx.itot).abs()
    t0 = {n: rnd(scale=1e-3) for n in s}
    for x in t0.values():
        x[:ks] = nan
        x[ke:] = nan
    ct = fz.ct.clone()
    ct[:, F.T_UG] += rnd(ctx.ktot)
    ct[:, F.T_VG] += rnd(ctx.ktot)
    bare = ct.clone()
    for col in (F.T_FACZ, F.T_FACZH):
        bare[:, col] = 0.
    layouts = {"aligned": (s, e),
               "shifted": ({n: shifted(torch, x) for n, x in s.items()},
                           shifted(torch, e))}
    grid_args = (ks, ctx.dxi, ctx.dyi)
    cases = []
    for chunks in chunk_counts:
        for sf, ef in layouts.values():
            for first, carry, sponge, coriolis in forms:
                def rk(kernel, sf=sf, ef=ef, first=first, carry=carry,
                       table=ct if sponge else bare, coriolis=coriolis,
                       chunks=chunks):
                    t = {n: (torch.full_like(x, nan) if first else x.clone())
                         for n, x in t0.items()}
                    can = -153. / 128. if carry else 0.
                    with attrs(fz, ct=table, coriolis=coriolis, fc=1e-2):
                        if kernel:
                            out = fz.tend_rk(sf, t, ef, 0.7, can, first,
                                             carry, chunks=chunks)
                        else:
                            out = F.tend_rk_plain(
                                sf, ef, t, table, *grid_args, fz.visc,
                                fz.svisc, fz.tPr, 0.7, can, first, carry,
                                *fz._sweep_args())
                    got = [out[n] for n in fz.prognostic]
                    if carry:
                        got += [t[n][ks:ke] for n in fz.prognostic]
                    if kernel and not all(bool(torch.isfinite(x).all())
                                          for x in got):
                        raise AssertionError("K2 wrote a non-finite value")
                    return got
                cases.append(("tend_rk", lambda f=rk: f(True),
                              lambda f=rk: f(False), "field"))
    return cases


def rk_chunks(m, dtype):
    """The k-splits the runs' phases force on K2: 1, 2 and 3 chunks, the
    plan's count and one level a chunk."""
    k = m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {m.fused.tend_rk_plan(dtype).chunks, k})


def check_rk_forced(torch, m):
    """K2 at a run's shapes in the path's form (its sponge and Coriolis
    term), on a middle and a first substep, with its k-split forced
    (rk_chunks), aligned and shifted by one value; returns the largest
    absolute difference."""
    worst = 0.
    cor = m.fused.coriolis
    for name, kern, plain, kind in rk_cases(
            torch, m, m.ctx.itot + 4, rk_chunks(m, m.dtype),
            ((False, True, True, cor), (True, True, True, cor))):
        worst = max(worst, compare(torch, name, kern, plain, kind, m.dtype,
                                   "%s forced" % shape_str(m)))
        torch.cuda.empty_cache()
    return worst


def check_rk_kmarch(torch):
    """K2 (rk_cases) against its plain version with the k-split forced
    (forced_chunks and the plan's count) at ktot 16 and 6, on partial
    tiles, aligned and shifted, first x carry, the sponge and Coriolis term
    on and off: with th on drycblles and sullivan2011 and without on the
    neutral Ekman LES, float64 and float32."""
    for label, build in (("drycblles", build_drycblles),
                         ("sullivan2011", build_sullivan),
                         ("andren1994", build_andren)):
        for n in ((45, 45), (48, 20)):
            if label == "drycblles" and n[0] != n[1]:
                continue
            for k in (16, 6):
                for dtype in (torch.float64, torch.float32):
                    m = build(torch, n, k, dtype, "cuda")
                    m.build_step(fold=False)
                    counts = sorted(set(forced_chunks(k))
                                    | set(rk_chunks(m, dtype)))
                    for name, kern, plain, kind in rk_cases(
                            torch, m, n[1] + k, counts):
                        compare(torch, name, kern, plain, kind, dtype,
                                "%s %s chunks %s"
                                % (label, shape_str(m), counts))
                    del m
                    torch.cuda.empty_cache()


def apply_cases(torch, m, seed, chunk_counts, carries=(True, False)):
    """(name, kernel call, plain call, error kind) for K4 apply on a model
    with the projection of pres_2 at each forced chunk count (None: the
    plan's), with the carry and without, aligned and with every array one
    value past a 16-byte boundary (single values only).  Seeded p and
    arrays; the ghost planes of s* and of the carries, which K4 apply never
    reads, are NaN, and so are the carries without the carry (not read).
    s* is compared on the interior, the carries there where written.  The
    kernel call fails on a non-finite output."""
    from microhh_torch.ops import fused as F
    ctx, gl = m.ctx, m.glue
    ks, ke = ctx.ks, ctx.ke
    # drawn on the model's device: at a run's shapes on the CPU they took
    # seconds an array
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    nan = float("nan")

    def rnd(*sh, scale=1.):
        return (scale * torch.randn(*(sh or shape), generator=gen,
                                    dtype=torch.float64,
                                    device=ctx.device)).to(ctx.dtype)

    p = rnd(ctx.ktot, ctx.jtot, ctx.itot)
    s0 = {n: rnd() for n in ("u", "v", "w")}
    t0 = {n: rnd(scale=1e-3) for n in ("u", "v", "w")}
    for x in list(s0.values()) + list(t0.values()):
        x[:ks] = nan
        x[ke:] = nan
    # each layout with its copy (the arrays are updated in place)
    layouts = {"aligned": (p, lambda x: x.clone()),
               "shifted": (shifted(torch, p), lambda x: shifted(torch, x))}
    cases = []
    for chunks in chunk_counts:
        for pf, copy in layouts.values():
            for carry in carries:
                def apply(kernel, pf=pf, copy=copy, carry=carry,
                          chunks=chunks):
                    st = {n: copy(x) for n, x in s0.items()}
                    t = {n: copy(x if carry else torch.full_like(x, nan))
                         for n, x in t0.items()}
                    can = -5. / 9. if carry else 0.
                    if kernel:
                        gl.apply(pf, st, t, 0.4, can, carry, chunks=chunks)
                    else:
                        F.pres_apply_plain(pf, st, t, gl.pc, ks, ctx.dxi,
                                           ctx.dyi, 0.4, can, carry)
                    got = [st[n][ks:ke] for n in st]
                    if carry:
                        got += [t[n][ks:ke] for n in t]
                    if kernel and not all(bool(torch.isfinite(x).all())
                                          for x in got):
                        raise AssertionError("K4 apply wrote a non-finite "
                                             "value")
                    return got
                cases.append(("pres_apply", lambda f=apply: f(True),
                              lambda f=apply: f(False), "field"))
    return cases


def apply_chunks(m, dtype):
    """The k-splits the runs' phases force on K4 apply: 1, 2 and 3 chunks,
    the plans' counts (with and without the carry) and one level a
    chunk."""
    k = m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {m.glue.apply_plan(dtype, c).chunks for c in (True, False)}
                  | {k})


def check_apply_forced(torch, m):
    """K4 apply at a run's shapes with and without the carry, its k-split
    forced (apply_chunks), aligned and shifted by one value; returns the
    largest absolute difference."""
    worst = 0.
    for name, kern, plain, kind in apply_cases(
            torch, m, m.ctx.itot + 5, apply_chunks(m, m.dtype)):
        worst = max(worst, compare(torch, name, kern, plain, kind, m.dtype,
                                   "%s forced" % shape_str(m)))
        torch.cuda.empty_cache()
    return worst


def check_apply_kmarch(torch):
    """K4 apply (apply_cases) against its plain version with the k-split
    forced (forced_chunks and the plans' counts) at ktot 16 and 6 on 45^2
    and 48x20 planes (partial tiles), aligned and shifted, with the carry
    and without, float64 and float32."""
    for n in ((45, 45), (48, 20)):
        for k in (16, 6):
            for dtype in (torch.float64, torch.float32):
                m = build_sullivan(torch, n, k, dtype, "cuda")
                m.build_step()
                counts = sorted(set(forced_chunks(k))
                                | set(apply_chunks(m, dtype)))
                for name, kern, plain, kind in apply_cases(
                        torch, m, n[0] + k, counts):
                    compare(torch, name, kern, plain, kind, dtype,
                            "%s chunks %s" % (shape_str(m), counts))
                del m
                torch.cuda.empty_cache()


# the stability regimes evisc_cases takes: N2 / tPr against each level's
# mean strain rate squared, times 0.7 to 1.3 (a column's factor, or a
# point's for an N2 field): unstable (-1, the N2 term a third to a half of
# the viscosity's radicand) and strongly stable (+30, far past every
# point's strain rate, so that the floor strain2 * dsmall is taken).  A
# radicand near zero, where the two branches meet, would amplify the
# rounding of the strain rate without bound in either version.
EVISC_REGIMES = {"unstable": -1., "stable": 30.}


def evisc_inputs(torch, m, seed, regimes=None):
    """The seeded inputs of the eddy-viscosity cases (K1/K14 and K7) on a
    model's grid: u, v, w; th around 300 K whose vertical steps give each of
    ``regimes`` (EVISC_REGIMES) its N2 (``ths``), and the N2 field itself
    (``n2s``); the
    fields' levels that the kernels never read (u, v and th outside [lo,
    hic], w outside [ks, ke]) are NaN; ``layouts``: u, v and w as they are
    and one value past a 16-byte boundary (single-value copies only)."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    ks, ke = ctx.ks, ctx.ke
    ghosts = bool(fz.ghosts)
    lo, hic = (ks - 1, ke) if ghosts else (ks, ke - 1)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    interior = (ctx.ktot, ctx.jtot, ctx.itot)
    nan = float("nan")

    def rnd(*sh, scale=1.):
        return (scale * torch.randn(*(sh or shape), generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    def factor(*sh):
        return 1. + 0.3 * (2. * torch.rand(*sh, generator=gen,
                                           dtype=torch.float64) - 1.)

    u, v, w = rnd(), rnd(), rnd(scale=0.3)
    grid_args = (ks, ctx.dxi, ctx.dyi, fz.tPr)
    # each level's mean strain rate squared, and the step of th a level
    # that gives N2 / tPr as large (held for the ghost levels)
    e0 = F.evisc_plain(u, v, w, None, fz.ce, *grid_args, False, ghosts)
    ce = fz.ce.double().cpu()
    s2 = ((e0.double().cpu() / ce[:, F.E_MLEN2][:, None, None]) ** 2).mean(
        dim=(1, 2))
    del e0
    step = s2 * fz.tPr * ce[:, F.E_THREF].abs() / (9.81 * ce[:, F.E_DZI])
    levels = (torch.arange(ctx.kcells) - ks).clamp(0, ctx.ktot - 1)
    rise = torch.cumsum(step[levels], 0)[:, None, None] * factor(
        1, ctx.jtot, ctx.itot)
    col = factor(*interior) * (s2 * fz.tPr)[:, None, None]

    def dev(x):
        return x.to(ctx.dtype).to(ctx.device)

    regimes = regimes or EVISC_REGIMES
    ths = {r: dev(300. + c * rise) for r, c in regimes.items()}
    n2s = {r: dev(c * col) for r, c in regimes.items()}
    for x, a, b in [(u, lo, hic), (v, lo, hic), (w, ks, ke)] + [
            (th, lo, hic) for th in ths.values()]:
        x[:a] = nan
        x[b + 1:] = nan
    layouts = {"aligned": (u, v, w),
               "shifted": tuple(shifted(torch, x) for x in (u, v, w))}
    return {"u": u, "ths": ths, "n2s": n2s, "layouts": layouts,
            "grid_args": grid_args, "ghosts": ghosts}


# the near-critical regime: N2 / tPr equal to each level's mean strain
# rate squared, times 0.7 to 1.3, so that the radicand strain2 - N2 / tPr
# of many points is a small difference of two large numbers
EVISC_CRITICAL = {"critical": 1.}
# the roundings a point's radicand may collect, each up to eps: strain2 sums
# some twenty rounded squares and differences, N2 three, their difference one
CRIT_ROUNDINGS = 32.


def check_evisc_critical(torch, seed=41, device="cuda"):
    """K1 (clamped mode, th), K14 (the N2 field) and K7 in EVISC_CRITICAL
    on drycblles and SBL_Smag at 48^2 x 16: the float32 kernel and the
    float32 plain version each against the float64 plain version on the
    same (float32-rounded) inputs.  Near strain2 = N2/tPr the square root
    amplifies the rounding of its radicand, so each point is held to
    CRIT_ROUNDINGS eps32 (1 + cond) |evisc|, cond = strain2 /
    |strain2 - N2/tPr| the point's condition number;
    K7's level maxima of the eddy viscosity to their level's largest point
    bound, its CFL maxima to CRIT_ROUNDINGS eps32 of their value.  Returns
    {case: (largest cond, largest error over its bound)}."""
    from microhh_torch.ops import fused as F
    eps = float(torch.finfo(torch.float32).eps)
    out = {}
    for label, build, n, st in (("drycblles", build_drycblles, (48, 48), 1),
                                ("SBL_Smag", build_sbl, 48, 2)):
        models = {}
        for dt in (torch.float64, torch.float32):
            models[dt] = build(torch, n, 16, dt, device)
            models[dt].build_step()
        m64, m32 = models[torch.float64], models[torch.float32]
        x = evisc_inputs(torch, m64, seed, EVISC_CRITICAL)
        u, v, w = x["layouts"]["aligned"]
        th = x["ths"]["critical"] if st == 1 else None
        n2 = x["n2s"]["critical"] if st == 2 else None
        f32 = [None if a is None else a.float() for a in (u, v, w, th, n2)]
        r64 = [None if a is None else a.double() for a in f32]
        ks, ke = m64.ctx.ks, m64.ctx.ke
        fz64, fz32 = m64.fused, m32.fused

        def plain(fz, a, stratified, limits=False, sign=1.):
            fn = F.limits_plain if limits else F.evisc_plain
            ks_, dxi, dyi, tpr = x["grid_args"]
            return fn(*a[:3], a[3] if a[3] is not None else a[0], fz.ce,
                      ks_, dxi, dyi, sign * tpr, stratified, x["ghosts"],
                      a[4] if stratified else None)

        e64 = plain(fz64, r64, True)
        mlen = fz64.ce[:, F.E_MLEN2][:, None, None]
        s2 = (plain(fz64, r64, False) / mlen) ** 2
        # the signed radicand strain2 - N2/tPr: with -tPr the plain version
        # gives strain2 + N2/tPr (N2 > 0 here), never floored
        rad = 2. * s2 - (plain(fz64, r64, True, sign=-1.) / mlen) ** 2
        cond = s2 / rad.abs().clamp_min(1e-15 * float(s2.max()))
        bound = CRIT_ROUNDINGS * eps * (1. + cond) * e64.abs()
        buf = torch.full((m32.ctx.kcells, m32.ctx.jtot, m32.ctx.itot),
                         float("nan"), dtype=torch.float32, device=device)
        with attrs(fz32, stratified=st):
            if st == 2:
                fz32.evisc_n2(*f32[:3], f32[4], out=buf[ks:ke])
                kname = "K14"
            else:
                fz32.evisc(*f32[:4], out=buf[ks:ke])
                kname = "K1"
            cfl_k, ev_k = fz32.limits(*f32[:3], f32[4] if st == 2 else f32[3])
        cfl64, ev64 = plain(fz64, r64, True, limits=True)
        cfl_p, ev_p = plain(fz32, f32, True, limits=True)
        lbound = bound.amax(dim=(1, 2))
        for name, got, want, bnd in (
                (kname, buf[ks:ke], e64, bound),
                (kname + " plain", plain(fz32, f32, True), e64, bound),
                ("K7 evisc", ev_k, ev64, lbound),
                ("K7 evisc plain", ev_p, ev64, lbound),
                ("K7 cfl", cfl_k, cfl64, CRIT_ROUNDINGS * eps * cfl64.abs()),
                ("K7 cfl plain", cfl_p, cfl64,
                 CRIT_ROUNDINGS * eps * cfl64.abs())):
            ratio = float(((got.double() - want).abs() / bnd).max())
            out["%s %s" % (label, name)] = (float(cond.max()), ratio)
            if not ratio <= 1.:
                raise AssertionError(
                    "%s %s near strain2 = N2/tPr: error %.3g of its bound"
                    % (label, name, ratio))
        log("  %s 48^2x16 near-critical N2: largest cond %.3e (median %.3e); "
            "error over bound %s" % (label, float(cond.max()),
                                     float(cond.median()),
                                     {k: "%.3g" % r for k, (c, r) in
                                      out.items() if k.startswith(label)}))
        del models, m64, m32
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def evisc_forms(m):
    """The (stratified mode, regime) pairs of a model's cases: its own mode
    in both EVISC_REGIMES where it is stratified, and 0."""
    own = m.fused.stratified
    return [(own, r) for r in EVISC_REGIMES if own] + [(0, None)]


def evisc_cases(torch, m, seed, chunk_counts, forms=None):
    """(name, kernel call, plain call, error kind) for the eddy viscosity on
    a model's wrappers at each forced chunk count (None: the plan's): K1
    (Fused.evisc) in the model's mode (ghost-filled or clamped) and K14
    (FusedGeneric.evisc_n2) where the model's N2 is a field, on the
    evisc_inputs in both layouts, in each (stratified mode, regime) of forms
    (default: evisc_forms).  The output goes into the interior of a kcells
    tensor of NaN whose ghost levels must stay NaN.  The kernel call fails
    on a non-finite output."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    ks, ke = ctx.ks, ctx.ke
    shape = (ctx.kcells, ctx.jtot, ctx.itot)
    nan = float("nan")
    x = evisc_inputs(torch, m, seed)
    u, ths, n2s = x["u"], x["ths"], x["n2s"]
    grid_args, ghosts = x["grid_args"], x["ghosts"]

    def run(kernel, uvw, st, regime, chunks):
        th, n2 = ths.get(regime, u), n2s.get(regime)
        if not kernel:
            return [F.evisc_plain(*uvw, th, fz.ce, *grid_args, bool(st),
                                  ghosts, n2 if st == 2 else None)]
        buf = torch.full(shape, nan, dtype=ctx.dtype, device=ctx.device)
        with attrs(fz, stratified=st):
            if st == 2:
                fz.evisc_n2(*uvw, n2, out=buf[ks:ke], chunks=chunks)
            else:
                fz.evisc(*uvw, th, out=buf[ks:ke], chunks=chunks)
        name = "K14" if st == 2 else "K1"
        if not (bool(torch.isnan(buf[:ks]).all())
                and bool(torch.isnan(buf[ke:]).all())):
            raise AssertionError("%s wrote outside its output" % name)
        if not bool(torch.isfinite(buf[ks:ke]).all()):
            raise AssertionError("%s wrote a non-finite value" % name)
        return [buf[ks:ke]]

    cases = []
    for chunks in chunk_counts:
        for uvw in x["layouts"].values():
            for st, regime in forms or evisc_forms(m):
                args = (uvw, st, regime, chunks)
                cases.append(("evisc_n2" if st == 2 else "evisc",
                              lambda a=args: run(True, *a),
                              lambda a=args: run(False, *a), "field"))
    return cases


def evisc_chunks(m, dtype):
    """The k-splits the runs' phases force on K1/K14: 1, 2 and 3 chunks,
    the plan's count and one level a chunk."""
    fz, k = m.fused, m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {fz.evisc_plan(dtype, fz.stratified).chunks, k})


def forced_check(torch, m, cases, chunks):
    """A march's cases (evisc_cases or limits_cases) at a run's shapes in the
    path's own mode (in both EVISC_REGIMES where it is stratified) with the
    k-split forced to chunks(m, dtype); returns the largest absolute
    difference."""
    st = m.fused.stratified
    worst = 0.
    for name, kern, plain, kind in cases(
            torch, m, m.ctx.itot + 3, chunks(m, m.dtype),
            [(st, r) for r in EVISC_REGIMES] if st else [(0, None)]):
        worst = max(worst, compare(torch, name, kern, plain, kind, m.dtype,
                                   "%s forced" % shape_str(m)))
        torch.cuda.empty_cache()
    return worst


def check_evisc_forced(torch, m):
    """K1 (K14 where the model's N2 is a field) at a run's shapes, forced to
    evisc_chunks, aligned and shifted by one value."""
    return forced_check(torch, m, evisc_cases, evisc_chunks)


def limits_cases(torch, m, seed, chunk_counts, forms=None):
    """(name, kernel call, plain call, error kind) for K7 (Fused.limits) on
    a model's wrappers in its ghost or clamped mode at each forced chunk
    count (None: the plan's), on the evisc_inputs in both layouts, in each
    (stratified mode, regime) of forms (default: evisc_forms; mode 2 takes
    the N2 field, 0 reads no th), and, at each count, with one NaN planted
    in u at the last point of level ktot // 2 (in the last, partial, tile
    where the plane has one): the CFL rate's maximum must be NaN at that
    level and no other, and both rates' NaN levels are compared with the
    plain version's as 0/1 rows beside the finite values (NaN taken as -1).
    Each call returns the two (ktot,) maxima; the kernel call fails on a
    non-finite maximum where no NaN was planted."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    x = evisc_inputs(torch, m, seed)
    u, ths, n2s = x["u"], x["ths"], x["n2s"]
    grid_args, ghosts = x["grid_args"], x["ghosts"]
    kp = ctx.ktot // 2
    planted = u.clone()
    planted[ctx.ks + kp, -1, -1] = float("nan")

    def run(kernel, uvw, st, regime, chunks):
        th, n2 = ths.get(regime, u), n2s.get(regime)
        if not kernel:
            return list(F.limits_plain(*uvw, th, fz.ce, *grid_args, bool(st),
                                       ghosts, n2 if st == 2 else None))
        with attrs(fz, stratified=st):
            got = list(fz.limits(*uvw, n2 if st == 2 else th, chunks=chunks))
        if not all(bool(torch.isfinite(r).all()) for r in got):
            raise AssertionError("K7 gave a non-finite maximum")
        return got

    def masked(rates):
        return ([torch.nan_to_num(r, nan=-1.) for r in rates]
                + [torch.isnan(r).to(r.dtype) for r in rates])

    def run_nan(kernel, uvw, st, regime, chunks):
        th, n2 = ths.get(regime, u), n2s.get(regime)
        if not kernel:
            return masked(F.limits_plain(*uvw, th, fz.ce, *grid_args,
                                         bool(st), ghosts,
                                         n2 if st == 2 else None))
        with attrs(fz, stratified=st):
            got = fz.limits(*uvw, n2 if st == 2 else th, chunks=chunks)
        want = torch.zeros(ctx.ktot, dtype=torch.bool, device=ctx.device)
        want[kp] = True
        if not torch.equal(torch.isnan(got[0]), want):
            raise AssertionError("K7's planted NaN is not in the CFL rate's "
                                 "maximum of its level alone")
        return masked(got)

    cases = []
    for chunks in chunk_counts:
        for uvw in x["layouts"].values():
            for st, regime in forms or evisc_forms(m):
                args = (uvw, st, regime, chunks)
                cases.append(("limits", lambda a=args: run(True, *a),
                              lambda a=args: run(False, *a), "field"))
        st, regime = (forms or evisc_forms(m))[0]
        args = ((planted,) + x["layouts"]["aligned"][1:], st, regime, chunks)
        cases.append(("limits", lambda a=args: run_nan(True, *a),
                      lambda a=args: run_nan(False, *a), "field"))
    return cases


def limits_chunks(m, dtype):
    """The k-splits the runs' phases force on K7: 1, 2 and 3 chunks, the
    plan's count and one level a chunk."""
    fz, k = m.fused, m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {fz.limits_plan(dtype, fz.stratified).chunks, k})


def check_limits_forced(torch, m):
    """K7 at a run's shapes, forced to limits_chunks, aligned and shifted by
    one value, and with a planted NaN."""
    return forced_check(torch, m, limits_cases, limits_chunks)


def sweep_cases(torch, m, seed, chunks):
    """(name, kernel call, plain call, error kind) for the scalar sweep, K10
    (with the RK fold, the carry written) and K19 (without), its k-split
    forced, on a generic model: advection on and off, 1, 2, 3, 4 and 6
    scalars (the wrappers split six over two launches), seeded fields, a
    positive eddy viscosity, random carries and, for K10, each scalar's
    base table with noise in every column."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)

    def rnd(*sh, scale=1.):
        return (scale * torch.randn(*(sh or shape), generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    most = 6
    names = tuple("s%d" % n for n in range(most))
    s = {"u": rnd(), "v": rnd(), "w": rnd(scale=0.3)}
    s.update({n: rnd() for n in names})
    e = rnd().abs()
    t0 = {n: rnd(scale=1e-3) for n in names}
    sviscs = [1e-5 * (n + 1) for n in range(most)]
    cts = (fz.base.repeat(most, 1, 1)
           + rnd(most, ctx.ktot, F.NTG, scale=1e-3))
    grid_args = (ctx.ks, ctx.dxi, ctx.dyi, fz.tPr)
    cases = []
    for advec in (False, True):
        for S in (1, 2, 3, 4, most):
            def rk(kernel, advec=advec, S=S):
                t = {n: t0[n].clone() for n in names[:S]}
                with attrs(fz, names=names[:S], sviscs=sviscs[:S],
                           advec=advec):
                    if kernel:
                        out = fz.tend_scalars(s, t, e, cts[:S], 0.7,
                                              -153. / 128., True,
                                              chunks=chunks)
                    else:
                        out = F.tend_scalars_plain(
                            s, names[:S], e, t, cts[:S], sviscs[:S],
                            *grid_args, 0.7, -153. / 128., True, advec)
                return [out[n] for n in out] + [t[n] for n in t]

            def acc(kernel, advec=advec, S=S):
                t = {n: t0[n].clone() for n in names[:S]}
                with attrs(fz, names=names[:S], sviscs=sviscs[:S],
                           advec=advec):
                    if kernel:
                        fz.tend_scalars_acc(s, t, e, chunks=chunks)
                    else:
                        F.tend_scalars_acc_plain(s, names[:S], e, t,
                                                 fz.ct_static, sviscs[:S],
                                                 *grid_args, advec)
                return [t[n] for n in t]
            cases.append(("tend_scalars", lambda f=rk: f(True),
                          lambda f=rk: f(False), "field"))
            cases.append(("tend_scalar_acc", lambda f=acc: f(True),
                          lambda f=acc: f(False), "field"))
    return cases


# K15's forms (fold, advection): each flag on and off
K15_FORMS = ((True, True), (True, False), (False, True), (False, False))


def scalar_rk_cases(torch, m, seed, chunk_counts, forms=K15_FORMS):
    """(name, kernel call, plain call, error kind) for K15
    (FusedGeneric.tend_scalars in a case of one scalar) on a
    generic model's grid at each forced chunk count (None: the plan's) in
    each form (fold, advec) of forms: seeded fields, a positive eddy
    viscosity, a random carry and the base table with noise in every
    column."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (ctx.kcells, ctx.jtot, ctx.itot)

    def rnd(*sh, scale=1.):
        return (scale * torch.randn(*(sh or shape), generator=gen,
                                    dtype=torch.float64)).to(ctx.dtype).to(ctx.device)

    s = {"u": rnd(), "v": rnd(), "w": rnd(scale=0.3), "a": rnd()}
    e = rnd().abs()
    t0 = rnd(scale=1e-3)
    cts = (fz.base + rnd(ctx.ktot, F.NTG, scale=1e-3))[None]
    args = (ctx.ks, ctx.dxi, ctx.dyi, fz.tPr, 0.7, -153. / 128., True)
    cases = []
    for chunks in chunk_counts:
        for fold, advec in forms:
            def run(kernel, chunks=chunks, fold=fold, advec=advec):
                t = {"a": t0.clone()}
                with attrs(fz, names=("a",), sviscs=[2e-5], advec=advec):
                    if kernel:
                        out = fz.tend_scalars(s, t, e, cts, *args[4:], fold,
                                              chunks=chunks)
                    else:
                        out = F.tend_scalars_plain(s, ("a",), e, t, cts,
                                                   [2e-5], *args, advec, fold)
                return [out["a"], t["a"]]
            cases.append(("tend_scalar_rk", lambda f=run: f(True),
                          lambda f=run: f(False), "field"))
    return cases


def scalar_rk_chunks(m, dtype):
    """The k-splits the runs' phases force on K15: 1, 2 and 3 chunks, the
    plan's count (in the path's form) and one level a chunk."""
    k = m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {m.fused.plan("tend_scalars", 1, dtype).chunks, k})


def check_scalar_rk_forced(torch, m):
    """K15 at a run's shapes with its k-split forced (scalar_rk_chunks),
    the column fold on (the path's) and off, the path's advection flag;
    returns the largest absolute difference."""
    adv = m.fused.advec
    worst = 0.
    for name, kern, plain, kind in scalar_rk_cases(
            torch, m, m.ctx.itot + 4, scalar_rk_chunks(m, m.dtype),
            ((True, adv), (False, adv))):
        worst = max(worst, compare(torch, name, kern, plain, kind, m.dtype,
                                   "%s forced" % shape_str(m)))
        torch.cuda.empty_cache()
    return worst


def forced_chunks(ktot):
    """The k-splits check_kmarch forces: 1, 2 and 3 chunks, 4 and 5 (which
    do not divide 6 or 16), and one level a chunk."""
    return sorted({c for c in (1, 2, 3, 4, 5) if c <= ktot} | {ktot})


def fold_chunks(m, dtype):
    """The k-splits check_kmarch forces on K22: 1, 2 and 3 chunks, the
    plan's count and one level a chunk."""
    k = m.ctx.ktot
    return sorted({c for c in (1, 2, 3) if c <= k}
                  | {m.fused.fold_plan(dtype).chunks, k})


def check_kmarch(torch):
    """K16 and K17 (both schemes), K13 and K12 (every scheme) and the scalar
    sweep K10/K19 (sweep_cases) against their plain versions with the
    k-split forced (forced_chunks; for K16 and K17 also K17's plan at one
    scalar, for K12 also its plan's count) at ktot 6 and 16, so that chunks
    of one to three levels touch both walls, on partial tiles: K16 and K17
    (1, 2, 3 and K17_MAXS + 1 scalars, the last over two launches) on
    moser180 at 45x40 and weakscaling at 48x20, K13 on rico at 45x24 and
    48x20 with 1, 2, 4 and max_scalars + 2 scalars, K12 on the same grids
    with its 16-byte copies where the grid allows them and without
    (advec_mom_cases), the sweep on rico at 45x24 and 48x20 (K15 in its
    four forms too, scalar_rk_cases), and there
    the momentum sweep K8/K9 and K18 (uvw_cases, also at both plans'
    counts) aligned and shifted; K22 in
    every form of kernel_cases (fold_chunks) on drycblles at 512^2x32 and
    on the neutral Ekman LES at 45^2x8 (a partial tile, null th); K20
    (check_dry_kmarch); K1/K14 and K7 (check_evisc_kmarch); K2
    (check_rk_kmarch); K4 apply (check_apply_kmarch)."""
    for label, build, n, k in (("drycblles", build_model, 512, 32),
                               ("andren1994", build_andren, (45, 45), 8)):
        for dtype in (torch.float64, torch.float32):
            m = build(torch, n, k, dtype, "cuda")
            m.build_step()
            for chunks in fold_chunks(m, dtype):
                for name, kern, plain, kind in kernel_cases(
                        torch, m, k + 3, chunks=chunks, fold_only=True):
                    compare(torch, name, kern, plain, kind, dtype,
                            "%s %s chunks=%d" % (label, shape_str(m), chunks))
            del m
            torch.cuda.empty_cache()
    from microhh_torch.ops import kmarch
    for label, build, n in (("moser 4m", build_moser, (45, 40)),
                            ("weakscaling 4", build_weakscaling, (48, 20))):
        for k in (16, 6):
            for dtype in (torch.float64, torch.float32):
                m = build(torch, n, k, dtype, "cuda")
                m.build_step()
                for chunks in sorted(set(forced_chunks(k))
                                     | {m.o4.scalar_plan(1, dtype).chunks}):
                    for name, kern, plain, kind in o4_kernel_cases(
                            torch, m, n[0] + k, chunks=chunks,
                            counts=(1, 2, 3, kmarch.K17_MAXS + 1)):
                        compare(torch, name, kern, plain, kind, dtype,
                                "%s %dx%dx%d chunks=%d"
                                % (label, n[0], n[1], k, chunks))
    for scheme in ("2i4", "2i5", "2i53", "2i62"):
        for n in ((45, 24), (48, 20)):
            for k in (16, 6):
                for dtype in (torch.float64, torch.float32):
                    m = build_rico(torch, n, k, dtype, "cuda", swadvec=scheme)
                    m.build_step()
                    where = "rico %s %dx%dx%d" % (scheme, n[0], n[1], k)
                    for chunks in forced_chunks(k):
                        for name, kern, plain, kind in advec_scalar_cases(
                                torch, m, n[0] + k, chunks):
                            compare(torch, name, kern, plain, kind, dtype,
                                    "%s chunks=%d" % (where, chunks))
                    counts = sorted(set(forced_chunks(k))
                                    | set(mom_chunks(m, dtype)))
                    for name, kern, plain, kind in advec_mom_cases(
                            torch, m, n[0] + k, counts):
                        compare(torch, name, kern, plain, kind, dtype,
                                "%s chunks %s" % (where, counts))
    for n in ((45, 24), (48, 20)):
        for k in (16, 6):
            for dtype in (torch.float64, torch.float32):
                m = build_rico(torch, n, k, dtype, "cuda")
                m.build_step()
                for chunks in forced_chunks(k):
                    for name, kern, plain, kind in sweep_cases(
                            torch, m, n[0] + k, chunks) + scalar_rk_cases(
                                torch, m, n[1] + k, (chunks,)):
                        compare(torch, name, kern, plain, kind, dtype,
                                "rico %dx%dx%d chunks=%d"
                                % (n[0], n[1], k, chunks))
                counts = sorted(set(forced_chunks(k)) | set(uvw_chunks(
                    m, dtype)) | set(uvw_chunks(m, dtype, True)))
                for name, kern, plain, kind in uvw_cases(
                        torch, m, n[1] + k, counts):
                    compare(torch, name, kern, plain, kind, dtype,
                            "rico %dx%dx%d chunks %s"
                            % (n[0], n[1], k, counts))
    check_dry_kmarch(torch)
    check_evisc_kmarch(torch)
    check_rk_kmarch(torch)
    check_apply_kmarch(torch)


def check_evisc_kmarch(torch):
    """K1/K14 (evisc_cases) and K7 (limits_cases) against their plain
    versions with the k-split forced (forced_chunks and each plan's count):
    ghost mode on rico (the moist N2) and on SBL_Smag (K14, K7's N2 field),
    the ghost mode of sullivan2011's substep without the RK fold (the dry
    N2), the clamped mode on drycblles and, without th, on the neutral
    Ekman LES, each also unstratified, on the grids of phase 3, float64
    and float32."""
    for label, build, sizes, step_kw in (
            ("rico", build_rico, ((45, 24), (48, 32)), {}),
            ("SBL_Smag", build_sbl, ((45, 24), (48, 32)), {}),
            ("sullivan2011", build_sullivan, (((45, 45), 24),
                                              ((48, 48), 32)),
             {"unfolded": True}),
            ("drycblles", build_model, ((45, 8), (64, 32)), {}),
            ("andren1994", build_andren, (((45, 45), 8), ((48, 48), 32)),
             {})):
        for n, k in sizes:
            for dtype in (torch.float64, torch.float32):
                m = build(torch, n, k, dtype, "cuda")
                m.build_step(**step_kw)
                for cases, chunks in ((evisc_cases, evisc_chunks),
                                      (limits_cases, limits_chunks)):
                    counts = sorted(set(forced_chunks(k))
                                    | set(chunks(m, dtype)))
                    for name, kern, plain, kind in cases(torch, m, k + 5,
                                                         counts):
                        compare(torch, name, kern, plain, kind, dtype,
                                "%s %s chunks %s"
                                % (label, shape_str(m), counts))


def compare(torch, name, kern, plain, kind, dtype, where):
    """Run a kernel and its plain version, fail unless every output agrees
    to the tolerance; returns the largest absolute difference."""
    a, b = kern(), plain()
    torch.cuda.synchronize()
    errs, abs_errs = [], []
    for x, y in zip(a, b):
        # each pair taken to float64 once, for both errors
        x, y = x.double(), y.double()
        errs.append(ERR[kind](x, y))
        abs_errs.append(float((x - y).abs().max()))
    err, abs_err = max(errs), max(abs_errs)
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
    for n, k in ((45, 24), (48, 32)):
        for dtype in (torch.float64, torch.float32):
            m = build_rico(torch, n, k, dtype, "cuda")
            m.build_step()
            for name, kern, plain, kind in generic_kernel_cases(torch, m,
                                                                seed=n + k):
                compare(torch, name, kern, plain, kind, dtype,
                        "rico %d^2x%d" % (n, k))
    # the interpolated schemes: K12, K13 and the sweeps without advection
    for scheme in ("2i4", "2i5", "2i53", "2i62"):
        for dtype in (torch.float64, torch.float32):
            m = build_rico(torch, 45, 24, dtype, "cuda", swadvec=scheme)
            m.build_step()
            for prefix in ("advec", "tend"):
                for name, kern, plain, kind in generic_kernel_cases(
                        torch, m, seed=69, only=prefix):
                    compare(torch, name, kern, plain, kind, dtype,
                            "rico %s" % scheme)
    for n, k in ((45, 24), (48, 32)):
        for dtype in (torch.float64, torch.float32):
            m = build_sbl(torch, n, k, dtype, "cuda")
            m.build_step()
            for name, kern, plain, kind in generic_kernel_cases(torch, m,
                                                                seed=n + k):
                compare(torch, name, kern, plain, kind, dtype,
                        "SBL %d^2x%d" % (n, k))
    # the folded dry sweep on its two other cases: K22, K2 with the Coriolis
    # flag, K1 and K7, with thermo (sullivan2011: sponge and Coriolis folds)
    # and without (the neutral Ekman LES), partial tiles
    for label, build in (("sullivan2011", build_sullivan),
                         ("andren1994", build_andren)):
        for n, k in (((45, 45), 8), ((48, 48), 32)):
            for dtype in (torch.float64, torch.float32):
                m = build(torch, n, k, dtype, "cuda")
                m.build_step()
                for name, kern, plain, kind in kernel_cases(torch, m,
                                                            seed=n[0] + k):
                    compare(torch, name, kern, plain, kind, dtype,
                            "%s %dx%dx%d" % (label, n[0], n[1], k))
    # the substep without the RK fold: K18, K19 and K21 on the plume case,
    # K20 and K21 on the dry ones (with and without thermo), with K1 and K7
    # in their ghost mode
    for label, build, sizes in (
            ("jaenschwalde", build_jaenschwalde, (((45, 40), 24), ((48, 16), 32))),
            ("sullivan2011", build_sullivan, (((45, 45), 24), ((48, 48), 32))),
            ("andren1994", build_andren, (((45, 45), 8), ((48, 48), 32)))):
        for n, k in sizes:
            for dtype in (torch.float64, torch.float32):
                m = build(torch, n, k, dtype, "cuda")
                m.build_step(unfolded=True)
                for name, kern, plain, kind in generic_kernel_cases(
                        torch, m, seed=n[0] + k):
                    compare(torch, name, kern, plain, kind, dtype,
                            "%s %dx%dx%d" % (label, n[0], n[1], k))
    # the 4th-order stack: K16 and K17 in both schemes, partial tiles
    for label, build, n in (("moser 4m", build_moser, (45, 40)),
                            ("weakscaling 4", build_weakscaling, (48, 20))):
        for k in (16, 6):
            for dtype in (torch.float64, torch.float32):
                m = build(torch, n, k, dtype, "cuda")
                m.build_step()
                for name, kern, plain, kind in o4_kernel_cases(torch, m,
                                                               seed=n[0] + k):
                    compare(torch, name, kern, plain, kind, dtype,
                            "%s %dx%dx%d" % (label, n[0], n[1], k))


# --------------------------------------------------------------------------
#  phase 4: whole step on the card against the CPU
# --------------------------------------------------------------------------

def check_step(torch):
    f64 = torch.float64
    cases = (("drycblles 32^3", lambda d: build_model(torch, 32, 32, f64, d),
              lambda m: initial_state(m, seed=7), {}),
             ("drycblles 32^3 fold=False",
              lambda d: build_model(torch, 32, 32, f64, d),
              lambda m: initial_state(m, seed=7), {"fold": False}),
             ("rico 16^2x24", lambda d: build_rico(torch, 16, 24, f64, d),
              lambda m: rico_state(m, seed=7), {}),
             ("rico 2i5 16^2x24", lambda d: build_rico(
                 torch, 16, 24, f64, d, swadvec="2i5"),
              lambda m: rico_state(m, seed=7), {}),
             ("SBL_Smag 16^2x24", lambda d: build_sbl(torch, 16, 24, f64, d),
              lambda m: sbl_state(m, seed=7), {}),
             ("moser180 16^3", lambda d: build_moser(torch, (16, 16), 16,
                                                     f64, d),
              lambda m: o4_state(m, seed=7), {}),
             ("weakscaling 16x8x32", lambda d: build_weakscaling(
                 torch, (16, 8), 32, f64, d),
              lambda m: o4_state(m, seed=7), {}),
             ("jaenschwalde 32x16x24", lambda d: build_jaenschwalde(
                 torch, (32, 16), 24, f64, d),
              lambda m: unfolded_state(m, seed=7), {}),
             ("sullivan2011 32^3", lambda d: build_sullivan(
                 torch, (32, 32), 32, f64, d),
              lambda m: unfolded_state(m, seed=7), {}),
             ("sullivan2011 32^3 unfolded", lambda d: build_sullivan(
                 torch, (32, 32), 32, f64, d),
              lambda m: unfolded_state(m, seed=7), {"unfolded": True}),
             ("andren1994 48x24x24", lambda d: build_andren(
                 torch, (48, 24), 24, f64, d),
              lambda m: unfolded_state(m, seed=7), {}))
    for label, make, state, step_kw in cases:
        out = {}
        for device in ("cuda", "cpu"):
            m = make(device)
            m.build_step(**step_kw)
            s, sfc = m.as_device_state(state(m))
            for _ in range(2):
                s, sfc, aux = m.step(s, sfc, min(2.0, m.timeloop.dt))
            out[device] = (m, s, aux)
        m, s_gpu, aux_gpu = out["cuda"]
        _, s_cpu, aux_cpu = out["cpu"]
        ks, ke = m.ctx.ks, m.ctx.ke
        worst = 0.
        for n in m.fields.prognostic_names:
            worst = max(worst, rel_err(s_gpu[n][ks:ke].cpu(), s_cpu[n][ks:ke]))
        worst = max(worst, rel_err(aux_gpu["p"].cpu(), aux_cpu["p"]))
        log("  2 RK3 steps %s float64 (%s), card vs CPU: max rel err %.3e"
            % (label, ", ".join(k.name for k in m.kernels()[:2]), worst))
        if not worst <= 1e-10:
            raise AssertionError("whole %s step on the card disagrees with "
                                 "the CPU" % label)


# --------------------------------------------------------------------------
#  phase 4b/4c: statistics and budgets
# --------------------------------------------------------------------------

def stats_run(torch, workdir, case, name, device, **over):
    """init + run of cases/<case>/<name>.ini (the given options replaced)
    through run_case in float64 on device, its input computed in memory;
    returns the path of its statistics file."""
    from microhh_torch.cases import case_input
    from microhh_torch.config import Ini
    from microhh_torch.model import run_case
    os.makedirs(workdir)
    path = os.path.join(workdir, "%s.ini" % name)
    with open(path, "w") as f:
        f.write(case_ini(case, name, **over))
    ini = Ini(path)
    mem = case_input(name, ini.get_int("grid", "ktot"),
                     ini.get_float("grid", "zsize"))
    for mode in ("init", "run"):
        run_case(workdir, name, mode, dtype=torch.float64, device=device,
                 input_nc=mem)
    return os.path.join(workdir, "%s.default.0000000.nc" % name)


STATS_CASES = (("drycblles 32^3 as written (endtime 900)", "drycblles",
                "drycblles", {"endtime": 900}),
               ("moser180 16^3 with swbudget=4 (endtime 120)", "moser180",
                "moser180", {"itot": 16, "jtot": 16, "ktot": 16,
                             "endtime": 120}))


def check_stats(torch):
    """Each of STATS_CASES through run_case on the card and on the CPU,
    float64: the two statistics files agree (stats_agree) to 1e-10 of each
    profile's scale.  Returns {case: (writer, samples, worst error)}."""
    from microhh_torch.stats import stats_writer
    writer = stats_writer()[1]
    out = {}
    for label, case, name, over in STATS_CASES:
        with tempfile.TemporaryDirectory() as workdir:
            files = {d: read_stats(stats_run(torch, os.path.join(workdir, d),
                                             case, name, d, **over))
                     for d in ("cuda", "cpu")}
        errs = stats_agree(files["cuda"], files["cpu"], label)
        worst = max(errs, key=errs.get)
        groups = sorted({g for g, _ in (k for k in files["cpu"]
                                        if isinstance(k, tuple))})
        log("  %s: %d samples at %s, %d variables in groups %s, written as "
            "%s; card against CPU float64, worst %s %.3e of its scale"
            % (label, len(files["cpu"]["time"]), list(files["cpu"]["time"]),
               len(errs), groups, writer, worst, errs[worst]))
        if not errs[worst] <= 1e-10:
            raise AssertionError("%s statistics: card and CPU disagree"
                                 % label)
        out[label] = {"writer": writer, "samples": len(files["cpu"]["time"]),
                      "variables": len(errs), "worst": worst,
                      "worst_err": errs[worst]}
    return out


def time_stats(torch, reps=5):
    """ms of one Stats.maybe_exec call (CUDA events around it, median of
    reps after one warm-up; the host's netCDF write included) for
    drycblles 512^3 float32 and for moser180 256x192x128 float64 with its
    budget_4 and the pressure of one step."""
    from microhh_torch.cases import moser180_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    from microhh_torch.stats import Stats
    out = {}
    for label, make in (
            ("drycblles 512^3 float32", lambda wd: (Model(
                Ini(DRYCBL_INI % {"n": 512, "k": 512}
                    + "\n[stats]\nswstats=1\nsampletime=300\n"),
                "run", "drycblles", workdir=wd, dtype=torch.float32,
                device="cuda"), lambda m: initial_state(m, seed=3))),
            ("moser180 256x192x128 float64 with budget_4", lambda wd: (Model(
                Ini(case_ini("moser180")), "run", "moser180", workdir=wd,
                dtype=torch.float64, device="cuda",
                input_nc=moser180_input(128, 2.)),
                lambda m: o4_state(m, seed=3)))):
        with tempfile.TemporaryDirectory() as workdir:
            m, state_of = make(workdir)
            m.finish_setup()
            s, sfc = m.as_device_state(state_of(m))
            if m.ctx.spatial_order == 4:
                m.build_step()
                s, sfc, aux = m.step(s, sfc, 0.1)
                m._last_aux = {"p": aux["p"]}
            st = Stats(m)
            ms, walls = [], []
            for it in range(reps + 1):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                st.maybe_exec(m, s, sfc)
                e1.record()
                e1.synchronize()
                if it:
                    ms.append(e0.elapsed_time(e1))
                    walls.append(1e3 * (time.perf_counter() - t0))
            nvars = len(st.vars)
            st.close()
            del m, s, sfc, st
        torch.cuda.empty_cache()
        out[label] = {"ms": statistics.median(ms), "ms_min": min(ms),
                      "wall_ms": statistics.median(walls),
                      "variables": nvars}
        log("  Stats.maybe_exec %s: %.3f ms (min %.3f; wall %.3f) a sample "
            "of %d variables" % (label, out[label]["ms"], min(ms),
                                 out[label]["wall_ms"], nvars))
    return out


# --------------------------------------------------------------------------
#  phase 4d: the chunked loop, captured
# --------------------------------------------------------------------------

def seeded_chunk_state(m, seed):
    """initial_state with random velocities and the surface planes of the
    case's init, as tensors on m's device."""
    from microhh_torch.model import NP_DTYPE
    st = initial_state(m, seed)
    s = {n: m.ctx.tensor(st[n]) for n in m.fields.prognostic_names}
    sfc = m.boundary.init_surface_state(dtype=NP_DTYPE[m.dtype])
    return s, {k: m.ctx.tensor(v) for k, v in sfc.items()}


def graph_against_eager(torch, n, dtype, nsteps=8):
    """drycblles n^3 on K22 from one seeded state: nsteps of the chunk body
    as its captured graphs against the same body run eagerly, both on the
    card: the same dt at every step and the final fields within 1e-5
    (float32) or 1e-12 (float64) of their maxima.  Returns the largest
    error and the replays' launches."""
    from microhh_torch.graph_step import ChunkLoop
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    m = build_model(torch, n, n, dtype, "cuda")
    m.build_step()
    s0, sfc0 = seeded_chunk_state(m, 11)
    runs = {}
    for capture in (False, True):
        loop = ChunkLoop(m, capture=capture)
        s = {k: v.clone() for k, v in s0.items()}
        sfc = {k: v.clone() for k, v in sfc0.items()}
        loop.start(m.timeloop.dt, 1e6)
        dts = []
        for i in range(nsteps):
            s, sfc, _ = loop.run(s, sfc, i + 1)
            dts.append(float(loop.dt))
        runs[capture] = (dts, s, loop)
    (dts_e, s_e, _), (dts_g, s_g, loop) = runs[False], runs[True]
    ks, ke = m.ctx.ks, m.ctx.ke
    errs = {k: rel_err(s_g[k][ks:ke], s_e[k][ks:ke]) for k in s_e}
    graphs = loop.graphs
    launches = {kern.name: sum(c[kern] * r for c, r in
                               zip(graphs.counts, graphs.replays))
                for kern in m.kernels()}
    log("  drycblles %d^3 %s, %d steps: graphs against the eager body: dt "
        "%s (eager %s), rel err %s, replays %s, launches in replays %s"
        % (n, str(dtype)[6:], nsteps, dts_g, dts_e,
           {k: "%.2e" % v for k, v in errs.items()}, graphs.replays, launches))
    if dts_g != dts_e:
        raise AssertionError("the graphs took another dt sequence")
    if not max(errs.values()) <= tol or sum(graphs.replays) != nsteps:
        raise AssertionError("the graphs disagree with the eager body")
    if min(launches.values()) == 0:
        raise AssertionError("a kernel of the step is not in the graphs")
    return max(errs.values()), launches


def chunked_case_dir(torch, workdir, n, device, endtime, outputiter,
                     capture=True, savetime=None):
    """A drycblles n^3 float64 case at workdir (initial_state with random
    velocities) run through Model.run to endtime, a restart every savetime
    seconds (default: one, at endtime), a status line every outputiter
    steps; capture False runs the chunk body eagerly on the card.  Returns
    the model."""
    text = DRYCBL_INI % {"n": n, "k": n}
    for key, val in (("endtime", endtime), ("savetime", savetime or endtime),
                     ("outputiter", outputiter)):
        text = re.sub(r"(?m)^%s=.*$" % key, "%s=%s" % (key, val), text)
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    init = Model(Ini(text), "init", "drycblles", workdir=workdir,
                 dtype=torch.float64, device=device)
    init.finish_setup()
    init.save_initial_state(initial_state(init, 13))
    m = Model(Ini(text), "run", "drycblles", workdir=workdir,
              dtype=torch.float64, device=device)
    m.finish_setup()
    m.build_chunk(capture=capture)
    m.run()
    return m


def chunked_outputs(torch, n, device, endtime, outputiter, capture=True,
                    savetime=None):
    """chunked_case_dir's run in a temporary directory: (its status rows,
    split; {time: {field: restart array}} and {time: iteration} at every
    restart time; the model's ChunkLoop; the seconds of the run)."""
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        m = chunked_case_dir(torch, workdir, n, device, endtime, outputiter,
                             capture, savetime)
        seconds = time.perf_counter() - t0
        with open(os.path.join(workdir, "drycblles.out")) as f:
            rows = [line.split() for line in f if line.split()[0].isdigit()]
        step = savetime or endtime
        fields = {t: {name: np.fromfile(os.path.join(
            workdir, "%s.%07d" % (name, t)))
            for name in m.fields.prognostic_names}
            for t in range(step, endtime + 1, step)}
        iters = {t: int(np.fromfile(os.path.join(workdir, "time.%07d" % t),
                                    dtype=np.int32, count=1, offset=16)[0])
                 for t in fields}
    return rows, fields, iters, m._chunk, seconds


def field_errs(f, ref):
    """The largest difference of each field over the largest value of its
    reference."""
    return {k: float(np.abs(f[k] - ref[k]).max() / np.abs(ref[k]).max())
            for k in ref}


def chunked_card_against_cpu(torch, n=32, endtime=25, outputiter=4):
    """The chunked run of chunked_case_dir on the card (captured) and on
    the CPU (eager): restart fields within 1e-10 of their scale, the same
    status ITER and TIME columns.  The run is short (9 steps): on this
    turbulent flow the difference of the two machines' roundoff grows by
    orders of magnitude over hundreds of steps, the same for the card's
    captured run and its eager one (--drift); chunked_captured_against_eager
    holds the graphs to the eager body bit for bit over hundreds of
    steps."""
    out = {}
    for device in ("cuda", "cpu"):
        rows, fields, _, loop, _ = chunked_outputs(torch, n, device,
                                                   endtime, outputiter)
        out[device] = ([r[:2] for r in rows], fields[endtime], loop)
    (rows_g, f_g, loop), (rows_c, f_c, _) = out["cuda"], out["cpu"]
    errs = field_errs(f_g, f_c)
    log("  drycblles %d^3 float64 to %d s through Model.run: card %s "
        "(captured %s, %d chunks) against CPU, status ITER/TIME %s, rel err "
        "%s" % (n, endtime, rows_g[-1], loop.graphs is not None,
                loop.counters["chunks"], rows_c[-1],
                {k: "%.2e" % v for k, v in errs.items()}))
    if loop.graphs is None or rows_g != rows_c or int(rows_g[-1][0]) < 8:
        raise AssertionError("the chunked runs on the card and the CPU "
                             "took other steps")
    if not max(errs.values()) <= 1e-10:
        raise AssertionError("the chunked run on the card disagrees with "
                             "the CPU")
    return max(errs.values())


def chunked_captured_against_eager(torch, n=32, endtime=300, outputiter=4,
                                   min_steps=200):
    """The chunked run of chunked_case_dir on the card with its step
    captured and with the chunk body run eagerly, over at least min_steps
    steps and a chunk ended every outputiter steps: every status column but
    CPUDT the same, row for row, and the restart fields bit for bit.
    Returns (steps, chunks)."""
    out = {}
    for capture in (True, False):
        out[capture] = chunked_outputs(torch, n, "cuda", endtime, outputiter,
                                       capture)
    (rows_g, f_g, _, loop_g, s_g), (rows_e, f_e, _, loop_e, s_e) = (
        out[True], out[False])
    rows_g, rows_e = ([r[:2] + r[3:] for r in rows] for rows in (rows_g,
                                                                  rows_e))
    same = {k: bool(np.array_equal(f_g[endtime][k], f_e[endtime][k]))
            for k in f_e[endtime]}
    steps, chunks = loop_g.counters["steps"], loop_g.counters["chunks"]
    log("  drycblles %d^3 float64 to %d s through Model.run on the card: "
        "captured (%d steps in %d chunks, %.1f s) against the eager body "
        "(%d steps in %d chunks, %.1f s): status rows the same %s (last %s), "
        "restart fields the same bit for bit %s"
        % (n, endtime, steps, chunks, s_g, loop_e.counters["steps"],
           loop_e.counters["chunks"], s_e, rows_g == rows_e, rows_g[-1][:2],
           same))
    if loop_g.graphs is None or loop_e.graphs is not None:
        raise AssertionError("the captured run did not capture, or the "
                             "eager one did")
    if steps < min_steps:
        raise AssertionError("the captured run took %d steps, fewer than %d"
                             % (steps, min_steps))
    if rows_g != rows_e or not all(same.values()):
        raise AssertionError("the captured chunked loop disagrees with the "
                             "eager body")
    return steps, chunks


def chunked_drift(torch, path, n=32, endtime=900, savetime=60,
                  outputiter=4):
    """--drift FILE: chunked_case_dir's run to endtime with a restart every
    savetime seconds, on the card captured, on the card with the body run
    eagerly, and on the CPU: at each restart time the iteration of each
    run and the largest field error (field_errs) of the captured run
    against the eager one, and of each card run against the CPU's.
    Written to FILE as JSON and printed; returns the rows."""
    runs = {}
    for key, device, capture in (("captured", "cuda", True),
                                 ("eager", "cuda", False),
                                 ("cpu", "cpu", False)):
        _, fields, iters, loop, seconds = chunked_outputs(
            torch, n, device, endtime, outputiter, capture, savetime)
        runs[key] = (iters, fields)
        log("  drycblles %d^3 float64 %s to %d s: %d steps in %d chunks, "
            "%.1f s" % (n, key, endtime, loop.counters["steps"],
                        loop.counters["chunks"], seconds))
    table = []
    for t in sorted(runs["cpu"][1]):
        it = {key: iters[t] for key, (iters, _) in runs.items()}
        f = {key: fields[t] for key, (_, fields) in runs.items()}
        row = {"time": t, "iteration": it,
               "captured_vs_eager": max(field_errs(f["captured"],
                                                   f["eager"]).values()),
               "captured_vs_cpu": max(field_errs(f["captured"],
                                                 f["cpu"]).values()),
               "eager_vs_cpu": max(field_errs(f["eager"], f["cpu"]).values())}
        table.append(row)
        log("  " + json.dumps(row))
    with open(path, "w") as f:
        json.dump({"card": card_line(), "n": n, "endtime": endtime,
                   "savetime": savetime, "outputiter": outputiter,
                   "rows": table}, f, indent=1)
    return table


def strict_replays(torch):
    """GraphChunk.run under torch.cuda.set_sync_debug_mode("error"): a
    synchronising call among the replays raises.  Returns the original, to
    be put back."""
    from microhh_torch import graph_step
    orig = graph_step.GraphChunk.run

    def run(self, *args, **kw):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(self, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    graph_step.GraphChunk.run = run
    return orig


def host_idle_share(torch, m, s, sfc, nsteps=4):
    """The host-side idle share of the chunked loop's steps and of the same
    body run eagerly (the per-step dispatch), from (s, sfc): one minus a
    graph replay's span between two CUDA events (the median of nsteps
    replays) over the wall time of a step.  The span counts the graph's
    gaps between its nodes as busy, so this is the time the card waits on
    the host, not the device idle share; the kernels' busy time a step is
    ring_timing's ``chunked`` group (torch.profiler, which stays out of this
    script: its tracing stays armed after it and slows every later launch).
    Returns {"span_ms_per_step", "graphs", "eager_body"}, each of the last
    two with its wall a step and its ``host_idle_share``."""
    from microhh_torch.graph_step import ChunkLoop
    loop = m._chunk
    graphs = loop.graphs
    out = {}
    loop.start(m.timeloop.dt, 1e6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, sfc, _ = loop.run(s, sfc, nsteps)
    torch.cuda.synchronize()
    out["graphs"] = {"wall_ms_per_step":
                     1e3 * (time.perf_counter() - t0) / nsteps}
    spans = []
    for _ in range(nsteps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        graphs.graphs[graphs.cur].replay()
        ev[1].record()
        ev[1].synchronize()
        graphs.cur = 1 - graphs.cur
        spans.append(ev[0].elapsed_time(ev[1]))
    span = out["span_ms_per_step"] = statistics.median(spans)
    eager = ChunkLoop(m, capture=False)
    eager.start(m.timeloop.dt, 1e6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager.run(s, sfc, nsteps)
    torch.cuda.synchronize()
    out["eager_body"] = {"wall_ms_per_step":
                         1e3 * (time.perf_counter() - t0) / nsteps}
    for key in ("graphs", "eager_body"):
        out[key]["host_idle_share"] = (1. - span
                                       / out[key]["wall_ms_per_step"])
    return out


def chunked_model(torch, m0, workdir, endtime, outputiter, step_kw=None,
                  mode="run"):
    """A model of m0's case on workdir with endtime and outputiter set and
    no restart before the end (mode "init": to write its restart of time
    0)."""
    import copy
    from microhh_torch.model import Model
    ini = copy.deepcopy(m0.ini)
    ini.used = set()
    for key, val in (("endtime", endtime), ("outputiter", outputiter),
                     ("savetime", 100 * endtime)):
        ini.items["time"][key] = {"": str(val)}
    m = Model(ini, mode, m0.casename, workdir=workdir, dtype=m0.dtype,
              device="cuda", input_nc=m0.input_nc)
    m.finish_setup()
    if mode == "run":
        m.build_step(**(step_kw or {}))
    return m


def chunked_run(torch, m0, label, endtime, outputiter, min_steps,
                step_kw=None, per_step=False, state_of=None):
    """[4d] the case of m0 (its workdir holds the restart of time 0, or,
    with state_of, a new one holds state_of's) to endtime through
    Model.run() without max_iters: the chunked loop with the step captured,
    its replays under set_sync_debug_mode("error").
    Fails unless the graphs were captured, every kernel of the step launched
    in replays, at least min_steps steps ran, the fields are finite and DIV
    <= 1e-4 after the first step.  Prints s/step of the loop (its capture
    and the status lines between chunks included) and of its chunks alone,
    the capture and instantiation seconds, the peak memory and the
    host-side idle share (host_idle_share) of the replays and of the body
    run eagerly; per_step: also s/step of the per-step loop
    (MICROHH_CHUNK=0) on the same build and case, loop against loop."""
    args = (label, endtime, outputiter, min_steps, step_kw, per_step)
    if state_of is None:
        return chunked_in(torch, m0, m0.workdir, *args)
    with tempfile.TemporaryDirectory() as workdir:
        init = chunked_model(torch, m0, workdir, endtime, outputiter,
                             mode="init")
        init.save_initial_state(state_of(init))
        del init
        return chunked_in(torch, m0, workdir, *args)


def chunked_in(torch, m0, workdir, label, endtime, outputiter, min_steps,
               step_kw, per_step):
    """chunked_run on workdir."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = chunked_model(torch, m0, workdir, endtime, outputiter, step_kw)
    where = "%s %s %s" % (label, shape_str(m), str(m.dtype)[6:])
    for kern in m.kernels():
        kern.launches = 0
    status = os.path.join(m.workdir, "%s.out" % m.casename)
    size0 = os.path.getsize(status) if os.path.exists(status) else 0
    from microhh_torch import graph_step
    orig = strict_replays(torch)
    try:
        t0 = time.perf_counter()
        s = m.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        graph_step.GraphChunk.run = orig
    peak = torch.cuda.max_memory_allocated()
    loop = m._chunk
    graphs = loop.graphs
    if graphs is None:
        raise AssertionError("%s: the chunked loop did not capture" % label)
    replayed = {kern.name: sum(c[kern] * r for c, r in
                               zip(graphs.counts, graphs.replays))
                for kern in m.kernels()}
    steps, loop_s = m.loop_wall
    ks, ke = m.ctx.ks, m.ctx.ke
    with open(status) as f:
        f.seek(size0)
        rows = [line.split() for line in f if line.split()[0].isdigit()]
    final = {kk: float(v) for kk, v in m.diagnostics(s, m.final_sfc).items()}
    divs = [float(r[6]) for r in rows if int(r[0]) > 0] + [final["div"]]
    res = {"steps": steps, "chunks": loop.counters["chunks"],
           "replays": list(graphs.replays), "launches_in_replays": replayed,
           "loop_s_per_step": loop_s / steps,
           "chunk_s_per_step": loop.counters["seconds"] / steps,
           "warm_up_s": graphs.seconds["warm_up"],
           "capture_instantiate_s": graphs.seconds["capture"],
           "run_wall_s": run_s, "peak_mem_gb": peak / 1e9,
           "div_max": max(divs), "dt_final": m.timeloop.dt}
    log("  [4d] Model.run() at %s to %s s: %d steps in %d chunks (replays "
        "%s), launches in replays %s, loop %.6f s/step (chunks alone %.6f), "
        "warm-up %.3f s, capture and instantiation %s s, run %.3f s wall, "
        "peak memory %.3f GB, max DIV %.3e, final dt %.4f s"
        % (where, endtime, steps, res["chunks"], graphs.replays, replayed,
           res["loop_s_per_step"], res["chunk_s_per_step"], res["warm_up_s"],
           ["%.3f" % x for x in graphs.seconds["capture"]], run_s,
           peak / 1e9, max(divs), m.timeloop.dt))
    missing = [name for name, c in replayed.items() if c == 0]
    if missing:
        raise AssertionError("%s did not launch %s in replays"
                             % (label, missing))
    if steps < min_steps:
        raise AssertionError("%s ran %d steps, fewer than %d"
                             % (label, steps, min_steps))
    for name in m.fields.prognostic_names:
        if not bool(torch.isfinite(s[name][ks:ke]).all()):
            raise AssertionError("non-finite %s after the chunked %s run"
                                 % (name, label))
    if not max(divs) <= 1e-4:
        raise AssertionError("%s: DIV %.3e after the chunked run"
                             % (label, max(divs)))
    idle = res["host_idle"] = host_idle_share(torch, m, s, m.final_sfc)
    log("  [4d] %s, 4 steps: a replay's span %.3f ms (median, its gaps "
        "between nodes included); the graphs' steps %.3f ms of wall a step, "
        "host-side idle share (1 - span / wall) %.3f; the body run eagerly "
        "%.3f ms, 1 - span / wall %.3f"
        % (where, idle["span_ms_per_step"],
           idle["graphs"]["wall_ms_per_step"],
           idle["graphs"]["host_idle_share"],
           idle["eager_body"]["wall_ms_per_step"],
           idle["eager_body"]["host_idle_share"]))
    # the model and its loop refer to each other: collect them, so that
    # their graphs' pool is freed before the next phase
    del m, s, loop, graphs
    gc.collect()
    torch.cuda.empty_cache()
    if per_step:
        os.environ["MICROHH_CHUNK"] = "0"
        try:
            mp = chunked_model(torch, m0, workdir, endtime, outputiter,
                               step_kw)
            mp.run()
            torch.cuda.synchronize()
        finally:
            os.environ.pop("MICROHH_CHUNK")
        psteps, ps = mp.loop_wall
        res["per_step_loop_s_per_step"] = ps / psteps
        res["per_step_steps"] = psteps
        log("  [4d] the per-step loop (MICROHH_CHUNK=0) at %s to %s s: %d "
            "steps, %.6f s/step; the chunked loop %.6f s/step"
            % (where, endtime, psteps, ps / psteps, res["loop_s_per_step"]))
        del mp
        gc.collect()
        torch.cuda.empty_cache()
    return res, replayed


# --------------------------------------------------------------------------
#  phase 5: the drycblles LES at 512^3
# --------------------------------------------------------------------------

def build_drycblles(torch, n, k, dtype, device, mode="run", workdir="."):
    """build_model with the signature of the other build_* functions, n =
    (itot, jtot) square."""
    return build_model(torch, n[0], k, dtype, device, mode, workdir)


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


def check_kernels_full(torch, m, cases):
    """Each kernel against its plain version on seeded inputs at the main
    path's shapes; returns the largest absolute difference per kernel."""
    errs = {}
    for name, kern, plain, kind in cases(torch, m, seed=m.ctx.itot):
        err = compare(torch, name, kern, plain, kind, m.dtype, shape_str(m))
        errs[name] = max(errs.get(name, 0.), err)
        torch.cuda.empty_cache()
    return errs


# the card's published peaks (H100 SXM): device memory rate and float32
# rate outside the tensor cores; float64 outside them runs at half that
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
PEAK_FLOPS_F64 = 33.5e12

# operations per output point of each stencil kernel, counted from its
# source (adds, multiplies and special functions each as one)
FLOPS_PER_POINT = {"evisc": 100, "evisc_n2": 100, "limits": 110,
                   "tend_rk": 700, "tend_rk_fold": 900, "tend_uvw": 450, "tend_scalars": 110,
                   "tend_scalar_rk": 110, "micro2": 300, "advec_mom": 400,
                   "advec_scalars": 130, "pres_rhs": 10, "pres_apply": 15,
                   "tdma": 16, "tend_uvw_acc": 430,
                   "tend_scalar_acc": 100, "tendencies": 700,
                   # K16 and K17 by scheme (K17 per scalar, with one
                   # scalar's share of the vertical weights); K16 computes
                   # each face interpolant once per point
                   "o4_mom": {"4": 560, "4m": 510},
                   "o4_scalars": {"4": 185, "4m": 140}}


def pair(kern, plain, nbytes, flops, lib=None, peak_flops=PEAK_FLOPS,
         info=None):
    """A kernel call, its plain version, the bytes its inputs and outputs
    hold (each once), its operations and the card's peak rate for their
    type, the one library call that computes the same function (or None),
    and what to report beside its times."""
    return {"kern": kern, "plain": plain, "bytes": nbytes, "flops": flops,
            "lib": lib, "peak_flops": peak_flops, "info": info or {}}


# the kernel functions of each DFT entry, as the build log names them
DFT_ENTRIES = {"dft_fwd": "dft_fwd_cluster", "dft_inv": "dft_inv_cluster",
               "dft_fwd_split": "dft_r2c_x", "dft_inv_split": "dft_c2r_x"}
# kernel function -> {type: registers}, from nvcc -Xptxas -v (main fills it)
REGISTERS = {}


def registers_of(build_log):
    """{kernel function: {"float"|"double": registers}} of every kernel
    from the ptxas lines of the build log (the most over a function's other
    template arguments), and the spills and stack of every instance."""
    from microhh_torch.ring_timing import ptxas_info
    out = {}
    info = ptxas_info(build_log)
    for key, rec in info.items():
        name, args = key[:-1].split("<", 1)
        dt = args.split(",")[0] or "float"
        regs = out.setdefault(name, {})
        regs[dt] = max(regs.get(dt, 0), rec.get("registers", 0))
    spills = {key: rec for key, rec in info.items()
              if rec.get("spill_stores") or rec.get("stack")}
    return out, spills


def kmarch_info(kern, dtype, scheme, S, plan):
    """What a k-marching kernel (K1/K14, K2, K4 apply, K7, K8/K9, K12, K13,
    K16, K17, K18, the scalar sweep, K20, K22) reports at a path's shape:
    its registers, local bytes a thread, shared memory a block and
    resident blocks an SM from the card, its chunk count, blocks and
    waves."""
    info = kern.info(dtype, scheme, S)
    return {"registers": info["registers"], "local_bytes": info["local_bytes"],
            "smem_per_block": info["smem"],
            "blocks_per_sm": info["blocks_per_sm"], "chunks": plan.chunks,
            "blocks": plan.tiles_i * plan.tiles_j * plan.chunks,
            "waves": plan.waves}


def field_bytes(m):
    """Bytes of one interior field of the model."""
    return points(m) * m.ctx.dzi.element_size()


def points(m):
    return m.ctx.ktot * m.ctx.jtot * m.ctx.itot


def tdma_info(pr, kmax, nmodes, dtype):
    """K3's form at a path's shape (ops/pres_2.py tdma_form) and what the
    card reports of it: registers, local bytes a thread, blocks an SM,
    threads and blocks of the launch, waves."""
    form = pr.tdma_form(kmax, dtype)
    info = pr.k_tdma.info(dtype, int(form.form == "sweep"), form.chunks)
    # a block of the scan form holds threads / chunks modes, of the sweep
    # form one a thread
    blocks = -(-nmodes // (form.threads // form.chunks))
    return {"form": form.form, "L": form.L, "chunks": form.chunks,
            "threads": form.threads, "registers": info["registers"],
            "local_bytes": info["local_bytes"], "smem_per_block": form.smem,
            "blocks_per_sm": info["blocks_per_sm"], "blocks": blocks,
            "waves": -(-blocks // (info["blocks_per_sm"] * info["sms"]))}


def pres_pairs(torch, m, s):
    """The projection's kernels (K3-K6) at the model's shapes."""
    from microhh_torch.ops import fused as F
    from microhh_torch.ops.pres_2 import tdma_plain
    ctx, gl, pr, t = m.ctx, m.glue, m.pres, m.t
    # dt and 1/dt as the step gives them: device scalars
    one, zero = (torch.full((), x, dtype=m.dtype, device=s["u"].device)
                 for x in (1., 0.))
    rhs = gl.rhs(s["u"], s["v"], s["w"], one)
    p = pr.solve(rhs)
    spec = torch.fft.rfft2(p, dim=(-2, -1))
    fb, n = field_bytes(m), points(m)
    sb = spec.numel() * spec.element_size()
    modes = spec.shape[1] * spec.shape[2]
    # a real 2-D transform of N points: 2.5 N log2 N operations
    dft_flops = 2.5 * n * np.log2(ctx.jtot * ctx.itot)

    def lib_fwd():
        return torch.fft.rfft2(rhs, dim=(-2, -1))

    def lib_inv():
        # irfft2 copies its input itself (a c2r transform overwrites it)
        return torch.fft.irfft2(spec, s=p.shape[-2:], dim=(-2, -1))

    form = pr.dft_form(ctx.jtot, ctx.itot, m.dtype)
    fwd, inv = pr.dft_kernels(m.dtype)
    info = {"form": form.form, "C": form.C, "F": form.F,
            "smem_per_cta": form.smem}
    dft = {
        fwd.name: pair(lambda: pr.rfft2(rhs), lib_fwd, fb + sb, dft_flops,
                       lib_fwd, info=dict(info, registers=REGISTERS.get(
                           DFT_ENTRIES[fwd.name], {}))),
        inv.name: pair(lambda: pr.irfft2(spec, ctx.itot), lib_inv, fb + sb,
                       dft_flops, lib_inv, info=dict(info, registers=(
                           REGISTERS.get(DFT_ENTRIES[inv.name], {}))))}
    if m.unfolded:
        # K21, K3's launch in place on K5's spectrum: the spectrum read and
        # written once, the pivots read once
        dft["tdma_ri"] = pair(
            lambda: pr.tdma_ri(spec),
            lambda: tdma_plain(spec, pr.winv, pr.tab), 5 * sb // 2,
            FLOPS_PER_POINT["tdma"] * n,
            info=tdma_info(pr, ctx.ktot, modes, m.dtype))
        return dft
    return dict(dft, **{
        "pres_rhs": pair(lambda: gl.rhs(s["u"], s["v"], s["w"], one),
                         lambda: F.pres_rhs_plain(s["u"], s["v"], s["w"], gl.pc,
                                                  ctx.ks, ctx.dxi, ctx.dyi, 1.),
                         4 * fb, FLOPS_PER_POINT["pres_rhs"] * n),
        # the spectrum read and written once, the pivots read once
        "tdma": pair(lambda: pr.tdma(spec),
                     lambda: tdma_plain(spec, pr.winv, pr.tab), 5 * sb // 2,
                     FLOPS_PER_POINT["tdma"] * n,
                     info=tdma_info(pr, ctx.ktot, modes, m.dtype)),
        "pres_apply": pair(lambda: gl.apply(p, s, t, zero, 0.0, True),
                           lambda: F.pres_apply_plain(p, s, t, gl.pc, ctx.ks,
                                                      ctx.dxi, ctx.dyi, 0.0,
                                                      0.0, True),
                           13 * fb, FLOPS_PER_POINT["pres_apply"] * n,
                           info=kmarch_info(gl.k_apply, m.dtype, 1, 0,
                                            gl.apply_plan(m.dtype, True))),
    })


def time_kernels(torch, m, s):
    """The kernels of a dry RK-folded model and their plain versions at its
    shapes: K22 and, timed in the same call so that the two forms can be
    compared, the three kernels it stands in for (K1, K2, K4 rhs)."""
    from microhh_torch.ops import fused as F
    ctx, fz = m.ctx, m.fused
    nf = len(fz.prognostic)
    uvwa = [s["u"], s["v"], s["w"], s["th"] if fz.has_thermo else s["u"]]
    e = fz.evisc(*uvwa)
    se_row = (F.surface_evisc_row(fz.smag, ctx, s, m.final_sfc, fz.has_thermo)
              if fz.smag.surface else None)
    t = m.t
    grid_args = (ctx.ks, ctx.dxi, ctx.dyi)
    rk = (fz.visc, fz.svisc, fz.tPr, 0.5, -5. / 9.)
    # cB*dt and 1/(cB*dt) as the step gives them: device scalars
    cbdt, dti = (torch.full((), x, dtype=m.dtype, device=s["u"].device)
                 for x in (0.5, 2.))
    fb, n = field_bytes(m), points(m)
    pairs = {
        "evisc": pair(lambda: fz.evisc(*uvwa),
                      lambda: F.evisc_plain(*uvwa, fz.ce, *grid_args, fz.tPr,
                                            fz.has_thermo),
                      (nf + 1) * fb, FLOPS_PER_POINT["evisc"] * n,
                      info=kmarch_info(fz.k_evisc, m.dtype, fz.stratified, 0,
                                       fz.evisc_plan(m.dtype,
                                                     fz.stratified))),
        "tend_rk": pair(lambda: fz.tend_rk(s, t, e, cbdt, -5. / 9., False,
                                           True),
                        lambda: F.tend_rk_plain(s, e, t, fz.ct, *grid_args,
                                                *rk, False, True,
                                                *fz._sweep_args()),
                        (4 * nf + 1) * fb, FLOPS_PER_POINT["tend_rk"] * n,
                        info=kmarch_info(fz.k_tend, m.dtype, 0,
                                         int(fz.has_thermo),
                                         fz.tend_rk_plan(m.dtype))),
        # fields and carries in, s*, carries, e and rhs out
        "tend_rk_fold": pair(
            lambda: fz.tend_rk_fold(s, t, se_row, cbdt, -5. / 9., dti, False,
                                    True),
            lambda: F.tend_rk_fold_plain(s, t, fz.ct, fz.ce, *grid_args, *rk,
                                         2., False, True, se_row, None,
                                         *fz._sweep_args()),
            (4 * nf + 2) * fb, FLOPS_PER_POINT["tend_rk_fold"] * n,
            info=kmarch_info(fz.k_tend_fold, m.dtype, int(fz.has_thermo), 0,
                             fz.fold_plan(m.dtype))),
        # the same sweep without the evisc fold: e read instead of written
        "tend_rk_fold_e": pair(
            lambda: fz.tend_rk_fold(s, t, None, cbdt, -5. / 9., dti, False,
                                    True, e=e),
            lambda: F.tend_rk_fold_plain(s, t, fz.ct, fz.ce, *grid_args, *rk,
                                         2., False, True, None, e,
                                         *fz._sweep_args()),
            (4 * nf + 2) * fb, FLOPS_PER_POINT["tend_rk"] * n),
        "limits": pair(lambda: fz.limits(*uvwa),
                       lambda: F.limits_plain(*uvwa, fz.ce, *grid_args, fz.tPr,
                                              fz.has_thermo),
                       nf * fb, FLOPS_PER_POINT["limits"] * n,
                       info=kmarch_info(fz.k_limits, m.dtype, fz.stratified,
                                        0, fz.limits_plan(m.dtype,
                                                          fz.stratified))),
    }
    pairs.update(pres_pairs(torch, m, s))
    out = time_pairs(torch, pairs)
    for a_t in t.values():      # a step expects the carry at zero
        a_t.zero_()
    return out


def forms_agree(torch, label, build, n, k, step_kws, state_of, tol):
    """Two steps of one case in two forms of the step from the same state,
    float32 on the card: every field within tol of its maximum (float32
    roundoff through two steps; w, which starts at rest, is the loosest)."""
    ends = []
    for kw in step_kws:
        m = build(torch, n, k, torch.float32, "cuda")
        m.build_step(**kw)
        s, sfc = m.as_device_state(state_of(m))
        for _ in range(2):
            s, sfc, _ = m.step(s, sfc, m.timeloop.dt)
        ends.append((m, s))
    (m, a), (_, b) = ends
    ks, ke = m.ctx.ks, m.ctx.ke
    errs = {nm: rel_err(a[nm][ks:ke], b[nm][ks:ke]) for nm in a}
    log("  %s %s float32, 2 steps, %s against %s: rel err %s"
        % (label, shape_str(m), step_kws[0] or "default", step_kws[1],
           {nm: "%.2e" % v for nm, v in errs.items()}))
    if not max(errs.values()) <= tol:
        raise AssertionError("the two forms of the %s step disagree" % label)
    return errs


# --------------------------------------------------------------------------
#  phases 7 to 12: the generic path's LES runs (rico, rico 2i5, SBL_Smag)
# --------------------------------------------------------------------------

def step_times(torch, m, s, sfc, n=12, warm=2):
    """Host wall times of n - warm steps after warm warm-up steps, each
    between two synchronisations; returns (times, s, sfc)."""
    dt = m.timeloop.dt
    times = []
    for it in range(n):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s, sfc, _ = m.step(s, sfc, dt)
        torch.cuda.synchronize()
        if it >= warm:
            times.append(time.perf_counter() - t1)
    return times, s, sfc


def run_les(torch, workdir, label, build, n, nonneg=(), k=None,
            dtype=None, div_tol=1e-4, p_floor=False, after_run=None,
            state_of=None, step_kw=None):
    """init + Model.run(max_iters=12) of a case at n^3 (or n = (itot, jtot)
    and k levels) through the entry points a user calls; fails unless every
    kernel of the path was launched, the fields are finite, DIV <= div_tol
    after the first step and the nonneg fields are >= 0.  Then the step
    time and the peak memory.  p_floor: hold DIV to 16 times what one
    rounding of p to the run's type leaves, eps |p| dzhi4 dzi4 dt, where
    that is above div_tol (a 4th-order case on finely stretched levels;
    three substeps a step each leave such a residue).  after_run(m, s): a
    further check of the state the run returned.  state_of(m): the initial
    state to save instead of Fields.create's (a case that sets its profiles
    itself); step_kw: arguments of build_step (another form of the step)."""
    dtype = dtype or torch.float32
    k = k or n
    init = build(torch, n, k, dtype, "cuda", "init", workdir)
    init.save_initial_state(state_of(init) if state_of else None)
    del init
    m = build(torch, n, k, dtype, "cuda", "run", workdir)
    m.build_step(**(step_kw or {}))
    where = "%s %s %s" % (label, shape_str(m), str(dtype)[6:])
    for kern in m.kernels():
        kern.launches = 0
    reads = getattr(m.thermo, "reads", None)
    if reads is not None:
        reads.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = m.run(max_iters=12)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in m.kernels()}
    syncs = dict(reads or {})
    peak = torch.cuda.max_memory_allocated()
    log("  Model.run(max_iters=12) at %s: %.3f s wall, launches %s, host "
        "reads %s" % (where, run_s, launches, syncs))
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        raise AssertionError("%s did not launch %s" % (label, missing))
    ks, ke = m.ctx.ks, m.ctx.ke
    for name in m.fields.prognostic_names:
        if not bool(torch.isfinite(s[name][ks:ke]).all()):
            raise AssertionError("non-finite %s after the %s run" % (name, label))
    mins = {name: float(s[name][ks:ke].min()) for name in nonneg}
    with open(os.path.join(workdir, "%s.out" % m.casename)) as f:
        rows = [line.split() for line in f if line.split()[0].isdigit()]
    final = {kk: float(v) for kk, v in m.diagnostics(s, m.final_sfc).items()}
    # the row of iteration 0 holds the divergence of the case's random
    # initial velocities, which no projection has seen yet
    divs = [float(r[6]) for r in rows if int(r[0]) > 0] + [final["div"]]
    if p_floor:
        _, _, aux = m.step(s, m.final_sfc, m.timeloop.dt)
        floor = (torch.finfo(dtype).eps * float(aux["p"].abs().max())
                 * float(m.ctx.dzhi4[ks:ke + 1].max())
                 * float(m.ctx.dzi4[ks:ke].max()) * m.timeloop.dt)
        log("  DIV floor of one rounding of p to %s: %.3e (max |p| %.3e)"
            % (str(dtype)[6:], floor, float(aux["p"].abs().max())))
        div_tol = max(div_tol, 16. * floor)
    log("  status rows %d, max DIV after the first step %.3e (limit %.3e), "
        "final DIV %.3e, TKE %.6e, dt %.4e s, minima %s"
        % (len(rows), max(divs), div_tol, final["div"], final["tke"],
           m.timeloop.dt, mins))
    if not (len(rows) >= 1 and max(divs) <= div_tol
            and np.isfinite(final["tke"])):
        raise AssertionError("%s divergence or status check failed" % label)
    if mins and min(mins.values()) < 0.:
        raise AssertionError("negative %s after the limiter" % mins)
    if after_run is not None:
        after_run(m, s)
    times, s, sfc = step_times(torch, m, s, m.final_sfc)
    step_s = statistics.median(times)
    log("  s/step %s: median %.6f (min %.6f, max %.6f) of 10; "
        "peak memory %.3f GB" % (where, step_s, min(times), max(times),
                                 peak / 1e9))
    m.final_sfc = sfc
    return m, s, {"launches": launches, "host_reads_run12": syncs,
                  "step_s_median": step_s, "peak_mem_gb": peak / 1e9,
                  "run12_wall_s": run_s, "div_max": max(divs),
                  "div_limit": div_tol,
                  "cell_updates_per_s": points(m) / step_s}


def check_plume(m, s):
    """The co2 of the jaenschwalde run: not below -1e-6 of its maximum (the
    flux limiter holds it), and its inventory, the integral of co2 rho /
    xmair over the domain, grown from zero at the nine sources' rate: the
    sum of their strengths in kmol/s times the run's time (in 12 steps
    nothing has reached an open edge)."""
    import torch
    from microhh_torch import constants as cst
    g, ctx = m.grid, m.ctx
    ks, ke = ctx.ks, ctx.ke
    co2 = s["co2"][ks:ke].double()
    w = torch.as_tensor(m.fields.rhoref[ks:ke] / cst.xmair * g.dz[ks:ke]
                        * g.dx * g.dy, device=co2.device)[:, None, None]
    inventory = float((co2 * w).sum())
    want = sum(m.source.strength) * m.timeloop.time
    lo, hi = float(co2.min()), float(co2.max())
    log("  co2 inventory %.6e kmol after %.3f s, the sources gave %.6e "
        "(ratio %.6f); co2 min %.3e, max %.3e"
        % (inventory, m.timeloop.time, want, inventory / want, lo, hi))
    if not abs(inventory / want - 1.) <= 1e-3:
        raise AssertionError("the co2 inventory does not follow the sources")
    if not lo >= -1e-6 * hi:
        raise AssertionError("co2 undershoots: min %.3e, max %.3e" % (lo, hi))


def time_pairs(torch, pairs, plain_reps=3):
    """name -> {ms, plain_ms, bound_ms, bound_by, library_ms}: kernel and
    plain version timed in turns, the bound from this run's shapes."""
    out = {}
    for name, pr in pairs.items():
        kern, plain = pr["kern"], pr["plain"]
        # plain, kernel, kernel, plain: both measured twice, in turns
        p1 = time_call(torch, plain, plain_reps)
        k1 = time_call(torch, kern, 10)
        k2 = time_call(torch, kern, 10)
        p2 = time_call(torch, plain, plain_reps)
        lib = time_call(torch, pr["lib"], 5) if pr["lib"] else None
        by_bytes = 1e3 * pr["bytes"] / PEAK_BYTES_S
        by_ops = 1e3 * pr["flops"] / pr["peak_flops"]
        ms = min(k1, k2)
        out[name] = {"ms": ms, "plain_ms": min(p1, p2),
                     "bound_ms": max(by_bytes, by_ops),
                     "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                     "library_ms": lib, "gbytes": pr["bytes"] / 1e9,
                     "gb_s": pr["bytes"] / ms / 1e6,
                     "bound_share": max(by_bytes, by_ops) / ms}
        out[name].update(pr["info"])
        log("  %-14s kernel %.3f ms  plain %.3f ms  bound %.3f ms (%s, %.2f GB)"
            "  library %s  (runs %.3f/%.3f, %.3f/%.3f)%s"
            % (name, ms, out[name]["plain_ms"],
               out[name]["bound_ms"], out[name]["bound_by"],
               pr["bytes"] / 1e9, "none" if lib is None else "%.3f ms" % lib,
               k1, k2, p1, p2,
               "  %.0f GB/s, %.1f%% of the bound %s"
               % (out[name]["gb_s"], 100 * out[name]["bound_share"],
                  pr["info"]) if pr["info"] else ""))
        torch.cuda.empty_cache()
    return out


def time_generic_kernels(torch, m, s):
    """A generic path's kernels and their plain versions at its shapes."""
    from microhh_torch.ops import advec_interp_fused as A
    from microhh_torch.ops import fused as F
    from microhh_torch.ops.microphys import MICRO_FIELDS, Microphys2momWarm
    ctx, fz, mic, adv = m.ctx, m.fused, m.micro, m.advec_fused
    sfc = m.final_sfc
    s = m.boundary.set_ghost_cells(ctx, s, sfc)
    e = F.generic_viscosity(fz, ctx, s, sfc, {})["evisc"]
    if not m.unfolded:
        ct, cts = F.generic_col_tables(fz, ctx, s, m.force, m.buffer)
    t = m.t
    uvw = [s[n] for n in ("u", "v", "w")]
    args = (ctx.ks, ctx.dxi, ctx.dyi, fz.tPr)
    fb, n = field_bytes(m), points(m)
    S = len(fz.names)
    can = -5. / 9.
    pairs = {}
    if fz.stratified == 2:
        n2 = m.thermo.get_n2(ctx, s).contiguous()
        pairs["evisc_n2"] = pair(
            lambda: fz.evisc_n2(*uvw, n2),
            lambda: F.evisc_plain(*uvw, None, fz.ce, *args, True, True, n2),
            5 * fb, FLOPS_PER_POINT["evisc_n2"] * n,
            info=kmarch_info(fz.k_evisc, m.dtype, 2, 0,
                             fz.evisc_plan(m.dtype, 2)))
        lim = uvw + [n2]
        lim_plain = uvw + [None, fz.ce, *args, True, True, n2]
    else:
        uvwa = uvw + [s[fz.n2_scalar]]
        pairs["evisc"] = pair(
            lambda: fz.evisc(*uvwa),
            lambda: F.evisc_plain(*uvwa, fz.ce, *args, True, True),
            5 * fb, FLOPS_PER_POINT["evisc"] * n,
            info=kmarch_info(fz.k_evisc, m.dtype, 1, 0,
                             fz.evisc_plan(m.dtype, 1)))
        lim = uvwa
        lim_plain = uvwa + [fz.ce, *args, True, True]
    if isinstance(mic, Microphys2momWarm):
        pref, exnref, _, _ = m.thermo._p_profiles(ctx, {})
        ql = m.thermo.get_ql(ctx, s)
        tm = {nm: torch.zeros_like(s[nm]) for nm in MICRO_FIELDS}
        pairs["micro2"] = pair(
            lambda: mic.micro2(ctx, s, tm, ql, pref, exnref, 2.),
            lambda: mic.apply_plain(ctx, s, tm, ql, pref, exnref, 2.),
            13 * fb, FLOPS_PER_POINT["micro2"] * n)
    if adv is not None:
        tuvw = [t[nm] for nm in ("u", "v", "w")]
        a, ta = [s[nm] for nm in fz.names], [t[nm] for nm in fz.names]
        pairs["advec_mom"] = pair(
            lambda: adv.momentum(*uvw, *tuvw),
            lambda: A.momentum_plain(adv.scheme, *uvw, *tuvw, adv.table(),
                                     ctx.ks, ctx.dxi, ctx.dyi),
            9 * fb, FLOPS_PER_POINT["advec_mom"] * n,
            info=kmarch_info(adv.k_mom, m.dtype, A.SCHEME_ID[adv.scheme], 0,
                             adv.mom_plan(m.dtype)))
        S1 = min(S, A.max_scalars(m.dtype))
        pairs["advec_scalars"] = pair(
            lambda: adv.scalars(*uvw, a, ta),
            lambda: A.scalars_plain(adv.scheme, *uvw, a, ta, adv.table(),
                                    ctx.ks, ctx.dxi, ctx.dyi),
            (3 + 3 * S) * fb, FLOPS_PER_POINT["advec_scalars"] * S * n,
            info=kmarch_info(adv.k_scal, m.dtype, A.SCHEME_ID[adv.scheme], S1,
                             adv.plan(S1, m.dtype)))
    if m.unfolded:
        pairs.update(unfolded_sweep_pairs(m, s, e))
    else:
        pairs.update(rk_sweep_pairs(m, s, e, ct, cts, can))
    pairs["limits"] = pair(lambda: fz.limits(*lim),
                           lambda: F.limits_plain(*lim_plain), 4 * fb,
                           FLOPS_PER_POINT["limits"] * n,
                           info=kmarch_info(fz.k_limits, m.dtype,
                                            fz.stratified, 0,
                                            fz.limits_plan(m.dtype,
                                                           fz.stratified)))
    pairs.update(pres_pairs(torch, m, s))
    out = time_pairs(torch, pairs)
    if m.unfolded:
        # K18-K20 have added onto the carry, which a step expects at zero
        for a_t in t.values():
            a_t.zero_()
    return out


def unfolded_sweep_pairs(m, s, e):
    """K18 and K19 (every scalar in one launch of up to four) or K20 at a
    model's shapes: ten fields, e + 3 S (+ u, v, w with advection) and
    thirteen, the carries read and written."""
    from microhh_torch.ops import fused as F
    from microhh_torch.ops import kmarch
    ctx, fz, t = m.ctx, m.fused, m.t
    fb, n = field_bytes(m), points(m)
    grid_args = (ctx.ks, ctx.dxi, ctx.dyi)
    if not m.generic:
        # u, v, w, (th,) e read, the carries read and written
        return {"tendencies": pair(
            lambda: fz.tendencies(s, t, e),
            lambda: F.tendencies_plain(s, e, t, fz.ct, *grid_args, fz.visc,
                                       fz.svisc, fz.tPr, fz.fc, ctx.utrans,
                                       ctx.vtrans, fz.coriolis,
                                       fz.has_thermo),
            (3 * len(fz.prognostic) + 1) * fb,
            FLOPS_PER_POINT["tendencies"] * n,
            info=kmarch_info(fz.k_tendencies, m.dtype, 0, int(fz.has_thermo),
                             fz.tendencies_plan(m.dtype)))}
    S = len(fz.names)
    S1 = min(S, kmarch.SW_MAXS)
    return {
        "tend_uvw_acc": pair(
            lambda: fz.tend_uvw_acc(s, t, e),
            lambda: F.tend_uvw_acc_plain(s, e, t, fz.ct_static, *grid_args,
                                         fz.visc, fz.fc, ctx.utrans,
                                         ctx.vtrans, fz.fold_force, fz.advec),
            10 * fb, FLOPS_PER_POINT["tend_uvw_acc"] * n,
            info=kmarch_info(fz.k_uvw_acc, m.dtype, 0, 0,
                             fz.uvw_plan(m.dtype, True))),
        "tend_scalar_acc": pair(
            lambda: fz.tend_scalars_acc(s, t, e),
            lambda: F.tend_scalars_acc_plain(s, fz.names, e, t, fz.ct_static,
                                             fz.sviscs, *grid_args, fz.tPr,
                                             fz.advec),
            (1 + 3 * S + (3 if fz.advec else 0)) * fb,
            FLOPS_PER_POINT["tend_scalar_acc"] * S * n,
            info=kmarch_info(fz.k_scalar_acc, m.dtype, int(fz.advec), S1,
                             fz.plan("tend_scalar_acc", S1, m.dtype)))}


def rk_sweep_pairs(m, s, e, ct, cts, can):
    """K8/K9 and K10 or K15 at a generic model's shapes; K10 reads e, the
    scalars and their carries (and u, v, w with advection) and writes s*
    and the carries."""
    from microhh_torch.ops import fused as F
    from microhh_torch.ops import kmarch
    ctx, fz, t = m.ctx, m.fused, m.t
    fb, n = field_bytes(m), points(m)
    S = len(fz.names)
    S1 = min(S, kmarch.SW_MAXS)
    pairs = {}
    pairs["tend_uvw"] = pair(
        lambda: fz.tend_uvw(s, t, e, ct, 0.5, can, True),
        lambda: F.tend_uvw_plain(s, e, t, ct, ctx.ks, ctx.dxi, ctx.dyi,
                                 fz.visc, fz.fc, ctx.utrans, ctx.vtrans, 0.5,
                                 can, fz.coriolis, True, fz.advec),
        13 * fb, FLOPS_PER_POINT["tend_uvw"] * n,
        info=kmarch_info(fz.k_uvw, m.dtype, 0, 0, fz.uvw_plan(m.dtype)))
    # e, each scalar and its carry read, s* and the carry written (and u,
    # v, w read with advection); K15 in a case of one scalar
    kern = fz.k_scalar if S == 1 else fz.k_scalars
    pairs[kern.name] = pair(
        lambda: fz.tend_scalars(s, t, e, cts, 0.5, can, True),
        lambda: F.tend_scalars_plain(
            s, fz.names, e, t, cts, fz.sviscs, ctx.ks, ctx.dxi, ctx.dyi,
            fz.tPr, 0.5, can, True, fz.advec),
        (1 + 4 * S + (3 if fz.advec else 0)) * fb,
        FLOPS_PER_POINT[kern.name] * S * n,
        info=kmarch_info(kern, m.dtype, int(fz.advec), S1,
                         fz.plan("tend_scalars", S1, m.dtype)))
    return pairs


def time_o4_kernels(torch, m, s, plain_reps):
    """K16 and K17 and their plain versions at a 4th-order path's shapes,
    on the run's own state under its two ghost types."""
    from microhh_torch.ops.boundary import w_cons
    ctx, o4, t = m.ctx, m.o4, m.t
    s = m.boundary.set_ghost_cells(ctx, s, m.final_sfc)
    u, v, wd = s["u"], s["v"], s["w"]
    wc = w_cons(ctx, wd)
    names = list(ctx.scalar_names)
    a, ta = [s[nm] for nm in names], [t[nm] for nm in names]
    tuvw = [t[nm] for nm in ("u", "v", "w")]
    fb, n, S = field_bytes(m), points(m), len(names)
    peak = PEAK_FLOPS if m.dtype == torch.float32 else PEAK_FLOPS_F64
    from microhh_torch.ops.o4_fused import SCHEME_ID
    pairs = {"o4_mom": pair(
        lambda: o4.momentum(u, v, wc, wd, *tuvw),
        lambda: o4.momentum_plain(u, v, wc, wd, *tuvw), 10 * fb,
        FLOPS_PER_POINT["o4_mom"][o4.scheme] * n, peak_flops=peak,
        info=kmarch_info(o4.k_mom, m.dtype, SCHEME_ID[o4.scheme], 0,
                         o4.plan(m.dtype)))}
    if names:
        from microhh_torch.ops.o4_fused import max_scalars
        S1 = min(S, max_scalars(m.dtype))
        pairs["o4_scalars"] = pair(
            lambda: o4.scalars(u, v, wc, names, a, ta),
            lambda: o4.scalars_plain(u, v, wc, names, a, ta),
            (3 + 3 * S) * fb, FLOPS_PER_POINT["o4_scalars"][o4.scheme] * S * n,
            peak_flops=peak,
            info=kmarch_info(o4.k_scal, m.dtype, SCHEME_ID[o4.scheme], S1,
                             o4.scalar_plan(S1, m.dtype)))
    out = time_pairs(torch, pairs, plain_reps)
    for a_t in t.values():
        a_t.zero_()
    return out


def time_pres4_parts(torch, m, s):
    """The pres_4 solve by its parts, ms: library calls (cuFFT, cuBLAS), not
    kernels of the port; timed on the run's own right-hand side."""
    from microhh_torch.ops.boundary import w_cons
    ctx, pr = m.ctx, m.pres
    s = m.boundary.set_ghost_cells(ctx, s, m.final_sfc)
    sc = dict(s, w=w_cons(ctx, s["w"]))
    rhs = pr.input(ctx, sc, m.t, 1. / m.timeloop.dt)
    p_hat = torch.fft.rfft2(rhs, dim=(-2, -1))
    x = pr.solve_eigen(p_hat)
    kmax, jtot, nf = p_hat.shape
    parts = {
        "input": time_call(torch, lambda: pr.input(ctx, sc, m.t, 1. / m.timeloop.dt), 5),
        "rfft2": time_call(torch, lambda: torch.fft.rfft2(rhs, dim=(-2, -1)), 5),
        "products": time_call(torch, lambda: pr.solve_eigen(p_hat), 5),
        "irfft2": time_call(torch, lambda: torch.fft.irfft2(
            x, s=rhs.shape[-2:], dim=(-2, -1)), 5),
        "solve": time_call(torch, lambda: pr.solve(rhs), 5),
        "exec": time_call(torch, lambda: pr.exec(ctx, sc, m.t, {}, m.timeloop.dt), 5),
    }
    flops = 2 * 2. * kmax * kmax * jtot * nf * 2
    log("  pres_4 at %s by parts, ms: %s; the two products %.3e operations, "
        "%.1f TFLOP/s; allow_tf32 %s"
        % (shape_str(m), ", ".join("%s %.3f" % kv for kv in parts.items()),
           flops, flops / parts["products"] / 1e9,
           torch.backends.cuda.matmul.allow_tf32))
    for a_t in m.t.values():
        a_t.zero_()
    parts["products_flops"] = flops
    return parts


# --------------------------------------------------------------------------
#  last phase (--profile): where the step's device time goes
# --------------------------------------------------------------------------

# kernel-name pattern -> part of the step; the first match counts (K18 is
# the instance of K8/K9's kernel without the RK fold, K20 its instances
# with the DRY flag, K2 those with both; K10 and K19 the scalar
# sweep's instances with and without it, K15 its RK instances at one scalar,
# which no main path launches as K10; K3 both its forms, and K21, K3's
# launch on the substep without the RK fold, where K3 does not run)
PARTS = [("evisc_kernel", "K1/K14 evisc"),
         (r"tend_uvw_kernel<\w+, *(true|\(bool\)1), *(true|\(bool\)1)",
          "K2 tend_rk"),
         ("tend_rk_fold_kernel", "K22 tend_rk_fold"),
         (r"tend_uvw_kernel<\w+, *(false|\(bool\)0), *(true|\(bool\)1)",
          "K20 tendencies"),
         (r"tend_uvw_kernel<\w+, *(false|\(bool\)0)", "K18 tend_uvw_acc"),
         (r"scalar_sweep_kernel<\w+, *(false|\(bool\)0)",
          "K19 tend_scalar_acc"),
         (r"scalar_sweep_kernel<\w+, *(true|\(bool\)1), *\w+, *1\b",
          "K15 tend_scalar_rk"),
         (r"scalar_sweep_kernel<\w+, *(true|\(bool\)1)", "K10 tend_scalars"),
         ("micro2_kernel", "K11 micro2"),
         ("advec_mom_kernel", "K12 advec_mom"),
         ("advec_scalars_kernel", "K13 advec_scalars"),
         ("o4_mom_kernel", "K16 o4_mom"),
         ("o4_scalars_kernel", "K17 o4_scalars"),
         ("gemm", "pres_4 k-axis products (library)"),
         ("fft", "pres_4 transforms (library)"),
         ("tend_uvw_kernel", "K8/K9 tend_uvw"),
         ("limits_", "K7 limits"),
         ("pres_rhs_kernel", "K4 pres_rhs"),
         ("dft_fwd_cluster", "K5 dft_fwd (cluster form)"),
         ("dft_inv_cluster", "K6 dft_inv (cluster form)"),
         ("dft_r2c_x", "K5 dft_fwd_split (i pass)"),
         ("dft_c2c_y", "K5/K6 split (j passes)"),
         (r"tdma_(scan_)?kernel", "K3 tdma (K21 without the RK fold)"),
         ("dft_c2r_x", "K6 dft_inv_split (i pass)"),
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


def profile_steps(torch, m, s, label, nsteps=2):
    """Device time by part over nsteps profiled steps; returns the report
    lines and the profiler's table."""
    from torch.profiler import profile, ProfilerActivity
    sfc, dt = m.final_sfc, m.timeloop.dt
    reads = getattr(m.thermo, "reads", {})
    state = {"s": s, "sfc": sfc}

    def steps():
        for _ in range(nsteps):
            state["s"], state["sfc"], _ = m.step(state["s"], state["sfc"], dt)

    plain_wall, _ = wall_and_device(torch, steps, 2)
    reads0 = sum(reads.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    parts = {lb: 0. for _, lb in PARTS}
    other, other_n = 0., 0
    for evt in avgs:
        us = device_us(evt)
        if us <= 0.:
            continue
        lb = next((lb for frag, lb in PARTS if re.search(frag, evt.key)),
                  None)
        if lb is None:
            other += us
            other_n += evt.count
        else:
            parts[lb] += us
    busy_ms = (sum(parts.values()) + other) / 1e3
    if busy_ms <= 0.:
        raise RuntimeError("the profiler recorded no device time")
    lines = ["%d steps of %s %s %s, card: %s"
             % (nsteps, label, shape_str(m), str(m.dtype)[6:], card_line()),
             "profiled wall %.3f ms/step, device busy %.3f ms/step, device "
             "idle share %.3f (same profiled steps); unprofiled wall %.3f "
             "ms/step; host reads of device values in the moist glue %.1f "
             "per step (%s since the run began)"
             % (wall_ms / nsteps, busy_ms / nsteps, 1. - busy_ms / wall_ms,
                plain_wall / nsteps,
                (sum(reads.values()) - reads0) / nsteps, dict(reads)),
             "%-28s %10s %7s" % ("part", "ms/step", "share")]
    for lb, us in list(parts.items()) + [
            ("other (%d device ops)" % (other_n // nsteps), other)]:
        if us > 0.:
            lines.append("%-28s %10.3f %7.3f" % (lb, us / 1e3 / nsteps,
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
    for line in lines:
        log("  " + line)
    return lines, avgs.table(sort_by=sort, row_limit=40)


def kernel_entry(k, launches, errs, times, where):
    e = {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": errs[k.name], "shape": where}
    e.update({key: times[k.name][key] for key in
              ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    # K5, K6 and K3: their form and its resources; the k-marching kernels:
    # their k-march
    e.update({key: times[k.name][key] for key in
              ("form", "C", "F", "L", "threads", "smem_per_cta", "registers",
               "local_bytes", "smem_per_block", "blocks_per_sm", "chunks",
               "blocks", "waves")
              if key in times[k.name]})
    return e


def main():
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from microhh_torch import kernels
    except ImportError as e:
        sys.exit("chip_smoke: microhh_torch is not beside this script (%s)" % e)
    args = sys.argv[1:]
    profile_path = drift_path = None
    if args:
        if len(args) != 2 or args[0] not in ("--profile", "--drift"):
            sys.exit("usage: chip_smoke.py [--profile FILE | --drift FILE]")
        if args[0] == "--profile":
            profile_path = args[1]
        else:
            drift_path = args[1]
    reports = []

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
        if ("Compiling entry" in line or "registers" in line or "spill" in line
                or line.startswith("== ")):
            log("    " + line.strip())
    if drift_path:
        log("[drift] the chunked loop on the card, captured and eager, "
            "against the CPU over a long run")
        chunked_drift(torch, drift_path)
        return

    regs, spills = registers_of(build_log)
    REGISTERS.update(regs)
    log("    registers by kernel function: %s" % REGISTERS)
    log("    instances with local memory (spills, stack): %s" % spills)

    log("[3] kernels against their plain versions")
    log("[3a] K5 and K6 in both forms against torch.fft, K3 in every form")
    check_dft(torch)
    check_tdma(torch)
    check_kernels(torch)
    log("[3b] K16, K17, K12, K13, the scalar sweep K10/K19, the momentum "
        "sweep K8/K9/K18, K22, K20, K1/K14, K7, K2 and K4 apply with the "
        "k-split forced")
    check_kmarch(torch)
    log("[3c] K11 at ring depths 3, 4 and 8, columns shorter than, equal to "
        "and not a multiple of its window")
    check_micro2(torch)

    log("[3d] K1, K14 and K7 near strain2 = N2/tPr, float32 against the "
        "float64 plain version, held to rounding times the condition number")
    critical = check_evisc_critical(torch)

    log("[4] whole step, card against CPU")
    check_step(torch)

    log("[4b] statistics and budgets through run_case, card against CPU")
    results = {"stats": check_stats(torch)}
    log("[4c] the statistics' sample time")
    results["stats_sample_ms"] = time_stats(torch)
    log("[4d] the chunked loop, captured: its graphs against the eager body, "
        "and the card against the CPU")
    chunk_checks = {}
    for dtype in (torch.float32, torch.float64):
        err, _ = graph_against_eager(torch, 64, dtype)
        chunk_checks["graph_vs_eager_64_%s" % str(dtype)[6:]] = err
    chunk_checks["card_vs_cpu_32_f64"] = chunked_card_against_cpu(torch)
    steps, chunks = chunked_captured_against_eager(torch)
    chunk_checks["captured_vs_eager_32_f64"] = {"steps": steps,
                                                "chunks": chunks}
    results["chunked"] = {"checks": chunk_checks}
    results["evisc_critical"] = {k: {"cond_max": c, "err_over_bound": r}
                                 for k, (c, r) in critical.items()}
    entries = {}
    by_path = {}

    def record(m, s, key, result_key, label, res, errs, times, where):
        """Keep a path's results: the kernels' entries (first path wins),
        their times at this path's shapes, its launches, and its profile."""
        for kern in m.kernels():
            if kern.name not in entries:
                entries[kern.name] = kernel_entry(kern, res["launches"], errs,
                                                  times, where)
        res["kernels"] = {
            kern.name: dict(times[kern.name],
                            launches=res["launches"][kern.name],
                            max_abs_err=errs[kern.name])
            for kern in m.kernels()}
        # kernels timed at these shapes that this path did not launch (the
        # three that K22 stands in for, for a comparison within one call)
        mine = {kern.name for kern in m.kernels()}
        res["also_timed"] = {name: tm for name, tm in times.items()
                             if name not in mine}
        by_path[key] = res.pop("launches")
        results[result_key] = res
        if profile_path:
            log("[p] profile of two %s steps" % where)
            reports.append(profile_steps(torch, m, s, label))

    def dry_path(phase, key, label, build, n, k, state_of=None, step_kw=None,
                 first=False, chunked=None):
        """A dry-path case through Model.run, then its kernels against
        their plain versions at its shapes and timed: the RK-folded forms
        through kernel_cases and time_kernels, the substep without the RK
        fold through generic_kernel_cases and time_generic_kernels.
        chunked: the arguments of chunked_run, which runs the case from the
        same restart through the captured chunked loop first ([4d])."""
        log("[%s] %s %dx%dx%d float32 through Model.run%s"
            % (phase[0], label, n[0], n[1], k,
               " (build_step(%s))" % step_kw if step_kw else ""))
        with tempfile.TemporaryDirectory() as workdir:
            m, s, res = run_les(torch, workdir, label, build, n, k=k,
                                state_of=state_of, step_kw=step_kw)
            if chunked is not None:
                log("[4d] %s %dx%dx%d float32 through Model.run(), the "
                    "chunked loop captured" % (label, n[0], n[1], k))
                res_c, replayed = chunked_run(torch, m, label,
                                              step_kw=step_kw, **chunked)
                results.setdefault("chunked", {})[key] = res_c
                by_path[key + "_chunked"] = replayed
            where = "%s %s float32" % (label, shape_str(m))
            log("[%s] kernels at %s: against their plain versions, then "
                "timed" % (phase[1], where))
            if m.unfolded:
                errs = check_kernels_full(torch, m, generic_kernel_cases)
            else:
                errs = check_kernels_full(torch, m, kernel_cases)
            if m.fused.k_evisc in m.kernels():
                errs["evisc"] = max(errs["evisc"],
                                    check_evisc_forced(torch, m))
            if m.unfolded:
                errs["tendencies"] = max(errs["tendencies"],
                                         check_dry_forced(torch, m))
            else:
                errs["pres_apply"] = max(errs["pres_apply"],
                                         check_apply_forced(torch, m))
            if m.fused.k_tend in m.kernels():
                errs["tend_rk"] = max(errs["tend_rk"],
                                      check_rk_forced(torch, m))
            errs["limits"] = max(errs["limits"], check_limits_forced(torch, m))
            times = (time_generic_kernels if m.unfolded else time_kernels)(
                torch, m, s)
            if first:
                res["kernel_build_s"] = build_s
            record(m, s, key, key, label, res, errs, times, where)
        torch.cuda.empty_cache()

    # A: the main path on K22, then its K1 -> K2 -> K4 rhs form at 256^3
    dry_path((5, 6), "drycblles_512_f32", "drycblles", build_drycblles,
             (512, 512), 512, state_of=initial_state, first=True,
             chunked={"endtime": 15, "outputiter": 8, "min_steps": 24,
                      "per_step": True,
                      "state_of": lambda m: initial_state(m, 17)})
    dry_path(("5b", "6b"), "drycblles_256_unfused_f32", "drycblles",
             build_drycblles, (256, 256), 256, state_of=initial_state,
             step_kw={"fold": False},
             chunked={"endtime": 15, "outputiter": 8, "min_steps": 8,
                      "state_of": lambda m: initial_state(m, 17)})

    def build_rico_2i5(*a):
        return build_rico(*a, swadvec="2i5")

    phase = 7
    for key, label, build, n, nonneg in (
            ("rico_384", "rico", build_rico, 384, ("qt", "qr", "nr")),
            ("rico2i5_384", "rico 2i5", build_rico_2i5, 384,
             ("qt", "qr", "nr")),
            ("sbl_256", "SBL_Smag", build_sbl, 256, ())):
        log("[%d] %s %d^3 float32 through Model.run" % (phase, label, n))
        with tempfile.TemporaryDirectory() as workdir:
            m, s, res = run_les(torch, workdir, label, build, n, nonneg)
            log("[%d] kernels at %s %d^3 float32: against their plain "
                "versions, then timed" % (phase + 1, label, n))
            errs = check_kernels_full(torch, m, generic_kernel_cases)
            if m.advec_fused is not None:
                errs["advec_mom"] = max(errs["advec_mom"],
                                        check_mom_forced(torch, m))
            errs["tend_uvw"] = max(errs["tend_uvw"],
                                   check_uvw_forced(torch, m))
            if len(m.fused.names) == 1:
                errs["tend_scalar_rk"] = max(errs["tend_scalar_rk"],
                                             check_scalar_rk_forced(torch, m))
            if key != "rico2i5_384":
                ev = "evisc_n2" if m.fused.stratified == 2 else "evisc"
                errs[ev] = max(errs[ev], check_evisc_forced(torch, m))
                errs["pres_apply"] = max(errs["pres_apply"],
                                         check_apply_forced(torch, m))
            errs["limits"] = max(errs["limits"], check_limits_forced(torch, m))
            times = time_generic_kernels(torch, m, s)
            record(m, s, key, key + "_f32", label, res, errs, times,
                   "%s %d^3 float32" % (label, n))
            del m, s
        torch.cuda.empty_cache()
        phase += 2

    for key, label, build, n, k, dtype, kw, plain_reps in (
            ("weakscaling_512x256x1024_f32", "weakscaling", build_weakscaling,
             (512, 256), 1024, torch.float32, {"p_floor": True}, 1),
            ("moser180_256x192x128_f64", "moser180", build_moser,
             (256, 192), 128, torch.float64, {"div_tol": 1e-10}, 3)):
        log("[%d] %s %dx%dx%d %s through Model.run"
            % (phase, label, n[0], n[1], k, str(dtype)[6:]))
        with tempfile.TemporaryDirectory() as workdir:
            m, s, res = run_les(torch, workdir, label, build, n, k=k,
                                dtype=dtype, **kw)
            where = "%s %s %s" % (label, shape_str(m), str(dtype)[6:])
            log("[%d] kernels at %s: against their plain versions, then "
                "timed" % (phase + 1, where))
            errs = check_kernels_full(torch, m, o4_kernel_cases)
            times = time_o4_kernels(torch, m, s, plain_reps)
            res["pres_4_ms"] = time_pres4_parts(torch, m, s)
            record(m, s, key, key, label, res, errs, times, where)
            del m, s
        torch.cuda.empty_cache()
        phase += 2

    log("[%d] jaenschwalde 1024x256x256 float32 through Model.run" % phase)
    with tempfile.TemporaryDirectory() as workdir:
        key, label = "jaenschwalde_1024x256x256_f32", "jaenschwalde"
        m, s, res = run_les(torch, workdir, label, build_jaenschwalde,
                            (1024, 256), k=256, nonneg=("qt",),
                            after_run=check_plume)
        where = "%s %s float32" % (label, shape_str(m))
        log("[%d] kernels at %s: against their plain versions, then timed"
            % (phase + 1, where))
        errs = check_kernels_full(torch, m, generic_kernel_cases)
        errs["advec_mom"] = max(errs["advec_mom"], check_mom_forced(torch, m))
        errs["tend_uvw_acc"] = max(errs["tend_uvw_acc"],
                                   check_uvw_forced(torch, m))
        errs["evisc"] = max(errs["evisc"], check_evisc_forced(torch, m))
        errs["limits"] = max(errs["limits"], check_limits_forced(torch, m))
        times = time_generic_kernels(torch, m, s)
        record(m, s, key, key, label, res, errs, times, where)
        del m, s
    torch.cuda.empty_cache()

    # B: sullivan2011 on the RK path (K22 with the sponge and Coriolis
    # folds), then its substep without the RK fold on a thinner grid (K20,
    # K21 and K1, K7 in their ghost mode), and the two forms held together
    dry_path((19, 20), "sullivan2011_512_f32", "sullivan2011", build_sullivan,
             (512, 512), 512,
             chunked={"endtime": 20, "outputiter": 8, "min_steps": 8})
    dry_path(("19b", "20b"), "sullivan2011_512x512x64_unfolded_f32",
             "sullivan2011", build_sullivan, (512, 512), 64,
             step_kw={"unfolded": True})
    results["sullivan2011_forms_rel_err"] = forms_agree(
        torch, "sullivan2011", build_sullivan, (512, 512), 64,
        ({}, {"unfolded": True}), lambda m: unfolded_state(m, 7), 1e-3)

    # C: the neutral Ekman LES (thermo 0, no scalar) at 5.2 m isotropic
    dry_path((21, 22), "andren1994_768x384x288_f32", "andren1994 less s",
             build_andren, (768, 384), 288,
             chunked={"endtime": 24, "outputiter": 8, "min_steps": 8})

    if profile_path:
        os.makedirs(os.path.dirname(os.path.abspath(profile_path)),
                    exist_ok=True)
        with open(profile_path, "w") as f:
            for lines, table in reports:
                f.write("\n".join(lines) + "\n\n" + table + "\n\n")
        log("  full tables: %s" % profile_path)

    for name, e in entries.items():
        e["launches_by_path"] = {key: lc.get(name, 0)
                                 for key, lc in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
    log("chip_smoke: %.1f s in all" % (time.perf_counter() - started))
    log(json.dumps(results))
    log("card: %s" % card_line())
    log(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
