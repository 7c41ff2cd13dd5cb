"""moser180 channel-flow budget validation of the PyTorch port
(``microhh_torch``) against the Moser, Kim & Mansour (1999) Re_tau=180 DNS
data in cases/moser180/chan180.*, with the arguments and checks of
``python/validate_moser180.py``:

  chan180 column   ->  budget profile
  produc               tke_shear
  dissip               tke_diss
  t-diff               tke_turb
  p-diff               tke_pres
  v-diff               tke_visc

The case runs at the requested resolution and length through
``microhh_torch.model.run_case`` in this process, its input computed in
memory (``microhh_torch.cases.moser180_input``), on the first CUDA device
or with ``--device cpu`` on the CPU; the budget profiles are averaged over
the second half of the samples.  Re_tau, the production peak, its height
and the dissipation at the wall are checked when the run covers the
spin-up (endtime >= 3600 s); the signs and the closure of the budget at any
length.  Exit status is nonzero when a check fails.

Usage:
  python python/validate_moser180_torch.py [--itot 64 --jtot 48 --ktot 64]
      [--endtime 900] [--device cuda|cpu] [--workdir DIR] [--rtol 0.5]
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE = os.path.join(REPO, "cases", "moser180")
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def load_chan(fname):
    rows = []
    for line in open(fname):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rows.append([float(x) for x in line.split()])
    return np.asarray(rows)


def run(args, wd):
    """The patched moser180 ini, init + run on the port."""
    import torch
    from microhh_torch.cases import moser180_input
    from microhh_torch.model import run_case
    ini = open(os.path.join(CASE, "moser180.ini")).read()
    repl = {"itot=256": "itot=%d" % args.itot,
            "jtot=192": "jtot=%d" % args.jtot,
            "ktot=128": "ktot=%d" % args.ktot,
            "endtime=7200.": "endtime=%g" % args.endtime,
            "savetime=1800.": "savetime=%g" % args.endtime,
            "sampletime=60.": "sampletime=%g" % args.sampletime}
    for a, b in repl.items():
        ini = ini.replace(a, b)
    with open(os.path.join(wd, "moser180.ini"), "w") as f:
        f.write(ini)
    dtype = torch.float64 if args.precision == "double" else torch.float32
    mem = moser180_input(args.ktot, 2.)
    for mode in ("init", "run"):
        t0 = time.perf_counter()
        m = run_case(wd, "moser180", mode, dtype=dtype, device=args.device,
                     input_nc=mem)
        print("+ %s moser180 %dx%dx%d on %s, %s: %.1f s, %d iterations"
              % (mode, args.itot, args.jtot, args.ktot, args.device,
                 args.precision, time.perf_counter() - t0,
                 m.timeloop.iteration), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--itot", type=int, default=64)
    ap.add_argument("--jtot", type=int, default=48)
    ap.add_argument("--ktot", type=int, default=64)
    ap.add_argument("--endtime", type=float, default=900.)
    ap.add_argument("--sampletime", type=float, default=30.)
    ap.add_argument("--workdir", default=None,
                    help="kept after the run; by default a temporary "
                         "directory, removed")
    ap.add_argument("--rtol", type=float, default=0.5,
                    help="relative tolerance on peak magnitudes")
    ap.add_argument("--retau-tol", type=float, default=0.10,
                    help="relative tolerance on Re_tau (armed with the "
                         "envelope checks, endtime >= 3600)")
    ap.add_argument("--precision", choices=["single", "double"],
                    default="double")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--analyze-only", action="store_true",
                    help="skip the simulation; analyze an existing "
                         "stats file in --workdir")
    args = ap.parse_args()
    import torch
    if (args.device == "cuda" and not args.analyze_only
            and not torch.cuda.is_available()):
        sys.exit("validate_moser180_torch: no CUDA device (--device cpu "
                 "runs on the CPU)")
    tmp = None
    if args.workdir is None:
        tmp = args.workdir = tempfile.mkdtemp(prefix="moser180_torch_")
    try:
        wd = args.workdir
        os.makedirs(wd, exist_ok=True)
        if not args.analyze_only:
            run(args, wd)
        return analyze(args, os.path.join(wd, "moser180.default.0000000.nc"))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def analyze(args, stats_path):
    from microhh_torch.stats import open_stats
    if not os.path.exists(stats_path):
        print("FAIL: no stats file written (enable [stats])")
        return 1
    f = open_stats(stats_path)
    bud = f.groups["budget"]
    z = np.asarray(f.variables["z"][:])

    def prof(name):
        # time-average the second half of the samples
        a = np.asarray(bud.variables[name][:])
        n = a.shape[0]
        return a[n // 2:].mean(axis=0)

    tke_shear = prof("tke_shear")
    tke_diss = prof("tke_diss")
    tke_turb = prof("tke_turb")
    tke_pres = prof("tke_pres")
    tke_visc = prof("tke_visc")
    u_prof = np.asarray(f.groups["default"].variables["u"][:])[-1]
    f.close()

    # channel budgets are symmetric about mid-channel: fold the two halves
    def fold(a):
        return 0.5 * (a + a[::-1])

    # wall units: u_tau from the wall shear of the mean profile (the case
    # drives a fixed uflux), averaged over the two walls of the symmetric
    # stretched grid
    visc = 1.e-5
    ref = load_chan(os.path.join(CASE, "chan180.kbal"))
    produc_ref, dissip_ref = ref[:, 3], ref[:, 2]
    zsize = z[0] + z[-1]
    dudz_wall = 0.5 * (abs(u_prof[0]) / z[0]
                       + abs(u_prof[-1]) / (zsize - z[-1]))
    utau = np.sqrt(visc * abs(dudz_wall))
    print("u_tau = %.5f (Re_tau = %.1f)" % (utau, utau * 1.0 / visc))
    norm = utau ** 4 / visc      # budget normalization

    failures = []

    def check(name, val, lo, hi):
        ok = lo <= val <= hi
        print("%-28s %12.4g  in [%g, %g]  %s"
              % (name, val, lo, hi, "ok" if ok else "FAIL"))
        if not ok:
            failures.append(name)

    rt = args.rtol
    if args.endtime >= 3600.:
        check("Re_tau", utau * 1.0 / visc,
              180. * (1. - args.retau_tol), 180. * (1. + args.retau_tol))
        shear_f = fold(tke_shear)
        diss_f = fold(tke_diss)
        shear_peak = shear_f.max() / norm
        ref_peak = produc_ref.max()
        check("tke production peak (+)", shear_peak,
              (1. - rt) * ref_peak, (1. + rt) * ref_peak)
        # an under-resolved DNS inflates the wall dissipation: 2x on the
        # high side below the full 256x192x128 resolution
        diss_hi = (1. + rt) if args.itot >= 256 else 2.
        diss_wall = -diss_f.min() / norm
        ref_dw = -dissip_ref.min()
        check("tke dissipation magnitude", diss_wall,
              (1. - rt) * ref_dw, diss_hi * ref_dw)
        zp = np.minimum(z, zsize - z) * utau / visc
        zp_peak = zp[np.argmax(shear_f)]
        check("production peak y+", zp_peak, 5., 30.)
    else:
        print("endtime %g < 3600 s: envelope checks skipped "
              "(spin-up incomplete); closure/sign checks only" % args.endtime)
    check("dissipation <= 0 everywhere", float((tke_diss <= 1e-12).all()),
          1., 1.)
    total = tke_shear + tke_diss + tke_turb + tke_pres + tke_visc
    interior = slice(4, len(z) - 4)
    resid = np.abs(total[interior]).max() / max(tke_shear.max(), 1e-30)
    check("stationary budget residual", resid, 0., 0.6)

    if failures:
        print("\nVALIDATION FAILED: %s" % ", ".join(failures))
        return 1
    print("\nVALIDATION PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
