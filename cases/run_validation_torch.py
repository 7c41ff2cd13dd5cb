"""Physics-validation envelopes of the PyTorch port (``microhh_torch``), the
drycblles and bomex legs of ``cases/run_validation.py`` with the same
grids, lengths and checks:

* drycblles - CBL growth: zi(t) rises and tracks the encroachment
              prediction zi = sqrt(zi(1)^2 + 2*wth_s*(t - t(1))/gamma).
* bomex     - GCSS shallow cumulus (Siebesma et al. 2003): cloud cover,
              cloud base and top from the mean ql profile.

Each leg runs the case's ini with the grid, endtime, savetime and
sampletime replaced, init + run through ``microhh_torch.model.run_case``
in this process, its input profiles computed in memory
(``microhh_torch.cases``), on the first CUDA device or with ``--device
cpu`` on the CPU; then it reads the statistics file (either format,
``microhh_torch.stats.open_stats``).  An ini option the run leaves unused
fails the leg.  Exit status is nonzero on any failed check.

Usage:
  python cases/run_validation_torch.py [--cases drycblles,bomex] [--quick]
      [--device cuda|cpu] [--precision single|double] [--workdir DIR]
"""

import argparse
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FAILURES = []


def check(name, val, lo, hi):
    ok = lo <= val <= hi
    print("  %-38s %12.4g  in [%g, %g]  %s"
          % (name, val, lo, hi, "ok" if ok else "FAIL"), flush=True)
    if not ok:
        FAILURES.append(name)


def run_case(case, overrides, args):
    """The case's ini with overrides, init + run on the port; returns the
    statistics file, open."""
    import torch
    from microhh_torch import model
    from microhh_torch.cases import case_input
    from microhh_torch.config import Ini
    from microhh_torch.stats import open_stats
    wd = os.path.join(args.workdir, case)
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    with open(os.path.join(REPO, "cases", case, "%s.ini" % case)) as f:
        ini = f.read()
    for key, val in overrides.items():
        ini, n = re.subn(r"(?m)^%s=\S*" % key, "%s=%s" % (key, val), ini)
        if n == 0:
            raise RuntimeError("%s: override %s not found in ini" % (case, key))
    path = os.path.join(wd, "%s.ini" % case)
    with open(path, "w") as f:
        f.write(ini)
    grid = Ini(path)
    mem = case_input(case, grid.get_int("grid", "ktot"),
                     grid.get_float("grid", "zsize"))
    dtype = torch.float64 if args.precision == "double" else torch.float32
    for mode in ("init", "run"):
        t0 = time.perf_counter()
        m = model.run_case(wd, case, mode, dtype=dtype, device=args.device,
                           input_nc=mem)
        print("+ %s %s on %s, %s: %.1f s, %d iterations"
              % (mode, case, args.device, args.precision,
                 time.perf_counter() - t0, m.timeloop.iteration), flush=True)
        unused = m.ini.unused_items()
        if unused:
            FAILURES.append("%s/%s: unused ini options %s"
                            % (case, mode, unused))
            print("  FAIL (unused ini options): %s" % unused)
    return open_stats(os.path.join(wd, "%s.default.0000000.nc" % case))


def _prof(group, name, tavg=1):
    a = np.asarray(group.variables[name][:])
    return a[-tavg:].mean(axis=0)


def validate_drycblles(args):
    itot = 32 if args.quick else 64
    endtime = 1800. if args.quick else 3600.
    f = run_case("drycblles",
                 {"itot": itot, "jtot": itot, "ktot": itot,
                  "endtime": "%g" % endtime, "savetime": "%g" % endtime,
                  "sampletime": "60."}, args)
    t = np.asarray(f.variables["time"][:])
    zi = np.asarray(f.groups["thermo"].variables["zi"][:])
    f.close()

    # encroachment with drycblles' surface flux sbot[th]=0.1 K m/s and
    # lapse rate 0.003 K/m (drycblles_input.py), from the second sample
    f0, gamma = 0.1, 0.003
    zi_pred = np.sqrt(zi[1] ** 2 + 2. * f0 * (t[-1] - t[1]) / gamma)
    print("drycblles: zi(0)=%.0f m -> zi(end)=%.0f m; zi(%g s)=%.0f m, "
          "encroachment from it %.0f m" % (zi[0], zi[-1], t[1], zi[1],
                                           zi_pred))
    check("zi grows", float(zi[-1] - zi[len(zi) // 4]), 1., 1e9)
    rt = 0.45 if args.quick else 0.30
    check("zi vs encroachment", float(zi[-1]),
          (1 - rt) * zi_pred, (1 + rt) * zi_pred)


def validate_bomex(args):
    itot = 32 if args.quick else 64
    ktot = 32 if args.quick else 48
    endtime = 3600. if args.quick else 7200.
    f = run_case("bomex",
                 {"itot": itot, "jtot": itot, "ktot": ktot,
                  "endtime": "%g" % endtime, "savetime": "%g" % endtime,
                  "sampletime": "60."}, args)
    thermo = f.groups["thermo"]
    z = np.asarray(f.variables["z"][:])
    navg = max(1, int(endtime / 60. / 4))      # final quarter of samples
    cover = np.asarray(thermo.variables["ql_cover"][:])[-navg:].mean()
    ql = _prof(thermo, "ql", navg)
    f.close()

    cloudy = np.where(ql > 1e-7)[0]
    base = z[cloudy[0]] if cloudy.size else np.nan
    top = z[cloudy[-1]] if cloudy.size else np.nan
    print("bomex: cover=%.3f base=%.0f m top=%.0f m" % (cover, base, top))
    if args.quick:
        check("cloud cover", float(cover), 0.01, 0.45)
        check("cloud base [m]", float(base), 200., 1000.)
    else:
        check("cloud cover", float(cover), 0.04, 0.30)
        check("cloud base [m]", float(base), 300., 800.)
        check("cloud top [m]", float(top), 1200., 2200.)


LEGS = {"drycblles": validate_drycblles, "bomex": validate_bomex}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="drycblles,bomex")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--precision", choices=["single", "double"],
                    default="single")
    ap.add_argument("--workdir", default=None,
                    help="kept after the run; by default a temporary "
                         "directory, removed")
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("run_validation_torch: no CUDA device (--device cpu runs "
                 "on the CPU)")
    tmp = None
    if args.workdir is None:
        tmp = args.workdir = tempfile.mkdtemp(prefix="mh_torch_val_")
    try:
        for case in args.cases.split(","):
            print("\n=== %s ===" % case, flush=True)
            LEGS[case](args)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if FAILURES:
        print("\nVALIDATION FAILED: %s" % ", ".join(FAILURES))
        return 1
    print("\nVALIDATION PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
