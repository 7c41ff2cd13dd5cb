"""Physics-validation envelopes of the PyTorch port (``microhh_torch``), the
drycblles, bomex, gabls1 and sbl_dnn legs of ``cases/run_validation.py``
with the same grids, lengths and checks, and the taylorgreen and
conservation checks of ``tests/test_taylorgreen.py`` and
``tests/test_conservation.py``:

* drycblles - CBL growth: zi(t) rises and tracks the encroachment
              prediction zi = sqrt(zi(1)^2 + 2*wth_s*(t - t(1))/gamma).
* bomex     - GCSS shallow cumulus (Siebesma et al. 2003): cloud cover,
              cloud base and top from the mean ql profile.
* gabls1    - Beare et al. (2006) SBL under its surface cooling of 0.25
              K/h (the th_sbot series, taken every step on the per-step
              loop): cooled surface air and stable stratification at any
              length, and from 7 h on the supergeostrophic low-level jet.
* sbl_dnn   - the stable Ekman layer of SBL_DNN with the DNN closure, its
              weights a TorchScript export (``models/dnn.py``, the
              reference's CNDNN layout, seeded random filters drawn as the
              JAX leg draws them) read through the run's dnnpath: stable
              stratification, Ekman turning, a near-wall u deficit and
              bounded winds in the final state.
* taylorgreen - the ini as written (128x1x64) to t = 1: its TKE equals
              0.25 exp(-16 pi^2 visc) within 1e-3; at 16x8, 32x16 and
              64x32 the L1 errors of u and w against the analytic vortex
              fall at order > 1.7, both < 5e-4 on the finest grid.
* ekman     - the laminar Ekman spiral as written (4x4x64, the 4th-order
              Coriolis term) to t = 30 s, float64: the mean (u, v)
              profiles' rms distance from the analytic spiral (delta =
              sqrt(2 visc / fc)) beside the JAX package's own run's
              (``cases/ekman_jax_reference.json``, written by
              ``cases/ekman_jax_reference.py``), the port's profiles within
              1e-6 of that run's.
* conservation - the ini as written (32^3, advec 2, no diffusion) with RK3
              and RK4 at dt 2 and 1: the TKE drift shrinks more than 4x
              when dt halves, RK4 drifts less than RK3, and the momentum
              drift stays below 0.02 of the velocity scale.  Both of these
              legs hold a discretisation's order: run them with
              ``--precision double``.

Each leg runs the case's ini with the grid, endtime, savetime and
sampletime replaced, init + run through ``microhh_torch.model.run_case``
in this process, its input profiles computed in memory
(``microhh_torch.cases``), on the first CUDA device or with ``--device
cpu`` on the CPU; then it reads the statistics file (either format,
``microhh_torch.stats.open_stats``).  An ini option the run leaves unused
fails the leg.  Exit status is nonzero on any failed check.

Usage:
  python cases/run_validation_torch.py
      [--cases drycblles,bomex,gabls1,sbl_dnn,taylorgreen,conservation,ekman]
      [--quick]
      [--device cuda|cpu] [--precision single|double] [--workdir DIR]
"""

import argparse
import json
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


def run_case(case, overrides, args, name=None, stats=True, label=None,
             unused_ok=()):
    """The case's ini (``cases/<case>/<name or case>.ini``) with overrides,
    init + run on the port in ``<workdir>/<label or case>``; returns the
    statistics file, open (stats False: the run's directory).  unused_ok:
    (section, item) pairs the case's ini sets and no run reads (the JAX
    package leaves them unused too)."""
    import torch
    from microhh_torch import model
    from microhh_torch.cases import case_input
    from microhh_torch.config import Ini
    from microhh_torch.stats import open_stats
    wd = os.path.join(args.workdir, label or case)
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    name = name or case
    with open(os.path.join(REPO, "cases", case, "%s.ini" % name)) as f:
        ini = f.read()
    for key, val in overrides.items():
        ini, n = re.subn(r"(?m)^%s=\S*" % key, "%s=%s" % (key, val), ini)
        if n == 0:
            raise RuntimeError("%s: override %s not found in ini" % (case, key))
    path = os.path.join(wd, "%s.ini" % name)
    with open(path, "w") as f:
        f.write(ini)
    grid = Ini(path)
    mem = case_input(name, grid.get_int("grid", "ktot"),
                     grid.get_float("grid", "zsize"))
    dtype = torch.float64 if args.precision == "double" else torch.float32
    for mode in ("init", "run"):
        t0 = time.perf_counter()
        m = model.run_case(wd, name, mode, dtype=dtype, device=args.device,
                           input_nc=mem)
        print("+ %s %s on %s, %s: %.1f s, %d iterations"
              % (mode, case, args.device, args.precision,
                 time.perf_counter() - t0, m.timeloop.iteration), flush=True)
        unused = [u for u in m.ini.unused_items()
                  if (u[0], u[1]) not in set(unused_ok)]
        if unused:
            FAILURES.append("%s/%s: unused ini options %s"
                            % (case, mode, unused))
            print("  FAIL (unused ini options): %s" % unused)
    if not stats:
        return wd
    return open_stats(os.path.join(wd, "%s.default.0000000.nc" % name))


def final_state(wd, name, iotime, args):
    """(model on the CPU in float64, the restart state at iotime as
    tensors) of a run's directory."""
    import torch
    from microhh_torch.cases import case_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    ini = Ini(os.path.join(wd, "%s.ini" % name))
    m = Model(ini, "run", name, workdir=wd, dtype=torch.float64, device="cpu",
              input_nc=case_input(name, ini.get_int("grid", "ktot"),
                                  ini.get_float("grid", "zsize")))
    m.finish_setup()
    st = m.fields.load(iotime, wd, dtype=np.float64 if args.precision ==
                       "double" else np.float32)
    return m, {n: m.ctx.tensor(a) for n, a in st.items()}


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


def validate_gabls1(args):
    itot = 32 if args.quick else 64
    endtime = 3600. if args.quick else 32400.
    f = run_case("gabls1",
                 {"itot": itot, "jtot": itot, "ktot": itot,
                  "endtime": "%g" % endtime, "savetime": "%g" % endtime,
                  "sampletime": "600."}, args)
    grp = f.groups["default"]
    z = np.asarray(f.variables["z"][:])
    u = _prof(grp, "u")
    v = _prof(grp, "v")
    th = _prof(grp, "th")
    f.close()

    ug = 8.0                       # GABLS1 geostrophic wind
    wind = np.hypot(u, v)
    jet = float(wind.max())
    zjet = float(z[int(np.argmax(wind))])
    print("gabls1: jet=%.2f m/s at %.0f m; th(sfc air)=%.2f K"
          % (jet, zjet, th[0]))
    # stability holds at any length: cooled surface air, positive lapse
    check("surface-air cooling [K]", float(265. - th[0]), 0.05, 6.)
    check("stable stratification", float(np.mean(np.diff(th[:len(th) // 2])
                                                 > -1e-3)), 0.75, 1.)
    if endtime >= 7 * 3600.:
        # Beare et al. (2006): a supergeostrophic jet near the top of the
        # boundary layer (130-180 m at 3.1 m resolution, lower when coarser)
        check("LLJ supergeostrophic ratio", jet / ug, 1.02, 1.25)
        check("LLJ height [m]", zjet, 60., 250.)


def validate_sbl_dnn(args):
    """SBL_DNN with the DNN closure end to end (cases/run_validation.py
    validate_sbl_dnn): a TorchScript export of seeded random filters at the
    reference's scale goes through the run's dnnpath (swdnnrandom=0) and
    drives the whole closure inside the run; the final state, read from
    the restart files, must keep stable stratification, Ekman turning and
    winds bounded by the geostrophic forcing."""
    from microhh_torch.cases import case_input
    from microhh_torch.config import Ini
    from microhh_torch.model import Model
    from microhh_torch.models.dnn import export_torchscript, random_filters
    os.makedirs(args.workdir, exist_ok=True)
    pt = os.path.join(args.workdir, "sbl_dnn_weights.pt")
    export_torchscript(pt, random_filters(7))
    itot = 16 if args.quick else 32
    ktot = 32 if args.quick else 64
    endtime = 100. if args.quick else 400.
    run_case("SBL_DNN",
             {"itot": itot, "jtot": itot, "ktot": ktot,
              "endtime": "%g" % endtime, "savetime": "%g" % endtime,
              "sampletime": "%g" % (endtime / 2),
              "dnnpath": pt, "swdnnrandom": "0"}, args, name="SBL").close()

    # the final state from the restart files (iotimeprec=-1: time * 10)
    wd = os.path.join(args.workdir, "SBL_DNN")
    ini = Ini(os.path.join(wd, "SBL.ini"))
    m = Model(ini, "run", "SBL", workdir=wd, device="cpu",
              input_nc=case_input("SBL", ktot, ini.get_float("grid", "zsize")))
    st = m.fields.load(int(round(endtime * 10)), wd,
                       dtype=np.float64 if args.precision == "double"
                       else np.float32)
    g = m.grid
    ks, ke = g.kstart, g.kend
    u = np.asarray(st["u"])[ks:ke].mean(axis=(1, 2))
    v = np.asarray(st["v"])[ks:ke].mean(axis=(1, 2))
    b = np.asarray(st["b"])[ks:ke].mean(axis=(1, 2))
    for n in ("u", "v", "w", "b"):
        if not np.isfinite(np.asarray(st[n])).all():
            FAILURES.append("SBL_DNN: non-finite %s" % n)
    ug = 0.05
    print("SBL_DNN: u(sfc)=%.4f v(sfc)=%.5f ug=%.2f" % (u[0], v[0], ug))
    check("stable stratification fraction",
          float(np.mean(np.diff(b) > -1e-9)), 0.9, 1.)
    check("Ekman cross-isobar v (near sfc) [m/s]",
          float(v[:ktot // 8].mean()), 1e-6, 0.05)
    check("near-wall u deficit [m/s]", float(ug - u[0]), 1e-5, 0.05)
    check("max |u|/ug", float(np.abs(u).max() / ug), 0.2, 2.0)


def taylorgreen_errors(m, s, time=1.):
    """The L1 errors of u and w against the analytic decaying vortex at
    time (tests/test_taylorgreen.py error_uw), with the run's viscosity."""
    g = m.grid
    ks, ke = g.kstart, g.kend
    decay = np.exp(-8. * np.pi ** 2 * m.fields.visc * time)
    u_ref = (np.sin(2 * np.pi * g.xh)[None, :]
             * np.cos(2 * np.pi * g.z[ks:ke])[:, None] * decay)
    w_ref = (-np.cos(2 * np.pi * g.x)[None, :]
             * np.sin(2 * np.pi * g.zh[ks:ke])[:, None] * decay)
    u = s["u"].numpy()[ks:ke, 0, :]
    w = s["w"].numpy()[ks:ke, 0, :]
    cell = g.xsize / g.itot * g.zsize / g.ktot
    return (float(np.sum(cell * np.abs(u - u_ref))),
            float(np.sum(cell * np.abs(w - w_ref))))


def validate_taylorgreen(args):
    """taylorgreen as written to t = 1: TKE against its analytic decay;
    then the 2nd-order convergence of u and w on three grids."""
    wd = run_case("taylorgreen", {}, args, stats=False)
    m, s = final_state(wd, "taylorgreen", 1, args)
    tke = float(m.diagnostics(s, {})["tke"])
    want = 0.25 * np.exp(-16. * np.pi ** 2 * m.fields.visc)
    print("taylorgreen 128x1x64: TKE(t=1) %.7f, 0.25 exp(-16 pi^2 visc) "
          "%.7f" % (tke, want))
    check("TKE(t=1) relative to its decay", tke / want, 1. - 1e-3, 1. + 1e-3)
    out = {"tke": tke, "tke_analytic": want, "errors": {}}
    errs = {}
    for itot, ktot in ((16, 8), (32, 16), (64, 32)):
        wd = run_case("taylorgreen", {"itot": itot, "ktot": ktot}, args,
                      stats=False, label="taylorgreen_%d" % itot)
        errs[itot] = taylorgreen_errors(*final_state(wd, "taylorgreen", 1,
                                                     args))
        out["errors"]["%dx%d" % (itot, ktot)] = errs[itot]
    order = [float(np.log(errs[16][i] / errs[64][i]) / np.log(4.))
             for i in (0, 1)]
    print("taylorgreen: L1 errors of (u, w) %s, orders %.3f, %.3f"
          % (errs, order[0], order[1]))
    check("u error at 64x32", errs[64][0], 0., 5e-4)
    check("w error at 64x32", errs[64][1], 0., 5e-4)
    check("convergence order of u", order[0], 1.7, 1e9)
    check("convergence order of w", order[1], 1.7, 1e9)
    out["orders"] = order
    return out


def validate_conservation(args):
    """conservation as written with RK3 and RK4 at dt 2 and 1
    (tests/test_conservation.py): the TKE drift over the run from the
    status table."""
    drift, outs = {}, {}
    for rk in (3, 4):
        for dt in (2.0, 1.0):
            wd = run_case("conservation",
                          {"rkorder": rk, "dt": dt, "dtmax": dt}, args,
                          stats=False,
                          label="conservation_rk%d_dt%g" % (rk, dt))
            out = np.loadtxt(os.path.join(wd, "conservation.out"),
                             skiprows=1)
            outs[rk, dt] = out
            tke = out[:, 8]
            drift[rk, dt] = abs(tke[-1] - tke[1]) / tke[1]
    print("conservation: TKE drift %s" % {"rk%d dt=%g" % k: "%.3e" % v
                                          for k, v in drift.items()})
    check("RK3 drift ratio dt 2 / dt 1", drift[3, 2.] / drift[3, 1.], 4.,
          1e9)
    check("RK4 drift ratio dt 2 / dt 1", drift[4, 2.] / drift[4, 1.], 4.,
          1e9)
    check("RK3 / RK4 drift at dt 2", drift[3, 2.] / drift[4, 2.], 1., 1e9)
    mom = outs[3, 2.][:, 7]
    scale = np.sqrt(2 * outs[3, 2.][1, 8])
    check("momentum drift / velocity scale", abs(mom[-1] - mom[0]) / scale,
          0., 0.02)
    return {"drift": {"rk%d_dt%g" % k: float(v) for k, v in drift.items()},
            "momentum_drift_over_scale": float(abs(mom[-1] - mom[0])
                                               / scale)}


# the JAX package's own run of ekman as written, float64 on the CPU
# (cases/ekman_jax_reference.py writes it)
EKMAN_JAX = os.path.join(REPO, "cases", "ekman_jax_reference.json")


def ekman_spiral(z, fc, visc, ug=1.):
    """The laminar Ekman spiral under a geostrophic wind (ug, 0) over a
    no-slip wall: u = ug (1 - e^(-z/d) cos(z/d)), v = ug e^(-z/d) sin(z/d),
    d = sqrt(2 visc / fc)."""
    d = np.sqrt(2. * visc / fc)
    return (ug * (1. - np.exp(-z / d) * np.cos(z / d)),
            ug * np.exp(-z / d) * np.sin(z / d))


def validate_ekman(args):
    """ekman as written (4x4x64, advec 4, diff 4, swlspres=geo with the
    4th-order Coriolis term, a translation (0.5, 0.15)) to its endtime of
    30 s: the horizontal means of u and v, translation added back, against
    the analytic spiral, beside the JAX package's own run
    (EKMAN_JAX), to whose profiles the port's are held within 1e-6."""
    from microhh_torch.config import Ini
    # the scalar options of the ini go unused in both packages: the case
    # has no scalar
    wd = run_case("ekman", {}, args, stats=False,
                  unused_ok={("boundary", "sbcbot"), ("boundary", "sbctop"),
                             ("boundary", "sbot"), ("boundary", "stop"),
                             ("fields", "svisc")})
    ini = Ini(os.path.join(wd, "ekman.ini"))
    fc = ini.get_float("force", "fc")
    visc = ini.get_float("fields", "visc")
    m, s = final_state(wd, "ekman", 3000, args)
    m.timeloop.load(3000, wd)
    g, ks, ke = m.grid, m.ctx.ks, m.ctx.ke
    z = np.asarray(g.z[ks:ke])
    u = s["u"][ks:ke].mean(dim=(1, 2)).numpy() + g.utrans
    v = s["v"][ks:ke].mean(dim=(1, 2)).numpy() + g.vtrans
    with open(EKMAN_JAX) as f:
        ref = json.load(f)
    ju, jv = np.asarray(ref["u"]), np.asarray(ref["v"])
    ua, va = ekman_spiral(z, fc, visc)

    def dist(a, b):
        return float(np.sqrt(np.mean((a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2)))

    d_port, d_jax = dist((u, v), (ua, va)), dist((ju, jv), (ua, va))
    d_pj = float(max(np.abs(u - ju).max(), np.abs(v - jv).max()))
    print("ekman 4x4x64 to t = %g s (delta = %.4f m): rms distance of the "
          "mean (u, v) from the analytic spiral: port %.6e, JAX package "
          "%.6e; port against JAX %.3e"
          % (m.timeloop.time, np.sqrt(2. * visc / fc), d_port, d_jax, d_pj))
    check("ekman time [s]", m.timeloop.time, ref["time"], ref["time"])
    check("ekman port vs JAX profiles", d_pj, 0., 1e-6)
    check("ekman rms distance from the spiral", d_port, 0., 0.05)
    return {"rms_from_spiral_port": d_port, "rms_from_spiral_jax": d_jax,
            "port_vs_jax_max": d_pj}


LEGS = {"drycblles": validate_drycblles, "bomex": validate_bomex,
        "gabls1": validate_gabls1, "sbl_dnn": validate_sbl_dnn,
        "taylorgreen": validate_taylorgreen,
        "conservation": validate_conservation, "ekman": validate_ekman}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="drycblles,bomex,gabls1,sbl_dnn")
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
