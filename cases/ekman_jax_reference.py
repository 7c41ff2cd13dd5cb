"""The JAX package's own run of cases/ekman as written (4x4x64 to its
endtime of 30 s), in float64 on the CPU, as the reference of the ekman leg
of ``cases/run_validation_torch.py``: writes the horizontal means of u and v
(with the grid's translation added back) at the final time to
``cases/ekman_jax_reference.json``.

Usage (on a machine with the JAX package; the card's has none, so the leg
reads the file):
  python cases/ekman_jax_reference.py [--out FILE]
"""

import argparse
import json
import os
import runpy
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "cases", "ekman_jax_reference.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from microhh_tpu.config import Ini
    from microhh_tpu.model import Model, run_case
    wd = tempfile.mkdtemp(prefix="ekman_jax_")
    cwd = os.getcwd()
    try:
        shutil.copy(os.path.join(REPO, "cases", "ekman", "ekman.ini"), wd)
        os.chdir(wd)
        runpy.run_path(os.path.join(REPO, "cases", "ekman", "ekman_input.py"))
        for mode in ("init", "run"):
            run_case(wd, "ekman", mode, dtype=np.float64)
        m = Model(Ini(os.path.join(wd, "ekman.ini")), "run", "ekman",
                  workdir=wd, dtype=np.float64)
        tl = m.timeloop
        iotime = int(round(tl.endtime * 10 ** -tl.iotimeprec))
        tl.load(iotime, wd)
        st = m.fields.load(iotime, wd, dtype=np.float64)
        g = m.grid
        ks, ke = g.kstart, g.kend
        out = {"time": tl.time, "iteration": tl.iteration,
               "z": [float(x) for x in g.z[ks:ke]],
               "u": [float(x) for x in
                     st["u"][ks:ke].mean(axis=(1, 2)) + g.utrans],
               "v": [float(x) for x in
                     st["v"][ks:ke].mean(axis=(1, 2)) + g.vtrans]}
    finally:
        os.chdir(cwd)
        shutil.rmtree(wd, ignore_errors=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("ekman (JAX package, CPU, float64): t = %g s after %d iterations; "
          "wrote %s" % (out["time"], out["iteration"], args.out))


if __name__ == "__main__":
    main()
