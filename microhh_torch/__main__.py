"""CLI: ``python -m microhh_torch {init,run,post} casename`` (reference
``main/microhh.cxx``; mirrors ``microhh_tpu/__main__.py``).  The model runs
on the first CUDA device; ``--device cpu`` runs the plain-torch versions of
the kernels on the CPU.  ``--memory-input`` computes the case's input
profiles in memory (``cases.case_input``) instead of reading
``<case>_input.nc``, for a machine without h5py."""

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser(prog="microhh_torch")
    p.add_argument("mode", choices=["init", "run", "post"])
    p.add_argument("casename")
    p.add_argument("--precision", choices=["single", "double"], default="single")
    p.add_argument("--dir", default=".")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--memory-input", action="store_true")
    args = p.parse_args(argv)
    dtype = torch.float64 if args.precision == "double" else torch.float32

    from .model import run_case
    input_nc = None
    if args.memory_input:
        import os
        from .cases import case_input
        from .config import Ini
        ini = Ini(os.path.join(args.dir, "%s.ini" % args.casename))
        input_nc = case_input(args.casename, ini.get_int("grid", "ktot"),
                              ini.get_float("grid", "zsize"))
    run_case(args.dir, args.casename, args.mode, dtype=dtype,
             device=args.device, input_nc=input_nc)


if __name__ == "__main__":
    main()
