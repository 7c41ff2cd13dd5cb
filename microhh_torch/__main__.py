"""CLI: ``python -m microhh_torch {init,run} casename`` (reference
``main/microhh.cxx``; mirrors ``microhh_tpu/__main__.py``).  The model runs
on the first CUDA device; ``--device cpu`` runs the plain-torch versions of
the kernels on the CPU."""

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser(prog="microhh_torch")
    p.add_argument("mode", choices=["init", "run"])
    p.add_argument("casename")
    p.add_argument("--precision", choices=["single", "double"], default="single")
    p.add_argument("--dir", default=".")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    dtype = torch.float64 if args.precision == "double" else torch.float32

    from .model import run_case
    run_case(args.dir, args.casename, args.mode, dtype=dtype,
             device=args.device)


if __name__ == "__main__":
    main()
