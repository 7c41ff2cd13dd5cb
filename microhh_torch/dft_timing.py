"""Time the DFT pair K5/K6 (``ops/pres_2.py``, ``csrc/dft.cu``) on one card.

    python3 -m microhh_torch.dft_timing [--out FILE]

At the plane shapes and level counts of the cells that take ``pres_2``
(512^2 x 512, 384^2 x 384, 768x384 x 288, 1024x256 x 256, 256^2 x 256,
float32) it times, by CUDA events over 10 launches after one warm-up, in
turns (library, cluster, split, split, cluster, library; the better of each
pair): ``Pres2.rfft2`` and ``Pres2.irfft2`` in the form ``dft_form`` picks
(the cluster form at all five), the split form's entries called directly,
and ``torch.fft.rfft2`` / ``torch.fft.irfft2``; and one ``clone`` of the
spectrum alone.  A torch.profiler trace of the same launches splits each
transform's device time by kernel.  Prints one JSON object per shape and,
with --out, writes them all to FILE.  Needs a CUDA device.

Copied into an older checkout of the package, one from before K5/K6 had
two forms (no ``Pres2.dft_form``; K6 overwrote its input), it times what
that tree has: K5 and K6 in their one form, K6 on a fresh copy of the
spectrum each call, with the copy's own time beside so that K6 can be
stated net of it; the library calls in turns as above.
"""

import argparse
import json
import subprocess
import sys

import torch

from .config import Ini
from .fields import Fields
from .grid import Grid
from .ops.pres_2 import Pres2

# (itot, jtot, kt) of the cells that take pres_2
SHAPES = [(512, 512, 512), (384, 384, 384), (768, 384, 288),
          (1024, 256, 256), (256, 256, 256)]
REPS = 10
PEAK_BYTES_S = 3.35e12


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_pres(itot, jtot, kt):
    text = ("[grid]\nitot=%d\njtot=%d\nktot=%d\nxsize=1.\nysize=1.\n"
            "zsize=1.\nswspatialorder=2\n[fields]\nvisc=1e-5\n"
            % (itot, jtot, kt))
    g = Grid(Ini(text))
    return Pres2(Ini(text), g, Fields(Ini(text), g))


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


def in_turns(lib, a, b):
    """lib, a, b, b, a, lib: the better of each pair, ms."""
    l1, a1, b1 = events_ms(lib), events_ms(a), events_ms(b)
    b2, a2, l2 = events_ms(b), events_ms(a), events_ms(lib)
    return min(l1, l2), min(a1, a2), min(b1, b2)


def device_ms_by_kernel(fn, reps=REPS):
    """Device ms per call of every kernel fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        us = float(getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0.)))
        if us > 0.:
            out[evt.key[:80]] = us / 1e3 / reps
    return out


def time_shape_one_form(pr, itot, jtot, kt, dtype):
    """K5 and K6 of a tree with one DFT form, whose K6 overwrites its
    input (timed on a copy, the copy timed alone)."""
    gen = torch.Generator(device="cuda").manual_seed(itot + jtot)
    x = torch.randn((kt, jtot, itot), dtype=dtype, device="cuda",
                    generator=gen)
    spec = torch.fft.rfft2(x, dim=(-2, -1))
    nbytes = x.numel() * x.element_size() + spec.numel() * spec.element_size()

    def inv():
        return pr.irfft2(spec.clone(), itot)
    fwd_lib, k5, _ = in_turns(lambda: torch.fft.rfft2(x, dim=(-2, -1)),
                              lambda: pr.rfft2(x), lambda: None)
    inv_lib, k6, _ = in_turns(
        lambda: torch.fft.irfft2(spec, s=(jtot, itot), dim=(-2, -1)), inv,
        lambda: None)
    clone = events_ms(lambda: spec.clone())
    row = {"itot": itot, "jtot": jtot, "kt": kt, "dtype": str(dtype)[6:],
           "form": "one form (two passes)", "gbytes": nbytes / 1e9,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES_S,
           "k5_ms": k5, "rfft2_ms": fwd_lib, "k6_with_clone_ms": k6,
           "clone_ms": clone, "k6_ms": k6 - clone, "irfft2_ms": inv_lib,
           "k5_passes_ms": device_ms_by_kernel(lambda: pr.rfft2(x)),
           "k6_passes_ms": device_ms_by_kernel(inv),
           "k5_gb_s": nbytes / k5 / 1e6,
           "k6_gb_s": nbytes / (k6 - clone) / 1e6}
    del x, spec
    torch.cuda.empty_cache()
    return row


def time_shape(itot, jtot, kt, dtype=torch.float32):
    pr = make_pres(itot, jtot, kt)
    if not hasattr(pr, "dft_form"):
        return time_shape_one_form(pr, itot, jtot, kt, dtype)
    form = pr.dft_form(jtot, itot, dtype)
    gen = torch.Generator(device="cuda").manual_seed(itot + jtot)
    x = torch.randn((kt, jtot, itot), dtype=dtype, device="cuda",
                    generator=gen)
    spec = torch.fft.rfft2(x, dim=(-2, -1))
    y, w, out = torch.empty_like(spec), torch.empty_like(spec), torch.empty_like(x)
    nbytes = x.numel() * x.element_size() + spec.numel() * spec.element_size()

    def fwd_split():
        pr.k_dft_fwd_split(dtype, x, y, kt, jtot, itot)

    def inv_split():
        pr.k_dft_inv_split(dtype, spec, w, out, kt, jtot, itot)

    def fwd():
        return pr.rfft2(x)

    def inv():
        return pr.irfft2(spec, itot)
    fwd_lib, k5, k5_split = in_turns(
        lambda: torch.fft.rfft2(x, dim=(-2, -1)), fwd, fwd_split)
    inv_lib, k6, k6_split = in_turns(
        lambda: torch.fft.irfft2(spec, s=(jtot, itot), dim=(-2, -1)), inv,
        inv_split)
    row = {"itot": itot, "jtot": jtot, "kt": kt, "dtype": str(dtype)[6:],
           "form": form.form, "C": form.C, "F": form.F,
           "smem_per_cta": form.smem,
           "gbytes": nbytes / 1e9, "bound_ms": 1e3 * nbytes / PEAK_BYTES_S,
           "k5_ms": k5, "k5_split_ms": k5_split, "rfft2_ms": fwd_lib,
           "k6_ms": k6, "k6_split_ms": k6_split, "irfft2_ms": inv_lib,
           "clone_ms": events_ms(lambda: spec.clone()),
           "k5_passes_ms": device_ms_by_kernel(fwd),
           "k6_passes_ms": device_ms_by_kernel(inv),
           "k5_split_passes_ms": device_ms_by_kernel(fwd_split),
           "k6_split_passes_ms": device_ms_by_kernel(inv_split),
           "k5_gb_s": nbytes / k5 / 1e6, "k6_gb_s": nbytes / k6 / 1e6,
           "launches": {k.name: k.launches for k in (
               pr.k_dft_fwd, pr.k_dft_inv, pr.k_dft_fwd_split,
               pr.k_dft_inv_split)}}
    del x, spec, y, w, out
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dft_timing: no CUDA device")
    card = card_line()
    print("card: %s" % card, flush=True)
    rows = []
    for itot, jtot, kt in SHAPES:
        row = time_shape(itot, jtot, kt)
        row["card"] = card
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
