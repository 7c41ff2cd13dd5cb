"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, under ``build/microhh_torch/`` at
the root of the checkout, and loaded with ctypes.  The library's name holds a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.

Every C entry ``mhh_<kernel>_<f32|f64>`` launches on the stream it is given,
allocates nothing and returns ``cudaGetLastError()``.  A ``Kernel`` object is
the Python side of one such kernel: it passes the pointers, raises on a
failed launch and counts its launches, so a run can show that its main path
went through the kernel.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "microhh_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_PP, _PD = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_double)

# C signatures without the trailing stream argument (csrc/*.cu).
SIGNATURES = {
    # u, v, w, th, out, ce; itot, jtot, ktot, ks; dxi, dyi, tPr; stratified,
    # ghosts, chunks (ops/kmarch.py)
    "evisc": [_P] * 6 + [_I] * 4 + [_D] * 3 + [_I] * 3,
    # u, v, w, th, e, us, vs, ws, ths, tu, tv, tw, tth, ct; itot, jtot, ktot,
    # ks; dxi, dyi, visc, svisc, tPr, cbdt, can, fc, utrans, vtrans; first,
    # carry, coriolis.  th, ths, tth null: no thermo
    "tend_rk": [_P] * 14 + [_I] * 4 + [_D] * 10 + [_I] * 3,
    # u, v, w, th, e_in, se, us, vs, ws, ths, tu_in, tv_in, tw_in, tu_out,
    # tv_out, tw_out, tth, e_out, rhs, ct, ce; itot, jtot, ktot, ks; dxi,
    # dyi, visc, svisc, tPr, cbdt, can, dti, fc, utrans, vtrans; first,
    # carry, coriolis, chunks (ops/kmarch.py)
    "tend_rk_fold": [_P] * 21 + [_I] * 4 + [_D] * 11 + [_I] * 4,
    # spectrum (complex, in place), winv, tab; kmax, nmodes, sweep (the
    # sweep form, else the scan form: ops/pres_2.py tdma_form)
    "tdma": [_P] * 3 + [_I, ctypes.c_longlong, _I],
    # u, v, w, out, pc; itot, jtot, ktot, ks; dxi, dyi, dti
    "pres_rhs": [_P] * 5 + [_I] * 4 + [_D] * 3,
    # p, su, sv, sw, tu, tv, tw, pc; itot, jtot, ktot, ks; dxi, dyi, dt, can;
    # carry
    "pres_apply": [_P] * 8 + [_I] * 4 + [_D] * 4 + [_I],
    # the cluster form: real x, complex y; kt, jtot, itot, C (CTAs a
    # cluster), F (modes a column chunk)
    "dft_fwd": [_P] * 2 + [_I] * 5,
    # complex y (read only), real x; kt, jtot, itot, C, F
    "dft_inv": [_P] * 2 + [_I] * 5,
    # the split form: real x, complex y; kt, jtot, itot
    "dft_fwd_split": [_P] * 2 + [_I] * 3,
    # complex y (read only), complex scratch w, real x; kt, jtot, itot
    "dft_inv_split": [_P] * 3 + [_I] * 3,
    # u, v, w, th, part, out, ce; itot, jtot, ktot, ks; dxi, dyi, tPr;
    # stratified, ghosts, chunks (ops/kmarch.py)
    "limits": [_P] * 7 + [_I] * 4 + [_D] * 3 + [_I] * 3,
    # u, v, w, e, us, vs, ws, tu, tv, tw, ct; itot, jtot, ktot, ks; dxi, dyi,
    # visc, fc, utrans, vtrans, cbdt, can; coriolis, carry, advec, chunks
    # (ops/kmarch.py)
    "tend_uvw": [_P] * 11 + [_I] * 4 + [_D] * 8 + [_I] * 4,
    # K10 and K15: u, v, w (null without advection), e; host arrays of the
    # S scalars' a, a*, carry pointers and viscosities; S; tables (S, ktot,
    # NTG); itot, jtot, ktot, ks; dxi, dyi, tPr, cbdt, can; carry, fold (the
    # tables' column terms; off at S = 1 only), advec, chunks
    # (ops/kmarch.py)
    "tend_scalars": [_P] * 4 + [_PP] * 3 + [_PD, _I, _P] + [_I] * 4
                    + [_D] * 5 + [_I] * 4,
    # u, v, w, n2 (interior), out, ce; itot, jtot, ktot, ks; dxi, dyi, tPr;
    # chunks (ops/kmarch.py)
    "evisc_n2": [_P] * 6 + [_I] * 4 + [_D] * 3 + [_I],
    # u, v, w, tu, tv, tw, cc; itot, jtot, ktot, ks, scheme; dxi, dyi;
    # chunks (ops/kmarch.py)
    "advec_mom": [_P] * 7 + [_I] * 5 + [_D] * 2 + [_I],
    # u, v, w; host arrays of the S scalars' and carries' pointers; S; cc;
    # itot, jtot, ktot, ks, scheme; dxi, dyi; chunks (ops/kmarch.py)
    "advec_scalars": [_P] * 3 + [_PP] * 2 + [_I, _P] + [_I] * 5 + [_D] * 2
                     + [_I],
    # u, v, w (conservation ghosts), w (plain ghosts), tu, tv, tw, cc; itot,
    # jtot, ktot, ks, scheme; dxi, dyi, visc; chunks (ops/kmarch.py)
    "o4_mom": [_P] * 8 + [_I] * 5 + [_D] * 3 + [_I],
    # u, v, w (conservation ghosts); host arrays of the S scalars' and
    # carries' pointers and of their viscosities; S; the per-level rows
    # (ops/o4_fused.py build_k17_rows); itot, jtot, ktot, ks, scheme; dxi,
    # dyi; chunks (ops/kmarch.py)
    "o4_scalars": [_P] * 3 + [_PP] * 2 + [_PD, _I, _P] + [_I] * 5 + [_D] * 2
                  + [_I],
    # u, v, w, e, tu, tv, tw, ct; itot, jtot, ktot, ks; dxi, dyi, visc, fc,
    # utrans, vtrans; coriolis, advec, chunks (ops/kmarch.py)
    "tend_uvw_acc": [_P] * 8 + [_I] * 4 + [_D] * 6 + [_I] * 3,
    # u, v, w (null without advection), e; host arrays of the S scalars'
    # a and carry pointers and viscosities; S; ct; itot, jtot, ktot, ks;
    # dxi, dyi, tPr; advec, chunks (ops/kmarch.py)
    "tend_scalar_acc": [_P] * 4 + [_PP] * 2 + [_PD, _I, _P] + [_I] * 4
                       + [_D] * 3 + [_I] * 2,
    # u, v, w, th, e (kcells), tu, tv, tw, tth, ct (ktot, NTG); itot, jtot,
    # ktot, ks; dxi, dyi, visc, svisc, tPr, fc, utrans, vtrans; coriolis.
    # th, tth null: no thermo
    "tendencies": [_P] * 10 + [_I] * 4 + [_D] * 8 + [_I],
    # dr, di (spectrum times dz^2, split), winv, afcf (kmax, 2), xr, xi;
    # kmax, nmodes
    "tdma_ri": [_P] * 6 + [_I, ctypes.c_longlong],
    # qr, nr, qt, thl, tqr, tnr, tqt, tthl, ql, rr_bot, cc; itot, jtot, ktot,
    # ks, nsed; Nc0, dt
    "micro2": [_P] * 11 + [_I] * 5 + [_D] * 2,
}

# Kernels with an entry mhh_<kernel>_info_<f32|f64>(scheme, S, int out[5])
# (the scalar sweep's "scheme" is its advec flag, plus 2 in K10/K15's
# form without the fold; K22's its thermo flag, K1/K14's and K7's its
# stratified mode, K3's its sweep flag with S its chunks a mode; K11,
# K8/K9 and K18 read neither, K12, K16, K1/K14 and K7 not S): registers,
# local bytes a thread, dynamic shared memory a block, resident blocks an
# SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), SMs.
INFO = ("advec_mom", "advec_scalars", "o4_mom", "o4_scalars",
        "tend_scalars", "tend_scalar_acc", "micro2", "tend_rk_fold",
        "tend_uvw", "tend_uvw_acc", "evisc", "limits", "tdma")
INFO_KEYS = ("registers", "local_bytes", "smem", "blocks_per_sm", "sms")

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path():
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, "libmicrohh_torch_%s.so" % h.hexdigest()[:16])


def build():
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc process per source, all running at once, then one link.  Returns
    (library path, seconds spent compiling, compiler log)."""
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return path, 0., log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = "%s.%d" % (path[:-3], os.getpid())
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = ["%s.%s.o" % (tag, os.path.basename(cu)[:-3]) for cu in cus]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc()] + NVCC_FLAGS + ["-I", CSRC_DIR, "-c",
                                                        "-o", obj, cu],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cu, obj in zip(cus, objs)]
    logs, failed = [], []
    for cu, proc in zip(cus, procs):
        out, _ = proc.communicate()
        logs.append("== %s\n%s" % (os.path.basename(cu), out))
        if proc.returncode != 0:
            failed.append(os.path.basename(cu))
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", tag + ".tmp"] + objs,
                              capture_output=True, text=True)
        logs.append("== link\n%s%s" % (link.stdout, link.stderr))
        if link.returncode != 0:
            failed.append("link")
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed (%s):\n%s" % (", ".join(failed), log))
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tag + ".tmp", path)
    return path, seconds, log


@functools.lru_cache(maxsize=None)
def load():
    """The loaded kernel library (built on first use), argtypes declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, args in SIGNATURES.items():
        for suffix in _SUFFIX.values():
            fn = getattr(lib, "mhh_%s_%s" % (name, suffix))
            fn.argtypes = args + [_P]
            fn.restype = ctypes.c_int
    for name in INFO:
        for suffix in _SUFFIX.values():
            fn = getattr(lib, "mhh_%s_info_%s" % (name, suffix))
            fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
    return lib


class Kernel:
    """One hand-written CUDA kernel: its C entry (its name unless given),
    where its source lies, which TPU kernel it replaces, and how often it
    was launched."""

    def __init__(self, name, source, replaces, entry=None):
        self.entry = entry or name
        if self.entry not in SIGNATURES:
            raise KeyError(self.entry)
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._info = {}

    def __call__(self, dtype, *args):
        fn = getattr(load(), "mhh_%s_%s" % (self.entry, _SUFFIX[dtype]))
        # a tensor goes as its pointer, None as a null pointer
        ptrs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
        rc = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError("CUDA kernel %s failed to launch (cudaError %d)"
                               % (self.name, rc))
        self.launches += 1

    def info(self, dtype, scheme, S=0):
        """What the card reports of the kernel's form for (dtype, scheme,
        S): INFO_KEYS -> int, asked once.  Launches nothing."""
        key = (dtype, scheme, S)
        if key not in self._info:
            out = (ctypes.c_int * len(INFO_KEYS))()
            rc = getattr(load(), "mhh_%s_info_%s"
                         % (self.entry, _SUFFIX[dtype]))(scheme, S, out)
            if rc != 0:
                raise RuntimeError("CUDA kernel %s: no occupancy (cudaError "
                                   "%d)" % (self.name, rc))
            self._info[key] = dict(zip(INFO_KEYS, out))
        return self._info[key]


def check(tensors, dtype, device, shapes=None):
    """Raise unless every tensor is contiguous, of dtype on device, and of
    the given shape (shapes: one tuple per tensor, or None)."""
    if dtype not in _SUFFIX:
        raise TypeError("kernels take float32 or float64, not %s" % dtype)
    for n, a in enumerate(tensors):
        if a.dtype != dtype or a.device != device:
            raise TypeError("tensor %d is %s on %s, expected %s on %s"
                            % (n, a.dtype, a.device, dtype, device))
        if not a.is_contiguous():
            raise ValueError("tensor %d is not contiguous" % n)
        if shapes is not None and tuple(a.shape) != tuple(shapes[n]):
            raise ValueError("tensor %d has shape %s, expected %s"
                             % (n, tuple(a.shape), tuple(shapes[n])))


def on_cpu(t):
    """True for a CPU tensor (plain-torch path), False for a CUDA tensor
    (kernel path); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise TypeError("no kernel for device %s" % t.device)
