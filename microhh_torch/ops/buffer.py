"""Rayleigh sponge layer (``microhh_tpu/ops/buffer.py``; reference
``src/buffer.cxx``).

Relaxes fields above zstart towards their reference profiles with strength
sigma * ((z - zstart)/(ztop - zstart))**beta (reference ``include/buffer.h:52-60``).
On the 2nd-order paths the static-profile sponge is folded into the RK
tendency kernels through per-level tables (ops/fused.py) and this op is its
reference; the 4th-order step, which has no such fold, runs it.
"""

import numpy as np
import torch


class Buffer:
    def __init__(self, ini, grid, fields, input_nc):
        self.zstart = ini.get_float("buffer", "zstart")
        self.sigma = ini.get_float("buffer", "sigma")
        self.beta = ini.get_float("buffer", "beta", default=2.)
        self.swupdate = ini.get_bool("buffer", "swupdate", default=False)
        g = grid
        ks, ke = g.kstart, g.kend
        zsize = g.zsize

        def damping(zarr):
            with np.errstate(invalid="ignore"):
                fac = self.sigma * ((zarr - self.zstart) / (zsize - self.zstart)) ** self.beta
            return np.where(zarr >= self.zstart, fac, 0.)

        self.fac_z = damping(g.z[ks:ke])[:, None, None]
        self.fac_zh = damping(g.zh[ks:ke])[:, None, None]

        # Reference profiles: from input nc init group (u, v, scalars); w -> 0.
        self.profs = {}
        names = ["u", "v"] + list(fields.sp.keys())
        init = input_nc.groups["init"] if (input_nc is not None and "init" in input_nc.groups) else None
        for n in names:
            if init is not None and n in init.variables:
                p = np.asarray(init.variables[n][:g.ktot], dtype=np.float64)
            else:
                p = np.zeros(g.ktot)
            off = g.utrans if n == "u" else (g.vtrans if n == "v" else 0.)
            self.profs[n] = (p - off)[:, None, None]

    def __call__(self, ctx, s, t, aux):
        """Add the sponge tendencies into t, in place on the interior."""
        ks, ke = ctx.ks, ctx.ke
        dev = s["u"].device
        facz = torch.as_tensor(self.fac_z, dtype=ctx.dtype, device=dev)
        faczh = torch.as_tensor(self.fac_zh, dtype=ctx.dtype, device=dev)
        for n in ["u", "v"] + list(ctx.scalar_names):
            if self.swupdate:
                ref = torch.mean(s[n][ks:ke], dim=(1, 2), keepdim=True)
            else:
                ref = torch.as_tensor(self.profs[n], dtype=ctx.dtype, device=dev)
            t[n][ks:ke] -= facz * (s[n][ks:ke] - ref)
        t["w"][ks:ke] -= faczh * s["w"][ks:ke]
        return t


def make_buffer(ini, grid, fields, input_nc):
    if ini.get_str("buffer", "swbuffer", default="0") in ("0", "false"):
        return None
    return Buffer(ini, grid, fields, input_nc)
