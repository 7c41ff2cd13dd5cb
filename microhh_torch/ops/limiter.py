"""Positive-definite tendency limiter (``microhh_tpu/ops/limiter.py``;
reference ``src/limiter.cxx``, ``include/limiter.h:36-57``).

Two forms of one rule.  ``__call__`` is the reference's: the last tendency
of a listed scalar is raised to -s/dt, so the RK update cannot make it
negative.  ``clamp`` is the form the RK-folded path applies after the
projection (``microhh_tpu/model.py:470-484``): max(t, -s/dt) is
s_new = max(s + dt t, 0), and the carry gains can * (s_new - s*) / dt.
"""

import torch


class Limiter:
    def __init__(self, ini, fields):
        self.limitlist = ini.get_list(str, "limiter", "limitlist", default=[])

    def __call__(self, ctx, s, t, aux, subdt):
        """t with the listed scalars' tendencies limited (new tensors)."""
        ks, ke = ctx.ks, ctx.ke
        t = dict(t)
        for name in self.limitlist:
            if name not in t:
                continue
            tn = t[name].clone()
            tn[ks:ke] = torch.maximum(tn[ks:ke], -s[name][ks:ke] / subdt)
            t[name] = tn
        return t

    def clamp(self, ctx, s_new, t, subdt, can):
        """The s*-clamp on the RK-folded path, in place on the interior of
        s_new and (when can != 0) of the carry t."""
        ks, ke = ctx.ks, ctx.ke
        for name in self.limitlist:
            if name not in s_new:
                continue
            sold = s_new[name][ks:ke]
            sclip = torch.clamp(sold, min=0.)
            if can != 0.:
                t[name][ks:ke] += can * (sclip - sold) / subdt
            sold.copy_(sclip)
