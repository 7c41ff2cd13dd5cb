"""Field dumps (``microhh_tpu/output.py`` ``Dump``; reference
``src/dump.cxx``): ``<var>.<iotime>`` holds the raw interior field, in the
run's precision, as the reference's post-processing tools read it.  Cross
sections and column output (the rest of that module) wait for ROADMAP
Queue 1 item 15."""

import os

import numpy as np

from .timeloop import IFACTOR


class Dump:
    def __init__(self, model):
        ini = model.ini
        self.sw = ini.get_str("dump", "swdump", default="0") not in ("0", "false")
        if not self.sw:
            return
        self.sampletime = ini.get_float("dump", "sampletime")
        self.isampletime = int(self.sampletime * IFACTOR + 0.5)
        self.dumplist = ini.get_list(str, "dump", "dumplist", default=[])
        self.model = model

    def do_dump(self, itime):
        return itime % self.isampletime == 0

    def exec(self, s, aux, iotime):
        m = self.model
        ks, ke = m.grid.kstart, m.grid.kend
        for name in self.dumplist:
            if name in s:
                data = s[name][ks:ke]
            elif name == "p" and aux is not None and "p" in aux:
                # the port's 2nd-order solvers keep the interior pressure
                p = aux["p"]
                data = p[ks:ke] if p.shape[0] == m.grid.kcells else p
            else:
                continue
            fname = os.path.join(m.workdir, "%s.%07d" % (name, iotime))
            np.ascontiguousarray(data.cpu().numpy()).tofile(fname)
