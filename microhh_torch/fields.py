"""Field registry and initial conditions.

Reference: ``src/fields.cxx``.  Host-side copy of ``microhh_tpu/fields.py``
(numpy only; ``tests/test_torch_host.py`` holds it to the original): the
state is a dict ``{name: (kcells, jtot, itot) array}`` with vertical ghost
levels and no horizontal ghosts (see grid.py).  Restart files are written
synchronously with ``np.tofile`` in the reference layout.

Initial conditions mirror ``Fields::create`` (reference ``src/fields.cxx:832-905``):
per-field random perturbations below ``rndz`` with exponent ``rndexp``,
optional vortex pairs, mean profiles from the input NetCDF ``init`` group.
"""

import numpy as np


class Field:
    """Metadata for one prognostic or diagnostic field."""

    def __init__(self, name, longname, unit, loc, visc=None):
        self.name = name
        self.longname = longname
        self.unit = unit
        self.loc = loc  # (x,y,z) staggering flags; 1 = at flux/half level
        self.visc = visc


class Fields:
    def __init__(self, ini, grid):
        self.ini = ini
        self.grid = grid
        self.visc = ini.get_float("fields", "visc")

        # Prognostic momentum fields (reference Fields ctor).
        self.mp = {
            "u": Field("u", "U velocity", "m s-1", (1, 0, 0), self.visc),
            "v": Field("v", "V velocity", "m s-1", (0, 1, 0), self.visc),
            "w": Field("w", "Vertical velocity", "m s-1", (0, 0, 1), self.visc),
        }
        # Prognostic scalars: passive ones from [fields] slist; physics modules
        # (thermo/microphys) register more via init_prognostic_field().
        # Initial-condition options are consumed at construction in every
        # sim mode, mirroring the reference Fields ctor (src/fields.cxx),
        # so run/post do not flag them as unused.
        self._rnd = {}
        self.sp = {}
        for name in ini.get_list(str, "fields", "slist", default=[]):
            self.init_prognostic_field(name, name, "-")

        self.rndseed = ini.get_int("fields", "rndseed", default=0)
        self.vortexnpair = ini.get_int("fields", "vortexnpair", default=0)
        self.vortexamp = ini.get_float("fields", "vortexamp", default=1.e-3)
        self.vortexaxis = ini.get_str("fields", "vortexaxis", default="y")
        for name in ("u", "v", "w"):
            self._read_rnd_options(name)
        # Diagnostic fields (p is always registered, like the reference).
        self.sd = {"p": Field("p", "Pressure", "Pa", (0, 0, 0))}
        # Prognostic soil fields (ktot_soil, jtot, itot; no ghosts) and 2-D
        # surface fields, registered by the land-surface scheme
        # (reference fields.sps / fields.ap2d).
        self.sps = {}
        self.sp2d = {}
        self.soil_ktot = 0

        # Reference profiles, filled by thermo's base state; default Boussinesq
        # rho == 1 (reference Fields::create_basestate defaults).
        kc = grid.kcells
        self.rhoref = np.ones(kc)
        self.rhorefh = np.ones(kc)

    # -- registry ----------------------------------------------------------
    def _read_rnd_options(self, name):
        ini = self.ini
        self._rnd[name] = (
            ini.get_float("fields", "rndamp", subitem=name, default=0.),
            ini.get_float("fields", "rndz", subitem=name,
                          default=self.grid.zsize),
            ini.get_float("fields", "rndexp", subitem=name, default=0.))

    def init_prognostic_field(self, name, longname, unit, group=""):
        if name in self.sp or name in self.mp:
            raise ValueError("field %s already exists" % name)
        svisc = self.ini.get_float("fields", "svisc", subitem=name,
                                   default=self.ini.get_float("fields", "svisc", default=self.visc))
        self.sp[name] = Field(name, longname, unit, (0, 0, 0), svisc)
        self._read_rnd_options(name)

    def init_diagnostic_field(self, name, longname, unit, group=""):
        self.sd[name] = Field(name, longname, unit, (0, 0, 0))

    def init_prognostic_soil_field(self, name, longname, unit):
        self.sps[name] = Field(name, longname, unit, (0, 0, 0))

    def init_prognostic_2d_field(self, name, longname="", unit=""):
        self.sp2d[name] = Field(name, longname, unit, (0, 0, 0))

    @property
    def prognostic_names(self):
        return ["u", "v", "w"] + list(self.sp.keys())

    @property
    def all_prognostic_names(self):
        """Atmospheric + soil + 2-D prognostics (drives the RK update/io)."""
        return (self.prognostic_names + list(self.sps.keys())
                + list(self.sp2d.keys()))

    def zeros(self, dtype=np.float64):
        g = self.grid
        return np.zeros((g.kcells, g.jtot, g.itot), dtype=dtype)

    # -- initial conditions (init mode) ------------------------------------
    def create(self, input_nc, dtype=np.float64):
        """Build the initial state dict (reference Fields::create)."""
        ini, g = self.ini, self.grid
        state = {name: self.zeros(dtype) for name in self.prognostic_names}

        rng = np.random.RandomState(self.rndseed + 2)

        def randomize(name, data):
            rndamp, rndz, rndexp = self._rnd.get(name) or (
                ini.get_float("fields", "rndamp", subitem=name, default=0.),
                ini.get_float("fields", "rndz", subitem=name, default=g.zsize),
                ini.get_float("fields", "rndexp", subitem=name, default=0.))
            if rndz > g.zsize:
                raise ValueError("rndz higher than domain top")
            if rndamp == 0.:
                return
            for k in range(g.kstart, g.kend):
                if g.z[k] >= rndz:
                    break
                rndfac = ((rndz - g.z[k]) / rndz) ** rndexp
                data[k] += rndfac * rndamp * (rng.rand(g.jtot, g.itot) - 0.5)

        randomize("u", state["u"])
        randomize("w", state["w"])
        if g.jtot > 1:
            randomize("v", state["v"])
        for name in self.sp:
            randomize(name, state[name])

        self._add_vortex_pair(state)
        self._add_mean_profs(state, input_nc)

        # w at the walls must be exactly zero (reference fields.cxx:861-869).
        state["w"][g.kstart] = 0.
        state["w"][g.kend] = 0.
        return state

    def _add_vortex_pair(self, state):
        g = self.grid
        npair, amp, axis = self.vortexnpair, self.vortexamp, self.vortexaxis
        if npair <= 0:
            return
        ks, ke = g.kstart, g.kend
        zc = g.z[ks:ke, None, None]
        zhc = g.zh[ks:ke, None, None]
        if axis == "y":
            xh = g.xh[None, None, :]
            xc = g.x[None, None, :]
            state["u"][ks:ke] += amp * np.sin(npair * 2. * np.pi * xh / g.xsize) * np.cos(np.pi * zc / g.zsize)
            state["w"][ks:ke] += -amp * np.cos(npair * 2. * np.pi * xc / g.xsize) * np.sin(np.pi * zhc / g.zsize)
        elif axis == "x":
            yh = g.yh[None, :, None]
            yc = g.y[None, :, None]
            state["v"][ks:ke] += amp * np.sin(npair * 2. * np.pi * yh / g.ysize) * np.cos(np.pi * zc / g.zsize)
            state["w"][ks:ke] += -amp * np.cos(npair * 2. * np.pi * yc / g.ysize) * np.sin(np.pi * zhc / g.zsize)

    def _add_mean_profs(self, state, input_nc):
        g = self.grid
        if input_nc is None or "init" not in input_nc.groups:
            return
        init = input_nc.groups["init"]

        def prof(name):
            if name in init.variables:
                return np.asarray(init.variables[name][:g.ktot], dtype=np.float64)
            return None

        for name, offset in (("u", g.utrans), ("v", g.vtrans)):
            p = prof(name)
            if p is not None:
                state[name][g.kstart:g.kend] += (p - offset)[:, None, None]
        for name in self.sp:
            p = prof(name)
            if p is not None:
                state[name][g.kstart:g.kend] += p[:, None, None]

    # -- binary field I/O (reference Field3d_io layout: interior, k-major) --
    def save_field(self, data, name, iotime, path=".", dtype=None):
        g = self.grid
        fname = "%s/%s.%07d" % (path, name, iotime)
        if name in self.sps or name in self.sp2d:
            interior = np.asarray(data)  # soil/2-D fields carry no ghosts
        else:
            interior = np.asarray(data[g.kstart:g.kend])
        if dtype is not None:
            interior = interior.astype(dtype)
        np.ascontiguousarray(interior).tofile(fname)

    def load_field(self, name, iotime, path=".", dtype=np.float64):
        g = self.grid
        fname = "%s/%s.%07d" % (path, name, iotime)
        raw = np.fromfile(fname, dtype=dtype)
        if name in self.sp2d:
            return raw.reshape(g.jtot, g.itot)
        if name in self.sps:
            return raw.reshape(self.soil_ktot, g.jtot, g.itot)
        if raw.size != g.ktot * g.jtot * g.itot:
            raise ValueError("size mismatch loading %s" % fname)
        data = self.zeros(dtype)
        data[g.kstart:g.kend] = raw.reshape(g.ktot, g.jtot, g.itot)
        return data

    def save(self, state, iotime, path=".", dtype=None):
        for name in self.all_prognostic_names:
            self.save_field(np.asarray(state[name]), name, iotime, path, dtype)

    def load(self, iotime, path=".", dtype=np.float64):
        return {name: self.load_field(name, iotime, path, dtype)
                for name in self.all_prognostic_names}
