"""Host-side time bookkeeping (reference ``src/timeloop.cxx``).

Integer time: ``itime = time * ifactor`` with ``ifactor = 1e9`` avoids FP
drift in the save/stats triggers exactly like the reference
(``timeloop.cxx:100-124``).  Host-side copy of ``microhh_tpu/timeloop.py``;
the RK substeps run in model.py, this class only manages dt, iteration
counters and the io triggers.
"""

import numpy as np

IFACTOR = 1_000_000_000

# Williamson low-storage RK3 (timeloop.cxx:250-285).
RK3_CA = (0., -5. / 9., -153. / 128.)
RK3_CB = (1. / 3., 15. / 16., 8. / 15.)

# Carpenter-Kennedy 5-stage RK4 (timeloop.cxx:287-334).
RK4_CA = (0.,
          -567301805773. / 1357537059087.,
          -2404267990393. / 2016746695238.,
          -3550918686646. / 2091501179385.,
          -1275806237668. / 842570457699.)
RK4_CB = (1432997174477. / 9575080441755.,
          5161836677717. / 13612068292357.,
          1720146321549. / 2090206949498.,
          3134564353537. / 4481467310338.,
          2277821191437. / 14882151754819.)

DBIG = 1.e9


class Timeloop:
    def __init__(self, ini, sim_mode="run"):
        self.sim_mode = sim_mode
        if sim_mode == "init":
            self.starttime = 0.
            ini.flag_as_used("time", "starttime")
        else:
            self.starttime = ini.get_float("time", "starttime")
        self.endtime = ini.get_float("time", "endtime")
        self.savetime = ini.get_float("time", "savetime")
        self.adaptivestep = ini.get_bool("time", "adaptivestep", default=True)
        self.dtmax = ini.get_float("time", "dtmax", default=DBIG)
        self.dt = ini.get_float("time", "dt", default=self.dtmax)
        self.rkorder = ini.get_int("time", "rkorder", default=3)
        self.outputiter = ini.get_int("time", "outputiter", default=20)
        self.iotimeprec = ini.get_int("time", "iotimeprec", default=0)
        if sim_mode == "post":
            self.postproctime = ini.get_float("time", "postproctime")
        if self.rkorder not in (3, 4):
            raise ValueError("%d is an illegal value for rkorder" % self.rkorder)

        self.loop = True
        self.time = 0.
        self.iteration = 0
        self.itime = 0
        self.iendtime = int(IFACTOR * self.endtime + 0.5)
        self.istarttime = int(IFACTOR * self.starttime + 0.5)
        self.idt = int(IFACTOR * self.dt + 0.5)
        self.idtmax = int(IFACTOR * self.dtmax + 0.5)
        self.isavetime = int(IFACTOR * self.savetime + 0.5)
        if sim_mode == "post":
            self.ipostproctime = int(IFACTOR * self.postproctime + 0.5)
        self.idtlim = self.idt
        self.iiotimeprec = int(IFACTOR * 10. ** self.iotimeprec + 0.5)
        if (self.istarttime % self.iiotimeprec) or (self.isavetime % self.iiotimeprec):
            raise ValueError("starttime or savetime is not a multiple of iotimeprec")
        self.iotime = self.istarttime // self.iiotimeprec

        # UTC calendar anchor (timeloop.cxx:73-77,561-571): feeds the solar
        # zenith of rrtmgp/prescribed radiation and the stats time units.
        self.datetime_utc = ini.get_str("time", "datetime_utc", default="")
        self.utc_start = None
        if self.datetime_utc:
            import datetime as _dt
            self.utc_start = _dt.datetime.strptime(self.datetime_utc,
                                                   "%Y-%m-%d %H:%M:%S")

    def _utc_actual(self, time_s):
        import datetime as _dt
        if self.utc_start is None:
            raise RuntimeError("No datetime in UTC specified")
        return self.utc_start + _dt.timedelta(seconds=float(time_s))

    def calc_day_of_year(self, time_s=None):
        """1-based fractional day of year at model time (timeloop.cxx:561)."""
        a = self._utc_actual(self.time if time_s is None else time_s)
        frac = (a.hour * 3600. + a.minute * 60. + a.second
                + a.microsecond * 1e-6) / 86400.
        return float(a.timetuple().tm_yday) + frac

    def calc_hour_of_day(self, time_s=None):
        a = self._utc_actual(self.time if time_s is None else time_s)
        return a.hour + (a.minute * 60. + a.second
                         + a.microsecond * 1e-6) / 3600.

    def get_year(self, time_s=None):
        return self._utc_actual(self.time if time_s is None else time_s).year

    @property
    def n_substeps(self):
        return 3 if self.rkorder == 3 else 5

    @property
    def rk_ca(self):
        return RK3_CA if self.rkorder == 3 else RK4_CA

    @property
    def rk_cb(self):
        return RK3_CB if self.rkorder == 3 else RK4_CB

    def reset_time_step_limit(self, at_wall_clock_limit=False):
        """Start-of-iteration limit from io triggers (timeloop.cxx:138-152)."""
        self.idtlim = self.idtmax
        if at_wall_clock_limit:
            # Steer dt onto an io-aligned time so a restart can be written
            # before the scheduler kills the job (timeloop.cxx:142-151).
            self.idtlim = min(self.idtlim,
                              self.iiotimeprec - self.itime % self.iiotimeprec)
        self.idtlim = min(self.idtlim, self.isavetime - self.itime % self.isavetime)
        if self.itime < self.iendtime:
            self.idtlim = min(self.idtlim, self.iendtime - self.itime)

    def set_time_step_limit(self, idtlimin):
        """Fold in one op's limit (timeloop.cxx:155-158); does NOT reset."""
        self.idtlim = min(self.idtlim, int(idtlimin))

    def set_time_step(self):
        if self.adaptivestep:
            if self.idt == 0:
                raise RuntimeError("Required time step less than integer-time precision")
            self.idt = self.idtlim
            self.dt = self.idt / IFACTOR

    def step_time(self):
        self.time += self.dt
        self.itime += self.idt
        self.iotime = self.itime // self.iiotimeprec
        self.iteration += 1
        if self.itime >= self.iendtime:
            self.loop = False

    def do_check(self):
        if self.outputiter == 0:
            return True
        return (self.iteration % self.outputiter == 0) or not self.loop

    def do_save(self, at_wall_clock_limit=False):
        # Wall-clock shutdown: save at any io-aligned time and stop looping
        # (timeloop.cxx:189-208).
        if at_wall_clock_limit and self.itime % self.iiotimeprec == 0:
            self.loop = False
            return True
        return (self.itime % self.isavetime == 0) and self.iteration != 0

    def is_stats_step(self):
        return not (self.iteration > 0 and self.itime == self.istarttime)

    def is_finished(self):
        return not self.loop

    def step_post_proc_time(self):
        self.itime += self.ipostproctime
        self.iotime = self.itime // self.iiotimeprec
        if self.itime > self.iendtime:
            self.loop = False

    # -- restart files (reference time.<iotime> format) --------------------
    def save(self, iotime, path="."):
        fname = "%s/time.%07d" % (path, iotime)
        with open(fname, "wb") as f:
            np.array([self.itime, self.idt], dtype=np.uint64).tofile(f)
            np.array([self.iteration], dtype=np.int32).tofile(f)

    def load(self, iotime, path="."):
        fname = "%s/time.%07d" % (path, iotime)
        with open(fname, "rb") as f:
            vals = np.fromfile(f, dtype=np.uint64, count=2)
            it = np.fromfile(f, dtype=np.int32, count=1)
        self.itime, self.idt = int(vals[0]), int(vals[1])
        self.iteration = int(it[0])
        self.time = self.itime / IFACTOR
        self.dt = self.idt / IFACTOR
