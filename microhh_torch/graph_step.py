"""The body of the device-side chunked time loop, and its capture as CUDA
graphs (the JAX package's build_chunk, ``microhh_tpu/model.py:993-1060``).

Between two output events the model runs a chunk of steps whose dt is
computed on the device from the previous dt and the limit rates
(``next_dt``), with the time summed under Kahan compensation so that the
chunk's last step lands on the event's time.  ``ChunkLoop`` holds what a
chunk carries from step to step, 0-dim tensors on the model's device in its
dtype (dt, the time ``tau`` since the chunk began and its compensation
``comp``, the horizon ``t_h``) and ``flags`` (int32: the step count ``n``
and ``done``), and runs the body:

1. the limits of the state before the step (``Model.limits``);
2. ``next_dt``, the last step clamped onto the horizon;
3. one step;
4. the Kahan update of the time;
5. the count, and ``done`` when the step was the last.

The chunk ends at ``done`` or after ``nmax`` steps.  The host reads ``n``
and ``done`` once a step: on the card one non-blocking copy into pinned
memory and one event wait.

On the CPU, and on the card for a path whose kernels still take dt by value
(the generic, unfolded and 4th-order paths, whose step reads dt to the host
once), the body runs eagerly.  On the card the dry RK step (K22, or K1 -> K2
-> K4 rhs with ``fold=False``) runs as two CUDA graphs (``GraphChunk``),
captured once per model after a warm-up on a side stream: graph k reads
state k and its last substep writes state 1 - k, so the state is never
copied; the surface planes are copied back into one static set at the end
of each graph.  The graphs share one memory pool and run one at a time, in
turn.  A capture that fails, or a host read inside the body (which fails
the capture), raises; nothing falls back to the eager body on the card.
"""

import collections
import gc
import math
import time

import torch

from .kernels import Kernel


def next_dt(lim, dt_prev, remaining, dtmax, cflmax, cflmin, dnmax, mcflmax):
    """The next step's dt from the previous one and the rates per unit dt in
    ``lim`` (cfl_rate, dn_rate, micro_rate, each where present), capped at
    dtmax and clamped to ``remaining``: (dt, last), 0-dim tensors, last true
    where the clamp took (microhh_tpu/model.py:1009-1026; the integer
    arithmetic of timeloop.cxx collapses to these ratios)."""
    dt = torch.full_like(dt_prev, dtmax)
    if "cfl_rate" in lim:
        cfl = torch.clamp(lim["cfl_rate"] * dt_prev, min=cflmin)
        dt = torch.minimum(dt, dt_prev * cflmax / cfl)
    if dnmax is not None and "dn_rate" in lim:
        dn = lim["dn_rate"] * dt_prev
        dt = torch.minimum(dt, torch.where(
            dn > 0., dt_prev * dnmax / torch.clamp(dn, min=1e-30), math.inf))
    if "micro_rate" in lim:
        mc = torch.clamp(lim["micro_rate"] * dt_prev, min=1e-5)
        dt = torch.minimum(dt, dt_prev * mcflmax / mc)
    last = remaining <= dt
    return torch.where(last, remaining, dt), last


class ChunkLoop:
    """The carried scalars and the body of one model's chunked loop.
    ``capture`` False keeps the body eager on the card too (the check of
    the graphs against it).  ``counters``: chunks, steps and the seconds
    spent in them, and the seconds the capture took (its warm-up
    included)."""

    def __init__(self, model, capture=True):
        self.model = model
        self.capture = capture
        dev, dty = model.device, model.dtype
        self.dt, self.tau, self.comp, self.t_h = (
            torch.zeros((), dtype=dty, device=dev) for _ in range(4))
        self.flags = torch.zeros(2, dtype=torch.int32, device=dev)
        self.n, self.done = self.flags[0], self.flags[1]
        self.rules = dict(
            dtmax=float(model.timeloop.dtmax),
            cflmax=float(getattr(model.advec, "cflmax", 1.0)),
            cflmin=float(getattr(model.advec, "cflmin", 1.e-5)),
            dnmax=getattr(model.diff, "dnmax", None),
            mcflmax=float(getattr(model.micro, "cflmax", 1.2)))
        self.on_card = dev.type == "cuda"
        if self.on_card:
            self.flags_host = torch.zeros(2, dtype=torch.int32,
                                          pin_memory=True)
            self.ready = torch.cuda.Event()
        self.graphs = None
        self.counters = {"chunks": 0, "steps": 0, "seconds": 0.,
                         "capture_s": 0.}

    def captured(self):
        """True where the chunk runs as CUDA graphs: the dry RK step on the
        card, whose kernels read dt from the device."""
        return self.capture and self.on_card and self.model.device_dt()

    def start(self, dt0, horizon):
        """A new chunk: dt0 the previous step's dt, horizon the time to the
        next event, both seconds; tau, comp, n and done zero.  Fills on the
        device, no copy."""
        self.dt.fill_(dt0)
        self.t_h.fill_(horizon)
        self.tau.zero_()
        self.comp.zero_()
        self.flags.zero_()

    def body(self, s, sfc, out=None):
        """One step of the chunk; returns (s, sfc, aux) and updates the
        carried scalars in place.  out: the arrays of the new state
        (Model.step)."""
        lim = self.model.limits(s, sfc)
        remaining = self.t_h - (self.tau + self.comp)
        dt, last = next_dt(lim, self.dt, remaining, **self.rules)
        s, sfc, aux = self.model.step(s, sfc, dt, out=out)
        # Kahan-compensated time: the chunk must land on t_h even after
        # thousands of float32 additions
        y = dt - self.comp
        tau = self.tau + y
        self.comp.copy_((tau - self.tau) - y)
        self.tau.copy_(tau)
        self.dt.copy_(dt)
        self.n.add_(1)
        self.done.copy_(last)
        return s, sfc, aux

    def status(self):
        """(n, done) of the chunk so far: the one host read of a step."""
        if not self.on_card:
            n, done = self.flags.tolist()
            return n, bool(done)
        self.flags_host.copy_(self.flags, non_blocking=True)
        self.ready.record()
        self.ready.synchronize()
        n, done = self.flags_host.tolist()
        return n, bool(done)

    def run(self, s, sfc, nmax):
        """Steps from (s, sfc) until done or n == nmax; returns (s, sfc,
        aux of the last step, None if none ran).  On the card the dry RK
        step's graphs are captured at the first call."""
        t0 = time.perf_counter()
        if self.captured():
            if self.graphs is None:
                self.graphs = GraphChunk(self, s, sfc)
                self.counters["capture_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
            s, sfc, aux, steps = self.graphs.run(s, sfc, nmax)
        else:
            aux, steps, n, done = None, 0, 0, False
            while n < nmax and not done:
                s, sfc, aux = self.body(s, sfc)
                steps += 1
                n, done = self.status()
        self.counters["chunks"] += 1
        self.counters["steps"] += steps
        self.counters["seconds"] += time.perf_counter() - t0
        return s, sfc, aux


class GraphChunk:
    """The chunk body as two CUDA graphs on two static states.  Graph k
    reads ``states[k]`` and the static surface planes ``sfc`` and writes
    ``states[1 - k]``; ``cur`` is the state that holds the model's present
    one.  ``p[k]``: graph k's pressure, valid after graph k ran last.
    Every kernel launched in graph k counts ``counts[k]`` launches a
    replay; ``replays[k]`` counts graph k's replays.  ``seconds``: the
    warm-up's, and each graph's capture and instantiation."""

    def __init__(self, loop, s, sfc):
        self.loop = loop
        model = loop.model
        self.states = [dict(s), {n: torch.zeros_like(a) for n, a in s.items()}]
        self.sfc = {k: v.clone() for k, v in sfc.items()}
        self.cur = 0
        # everything a graph reads or writes outside its pool stays alive:
        # the carries each capture starts from
        self.kept = []
        carried = [a.clone() for a in (loop.dt, loop.tau, loop.comp,
                                       loop.flags)]
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # the warm-up loads the library, asks the plans and builds
            # every lazy table; the states and the surface planes are only
            # read, and the carried scalars it stepped are put back
            loop.body(self.states[0], self.sfc, out=self.states[1])
        torch.cuda.current_stream().wait_stream(side)
        for a, b in zip((loop.dt, loop.tau, loop.comp, loop.flags), carried):
            a.copy_(b)
        torch.cuda.synchronize()
        self.seconds = {"warm_up": time.perf_counter() - t0, "capture": []}
        pool = torch.cuda.graph_pool_handle()
        self.graphs, self.p, self.counts = [], [], []
        # a CUDA graph that the cyclic collector destroys while another is
        # captured (an earlier model's: a model and its loop refer to each
        # other) invalidates that capture, so collect first and not during
        # the captures
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for k in (0, 1):
                self._capture(k, pool)
        finally:
            if collecting:
                gc.enable()
        self.kept.append(dict(model.t))
        self.replays = [0, 0]

    def _capture(self, k, pool):
        """Capture graph k: the chunk body from states[k] into
        states[1 - k]."""
        loop, model = self.loop, self.loop.model
        t0 = time.perf_counter()
        self.kept.append(dict(model.t))
        graph = torch.cuda.CUDAGraph()
        Kernel.recording = recorded = []
        try:
            with torch.cuda.graph(graph, pool=pool):
                s2, sfc2, aux = loop.body(self.states[k], self.sfc,
                                          out=self.states[1 - k])
                for key, v in sfc2.items():
                    if v is not self.sfc[key]:
                        self.sfc[key].copy_(v)
        finally:
            Kernel.recording = None
        if set(sfc2) != set(self.sfc) or any(
                s2[n] is not self.states[1 - k][n] for n in s2):
            raise RuntimeError("the captured step did not write its "
                               "state into the other static state")
        self.graphs.append(graph)
        self.p.append(aux["p"])
        self.counts.append(collections.Counter(recorded))
        self.seconds["capture"].append(time.perf_counter() - t0)

    def adopt(self, s, sfc):
        """Make the current static state hold (s, sfc), copying only what
        is not already there."""
        for n, a in s.items():
            if a is not self.states[self.cur][n]:
                self.states[self.cur][n].copy_(a)
        for k, v in sfc.items():
            if v is not self.sfc[k]:
                self.sfc[k].copy_(v)

    def run(self, s, sfc, nmax):
        """Replays from (s, sfc) until done or n == nmax: returns (s, sfc,
        {"p": the last step's pressure} or None, the replays); s and sfc
        are the static ones."""
        self.adopt(s, sfc)
        steps, n, done, last = 0, 0, False, None
        while n < nmax and not done:
            last = self.cur
            self.graphs[last].replay()
            self.replays[last] += 1
            for kern, count in self.counts[last].items():
                kern.launches += count
            self.cur = 1 - last
            steps += 1
            n, done = self.loop.status()
        aux = None if last is None else {"p": self.p[last]}
        return self.states[self.cur], self.sfc, aux, steps
