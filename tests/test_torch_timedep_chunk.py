"""The chunked loop's gate and behaviour with time dependence, in float64
on the CPU:

* ``Model._chunk_supported`` equal to the JAX package's over a list of
  inis, with MICROHH_CHUNK on and off;
* reference behaviour pinned: the chunked loop of both packages makes no
  update, so a time-dependent geostrophic wind, subsidence or surface
  pressure, which the gate lets through, keeps its static profile there
  (the port's chunked run equals the JAX package's <= 1e-10, neither calls
  an update, and the per-step loop, which updates, differs by more than
  1e3 times that).
"""

import numpy as np
import pytest
import torch

from chip_smoke import case_ini
from microhh_tpu.config import Ini as JIni
from microhh_tpu.model import Model as JModel
from microhh_torch import cases
from microhh_torch.config import Ini
from microhh_torch.model import Model
from microhh_torch.utils.nc import MemoryDataset
from test_torch_timedep import (CONTROL, FORCE_INI, TOL, force_input,
                                initial_files, pbot_input, pbot_text,
                                state_err, write_nc)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


# --------------------------------------------------------------------------
#  the chunked loop makes no update: reference behaviour, pinned
# --------------------------------------------------------------------------

PIN_FORCE = """[force]
swlspres=geo
fc=1.0e-4
swtimedep_geo=1
swwls=mean
swtimedep_wls=1

"""


def pin_text():
    """The moist case of the surface-pressure test with a time-dependent
    geostrophic wind and subsidence, to 40 s."""
    text = pbot_text().replace("[boundary]", PIN_FORCE + "[boundary]")
    return text.replace("endtime=400", "endtime=40").replace(
        "savetime=400", "savetime=40")


def pin_input(ktot=16, zsize=400.):
    """pbot_input with geostrophic and subsidence profiles, static and
    steep over time (20 s)."""
    base = pbot_input(ktot, zsize)
    z = base.variables["z"][:]
    one = np.ones(ktot)
    init = dict(base.groups["init"].variables, u_geo=5. * one,
                v_geo=0. * one, w_ls=-0.01 * one)
    td = dict(base.groups["timedep"].variables,
              time_ls=np.array([0., 20., 800.]),
              u_geo=np.outer([5., 15., 7.], one),
              v_geo=np.outer([0., -8., 1.], one) + 0.01 * z,
              w_ls=np.outer([-0.01, -0.3, -0.03], one))
    return MemoryDataset({"z": z}, {"init": init, "timedep": td})


def gate_cases():
    """(label, casename, ini text, in-memory input) of the gate's list."""
    out = []
    for case, over in (("gabls1", {}), ("gabls4s3", {}), ("arm", {}),
                       ("drycblles", {"swstats": 0}),
                       ("gabls1", {"adaptivestep": "false"})):
        text = case_ini(case, **over)
        ini = Ini(text)
        out.append(("%s %s" % (case, over), case, text, cases.case_input(
            case, ini.get_int("grid", "ktot"), ini.get_float("grid", "zsize"))))
    mem = force_input()
    for label, keep in (("geo", "swtimedep_geo=1"),
                        ("wls", "swtimedep_wls=1"),
                        ("ls", "swtimedep_ls=1")):
        text = FORCE_INI
        for item in ("swtimedep_geo=1", "swtimedep_wls=1", "swtimedep_ls=1"):
            if item != keep:
                text = text.replace(item + "\n", "")
        out.append(("force " + label, "ftd", text, mem))
    out.append(("pbot", "ftd", pbot_text(), pin_input()))
    text = case_ini("gabls1").replace("swtimedep=1\ntimedeplist=th_sbot\n", "")
    for extra in ("", "\nswtimedep_sbot_2d=1\nsbot_2d_loadtime=300"):
        out.append(("sbot_2d" + extra.replace("\n", " "), "gabls1",
                    text.replace("sbcbot=dirichlet",
                                 "sbcbot=dirichlet\nsbot_2d_list=th" + extra),
                    cases.gabls1_input(64, 400.)))
    return out


GATE = gate_cases()


@pytest.mark.parametrize("label,casename,text,mem", GATE,
                         ids=[c[0] for c in GATE])
@pytest.mark.parametrize("chunk_env", ["1", "0"])
def test_chunk_gate_equals_jax(tmp_path, monkeypatch, label, casename, text,
                               mem, chunk_env):
    monkeypatch.setenv("MICROHH_CHUNK", chunk_env)
    write_nc(tmp_path / ("%s_input.nc" % casename), mem)
    jm = JModel(JIni(text), "run", casename, workdir=str(tmp_path),
                dtype=np.float64)
    tm = Model(Ini(text), "run", casename, dtype=torch.float64, device="cpu",
               input_nc=mem)
    assert tm._chunk_supported() == jm._chunk_supported()
    if label == "gabls1 {}":
        assert not tm._chunk_supported()


class Calls:
    """Counts the calls of the named methods of some objects."""

    def __init__(self, monkeypatch, *targets):
        self.n = 0
        for obj, attr in targets:
            orig = getattr(obj, attr)

            def counted(*a, _orig=orig, **k):
                self.n += 1
                return _orig(*a, **k)
            monkeypatch.setattr(obj, attr, counted)


def test_chunked_loop_keeps_static_geo_wls_pbot(tmp_path, monkeypatch):
    text, mem = pin_text(), pin_input()
    jdir, tdir = initial_files(tmp_path, "pin", text, mem)
    jm = JModel(JIni(text), "run", "pin", workdir=str(jdir),
                dtype=np.float64)
    jm.finish_setup()
    assert jm._chunk_supported() and jm.force.has_timedep
    assert jm.thermo.tdep_pbot is not None
    jcalls = Calls(monkeypatch, (jm.force, "update_timedep"),
                   (jm.thermo, "update_timedep"))
    js, _ = jm.run()
    assert jcalls.n == 0 and jm.timeloop.time == 40.
    js = {k: np.asarray(v) for k, v in js.items()}

    tm = Model(Ini(text), "run", "pin", workdir=str(tdir),
               dtype=torch.float64, device="cpu", input_nc=mem)
    tm.finish_setup()
    assert tm._chunk_supported()
    tcalls = Calls(monkeypatch, (tm.force, "update_timedep"),
                   (tm.thermo, "update_timedep"))
    ts = {k: v.numpy() for k, v in tm.run().items()}
    assert tcalls.n == 0 and tm._chunk is not None
    assert tm.timeloop.iteration == jm.timeloop.iteration
    assert state_err(tm, ts, js) <= TOL

    # the per-step loop takes the updates, and its state differs
    monkeypatch.setenv("MICROHH_CHUNK", "0")
    step = Model(Ini(text), "run", "pin", workdir=str(tdir),
                 dtype=torch.float64, device="cpu", input_nc=mem)
    step.finish_setup()
    scalls = Calls(monkeypatch, (step.force, "update_timedep"),
                   (step.thermo, "update_timedep"))
    ps = {k: v.numpy() for k, v in step.run().items()}
    assert step._chunk is None and scalls.n > 0
    assert state_err(tm, ps, ts) >= CONTROL
