"""The disabled thermodynamics (``microhh_tpu/ops/thermo.py``; reference
``src/thermo_disabled.cxx``): no scalar, no buoyancy, no base state, no N2.
Passive scalars ride along.  At 2nd order a case without scalars runs on
the dry kernels' neutral set (ops/fused.py ``has_thermo=False``), one with
scalars on the generic kernels without a stability term."""


class ThermoDisabled:
    scalars = ()

    def create_basestate(self, input_nc):
        pass

    def exec(self, ctx, s, t, aux):
        return t

    def get_n2(self, ctx, s):
        return None
