"""The disabled thermodynamics (``microhh_tpu/ops/thermo.py``; reference
``src/thermo_disabled.cxx``): no scalar, no buoyancy, no base state.  At 4th
order any passive scalars ride along; at 2nd order a case without scalars
runs on the dry kernels' neutral set (ops/fused.py ``has_thermo=False``)."""


class ThermoDisabled:
    scalars = ()

    def create_basestate(self, input_nc):
        pass

    def exec(self, ctx, s, t, aux):
        return t
