"""The disabled thermodynamics (``microhh_tpu/ops/thermo.py``; reference
``src/thermo_disabled.cxx``): no scalar, no buoyancy, no base state."""


class ThermoDisabled:
    scalars = ()

    def create_basestate(self, input_nc):
        pass

    def exec(self, ctx, s, t, aux):
        return t
