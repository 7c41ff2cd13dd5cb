"""Networks of the port's closures (``microhh_tpu/models``)."""
