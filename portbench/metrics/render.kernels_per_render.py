"""Device kernels a render in the traced window."""

from portbench.harness.readers import kernels_per_unit as read  # noqa: F401
