"""Device milliseconds of host-to-device copies in the window per 1000
tiles the window completed, from the device trace."""

from benchmark.readers import h2d_ms_per_ktile as read  # noqa: F401
