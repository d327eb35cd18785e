"""The gated pool's forward kernel (``gated_pool_fwd_kernel``) against its
roofline: the least time of each launch in the window, by its bytes at
3.35 TB/s or its operations at the float32 peak, over the launches' device
time, from the device trace and the slides' tile counts."""

from benchmark.readers import pool_fwd_roofline as read  # noqa: F401
