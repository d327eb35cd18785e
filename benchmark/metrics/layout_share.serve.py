"""Device time of kernels that only change a tensor's layout (cuDNN's
channel padding and NCHW <-> NHWC conversions, ``readers.LAYOUT_KERNELS``)
over the window's busy time, from the device trace."""

from benchmark.readers import layout_percent as read  # noqa: F401
