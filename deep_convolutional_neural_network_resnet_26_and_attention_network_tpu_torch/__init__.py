"""PyTorch/CUDA port of the attention-MIL framework for whole-slide
histopathology, for an NVIDIA H100.

Each module mirrors the module of the same relative path in the JAX
package (``deep_convolutional_neural_network_resnet_26_and_attention_network_tpu``),
which stays the numerical reference. The public functions keep the JAX
layouts (NHWC tiles, ``[T]`` masks, ``[K, T]`` attention) so one numpy
array can feed both packages; inside, convolutions run NCHW in the
``channels_last`` memory format. Where the JAX package wrote a Pallas
kernel, the port has a hand-written CUDA kernel under ``csrc/``, built on
first use (``ops/_build.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no such request they raise
(``_device.resolve_device``). Importing the package touches no device,
imports no JAX and builds nothing.
"""

from . import data, models, ops, parallel, train, utils  # noqa: F401

__version__ = "0.1.0"
