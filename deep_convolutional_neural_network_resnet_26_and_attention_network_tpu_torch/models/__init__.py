"""Models: the ResNet-26 tile extractor and the gated attention-MIL head."""

from . import attention_mil, resnet  # noqa: F401
