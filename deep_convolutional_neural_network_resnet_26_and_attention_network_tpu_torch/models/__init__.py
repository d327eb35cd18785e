"""Models: the ResNet-26 tile extractor, the gated attention-MIL head, the
StyleGAN generator and critic, the critic cut into a tile extractor, and
the reference toolbox's misc blocks."""

from . import (  # noqa: F401
    attention_mil,
    blocks,
    disc_extractor,
    resnet,
    stylegan,
)
