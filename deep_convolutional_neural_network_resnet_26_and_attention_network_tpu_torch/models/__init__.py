"""Models: the ResNet-26 tile extractor, the gated attention-MIL head, the
StyleGAN generator and critic, the critic cut into a tile extractor, the
reference toolbox's misc blocks, and the auxiliary models: the
torchvision-template ResNet, the WAE and the LatentUNet."""

from . import (  # noqa: F401
    alt_resnet,
    attention_mil,
    blocks,
    disc_extractor,
    resnet,
    stylegan,
    unet,
    wae,
)
