"""Torchvision-template ResNet (the no-norm variant the reference vendors).

Counterpart of ``models/alt_resnet.py`` in the JAX package: the stripped
torchvision ResNet the reference keeps as the template of its narrow
ResNet-26 (reference: alt_resnet.py:1-165) -- no BatchNorm, plain ReLU,
bias-free convs, widths 64/128/256/512. The module names are
torchvision's (``conv1``, ``layer{s}.{b}.conv{1,2}``,
``layer{s}.{b}.downsample.0``, ``fc``), so a torchvision state dict
overlays it directly (:func:`from_torch_state_dict`). The forward takes
NHWC images, like the JAX function; the convs run in ``channels_last``.
"""

from typing import Sequence

import torch
from torch import nn
import torch.nn.functional as F

from .._device import resolve_device
from ..ops import init as I
from ..ops import nn as N

WIDTHS = (64, 128, 256, 512)


def _kaiming_relu(generator, conv):
    """kaiming fan_out for ReLU (gain sqrt(2)): torchvision's conv init."""
    o, i, kh, kw = conv.weight.shape
    conv.weight.copy_(I.kaiming_normal(generator, (o, i, kh, kw),
                                       o * kh * kw, 2.0 ** 0.5))


class BasicBlock(nn.Module):
    """Bias-free conv pair + optional 1x1 downsample
    (reference: alt_resnet.py:35-68)."""

    def __init__(self, cin: int, cout: int, stride: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False,
                               device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False,
                               device=device)
        self.downsample = (nn.Sequential(nn.Conv2d(
            cin, cout, 1, stride, 0, bias=False, device=device))
            if stride != 1 or cin != cout else None)

    @torch.no_grad()
    def reset_parameters(self, generator):
        convs = [self.conv1, self.conv2]
        if self.downsample is not None:
            convs.append(self.downsample[0])
        for conv in convs:
            _kaiming_relu(generator, conv)

    def forward(self, x, compute_dtype=None):
        out = N.relu(N.conv2d_nchw(x, self.conv1.weight, stride=self.stride,
                                   padding=1, compute_dtype=compute_dtype))
        out = N.conv2d_nchw(out, self.conv2.weight, stride=1, padding=1,
                            compute_dtype=compute_dtype)
        identity = (N.conv2d_nchw(x, self.downsample[0].weight,
                                  stride=self.stride, padding=0,
                                  compute_dtype=compute_dtype)
                    if self.downsample is not None else x)
        return N.relu(out + identity)


class ResNet(nn.Module):
    """Images [N, H, W, 3] (NHWC) -> logits [N, num_classes]
    (reference: alt_resnet.py:71-120)."""

    def __init__(self, layers: Sequence[int], *, num_classes: int = 1000,
                 widths: Sequence[int] = WIDTHS, device=None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(3, widths[0], 7, 2, 3, bias=False,
                               device=device)
        self.n_stages = len(layers)
        cin = widths[0]
        for s, (width, n) in enumerate(zip(widths, layers)):
            blocks = []
            for b in range(n):
                stride = 2 if (s > 0 and b == 0) else 1
                blocks.append(BasicBlock(cin, width, stride, device=device))
                cin = width
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(widths[-1], num_classes, device=device)

    def stages(self):
        return [getattr(self, f"layer{s + 1}") for s in range(self.n_stages)]

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's init, drawn from ``generator``: kaiming
        fan-out with gain sqrt(2) for the convs, kaiming fan-in with gain
        1 for the fc, zero bias."""
        _kaiming_relu(generator, self.conv1)
        o, i = self.fc.weight.shape
        self.fc.weight.copy_(I.linear_kaiming_fan_in(generator, i, o, 1.0))
        self.fc.bias.zero_()
        for stage in self.stages():
            for block in stage:
                block.reset_parameters(generator)

    def forward(self, x, *, compute_dtype=None):
        h = N.conv2d_nchw(x.permute(0, 3, 1, 2), self.conv1.weight, stride=2,
                          padding=3, compute_dtype=compute_dtype)
        h = F.max_pool2d(N.relu(h), 3, 2, 1)
        for stage in self.stages():
            for block in stage:
                h = block(h, compute_dtype)
        return N.linear(h.mean(dim=(2, 3)), self.fc.weight.T, self.fc.bias,
                        compute_dtype=compute_dtype)


def init_resnet(generator, layers: Sequence[int], *, num_classes: int = 1000,
                widths: Sequence[int] = WIDTHS, device=None):
    """A ResNet on ``device`` (the card by default) with the JAX
    package's init drawn from ``generator``."""
    model = ResNet(layers, num_classes=num_classes, widths=widths,
                   device="meta").to_empty(device=resolve_device(device))
    model.reset_parameters(generator)
    return model


def apply_resnet(model, x, *, compute_dtype=None):
    """x [N, H, W, 3] -> logits [N, num_classes]."""
    return model(x, compute_dtype=compute_dtype)


def resnet18(generator, **kwargs):
    return init_resnet(generator, [2, 2, 2, 2], **kwargs)


def resnet34(generator, **kwargs):
    return init_resnet(generator, [3, 4, 6, 3], **kwargs)


def from_torch_state_dict(model, state_dict):
    """Overlay a torchvision (or reference) state dict onto ``model`` in
    place, as the JAX package's ``from_torch_state_dict`` does onto its
    tree: ``conv1.weight``, ``fc.weight`` / ``fc.bias``, each block's 4-D
    ``conv1`` / ``conv2`` weight and its 4-D ``downsample`` conv
    (``downsample.0.weight``). Every other key is skipped, the BatchNorm
    ``downsample.1.*`` vectors of a torchvision checkpoint among them.
    Returns ``(model, loaded names)`` (reference: alt_resnet.py:148-165)."""
    loaded = []
    with torch.no_grad():
        for name, value in state_dict.items():
            v = torch.as_tensor(value)
            if name in ("conv1.weight", "fc.weight", "fc.bias"):
                layer, attr = name.split(".")
                target = getattr(getattr(model, layer), attr)
            elif name.startswith("layer"):
                parts = name.split(".")            # layer1.0.conv1.weight
                block = getattr(model, parts[0])[int(parts[1])]
                leaf = parts[2]
                if leaf in ("conv1", "conv2") and v.ndim == 4:
                    target = getattr(block, leaf).weight
                elif leaf == "downsample" and v.ndim == 4:
                    target = block.downsample[0].weight
                else:
                    continue
            else:
                continue
            target.copy_(v)
            loaded.append(name)
    return model, loaded


# the reference's pretrained weight URLs (reference: alt_resnet.py:11-21)
MODEL_URLS = {
    "resnet18": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    "resnet34": "https://download.pytorch.org/models/resnet34-333f7ec4.pth",
}


def from_pretrained(model, arch: str = "resnet18", *, url: str = None,
                    progress: bool = True):
    """Overlay torchvision's pretrained ImageNet weights through
    ``torch.hub``'s cache (reference: alt_resnet.py:148-165
    ``load_state_dict_from_url``). Offline it raises a RuntimeError that
    points to :func:`from_torch_state_dict` with a saved ``.pth``."""
    url = url or MODEL_URLS[arch]
    try:
        state_dict = torch.hub.load_state_dict_from_url(
            url, progress=progress, map_location="cpu")
    except Exception as e:  # no egress / bad mirror
        raise RuntimeError(
            f"could not fetch pretrained weights from {url}; download the "
            ".pth manually and use from_torch_state_dict(model, "
            "torch.load(path))") from e
    return from_torch_state_dict(model, state_dict)
