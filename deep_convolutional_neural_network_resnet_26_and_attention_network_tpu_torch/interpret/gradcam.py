"""Grad-CAM and guided Grad-CAM over the ResNet-26 activation taps.

Counterpart of ``interpret/gradcam.py`` in the JAX package (reference:
pytorch-cnn-visualizations-master/src/gradcam.py:13-110 and
guided_gradcam.py). The tap dict ('stem', 'stage1'..'stage4') plays the
role of the hooked conv layer; the activation gradient comes from
``torch.autograd.grad`` through a function that re-enters the stages at
the tap, as the JAX package's ``from_tap`` does.
"""

import torch
import torch.nn.functional as F

from .._device import module_device
from ..models import resnet
from ..ops import nn as N
from . import guided as G

LAYER_ORDER = ("stem", "stage1", "stage2", "stage3", "stage4")


def _from_tap(model, layer, a):
    """logits [N, embed_dim] from the NHWC activation ``a`` at tap
    ``layer``: the stages after it, the average pool and the fc."""
    h = a.permute(0, 3, 1, 2)
    for stage in model.stages()[LAYER_ORDER.index(layer):]:
        for block in stage:
            h = block(h)
    return N.linear(h.mean(dim=(2, 3)), model.fc.weight.T)


def gradcam(model, x, target_class: int, layer: str = "stage4"):
    """[H, W] class-activation map in [0, 1] at input resolution, on the
    model's device. ``target_class`` picks one of the fc's ``embed_dim``
    outputs.

    cam = relu(sum_c mean-grad_c * A_c), min-max normalized then bilinear
    upsampled (reference: gradcam.py generate_cam)."""
    x = torch.as_tensor(x, device=module_device(model))
    with torch.no_grad():
        _, acts = resnet.apply_resnet26(model, x, taps=True)
    conv_out = acts[layer].detach().requires_grad_(True)   # [1, h, w, c]
    with torch.enable_grad():
        score = _from_tap(model, layer, conv_out)[0, target_class]
        (grads,) = torch.autograd.grad(score, conv_out)
    conv_out = conv_out.detach()
    weights = grads[0].mean(dim=(0, 1))                     # [c]
    cam = torch.clamp_min((weights * conv_out[0]).sum(dim=-1), 0.0)
    cam = (cam - cam.min()) / (cam.max() - cam.min() + 1e-12)
    return F.interpolate(cam[None, None], size=tuple(x.shape[1:3]),
                         mode="bilinear", align_corners=False)[0, 0]


def guided_gradcam(model, x, target_class: int, layer: str = "stage4"):
    """Elementwise product of the CAM and the guided-backprop gradients
    (reference: guided_gradcam.py guided_grad_cam): [H, W, C]."""
    cam = gradcam(model, x, target_class, layer)
    gb = G.guided_backprop(model, x, target_class)[0]
    return cam[..., None] * gb
