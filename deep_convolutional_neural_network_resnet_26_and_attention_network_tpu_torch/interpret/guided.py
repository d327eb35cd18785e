"""Guided backpropagation through a guided activation.

Counterpart of ``interpret/guided.py`` in the JAX package. The reference
clamps gradients in backward ReLU hooks: zero wherever the forward input
was non-positive OR the incoming gradient is negative (reference:
pytorch-cnn-visualizations-master/src/guided_backprop.py:15-99). Here, as
in the JAX package, the same semantics are an activation with its own
backward (a ``torch.autograd.Function`` where JAX has a ``custom_vjp``)
swapped into the ResNet-26 through its ``act_fn``.
"""

import torch

from .._device import module_device
from ..models import resnet
from ..ops import nn as N
from . import saliency


class _GuidedLeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, negative_slope):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, x, negative_slope * x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # the gradient passes only where the forward input was positive
        # AND the incoming gradient is positive; none for the slope
        return torch.where((x > 0) & (g > 0), g, torch.zeros_like(g)), None


def guided_leaky_relu(x, negative_slope: float = N.LEAKY_SLOPE):
    """LeakyReLU forward, guided backward."""
    return _GuidedLeakyReLU.apply(x, negative_slope)


def guided_backprop(model, x, target_class: int, *, apply_fn=None):
    """Input gradient [N, H, W, C] of ``logits[0, target_class]`` with
    guided activations. ``model``: a ResNet26 by default; ``apply_fn``
    overrides the forward for other models (it must accept ``act_fn``).
    ``x`` goes to the model's device."""
    apply_fn = apply_fn or resnet.apply_resnet26

    def score(inp):
        logits = apply_fn(model, inp, act_fn=guided_leaky_relu)
        return logits[0, target_class]

    return saliency.vanilla_backprop(
        score, torch.as_tensor(x, device=module_device(model)))


def layer_activation_guided_backprop(model, x, layer: str, filter_pos: int):
    """Guided gradient of one filter's mean activation at a tap
    (reference: layer_activation_with_guided_backprop.py)."""

    def score(inp):
        _, acts = resnet.apply_resnet26(model, inp, taps=True,
                                        act_fn=guided_leaky_relu)
        return acts[layer][..., filter_pos].mean()

    return saliency.vanilla_backprop(
        score, torch.as_tensor(x, device=module_device(model)))
