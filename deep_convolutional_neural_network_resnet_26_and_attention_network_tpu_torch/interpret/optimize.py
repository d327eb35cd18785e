"""Input-optimization visualizations: filter maximization, deep dream,
inverted representations, class-specific image generation.

Counterpart of ``interpret/optimize.py`` in the JAX package (reference:
pytorch-cnn-visualizations-master/src/cnn_layer_visualization.py,
deep_dream.py, inverted_representation.py,
generate_class_specific_samples.py). Each runs plain gradient steps on
the input image, eagerly: one forward and backward a step.

The random start images are drawn from ``generator`` on its own device
and moved to the model's, so a CPU generator gives every device the same
start; the default is a CPU generator seeded 0, as the JAX package's
default key is ``PRNGKey(0)``.
"""

import torch

from .._device import module_device
from ..models import resnet
from . import misc


def _ascend(loss_fn, x0, *, steps: int, lr: float):
    """Gradient DEscent on ``loss_fn`` (the losses are negated
    objectives). The history records the loss at the pre-step ``x``, as
    the reference logs it. Returns ``(x, history)``."""
    x = x0.detach()
    history = []
    for _ in range(steps):
        x.requires_grad_(True)
        with torch.enable_grad():
            val = loss_fn(x)
            (g,) = torch.autograd.grad(val, x)
        x = (x - lr * g).detach()
        history.append(float(val.detach()))
    return x, history


def _uniform(generator, shape, lo, hi, device):
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (lo + (hi - lo) * u).to(device)


def filter_loss(model, layer: str, filter_pos: int):
    """The negated mean activation of one filter at a tap."""
    def loss(x):
        _, acts = resnet.apply_resnet26(model, x, taps=True)
        return -acts[layer][..., filter_pos].mean()

    return loss


def inversion_loss(model, target, layer: str, *, alpha_reg_alpha: float,
                   alpha_reg_lambda: float, tv_reg_beta: float,
                   tv_reg_coeff: float):
    """Euclidean match to the ``target`` activation at a tap, plus the
    alpha-norm and total-variation regularizers."""
    def loss(x):
        _, acts = resnet.apply_resnet26(model, x, taps=True)
        euc = (torch.linalg.vector_norm(acts[layer] - target)
               / torch.linalg.vector_norm(target))
        alpha_reg = alpha_reg_lambda * (x.abs() ** alpha_reg_alpha).sum()
        dh = x[:, 1:, :-1, :] - x[:, :-1, :-1, :]
        dw = x[:, :-1, 1:, :] - x[:, :-1, :-1, :]
        tv = tv_reg_coeff * ((dh ** 2 + dw ** 2)
                             ** (tv_reg_beta / 2.0)).sum()
        return euc + alpha_reg + tv

    return loss


def class_loss(model, target_class: int, wd: float, apply_fn):
    """The negated class logit plus an L2 penalty on the image."""
    def loss(x):
        return -apply_fn(model, x)[0, target_class] + wd * (x * x).sum()

    return loss


def _image(x):
    return misc.recreate_image(x.cpu().numpy())


def cnn_layer_visualization(model, layer: str, filter_pos: int, *,
                            size: int = 56, steps: int = 30, lr: float = 1.0,
                            generator=None):
    """Gradient-ascent filter maximization from a random image
    U(-0.14, 0.14) (~ uint8 116-180 normalized) (reference:
    cnn_layer_visualization.py:16-114). Returns (uint8 image, loss
    history)."""
    x0 = _uniform(generator, (1, size, size, 3), -0.14, 0.14,
                  module_device(model))
    x, hist = _ascend(filter_loss(model, layer, filter_pos), x0,
                      steps=steps, lr=lr)
    return _image(x), hist


def deep_dream(model, image_u8, layer: str, filter_pos: int, *,
               steps: int = 50, lr: float = 12.0):
    """Maximize a filter on a real image with a large LR (reference:
    deep_dream.py:15-70)."""
    x0 = torch.from_numpy(misc.preprocess_image(image_u8)).to(
        module_device(model))
    x, hist = _ascend(filter_loss(model, layer, filter_pos), x0,
                      steps=steps, lr=lr)
    return _image(x), hist


def inverted_representation(model, image_u8, layer: str, *,
                            steps: int = 100, lr: float = 1e-2,
                            alpha_reg_alpha: float = 6.0,
                            alpha_reg_lambda: float = 1e-2,
                            tv_reg_beta: float = 3.0,
                            tv_reg_coeff: float = 1e-2, generator=None):
    """Reconstruct an image from its representation at a tap, from a
    start 0.1 * U(0, 1) (reference: inverted_representation.py:14-90)."""
    device = module_device(model)
    target_x = torch.from_numpy(misc.preprocess_image(image_u8)).to(device)
    with torch.no_grad():
        _, target_acts = resnet.apply_resnet26(model, target_x, taps=True)
    loss = inversion_loss(model, target_acts[layer], layer,
                          alpha_reg_alpha=alpha_reg_alpha,
                          alpha_reg_lambda=alpha_reg_lambda,
                          tv_reg_beta=tv_reg_beta, tv_reg_coeff=tv_reg_coeff)
    x0 = 1e-1 * _uniform(generator, tuple(target_x.shape), 0.0, 1.0, device)
    x, hist = _ascend(loss, x0, steps=steps, lr=lr)
    return _image(x), hist


def class_specific_image_generation(model, target_class: int, *,
                                    size: int = 56, steps: int = 150,
                                    lr: float = 6.0, wd: float = 1e-4,
                                    apply_fn=None, generator=None):
    """Generate an input that maximizes one class logit, from U(-1, 1)
    (reference: generate_class_specific_samples.py:15-80)."""
    apply_fn = apply_fn or resnet.apply_resnet26
    x0 = _uniform(generator, (1, size, size, 3), -1.0, 1.0,
                  module_device(model))
    x, hist = _ascend(class_loss(model, target_class, wd, apply_fn), x0,
                      steps=steps, lr=lr)
    return _image(x), hist
