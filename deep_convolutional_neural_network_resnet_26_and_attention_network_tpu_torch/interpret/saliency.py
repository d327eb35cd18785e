"""Gradient saliency: vanilla backprop, grad x image, integrated
gradients, and smooth-grad averaging.

Counterpart of ``interpret/saliency.py`` in the JAX package (reference:
pytorch-cnn-visualizations-master/src/vanilla_backprop.py,
grad_times_image.py, integrated_gradients.py, smooth_grad.py), with
``torch.autograd.grad`` where JAX takes ``jax.grad``.

Every technique takes ``score_fn(x) -> scalar`` (typically
``lambda x: apply_fn(model, x)[0, target_class]``), so it works with the
ResNet-26 tile classifier, the attention-MIL head over a bag's features
(``attention_pool(model, H, cfg)["logits"][0, c]``, whose pool runs the
gated pool's forward and backward kernels on the card), or any
differentiable model. ``x`` stays on its own device.
"""

import torch


def class_score_fn(apply_fn, model, target_class: int):
    """score_fn for a logits-producing ``apply_fn(model, x [N, ...])``."""
    def score(x):
        return apply_fn(model, x)[0, target_class]

    return score


def vanilla_backprop(score_fn, x):
    """d(score)/d(input) (reference: vanilla_backprop.py)."""
    x = torch.as_tensor(x).detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(score_fn(x), x)
    return g


def grad_times_image(score_fn, x):
    """Gradient * input (reference: grad_times_image.py)."""
    x = torch.as_tensor(x)
    return vanilla_backprop(score_fn, x) * x


def generate_images_on_linear_path(x, steps: int):
    """Blank -> input interpolation (reference: integrated_gradients.py)."""
    return [x * (i / steps) for i in range(steps)]


def integrated_gradients(score_fn, x, steps: int = 100):
    """Riemann-sum path integral of gradients from a black image
    (reference: integrated_gradients.py generate_integrated_gradients)."""
    x = torch.as_tensor(x)
    total = torch.zeros_like(x)
    for xbar in generate_images_on_linear_path(x, steps):
        total = total + vanilla_backprop(score_fn, xbar) / steps
    return total


def smooth_grad(grad_technique, x, generator, *, param_n: int = 50,
                param_sigma_multiplier: float = 4.0):
    """Average a gradient technique over noisy copies of the input
    (reference: smooth_grad.py generate_smooth_grad): noise std =
    sigma_mult / (max - min) of the input. Each draw is a standard normal
    of ``x``'s shape from ``generator``, on the generator's device, moved
    to ``x``'s, so a CPU generator gives every device the same draws."""
    x = torch.as_tensor(x)
    sigma = param_sigma_multiplier / (float(x.max()) - float(x.min())
                                      + 1e-12)
    total = torch.zeros_like(x)
    for _ in range(param_n):
        z = torch.randn(x.shape, generator=generator,
                        device=generator.device)
        total = total + grad_technique(x + sigma * z.to(x.device, x.dtype))
    return total / param_n
