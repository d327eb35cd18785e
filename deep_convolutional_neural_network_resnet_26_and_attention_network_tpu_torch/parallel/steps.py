"""Train and eval steps of the attention-MIL model on one device.

Counterpart of the single-device half of ``parallel/steps.py`` in the JAX
package, after the reference training loop (reference:
gbm/classify_combined.py:388-485): Adam(betas=(0.9, 0.999), eps=1e-8),
gradients summed over ``accum`` bags before each optimizer step (the
reference uses 5), and the staged learning rate passed in per step.

Where the JAX package returns a gradient tree and sums trees
(``make_accumulate``), each bag's ``loss.backward()`` here adds its
gradient into the parameters' ``.grad``, so consecutive calls sum the
window exactly as the JAX package's ``acc + grads`` does; ``apply_updates``
steps and clears them. ``torch.optim.Adam`` with the learning rate set per
step is optax's ``scale_by_adam`` followed by ``-lr * update``. The batched
window step with ``bag_weights`` (``make_train_step``) serves only the
multi-device mesh and comes with it.
"""

import torch

from ..models import attention_mil as amil

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def make_optimizer(model):
    """Adam matching the JAX package's ``optax.scale_by_adam(b1=0.9,
    b2=0.999, eps=1e-8)``; the learning rate is set by each
    :func:`apply_updates` call so the staged schedule can change it."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=ADAM_BETAS,
                            eps=ADAM_EPS)


def apply_updates(optimizer, lr: float):
    """One optimizer step on the summed gradients at learning rate ``lr``
    (``optimizer.step()`` after the reference's 5 accumulated bags,
    gbm/classify_combined.py:450-454), then clear the gradients. A
    parameter without a gradient steps with a zero one, as optax updates
    every leaf: its moments decay and its step count advances."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_bag_grad(cfg: amil.MILConfig, *, compute_dtype=None):
    """Per-bag loss backward: ``fn(model, tiles, mask, label,
    generator=None, *, scores=None, keep=None) -> outputs``. One call is one
    ``loss.backward()`` of the reference's hot loop
    (gbm/classify_combined.py:446-447): the bag's gradient is added to each
    parameter's ``.grad``. The outputs are detached."""

    def grad_fn(model, tiles, mask, label, generator=None, **noise):
        outs = amil.apply_attention_mil(
            model, tiles, label, cfg, mask=mask, train=True,
            generator=generator, compute_dtype=compute_dtype, **noise)
        outs["loss"].backward()
        return {**outs, "loss": outs["loss"].detach()}

    return grad_fn


def make_bag_forward(cfg: amil.MILConfig, *, train: bool = False,
                     compute_dtype=None, extractor=None):
    """Single-bag forward without autograd: ``fn(model, tiles, mask, label,
    generator=None) -> dict``; ``train=True`` takes the training forward's
    subsample and dropout (validation before the Check stage does).
    ``extractor`` swaps the tile embedder (the W8A8 int8 serving path,
    ``ops.quant.make_int8_extractor``)."""

    def fwd(model, tiles, mask, label, generator=None):
        with torch.no_grad():
            return amil.apply_attention_mil(
                model, tiles, label, cfg, mask=mask, train=train,
                generator=generator, compute_dtype=compute_dtype,
                extractor=extractor)

    return fwd


def make_eval_step(cfg: amil.MILConfig, *, compute_dtype=None):
    """``eval(model, tiles [B, T, H, W, 3], masks [B, T], labels [B]) ->``
    the per-bag outputs stacked on a leading axis, without ``Fterm``."""
    fwd = make_bag_forward(cfg, compute_dtype=compute_dtype)

    def step(model, tiles, masks, labels):
        outs = [fwd(model, t, m, int(lbl))
                for t, m, lbl in zip(tiles, masks, labels)]
        return {k: torch.stack([o[k] for o in outs])
                for k in outs[0] if k != "Fterm"}

    return step
