"""The attention-MIL classifier CLI's configuration.

Counterpart of ``train/classify.py`` in the JAX package. Only
:func:`make_config` is ported so far, for the serving daemon
(``train/serve.py``); the training, validation and interface CLI comes
with the training slice.
"""

from ..models import attention_mil as amil


def make_config(args, class_weights=None) -> amil.MILConfig:
    """``args.arch`` ``full`` (widths 20/40/60/80, 3 blocks a stage) or
    ``tiny`` (widths 8, 1 block a stage), ``args.stem`` (``conv7`` unless
    given) and optional class weights. ``args.remat`` is ignored: the
    port's ``MILConfig`` has no ``remat`` until the training slice, and
    serving never recomputes activations."""
    cw = tuple(class_weights) if class_weights is not None else None
    stem = getattr(args, "stem", "conv7")
    if args.arch == "tiny":
        return amil.MILConfig(widths=(8, 8, 8, 8), blocks=(1, 1, 1, 1),
                              class_weights=cw, stem=stem)
    return amil.MILConfig(class_weights=cw, stem=stem)
