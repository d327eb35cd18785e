"""CNN interpretability kit: the counterpart of the JAX package's
``interpret`` (reference: pytorch-cnn-visualizations-master/src/*).
Forward hooks become the ResNet-26's activation taps; backward ReLU hooks
become a guided activation with its own backward."""

from . import gradcam, guided, misc, optimize, saliency  # noqa: F401
