"""Parameter initializers reproducing the reference's PyTorch init semantics.

The reference resets every layer explicitly (reference: gbm/model.py:161-181):
  * Conv2d:   kaiming_normal_(mode='fan_out', nonlinearity='leaky_relu', a=0.1)
  * Linear in a module whose name contains 'attention':
              kaiming_normal_(mode='fan_in', nonlinearity='tanh')
  * Linear named 'classifier' (the buffer head): xavier_normal_
  * other Linear: kaiming_normal_(mode='fan_in', nonlinearity='leaky_relu', a=0.1)
  * all biases: zeros

Gains follow torch.nn.init.calculate_gain:
  leaky_relu(a): sqrt(2 / (1 + a^2));   tanh: 5/3;   linear/identity: 1.
Weight layouts are torch-native: conv kernels OIHW, linears [out, in].
Every draw comes from the caller's ``torch.Generator``, on its device.
"""

import math

import torch


def leaky_relu_gain(negative_slope: float = 0.1) -> float:
    return math.sqrt(2.0 / (1.0 + negative_slope ** 2))


TANH_GAIN = 5.0 / 3.0


def _normal(generator, shape, std):
    return std * torch.randn(shape, generator=generator,
                             device=generator.device, dtype=torch.float32)


def kaiming_normal(generator, shape, fan: int, gain: float):
    """N(0, (gain/sqrt(fan))^2) — matches torch.nn.init.kaiming_normal_."""
    return _normal(generator, shape, gain / math.sqrt(fan))


def conv_kernel(generator, kh, kw, cin, cout, negative_slope=0.1):
    """Conv kernel OIHW with torch fan_out = cout*kh*kw (mode='fan_out')."""
    return kaiming_normal(generator, (cout, cin, kh, kw), cout * kh * kw,
                          leaky_relu_gain(negative_slope))


def linear_kaiming_fan_in(generator, cin, cout, gain):
    """Linear weight [out, in], kaiming fan_in (torch fan_in = cin)."""
    return kaiming_normal(generator, (cout, cin), cin, gain)


def linear_xavier_normal(generator, cin, cout):
    """Linear weight [out, in], xavier normal: std = sqrt(2/(fan_in+fan_out))."""
    return _normal(generator, (cout, cin), math.sqrt(2.0 / (cin + cout)))
