"""Layers with flax semantics (counterpart of
``garfield_tpu/models/_layers.py``).

Conventions kept from the JAX zoo, in PyTorch idiom:
  - modules take NCHW tensors (the trainer permutes the JAX package's NHWC
    batches at its public boundary);
  - parameters stay float32 and ``dtype`` is the compute type: convs and
    dense layers cast their inputs and weights to it, as flax ``dtype=``
    does;
  - ``BatchNorm`` follows ``flax.linen.BatchNorm`` (momentum 0.9, eps 1e-5):
    batch statistics in f32 as E[x^2] - E[x]^2 clipped at 0, the running
    variance updated with the BIASED batch variance, and the running
    statistics left untouched by ``forward``. ``torch.nn.BatchNorm2d``
    differs on all three (unbiased running variance, momentum 0.1, in-place
    update), so it is not used.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv", "Dense", "BatchNorm", "init_parameters"]

# flax.linen default kernel init: lecun_normal = variance_scaling(1.0,
# "fan_in", "truncated_normal"); this constant is the std of a unit normal
# truncated to [-2, 2], which the initializer divides out.
_TRUNC_STD = 0.87962566103423978


class Conv(nn.Module):
    """2-D convolution, no bias by default (flax ``nn.Conv`` as the zoo
    builds it): OIHW float32 weight, computed in ``dtype``."""

    def __init__(self, in_features, features, kernel, stride=1, padding=0,
                 use_bias=False, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel)
        )
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, self.padding)


class Dense(nn.Module):
    """Fully connected layer (flax ``nn.Dense``), computed in ``dtype``."""

    def __init__(self, in_features, features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with flax semantics (module docstring).

    In training mode ``forward`` normalizes with the batch statistics and
    keeps them in ``batch_stats``; ``updated_stats()`` then gives the new
    running statistics, which the trainer averages over worker slots before
    it writes them back (``parallel.core``)."""

    def __init__(self, features, momentum=0.9, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.batch_stats = None

    def forward(self, x):
        if self.training:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            mean2 = (xf * xf).mean((0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            self.batch_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        y = x - mean[None, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = y * mul[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(self.dtype)

    def updated_stats(self):
        """(running_mean, running_var) after the last training batch."""
        mean, var = self.batch_stats
        m = self.momentum
        return (m * self.running_mean + (1 - m) * mean,
                m * self.running_var + (1 - m) * var)


@torch.no_grad()
def init_parameters(module, generator):
    """flax's default initialization, drawn from ``generator``: lecun-normal
    (truncated) conv and dense weights, zero biases, BN scale 1 and bias 0,
    running mean 0 and variance 1."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            fan_in = math.prod(m.weight.shape[1:])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
