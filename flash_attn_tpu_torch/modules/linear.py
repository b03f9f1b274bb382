"""Dense layer with separate storage and compute dtypes (the counterpart of
flax's `nn.Dense(dtype=...)`, which keeps its parameters in fp32 and
computes in `dtype`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are stored in `param_dtype` (default:
    `dtype`) and cast, with the input, to `dtype` at use. With both dtypes
    equal the casts are no-ops, which is how the serving path runs."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=torch.bfloat16, param_dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)
