"""MLP modules (counterpart of flash_attn_tpu/modules/mlp.py). The matrix
products are plain dense layers (`modules.linear.Linear`, weights stored in
`param_dtype` and computed in `dtype`), as the JAX package leaves them to
XLA."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.modules.linear import Linear


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# jax.nn.gelu defaults to the tanh approximation, so "gelu" does too.
ACT2FN = {
    "gelu": _gelu_tanh,
    "gelu_new": _gelu_tanh,
    "gelu_approx": _gelu_tanh,
    "gelu_pytorch_tanh": _gelu_tanh,
    "relu": F.relu,
    "sqrelu": lambda x: torch.square(F.relu(x)),
    "silu": F.silu,
    "swiglu": F.silu,  # gate activation for GatedMlp
    "swiglu_gelu": _gelu_tanh,  # Gemma gate
    "glu": torch.sigmoid,
}


class Mlp(nn.Module):
    """fc1 -> activation -> fc2."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None,
                 activation: str = "gelu_approx", bias1: bool = True,
                 bias2: bool = True, device=None, dtype=torch.bfloat16,
                 param_dtype=None):
        super().__init__()
        hidden = hidden_features or 4 * in_features
        out = out_features or in_features
        self.activation = activation
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.fc1 = Linear(in_features, hidden, bias=bias1, **kw)
        self.fc2 = Linear(hidden, out, bias=bias2, **kw)

    def forward(self, x):
        return self.fc2(ACT2FN[self.activation](self.fc1(x)))


class GatedMlp(nn.Module):
    """SwiGLU-style gated MLP: out = fc2(act(fc1_gate(x)) * fc1_up(x)), with
    separate gate and up projections as in the JAX package."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, activation: str = "silu",
                 bias1: bool = False, bias2: bool = False,
                 multiple_of: int = 128, device=None, dtype=torch.bfloat16,
                 param_dtype=None):
        super().__init__()
        out = out_features or in_features
        if hidden_features is not None:
            hidden = hidden_features
        else:
            hidden = int(8 * in_features / 3)
            hidden = (hidden + multiple_of - 1) // multiple_of * multiple_of
        self.activation = activation
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.fc1_gate = Linear(in_features, hidden, bias=bias1, **kw)
        self.fc1_up = Linear(in_features, hidden, bias=bias1, **kw)
        self.fc2 = Linear(hidden, out, bias=bias2, **kw)

    def forward(self, x):
        y = ACT2FN[self.activation](self.fc1_gate(x)) * self.fc1_up(x)
        return self.fc2(y)
