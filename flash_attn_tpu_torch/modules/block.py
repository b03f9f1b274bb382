"""Transformer block (counterpart of flash_attn_tpu/modules/block.py):
pre-norm with an fp32 residual stream, post-norm, and the parallel block.
Norms compute in fp32 and their outputs are cast to the block's dtype, as
the JAX package's `nn.RMSNorm/LayerNorm(dtype=float32)` then `.astype` do.
The JAX block's residual dropout and drop-path options are not kept: the
model raises when its config asks for residual dropout while training."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from flash_attn_tpu_torch.modules.mha import InferenceParams


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, in fp32 (flax nn.RMSNorm)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device)
        )

    def forward(self, x):
        x = x.float()
        x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps)
        return x * self.weight


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 parameters that computes in fp32 whatever the
    input's dtype (flax nn.LayerNorm(dtype=float32))."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__(dim, eps=eps, device=device, dtype=torch.float32)

    def forward(self, x):
        return super().forward(x.float())


def make_norm(dim: int, eps: float, rms_norm: bool, device=None) -> nn.Module:
    """An fp32 RMSNorm or LayerNorm."""
    return (RMSNorm if rms_norm else LayerNorm)(dim, eps, device=device)


class Block(nn.Module):
    """prenorm:  res = x + mixer(norm1(x)); out = mlp(norm2(res)), returning
    (out, res) with `res` the residual stream (fp32 when residual_in_fp32);
    postnorm: x = norm1(x + mixer(x)); out = norm2(x + mlp(x))."""

    def __init__(self, dim: int, mixer: Callable[[], nn.Module],
                 mlp: Callable[[], nn.Module], norm_eps: float = 1e-5,
                 prenorm: bool = True, residual_in_fp32: bool = True,
                 rms_norm: bool = False, parallel_block: bool = False,
                 parallel_block_tied_norm: bool = False, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.prenorm = prenorm
        self.residual_in_fp32 = residual_in_fp32
        self.parallel_block = parallel_block
        self.parallel_block_tied_norm = parallel_block_tied_norm
        self.dtype = dtype
        self.mixer = mixer()
        self.mlp = mlp()
        self.norm1 = make_norm(dim, norm_eps, rms_norm, device)
        self.norm2 = (
            None if parallel_block and parallel_block_tied_norm
            else make_norm(dim, norm_eps, rms_norm, device)
        )

    def forward(self, hidden_states: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                inference_params: Optional[InferenceParams] = None,
                dropout_seed: Optional[int] = None):
        """`dropout_seed` goes to the mixer (its attention dropout's mask)."""
        mix = dict(inference_params=inference_params)
        if dropout_seed is not None:
            mix["dropout_seed"] = dropout_seed
        if not self.prenorm:
            attn_out = self.mixer(hidden_states, **mix)
            x = self.norm1(hidden_states + attn_out).to(self.dtype)
            return self.norm2(x + self.mlp(x)).to(self.dtype)
        acc = torch.float32 if self.residual_in_fp32 else hidden_states.dtype
        res = (hidden_states.to(acc) if residual is None
               else residual + hidden_states.to(acc))
        normed1 = self.norm1(res).to(self.dtype)
        if self.parallel_block:
            normed2 = (normed1 if self.norm2 is None
                       else self.norm2(res).to(self.dtype))
            attn_out = self.mixer(normed1, **mix)
            return attn_out + self.mlp(normed2), res
        attn_out = self.mixer(normed1, **mix)
        res = res + attn_out.to(acc)
        return self.mlp(self.norm2(res).to(self.dtype)), res
