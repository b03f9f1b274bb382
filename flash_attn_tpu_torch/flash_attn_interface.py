"""Public dense flash-attention API (counterpart of
flash_attn_tpu/flash_attn_interface.py `flash_attn_func` and its packed
forms).

The JAX package's `custom_vjp` core becomes `_FlashAttnCore`, a
`torch.autograd.Function` whose forward runs `kernels.flash_fwd` and whose
backward runs `kernels.flash_bwd` (two kernels on the card, their plain
versions on the CPU). The backward is deterministic: no atomics.

Layouts: (batch, seqlen, nheads, headdim) ["bshd"] by default, or
["bhsd"]. The kernels take strided inputs, so bshd tensors go in as
transposed views without a copy, and the outputs come back in the same
layout as q.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels.common import rows_dense
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd

__all__ = [
    "flash_attn_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_kvpacked_func",
]


class _FlashAttnCore(torch.autograd.Function):
    """out, lse = attention(q, k, v) in (b, h, s, d); the backward takes dO
    only (the LSE's cotangent is ignored, as in the JAX package) and needs
    no copy of out (see kernels.flash_bwd on delta)."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale, causal, window_size, softcap,
                extras):
        kw = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap)
        q, k, v = (rows_dense(x) for x in (q, k, v))
        out, lse = flash_attention_fwd(q, k, v, **kw, **extras)
        ctx.save_for_backward(q, k, v, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, rows_dense(dout),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    *,
    qv: Optional[torch.Tensor] = None,
    gather_kv_indices: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    bias_grad: bool = True,
    sink: Optional[torch.Tensor] = None,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_descale: Optional[torch.Tensor] = None,
    k_descale: Optional[torch.Tensor] = None,
    v_descale: Optional[torch.Tensor] = None,
    score_mod=None,
    mask_mod=None,
    aux_tensors=(),
    aux_scalars=(),
    block_sparse_tensors=None,
    dropout_seed: Optional[torch.Tensor] = None,
    layout: str = "bshd",
):
    """Dense attention, as the JAX package's `flash_attn_func`.

    q: (b, sq, h, d); k/v: (b, sk, hk, d) with h % hk == 0 (or (b, h, s, d)
    with layout="bhsd"). Returns out in q's layout; with
    return_attn_probs=True returns (out, softmax_lse (b, h, sq) fp32,
    None).

    `deterministic`, `bias_grad` and `dropout_seed` are taken so that calls
    written for the JAX API run unchanged, and nothing reads them: the
    backward is always deterministic, and a bias or dropout raises."""
    del deterministic, bias_grad, dropout_seed
    if gather_kv_indices is not None:
        raise NotImplementedError(
            "gather_kv_indices (top-k gathered attention) is not ported yet: "
            "ROADMAP queue 2, kernels 1-3: gather_kv_indices"
        )
    if block_sparse_tensors is not None:
        raise NotImplementedError(
            "block_sparse_tensors is not ported yet: ROADMAP queue 1, item 8 "
            "(block sparsity)"
        )
    if layout == "bshd":
        q_, k_, v_ = (x.transpose(1, 2) for x in (q, k, v))
    elif layout == "bhsd":
        q_, k_, v_ = q, k, v
    else:
        raise ValueError(f"unknown layout {layout!r}")
    extras = dict(
        qv=qv, bias=attn_bias, alibi_slopes=alibi_slopes, sink=sink,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale,
        attention_chunk=attention_chunk, sink_token_length=sink_token_length,
        dropout_p=dropout_p, score_mod=score_mod, mask_mod=mask_mod,
        aux_tensors=aux_tensors, aux_scalars=aux_scalars,
    )
    out, lse = _FlashAttnCore.apply(
        q_, k_, v_, softmax_scale, bool(causal),
        tuple(int(w) for w in window_size), float(softcap), extras,
    )
    if layout == "bshd":
        out = out.transpose(1, 2)
    if return_attn_probs:
        return out, lse, None
    return out


def flash_attn_qkvpacked_func(
    qkv: torch.Tensor,  # (b, s, 3, h, d)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    **kwargs,
):
    """`flash_attn_func` on q, k, v packed as (b, s, 3, h, d)."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return flash_attn_func(
        q, k, v, dropout_p, softmax_scale, causal, window_size, softcap,
        alibi_slopes, deterministic, return_attn_probs, **kwargs
    )


def flash_attn_kvpacked_func(
    q: torch.Tensor,   # (b, sq, h, d)
    kv: torch.Tensor,  # (b, sk, 2, hk, d)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    **kwargs,
):
    """`flash_attn_func` on k, v packed as (b, sk, 2, hk, d)."""
    k, v = kv[:, :, 0], kv[:, :, 1]
    return flash_attn_func(
        q, k, v, dropout_p, softmax_scale, causal, window_size, softcap,
        alibi_slopes, deterministic, return_attn_probs, **kwargs
    )
