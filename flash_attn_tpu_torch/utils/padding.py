"""Pad and unpad between (batch, seqlen, ...) and packed (total_tokens, ...)
layouts (counterpart of flash_attn_tpu/utils/padding.py): plain torch
gathers and scatters.

As in the JAX package, `unpad_input` returns a buffer of batch * seqlen rows
(or `total_tokens`) with the valid tokens packed at the front, so that it
needs no host read to size it: the varlen kernels read only the rows that
cu_seqlens names and give the trailing rows out 0 and lse -inf.
"""

from __future__ import annotations

from typing import Optional

import torch


def unpad_input(
    hidden_states: torch.Tensor,   # (b, s, ...)
    attention_mask: torch.Tensor,  # (b, s) bool
    total_tokens: Optional[int] = None,
):
    """Front-pack the valid tokens. Returns (packed, indices, cu_seqlens,
    max_seqlen_in_batch, used_seqlens); cu_seqlens and used_seqlens are
    int32, max_seqlen_in_batch a 0-dim tensor."""
    b, s = attention_mask.shape
    total = total_tokens if total_tokens is not None else b * s
    seqlens = attention_mask.sum(-1, dtype=torch.int32)
    cu_seqlens = torch.nn.functional.pad(
        torch.cumsum(seqlens, 0, dtype=torch.int32), (1, 0))
    # Stable sort of ~mask: valid tokens first, each group in order.
    order = torch.argsort((~attention_mask.bool()).reshape(-1).to(torch.int8),
                          stable=True)
    indices = order[:total]
    flat = hidden_states.reshape(b * s, *hidden_states.shape[2:])
    return flat[indices], indices, cu_seqlens, seqlens.max(), seqlens


def pad_input(packed: torch.Tensor, indices: torch.Tensor, batch: int,
              seqlen: int) -> torch.Tensor:
    """Inverse of `unpad_input`: (batch, seqlen, ...) with zeros where no
    packed row lands."""
    out = packed.new_zeros((batch * seqlen, *packed.shape[1:]))
    out[indices] = packed
    return out.reshape(batch, seqlen, *packed.shape[1:])


def unpad_input_for_concatenated_sequences(
    hidden_states: torch.Tensor,             # (b, s, ...)
    attention_mask_in_length: torch.Tensor,  # (b, s) int: per-seq lengths
):
    """Each batch row packs several sequences whose lengths stand, front
    packed, in attention_mask_in_length. Returns (packed, indices,
    cu_seqlens over every length entry, zero-length ones included,
    max_seqlen_in_batch)."""
    b, s = attention_mask_in_length.shape
    lengths = attention_mask_in_length.reshape(-1).to(torch.int32)
    cu_seqlens = torch.nn.functional.pad(
        torch.cumsum(lengths, 0, dtype=torch.int32), (1, 0))
    row_totals = attention_mask_in_length.sum(-1)
    mask = (torch.arange(s, device=hidden_states.device)[None]
            < row_totals[:, None])
    packed, indices, _, _, _ = unpad_input(hidden_states, mask)
    return packed, indices, cu_seqlens, lengths.max()
