"""Legacy fixed-blockmask blocksparse attention (counterpart of
flash_attn_tpu/flash_blocksparse_attention.py; the reference's
flash_blocksparse_attn_interface.py:7 `flash_blocksparse_attn_func` and
:185 `convert_blockmask`).

A (q_blocks, k_blocks) boolean blockmask of 64 x 64 blocks, shared by every
batch row and head, is expressed as per-query-block slash ranges at
aligned offsets and run through `sparse_attn_func` (kernels 12-15 forward,
13-14 backward), so it is differentiable.
"""

from __future__ import annotations

from typing import Optional

import torch

from flash_attn_tpu_torch.flash_attn_interface import sparse_attn_func


def convert_blockmask(blockmask: torch.Tensor, block_size: int = 64):
    """(nqb, nkb) bool -> (block_count (nqb,) int32, block_offset (nqb, nkb)
    int32): each query block's kept key blocks as element offsets, in
    ascending order first (the entries past the count are the others)."""
    bm = blockmask.to(torch.bool)
    counts = bm.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~bm).to(torch.int8), dim=1, stable=True)
    return counts, (order * block_size).to(torch.int32)


def flash_blocksparse_attn_func(
    q: torch.Tensor,  # (b, s, h, d)
    k: torch.Tensor,
    v: torch.Tensor,
    blockmask: torch.Tensor,  # (cdiv(s, 64), cdiv(sk, 64)) bool keep-mask
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    *,
    block_size: int = 64,
    dropout_seed: Optional[torch.Tensor] = None,
):
    """Fixed-blockmask flash attention, the mask shared across batch and
    heads (the legacy kernel's contract). Differentiable; dropout raises
    NotImplementedError (ROADMAP queue 2, kernels 1-3 / 12-14)."""
    if block_size != 64:
        raise ValueError("the legacy blocksparse blockmask granularity is 64")
    b, _, h, _ = q.shape
    counts, offsets = convert_blockmask(blockmask.to(q.device), block_size)
    nqb, nnz = offsets.shape
    return sparse_attn_func(
        q, k, v, counts.expand(b, h, nqb),
        offsets.expand(b, h, nqb, nnz),
        torch.zeros((b, h, nqb), dtype=torch.int32, device=q.device),
        torch.zeros((b, h, nqb, 0), dtype=torch.int32, device=q.device),
        dropout_p=dropout_p, dropout_seed=dropout_seed,
        softmax_scale=softmax_scale, causal=causal)
