"""Rotary position embeddings (counterpart of flash_attn_tpu/ops/rotary.py):
plain tensor code, computed in fp32 and cast back to the input's dtype."""

from __future__ import annotations

from typing import Union

import torch


def apply_rotary_emb(
    x: torch.Tensor,    # (b, s, h, d)
    cos: torch.Tensor,  # (smax, rot_dim / 2)
    sin: torch.Tensor,
    *,
    interleaved: bool = False,
    seqlen_offsets: Union[int, torch.Tensor] = 0,
) -> torch.Tensor:
    """Rotate the first rot_dim features of x; the rest pass through.

    seqlen_offsets: an int, or a (b,) tensor of per-row position offsets
    (the decode path passes the cache lengths). Positions past the table
    read its last row."""
    b, s, h, d = x.shape
    half = cos.shape[-1]
    rot = 2 * half
    if rot > d:
        raise ValueError(f"rotary dim {rot} exceeds head dim {d}")
    steps = torch.arange(s, device=x.device)
    if isinstance(seqlen_offsets, int):
        pos = (seqlen_offsets + steps)[None]  # (1, s)
    else:
        pos = seqlen_offsets.to(x.device).long()[:, None] + steps[None]
    pos = pos.clamp(0, cos.shape[0] - 1)
    cos_s = cos[pos][:, :, None, :].float()  # (b|1, s, 1, half)
    sin_s = sin[pos][:, :, None, :].float()
    xf = x.float()
    if not interleaved:
        x1, x2 = xf[..., :half], xf[..., half:rot]
        rotated = torch.cat(
            [x1 * cos_s - x2 * sin_s, x2 * cos_s + x1 * sin_s], dim=-1
        )
    else:
        x1, x2 = xf[..., 0:rot:2], xf[..., 1:rot:2]
        rotated = torch.stack(
            [x1 * cos_s - x2 * sin_s, x2 * cos_s + x1 * sin_s], dim=-1
        ).reshape(b, s, h, rot)
    if rot < d:
        rotated = torch.cat([rotated, xf[..., rot:]], dim=-1)
    return rotated.to(x.dtype)
