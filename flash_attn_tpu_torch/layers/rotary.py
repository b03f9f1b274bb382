"""RotaryEmbedding tables (counterpart of flash_attn_tpu/layers/rotary.py
`RotaryEmbedding.cos_sin`). xPos scaling is not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch


class RotaryEmbedding:
    """Cos/sin tables for `ops.rotary.apply_rotary_emb`, computed in fp32
    and cached per device; a longer request rebuilds them."""

    def __init__(self, dim: int, base: float = 10000.0,
                 interleaved: bool = False):
        self.dim = dim
        self.base = float(base)
        self.interleaved = interleaved
        self._cached = {}  # device -> (seqlen, cos, sin)

    def cos_sin(self, seqlen: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        device = torch.device(device if device is not None else "cpu")
        cached = self._cached.get(device)
        if cached is None or cached[0] < seqlen:
            half = torch.arange(0, self.dim, 2, dtype=torch.float32,
                                device=device)
            inv_freq = 1.0 / (self.base ** (half / self.dim))
            t = torch.arange(seqlen, dtype=torch.float32, device=device)
            freqs = torch.outer(t, inv_freq)
            cached = (seqlen, torch.cos(freqs), torch.sin(freqs))
            self._cached[device] = cached
        return cached[1][:seqlen], cached[2][:seqlen]
