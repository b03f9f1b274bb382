"""RotaryEmbedding tables (counterpart of flash_attn_tpu/layers/rotary.py
`RotaryEmbedding.cos_sin`). xPos scaling is not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch


class RotaryEmbedding:
    """Cos/sin tables for `ops.rotary.apply_rotary_emb`, computed in fp32
    and cached per device (a bare "cuda" and the card's index are one
    key); a longer request rebuilds them, at least doubling their length.
    A step captured in a CUDA graph must find its table built (its warm-up
    builds it), and the graph reads that table by address on every replay:
    so a table once handed out lives as long as the embedding, and a
    rebuild keeps the tables it supersedes (at most twice the memory of
    the longest)."""

    def __init__(self, dim: int, base: float = 10000.0,
                 interleaved: bool = False):
        self.dim = dim
        self.base = float(base)
        self.interleaved = interleaved
        self._cached = {}  # device -> (seqlen, cos, sin)
        self._superseded = []  # tables a rebuild replaced, kept alive

    def cos_sin(self, seqlen: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        device = torch.device(device if device is not None else "cpu")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        cached = self._cached.get(device)
        if cached is None or cached[0] < seqlen:
            length = seqlen
            if cached is not None:
                self._superseded.append(cached)
                length = max(seqlen, 2 * cached[0])
            half = torch.arange(0, self.dim, 2, dtype=torch.float32,
                                device=device)
            inv_freq = 1.0 / (self.base ** (half / self.dim))
            t = torch.arange(length, dtype=torch.float32, device=device)
            freqs = torch.outer(t, inv_freq)
            cached = (length, torch.cos(freqs), torch.sin(freqs))
            self._cached[device] = cached
        return cached[1][:seqlen], cached[2][:seqlen]
