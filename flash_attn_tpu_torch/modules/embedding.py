"""Token (and optional learned position) embeddings (counterpart of
flash_attn_tpu/modules/embedding.py `GPT2Embeddings`). Tables are stored in
`param_dtype` (default: `dtype`) and looked-up rows are cast to `dtype`, as
flax's `nn.Embed(dtype=...)` does with fp32 tables."""

from __future__ import annotations

import torch
from torch import nn


class GPT2Embeddings(nn.Module):
    def __init__(self, embed_dim: int, vocab_size: int,
                 max_position_embeddings: int, device=None,
                 dtype=torch.bfloat16, param_dtype=None):
        """max_position_embeddings = 0: no learned position embeddings."""
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, dtype=param_dtype or dtype)
        self.word_embeddings = nn.Embedding(vocab_size, embed_dim, **kw)
        self.position_embeddings = (
            nn.Embedding(max_position_embeddings, embed_dim, **kw)
            if max_position_embeddings > 0 else None
        )

    def forward(self, input_ids, position_ids=None):
        emb = self.word_embeddings(input_ids).to(self.dtype)
        if self.position_embeddings is not None:
            if position_ids is None:
                position_ids = torch.arange(input_ids.shape[1],
                                            device=input_ids.device)[None]
            emb = emb + self.position_embeddings(position_ids).to(self.dtype)
        return emb
