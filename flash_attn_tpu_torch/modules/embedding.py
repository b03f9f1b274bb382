"""Token (and optional learned position) embeddings (counterpart of
flash_attn_tpu/modules/embedding.py `GPT2Embeddings`)."""

from __future__ import annotations

import torch
from torch import nn


class GPT2Embeddings(nn.Module):
    def __init__(self, embed_dim: int, vocab_size: int,
                 max_position_embeddings: int, device=None,
                 dtype=torch.bfloat16):
        """max_position_embeddings = 0: no learned position embeddings."""
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, embed_dim,
                                            device=device, dtype=dtype)
        self.position_embeddings = (
            nn.Embedding(max_position_embeddings, embed_dim, device=device,
                         dtype=dtype)
            if max_position_embeddings > 0 else None
        )

    def forward(self, input_ids, position_ids=None):
        emb = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                position_ids = torch.arange(input_ids.shape[1],
                                            device=input_ids.device)[None]
            emb = emb + self.position_embeddings(position_ids)
        return emb
