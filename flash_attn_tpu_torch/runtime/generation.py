"""Token sampling (counterpart of flash_attn_tpu/runtime/generation.py
`sample_tokens`). The rest of that module (`decode`, `GenerationMixin`,
speculative decoding) is not ported yet: ROADMAP queue 1, item 5."""

from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(
    logits: torch.Tensor,  # (b, vocab)
    generator: Optional[torch.Generator] = None,
    *,
    top_k: int = 1,
    top_p: float = 0.0,
    min_p: float = 0.0,
    temperature: float = 1.0,
) -> torch.Tensor:
    """top-k / top-p / min-p / temperature sampling; top_k=1 is greedy
    (argmax, the first maximum on ties). Returns (b,) int32."""
    if top_k == 1:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        logits = torch.where(probs < min_p * pmax, neg_inf, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep the smallest set with cumulative probability >= top_p.
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
