"""Cross-entropy loss with label smoothing, z-loss and logit scaling
(counterpart of flash_attn_tpu/losses/cross_entropy.py). Plain torch in
fp32: the JAX package leaves it to XLA too."""

from __future__ import annotations

import torch


def cross_entropy_loss(
    logits: torch.Tensor,  # (..., vocab)
    labels: torch.Tensor,  # (...,) integer
    *,
    label_smoothing: float = 0.0,
    logit_scale: float = 1.0,
    lse_square_scale: float = 0.0,  # z-loss coefficient
    ignore_index: int = -100,
    reduction: str = "mean",
) -> torch.Tensor:
    """The JAX package's semantics: `logit_scale` applied before the
    softmax, label smoothing as (1-eps)(-label_logit) + eps(-mean(logits)),
    z-loss `lse_square_scale * lse^2`, `ignore_index` rows give 0, and
    reduction in {none, mean, sum}; mean divides by the valid rows (at
    least 1)."""
    logits_f = logits.float() * logit_scale
    lse = torch.logsumexp(logits_f, dim=-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    label_logit = torch.gather(logits_f, -1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        loss = (lse - (1.0 - label_smoothing) * label_logit
                - label_smoothing * logits_f.mean(-1))
    else:
        loss = lse - label_logit
    if lse_square_scale > 0.0:
        loss = loss + lse_square_scale * lse.square()
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.sum().clamp_min(1)


def fused_linear_cross_entropy(*args, **kwargs):
    """Cross-entropy fused with the LM-head product, chunked over the
    sequence so full-vocab logits never exist at once: not ported yet."""
    raise NotImplementedError(
        "fused_linear_cross_entropy is not ported yet: ROADMAP queue 1, "
        "item 13 (trainer leftovers: fused linear cross-entropy)"
    )


class CrossEntropyLoss:
    """Module-style wrapper of `cross_entropy_loss` with the JAX package's
    arguments (`inplace_backward` and `process_group` are accepted and
    ignored, as there)."""

    def __init__(
        self,
        ignore_index: int = -100,
        reduction: str = "mean",
        label_smoothing: float = 0.0,
        logit_scale: float = 1.0,
        lse_square_scale: float = 0.0,
        inplace_backward: bool = False,
        process_group=None,
        return_z_loss: bool = False,
    ):
        del inplace_backward, process_group
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.label_smoothing = label_smoothing
        self.logit_scale = logit_scale
        self.lse_square_scale = lse_square_scale
        self.return_z_loss = return_z_loss

    def __call__(self, logits, labels):
        loss = cross_entropy_loss(
            logits, labels,
            label_smoothing=self.label_smoothing,
            logit_scale=self.logit_scale,
            lse_square_scale=self.lse_square_scale,
            ignore_index=self.ignore_index,
            reduction=self.reduction,
        )
        if not self.return_z_loss:
            return loss
        lse = torch.logsumexp(logits.float() * self.logit_scale, dim=-1)
        valid = labels != self.ignore_index
        z = torch.where(valid, self.lse_square_scale * lse.square(),
                        torch.zeros_like(lse))
        if self.reduction == "mean":
            z = z.sum() / valid.sum().clamp_min(1)
        elif self.reduction == "sum":
            z = z.sum()
        return loss, z
