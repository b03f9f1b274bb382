"""Optimizer construction: parameter grouping, schedules, clipping
(counterpart of flash_attn_tpu/training/optim.py, which builds an optax
chain of clip_by_global_norm and adamw).

The port uses `torch.optim.AdamW` with optax's settings and semantics:
b2 = 0.95, eps = 1e-8 outside the square root, decoupled weight decay
scaled by the learning rate, a schedule counted from step 0 (so a warmup
starts at lr 0), no decay on biases, norm scales and embeddings, and
clipping by optax's global-norm formula (no epsilon)."""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from flash_attn_tpu_torch.modules.block import LayerNorm, RMSNorm

NO_DECAY_PATTERNS = (r"bias$", r"scale$", r"embedding$", r"norm", r"ln_")


def flax_path(module_name: str, module: nn.Module, param_name: str) -> str:
    """The path of a parameter in the JAX package's params tree, e.g.
    `transformer.layers.0.mixer.Wq` weight -> params/transformer/layers_0/
    mixer/Wq/kernel."""
    if isinstance(module, nn.Embedding):
        leaf = "embedding"
    elif param_name == "weight":
        leaf = "scale" if isinstance(module, (LayerNorm, RMSNorm)) else "kernel"
    else:
        leaf = param_name
    path = re.sub(r"layers\.(\d+)", r"layers_\1", module_name).replace(".", "/")
    return f"params/{path}/{leaf}"


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies}, by matching the
    parameter's flax path against NO_DECAY_PATTERNS as the JAX package
    does. A tied LM head is the word embedding, so it gets no decay."""
    mask = {}
    for mname, module in model.named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            path = flax_path(mname, module, pname)
            full = f"{mname}.{pname}" if mname else pname
            mask[full] = not any(re.search(p, path) for p in NO_DECAY_PATTERNS)
    return mask


def make_schedule(
    *,
    lr: float,
    warmup_steps: int = 0,
    total_steps: int = 10000,
    schedule: str = "cosine",  # cosine | linear | constant
    min_lr_ratio: float = 0.1,
) -> Callable[[int], float]:
    """step -> learning rate, as optax's schedules give it: a linear warmup
    from 0 over `warmup_steps`, then cosine or linear decay to
    lr * min_lr_ratio over the remaining steps (held there after), or a
    constant."""
    decay_steps = max(total_steps - warmup_steps, 1)
    if schedule not in ("cosine", "linear", "constant"):
        raise ValueError(schedule)

    def main(step: int) -> float:
        if schedule == "constant":
            return lr
        count = min(max(step, 0), decay_steps)
        if schedule == "cosine":
            cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
            return lr * ((1.0 - min_lr_ratio) * cosine + min_lr_ratio)
        end = lr * min_lr_ratio
        return (lr - end) * (1.0 - count / decay_steps) + end

    def sched(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return lr * max(step, 0) / warmup_steps
        return main(step - warmup_steps if warmup_steps > 0 else step)

    return sched


def make_optimizer(
    model: nn.Module,
    *,
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    warmup_steps: int = 0,
    total_steps: int = 10000,
    schedule: str = "cosine",
) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """(AdamW over decay / no-decay groups, schedule). The caller sets each
    group's lr to sched(step) before step `step` (counted from 0) and clips
    with `clip_by_global_norm_` first, as optax's chain does."""
    sched = make_schedule(lr=lr, warmup_steps=warmup_steps,
                          total_steps=total_steps, schedule=schedule)
    mask = decay_mask(model)
    groups: List[dict] = [
        dict(params=[p for n, p in model.named_parameters() if mask[n]],
             weight_decay=weight_decay),
        dict(params=[p for n, p in model.named_parameters() if not mask[n]],
             weight_decay=0.0),
    ]
    opt = torch.optim.AdamW(groups, lr=sched(0), betas=(b1, b2), eps=1e-8)
    return opt, sched


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm_(grads, max_norm: Optional[float]) -> torch.Tensor:
    """Scale `grads` in place by max_norm / norm when their global norm is
    at least max_norm (optax.clip_by_global_norm, no epsilon). Returns the
    norm before clipping; does not synchronise."""
    grads = list(grads)
    norm = global_norm(grads)
    if max_norm is not None:
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return norm
