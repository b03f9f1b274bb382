"""Training loop (counterpart of flash_attn_tpu/training/trainer.py): an
eager train step (loss, backward, global-norm clip, AdamW, schedule),
gradient accumulation, throughput and MFU, EMA.

The model keeps fp32 parameters (`GPTLMHeadModel(param_dtype=
torch.float32)`) and computes in its config's dtype; the logits are cast to
fp32 before the cross-entropy, as the JAX trainer does. ZeRO, fused linear
cross-entropy, checkpointing, run logging and the norm monitor are not
ported yet and raise."""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Optional

import numpy as np
import torch

from flash_attn_tpu_torch.kernels.common import fold_seed, round_up
from flash_attn_tpu_torch.losses.cross_entropy import cross_entropy_loss
from flash_attn_tpu_torch.models.gpt import GATED_ACTIVATIONS
from flash_attn_tpu_torch.training.optim import (
    clip_by_global_norm_,
    make_optimizer,
)
from flash_attn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 10
    total_steps: int = 100
    schedule: str = "cosine"
    log_every: int = 10
    checkpoint_every: int = 0  # 0 = off
    checkpoint_dir: Optional[str] = None
    ema_decay: float = 0.0  # 0 = off
    seed: int = 0
    log_dir: Optional[str] = None
    norm_monitor: bool = False
    zero_stage: int = 0
    fused_ce_chunk: int = 0
    # >1: that many microbatches per optimizer update, gradients averaged.
    accumulate_steps: int = 1


# Options of TrainConfig the port does not run yet: (field, "off" value,
# ROADMAP item).
_UNPORTED = (
    ("zero_stage", 0, "queue 1, item 12 (ZeRO)"),
    ("fused_ce_chunk", 0, "queue 1, item 13 (fused linear cross-entropy)"),
    ("checkpoint_every", 0, "queue 1, item 13 (checkpointing)"),
    ("log_dir", None, "queue 1, item 13 (run logging)"),
    ("norm_monitor", False, "queue 1, item 13 (norm monitor)"),
)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SpeedMonitor:
    """Tokens/s and model-FLOPs utilisation. It synchronises the card
    before every read of the clock, so the time covers the work queued."""

    def __init__(self, flops_per_token: float, peak_flops: float):
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.reset()

    def reset(self):
        _sync()
        self._t0 = time.perf_counter()
        self._tokens = 0

    def update(self, tokens: int):
        self._tokens += tokens

    def report(self) -> Dict[str, float]:
        _sync()
        dt = max(time.perf_counter() - self._t0, 1e-9)
        tps = self._tokens / dt
        return {
            "tokens_per_s": tps,
            "mfu": tps * self.flops_per_token / self.peak_flops,
        }


def _mla_matrices(c) -> int:
    """Weights of one MLA layer: W_q (or W_dq and W_uq), W_dkv, W_uk, W_uv
    and out_proj."""
    d = c.resolved_head_dim
    h, dc, dr = c.n_head, c.kv_lora_rank, c.qk_rope_head_dim
    dn, dv = c.qk_nope_head_dim or d, c.v_head_dim or d
    q = (c.n_embd * c.q_lora_rank + c.q_lora_rank * h * (dn + dr)
         if c.q_lora_rank else c.n_embd * h * (dn + dr))
    return q + c.n_embd * (dc + dr) + h * dn * dc + h * dc * dv + h * dv * c.n_embd


def gpt_flops_per_token(config) -> float:
    """6 N, N the weights a token is multiplied by: every dense layer's
    matrices and the head's (vocab x n_embd, tied or not); no attention
    term, no biases or norms. A gated MLP has three n_embd x n_inner
    matrices, a plain one two; an MLA layer counts its own five weights,
    not MHA's projections. (The JAX package counts three MLP matrices for
    both and MHA's projections for MLA.)"""
    c = config
    d = c.head_dim if c.head_dim is not None else c.n_embd // c.n_head
    if c.activation_function in GATED_ACTIVATIONS:
        mlp = 3 * c.n_embd * (c.n_inner or round_up(int(8 * c.n_embd / 3),
                                                     128))
    else:
        mlp = 2 * c.n_embd * (c.n_inner or 4 * c.n_embd)
    attn = (_mla_matrices(c) if c.attn_type == "mla" else
            c.n_embd * (c.n_head + 2 * (c.n_head_kv or c.n_head)) * d
            + c.n_head * d * c.n_embd)
    return 6.0 * (c.padded_vocab_size * c.n_embd + c.n_layer * (attn + mlp))


class EMA:
    """Exponential moving average of the parameters, in fp32."""

    def __init__(self, model: torch.nn.Module, decay: float):
        self.decay = decay
        self.shadow = {n: p.detach().float().clone()
                       for n, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: torch.nn.Module):
        d = self.decay
        for n, p in model.named_parameters():
            self.shadow[n].mul_(d).add_(p.detach().float(), alpha=1.0 - d)


class Trainer:
    """Config-driven LM trainer on one device (CUDA unless `device` names
    another). `model` is a GPTLMHeadModel, moved to that device."""

    def __init__(self, model: torch.nn.Module, config: TrainConfig,
                 device=None):
        for field, off, item in _UNPORTED:
            if getattr(config, field) != off:
                raise NotImplementedError(
                    f"TrainConfig.{field} is not ported yet: ROADMAP {item}")
        self.device = resolve_device(device)
        self.config = config
        self.model = model.to(self.device).train()
        self.opt, self.sched = make_optimizer(
            self.model, lr=config.lr, weight_decay=config.weight_decay,
            warmup_steps=config.warmup_steps, total_steps=config.total_steps,
            schedule=config.schedule,
        )
        self.step_idx = 0
        self.ema = EMA(self.model, config.ema_decay) if config.ema_decay > 0 else None
        self.history: list = []
        # Every step's {"step", "loss", "grad_norm", "lr"}; loss and norm stay
        # on the device until `fit` ends, so logging costs no sync per step.
        self.steps: list = []

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).long()

    def _loss(self, input_ids, labels, dropout_seed=None) -> torch.Tensor:
        logits = self.model(input_ids, dropout_seed=dropout_seed)
        return cross_entropy_loss(logits.float(), labels)

    def step_seed(self, micro: int = 0) -> int:
        """The attention dropout seed of this step's microbatch `micro`:
        TrainConfig.seed folded with the step and the microbatch, as the JAX
        trainer splits its key once a step; the model folds in each layer's
        index."""
        return fold_seed(self.config.seed, self.step_idx, micro)

    def train_step(self, input_ids, labels):
        """One optimizer update from a batch (b, s), or with
        accumulate_steps > 1 from microbatches (acc, b, s). Returns (loss,
        grad_norm before clipping) as device tensors."""
        ids, lbl = self._tensor(input_ids), self._tensor(labels)
        acc = self.config.accumulate_steps
        params = [p for p in self.model.parameters() if p.requires_grad]
        if acc > 1:
            loss = 0.0
            for i in range(acc):
                micro = self._loss(ids[i], lbl[i], self.step_seed(i))
                micro.backward()
                loss = loss + micro.detach()
            for p in params:
                if p.grad is not None:
                    p.grad.div_(acc)
            loss = loss / acc
        else:
            loss = self._loss(ids, lbl, self.step_seed())
            loss.backward()
            loss = loss.detach()
        grad_norm = clip_by_global_norm_(
            (p.grad for p in params if p.grad is not None),
            self.config.grad_clip)
        lr = self.sched(self.step_idx)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.steps.append({"step": self.step_idx + 1, "loss": loss,
                           "grad_norm": grad_norm, "lr": lr})
        self.step_idx += 1
        return loss, grad_norm

    def fit(self, datamodule, steps: Optional[int] = None,
            speed_monitor: Optional[SpeedMonitor] = None):
        steps = steps or self.config.total_steps
        first = True
        acc = self.config.accumulate_steps

        def grouped(it):
            if acc <= 1:
                yield from it
                return
            while True:
                mbs = list(itertools.islice(it, acc))
                if len(mbs) < acc:
                    return
                yield (np.stack([m[0] for m in mbs]),
                       np.stack([m[1] for m in mbs]))

        for input_ids, labels in grouped(iter(datamodule.batches(steps * acc))):
            loss, gnorm = self.train_step(input_ids, labels)
            if speed_monitor is not None:
                if first:
                    # Step 0 builds the kernels and warms the allocator;
                    # it does not count towards throughput.
                    speed_monitor.reset()
                    first = False
                else:
                    speed_monitor.update(int(np.prod(input_ids.shape)))
            if self.ema is not None:
                self.ema.update(self.model)
            if self.step_idx % self.config.log_every == 0 or \
                    self.step_idx == steps:
                self.history.append({"step": self.step_idx, "loss": float(loss),
                                     "grad_norm": float(gnorm)})
        for rec in self.steps:
            rec["loss"], rec["grad_norm"] = float(rec["loss"]), float(rec["grad_norm"])
        return self.history

    @torch.no_grad()
    def evaluate(self, batches) -> Dict[str, float]:
        losses = [float(self._loss(self._tensor(x), self._tensor(y)))
                  for x, y in batches]
        mean = float(np.mean(losses))
        return {"loss": mean, "ppl": float(np.exp(mean))}

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "checkpointing is not ported yet: ROADMAP queue 1, item 13 "
            "(checkpointing)")

    load_checkpoint = save_checkpoint
