"""Config-driven GPT model family (counterpart of
flash_attn_tpu/models/gpt.py): one `GPTConfig` covers GPT-2-style and
Llama/Mistral-style models. Without a cache the forward runs the whole
sequence through the flash-attention kernels (training; `remat` sets the
activation checkpointing); with a paged KV cache (`InferenceParams` with a
block table) it is `LLMEngine`'s step; with contiguous caches
(`allocate_inference_cache`) it is `generate`'s. `attn_type="mla"` takes
DeepSeek-style latent attention (`modules.mla.MLA`) as every layer's mixer.
`utils.testing.gpt_forward_ref` is a plain full-sequence forward to check
it against."""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from flash_attn_tpu_torch.kernels.common import fold_seed
from flash_attn_tpu_torch.modules.block import Block, LayerNorm, RMSNorm, make_norm
from flash_attn_tpu_torch.modules.embedding import GPT2Embeddings
from flash_attn_tpu_torch.modules.linear import Linear
from flash_attn_tpu_torch.modules.mha import MHA, InferenceParams
from flash_attn_tpu_torch.modules.mla import MLA
from flash_attn_tpu_torch.modules.mlp import GatedMlp, Mlp
from flash_attn_tpu_torch.runtime.generation import GenerationMixin
from flash_attn_tpu_torch.runtime.kv_cache import allocate_kv_cache
from flash_attn_tpu_torch.utils.device import resolve_device

GATED_ACTIVATIONS = ("swiglu", "silu", "glu", "swiglu_gelu")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The JAX package's GPTConfig fields, with a torch dtype."""

    vocab_size: int = 50257
    n_positions: int = 2048  # 0 => no learned positions (rotary models)
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_head_kv: Optional[int] = None
    head_dim: Optional[int] = None
    n_inner: Optional[int] = None
    activation_function: str = "gelu_approx"  # "swiglu"/"silu" => GatedMlp
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    layer_norm_epsilon: float = 1e-5
    rms_norm: bool = False
    prenorm: bool = True
    parallel_block: bool = False
    parallel_block_tied_norm: bool = False
    rotary_emb_fraction: float = 0.0
    rotary_emb_base: float = 10000.0
    rotary_emb_interleaved: bool = False
    use_alibi: bool = False
    window_size: Tuple[int, int] = (-1, -1)
    softcap: float = 0.0
    qkv_proj_bias: bool = True
    out_proj_bias: bool = True
    mlp_fc1_bias: bool = True
    mlp_fc2_bias: bool = True
    tie_word_embeddings: bool = True
    residual_in_fp32: bool = True
    pad_vocab_size_multiple: int = 1
    position_offset: int = 0
    embed_scale: Optional[float] = None
    # "mha", or "mla": DeepSeek-style latent attention (modules/mla.py) with
    # the five widths below (None: head_dim, as in the JAX config).
    attn_type: str = "mha"
    # Activation checkpointing per block while training ("none" | "dots" |
    # "full"): "dots" keeps the outputs of the (non-batched) matrix
    # products and recomputes the rest, attention included, in the
    # backward, as jax.checkpoint's dots_with_no_batch_dims_saveable does;
    # "full" keeps nothing.
    remat: str = "none"
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: Optional[int] = None
    dtype: Any = torch.bfloat16

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_size_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.n_embd // self.n_head

    @property
    def resolved_n_head_kv(self) -> int:
        return self.n_head_kv if self.n_head_kv is not None else self.n_head


def _mixer_factory(config: GPTConfig, layer_idx: int, device, param_dtype):
    if config.attn_type == "mla":
        d = config.resolved_head_dim
        return functools.partial(
            MLA,
            embed_dim=config.n_embd,
            num_heads=config.n_head,
            kv_lora_rank=config.kv_lora_rank,
            q_lora_rank=config.q_lora_rank,
            qk_nope_head_dim=config.qk_nope_head_dim or d,
            qk_rope_head_dim=config.qk_rope_head_dim,
            v_head_dim=config.v_head_dim or d,
            rotary_emb_base=config.rotary_emb_base,
            causal=True,
            layer_idx=layer_idx,
            device=device,
            dtype=config.dtype,
            param_dtype=param_dtype,
        )
    if config.attn_type != "mha":
        raise ValueError(f"attn_type must be mha or mla, not "
                         f"{config.attn_type!r}")
    return functools.partial(
        MHA,
        embed_dim=config.n_embd,
        num_heads=config.n_head,
        num_heads_kv=config.n_head_kv,
        head_dim=config.head_dim,
        qkv_proj_bias=config.qkv_proj_bias,
        out_proj_bias=config.out_proj_bias,
        dropout=config.attn_pdrop,
        window_size=config.window_size,
        softcap=config.softcap,
        use_alibi=config.use_alibi,
        rotary_emb_dim=int(config.rotary_emb_fraction * config.resolved_head_dim),
        rotary_emb_base=config.rotary_emb_base,
        rotary_emb_interleaved=config.rotary_emb_interleaved,
        layer_idx=layer_idx,
        device=device,
        dtype=config.dtype,
        param_dtype=param_dtype,
    )


def _mlp_factory(config: GPTConfig, device, param_dtype):
    kw = dict(in_features=config.n_embd, bias1=config.mlp_fc1_bias,
              bias2=config.mlp_fc2_bias, device=device, dtype=config.dtype,
              param_dtype=param_dtype)
    act = config.activation_function
    if act in GATED_ACTIVATIONS:
        return functools.partial(GatedMlp, hidden_features=config.n_inner,
                                 activation=act, **kw)
    return functools.partial(
        Mlp, hidden_features=config.n_inner or 4 * config.n_embd,
        activation=act, **kw,
    )


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep the outputs of the
    dense layers' matrix products, recompute everything else."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context():
    return create_selective_checkpoint_contexts(_save_matmuls)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None, param_dtype=None):
        super().__init__()
        c = config
        if c.remat not in ("none", "dots", "full"):
            raise ValueError(f"remat must be none, dots or full, not {c.remat!r}")
        self.config = c
        self.embeddings = GPT2Embeddings(c.n_embd, c.padded_vocab_size,
                                         c.n_positions, device=device,
                                         dtype=c.dtype, param_dtype=param_dtype)
        self.layers = nn.ModuleList(
            Block(
                c.n_embd, _mixer_factory(c, i, device, param_dtype),
                _mlp_factory(c, device, param_dtype),
                norm_eps=c.layer_norm_epsilon, prenorm=c.prenorm,
                residual_in_fp32=c.residual_in_fp32, rms_norm=c.rms_norm,
                parallel_block=c.parallel_block,
                parallel_block_tied_norm=c.parallel_block_tied_norm,
                device=device, dtype=c.dtype,
            )
            for i in range(c.n_layer)
        )
        self.ln_f = make_norm(c.n_embd, c.layer_norm_epsilon, c.rms_norm, device)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                inference_params: Optional[InferenceParams] = None,
                dropout_seed=None):
        """`dropout_seed` (training with attn_pdrop > 0): an int, from which
        layer i's attention dropout takes fold_seed(seed, i), or a sequence
        of one seed per layer; None draws the int from torch's CPU
        generator. The seeds are taken here, outside any checkpointed
        block, so that a recomputed block draws the same mask."""
        c = self.config
        if position_ids is None and c.n_positions > 0:
            offset = 0 if inference_params is None else inference_params.seqlen_offset
            steps = torch.arange(input_ids.shape[1], device=input_ids.device)
            if isinstance(offset, int):
                position_ids = (c.position_offset + offset + steps)[None]
            else:
                position_ids = (c.position_offset
                                + offset.to(input_ids.device).long()[:, None]
                                + steps[None])
        training = self.training and torch.is_grad_enabled()
        if training and (c.embd_pdrop > 0 or c.resid_pdrop > 0):
            raise NotImplementedError(
                "embedding and residual dropout are not ported yet: ROADMAP "
                "queue 1, item 13 (trainer leftovers: embd/resid dropout)"
            )
        hidden = self.embeddings(input_ids, position_ids)
        if c.embed_scale is not None:
            hidden = hidden * torch.tensor(c.embed_scale, dtype=c.dtype)
        remat = c.remat != "none" and inference_params is None and training
        seeds = [None] * c.n_layer
        if training and c.attn_pdrop > 0 and inference_params is None:
            if dropout_seed is None:
                dropout_seed = int(torch.randint(0, 2**31 - 1, ()))
            seeds = (list(dropout_seed) if isinstance(dropout_seed, (list, tuple))
                     else [fold_seed(dropout_seed, i) for i in range(c.n_layer)])

        def run(layer, seed, *args):
            if not remat:
                return layer(*args, inference_params=inference_params,
                             dropout_seed=seed)
            kw = dict(context_fn=_remat_context) if c.remat == "dots" else {}
            return checkpoint(layer, *args, use_reentrant=False,
                              dropout_seed=seed, **kw)

        if not c.prenorm:
            for layer, seed in zip(self.layers, seeds):
                hidden = run(layer, seed, hidden)
            return hidden
        residual = None
        for layer, seed in zip(self.layers, seeds):
            hidden, residual = run(layer, seed, hidden, residual)
        residual = residual + hidden.to(residual.dtype)
        return self.ln_f(residual).to(c.dtype)


class GPTLMHeadModel(nn.Module, GenerationMixin):
    """LM-head model. Built on `device` (CUDA unless named; the CPU only on
    request) with random weights drawn from `generator` (a torch.Generator
    on that device; seed 0 when None) at flax's default scales:
    normal(0, 1/sqrt(fan_in)) kernels and embedding rows
    (normal(0, 1/sqrt(n_embd))), zero biases, unit norm weights. Load real
    weights with `load_state_dict`.

    Weights are stored in `param_dtype` (default: `config.dtype`, as
    serving keeps them) and computed in `config.dtype`; training passes
    `torch.float32`, as flax keeps its parameters. Norms are fp32 always."""

    def __init__(self, config: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 param_dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.transformer = GPTModel(config, device=device,
                                    param_dtype=param_dtype)
        self.lm_head = (
            None if config.tie_word_embeddings
            else Linear(config.n_embd, config.padded_vocab_size, bias=False,
                        device=device, dtype=config.dtype,
                        param_dtype=param_dtype)
        )
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, 1.0 / math.sqrt(module.in_features),
                                      generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, 1.0 / math.sqrt(module.embedding_dim),
                                      generator=generator)
            elif isinstance(module, (LayerNorm, RMSNorm)):
                module.weight.fill_(1.0)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, MLA):
                module.init_up_projections(generator)

    @property
    def device(self) -> torch.device:
        return self.transformer.ln_f.weight.device

    def forward(self, input_ids, position_ids=None,
                inference_params: Optional[InferenceParams] = None,
                num_last_tokens: int = 0, dropout_seed=None):
        """Returns logits (b, s or num_last_tokens, padded_vocab).
        `dropout_seed` as GPTModel.forward takes it."""
        hidden = self.transformer(input_ids, position_ids, inference_params,
                                  dropout_seed=dropout_seed)
        if num_last_tokens > 0:
            hidden = hidden[:, -num_last_tokens:]
        if self.lm_head is None:
            wte = self.transformer.embeddings.word_embeddings.weight
            return F.linear(hidden, wte.to(self.config.dtype))
        return self.lm_head(hidden)

    def allocate_inference_cache(self, batch_size: int, max_seqlen: int,
                                 dtype=None) -> InferenceParams:
        """Zeroed contiguous (batch_size, hk, max_seqlen, d) K and V caches
        for every layer, on the model's device; for MLA each layer's (rope
        (b, 1, smax, qk_rope_head_dim), latent (b, 1, smax, kv_lora_rank))
        pair, one KV head."""
        c = self.config
        if c.attn_type == "mla":
            caches = {i: layer.mixer.allocate_cache(
                          batch_size, max_seqlen, dtype or c.dtype,
                          device=self.device)
                      for i, layer in enumerate(self.transformer.layers)}
            return InferenceParams(max_seqlen=max_seqlen,
                                   max_batch_size=batch_size, seqlen_offset=0,
                                   key_value_memory_dict=caches)
        caches = {
            i: allocate_kv_cache(batch_size, max_seqlen, c.resolved_n_head_kv,
                                 c.resolved_head_dim, dtype or c.dtype,
                                 device=self.device)
            for i in range(c.n_layer)
        }
        return InferenceParams(max_seqlen=max_seqlen,
                               max_batch_size=batch_size, seqlen_offset=0,
                               key_value_memory_dict=caches)
