"""Multi-head attention (counterpart of flash_attn_tpu/modules/mha.py).

Separate Wq/Wk/Wv projections, rotary, GQA/MQA, sliding window, softcap,
ALiBi, attention dropout and key padding. Without a cache (training,
full-sequence forwards) it runs dense causal flash attention
(`flash_attn_func`: the flash forward and backward kernels, with their
feature instances for ALiBi, dropout and padding). With a cache, `_decode_step` appends the new K/V to the layer's
cache in place, a contiguous (b, hk, smax, d) pair (`generate`) or a paged
pool (`LLMEngine`), and runs `flash_attention_decode` over it (kernel 5 for
contiguous caches and ALiBi, kernel 4 for the engine's paged pools). A
quantized engine layer (`QuantPagedKV`, a 1-byte pool and its per-head
descales) quantizes the new K/V on write and decodes with the descales.
dwconv raises NotImplementedError.

Attention dropout draws its mask from a seed per call: the caller's
`dropout_seed` (the GPT model passes one per layer, derived from the
trainer's step seed), else one drawn from torch's CPU generator, with no
device read. The JAX MHA passes none, so its kernel uses seed 0 in every
layer and at every step (a fixed mask); the port's differ per step and
layer (a held difference, ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from flash_attn_tpu_torch.flash_attn_interface import flash_attn_func
from flash_attn_tpu_torch.kernels.common import default_alibi_slopes
from flash_attn_tpu_torch.kernels.flash_decode import flash_attention_decode
from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding
from flash_attn_tpu_torch.modules.linear import Linear
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb
from flash_attn_tpu_torch.runtime.kv_cache import (
    QuantPagedKV,
    quantize_to_cache_dtype,
    update_fused_paged_kv_cache,
    update_kv_cache,
    update_paged_kv_cache,
)


@dataclasses.dataclass
class InferenceParams:
    """KV-cache state for a forward with a cache. `key_value_memory_dict`
    maps layer_idx to a (k_cache, v_cache) tuple, contiguous (b, hk, smax,
    d) when `block_table` is None, else paged (npages, hk, page, d), to a
    fused K|V page pool (a tensor), or to a `QuantPagedKV` (a 1-byte paged
    pool, split or fused, and its descales); `block_table` (b, max_pages)
    int32 maps
    positions to pages; `seqlen_offset` is an int or a (b,) int32 tensor of
    cache lengths before this call's tokens."""

    max_seqlen: int
    max_batch_size: int
    seqlen_offset: Any = 0
    key_value_memory_dict: dict = dataclasses.field(default_factory=dict)
    block_table: Optional[torch.Tensor] = None


class MHA(nn.Module):
    """Causal self-attention with separate q/k/v projections, rotary,
    GQA/MQA, sliding window, softcap, ALiBi, and a KV-cache decode path.
    Projection weights are stored in `param_dtype` (default: `dtype`) and
    computed in `dtype`. Attention dropout (`dropout` > 0) applies while
    training with gradients enabled, as the GPT model's training rule
    says."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        num_heads_kv: Optional[int] = None,
        head_dim: Optional[int] = None,
        qkv_proj_bias: bool = True,
        out_proj_bias: bool = True,
        dropout: float = 0.0,
        softmax_scale: Optional[float] = None,
        window_size: Tuple[int, int] = (-1, -1),
        softcap: float = 0.0,
        use_alibi: bool = False,
        dwconv: bool = False,
        rotary_emb_dim: int = 0,
        rotary_emb_base: float = 10000.0,
        rotary_emb_interleaved: bool = False,
        layer_idx: Optional[int] = None,
        device=None,
        dtype=torch.bfloat16,
        param_dtype=None,
    ):
        super().__init__()
        if dwconv:
            raise NotImplementedError(
                "dwconv is not ported yet: ROADMAP queue 1, item 4 (mha.py)"
            )
        h = num_heads
        hk = num_heads_kv if num_heads_kv is not None else h
        if h % hk != 0:
            raise ValueError(f"{h} heads do not group over {hk} kv heads")
        d = head_dim if head_dim is not None else embed_dim // num_heads
        self.num_heads, self.num_heads_kv, self.head_dim = h, hk, d
        self.dropout = dropout
        self.softmax_scale = softmax_scale
        self.window_size = tuple(window_size)
        self.softcap = softcap
        self.rotary_emb_dim = rotary_emb_dim
        self.rotary_emb_interleaved = rotary_emb_interleaved
        self.layer_idx = layer_idx
        kw = dict(device=device, dtype=dtype, param_dtype=param_dtype)
        self.Wq = Linear(embed_dim, h * d, bias=qkv_proj_bias, **kw)
        self.Wk = Linear(embed_dim, hk * d, bias=qkv_proj_bias, **kw)
        self.Wv = Linear(embed_dim, hk * d, bias=qkv_proj_bias, **kw)
        self.out_proj = Linear(h * d, embed_dim, bias=out_proj_bias, **kw)
        self.rotary = (
            RotaryEmbedding(rotary_emb_dim, base=rotary_emb_base,
                            interleaved=rotary_emb_interleaved)
            if rotary_emb_dim > 0 else None
        )
        # The JAX module's fixed geometric slopes; a buffer so that it moves
        # with the module, left out of the state_dict.
        self.register_buffer(
            "alibi_slopes",
            default_alibi_slopes(h).to(device=device) if use_alibi else None,
            persistent=False)

    def forward(self, x: torch.Tensor,
                inference_params: Optional[InferenceParams] = None, *,
                key_padding_mask: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None):
        """x: (b, s, embed_dim). Without `inference_params`: causal attention
        over the whole sequence (`key_padding_mask` (b, s) bool: False keys
        are padding; `dropout_seed`: the seed of this call's dropout mask);
        with one (a paged cache): `_decode_step`."""
        b, s, _ = x.shape
        h, hk, d = self.num_heads, self.num_heads_kv, self.head_dim
        q = self.Wq(x).reshape(b, s, h, d)
        k = self.Wk(x).reshape(b, s, hk, d)
        v = self.Wv(x).reshape(b, s, hk, d)
        if inference_params is None:
            context = self._full_sequence(q, k, v, key_padding_mask,
                                          dropout_seed)
        else:
            context = self._decode_step(q, k, v, inference_params)
        return self.out_proj(context.reshape(b, s, h * d))

    def _full_sequence(self, q, k, v, key_padding_mask=None,
                       dropout_seed=None):
        """Rotary over positions 0..s-1, then causal flash attention; padding
        keys become mismatching segment ids, as the JAX MHA's
        key_padding_mask does (query rows of padding see nothing and give
        0)."""
        dropout_p = (self.dropout if self.training and torch.is_grad_enabled()
                     else 0.0)
        if dropout_p > 0.0 and dropout_seed is None:
            dropout_seed = int(torch.randint(0, 2**31 - 1, ()))
        seg = {}
        if key_padding_mask is not None:
            kpm = key_padding_mask.to(q.device, torch.bool)
            seg = dict(
                q_segment_ids=torch.where(kpm[:, :q.shape[1]], 0, -1).int(),
                kv_segment_ids=torch.where(kpm, 0, -2).int())
        if self.rotary is not None:
            cos, sin = self.rotary.cos_sin(q.shape[1], device=q.device)
            q = apply_rotary_emb(q, cos, sin,
                                 interleaved=self.rotary_emb_interleaved)
            k = apply_rotary_emb(k, cos, sin,
                                 interleaved=self.rotary_emb_interleaved)
        return flash_attn_func(q, k, v, dropout_p=dropout_p,
                               softmax_scale=self.softmax_scale,
                               causal=True, window_size=self.window_size,
                               softcap=self.softcap,
                               alibi_slopes=self.alibi_slopes,
                               dropout_seed=dropout_seed, **seg)

    def _decode_step(self, q, k, v, inference_params: InferenceParams):
        """Append this call's K/V to the layer's cache (in place) and attend
        the new queries to it, prefills and decode steps alike."""
        b, s = q.shape[0], q.shape[1]
        layer = self.layer_idx if self.layer_idx is not None else 0
        entry = inference_params.key_value_memory_dict[layer]
        table = inference_params.block_table
        offset = inference_params.seqlen_offset
        if isinstance(offset, int):
            offsets = torch.full((b,), offset, dtype=torch.int32,
                                 device=q.device)
        else:
            offsets = offset.to(device=q.device, dtype=torch.int32)
        if self.rotary is not None:
            cos, sin = self.rotary.cos_sin(inference_params.max_seqlen,
                                           device=q.device)
            rot = dict(interleaved=self.rotary_emb_interleaved,
                       seqlen_offsets=offsets)
            q = apply_rotary_emb(q, cos, sin, **rot)
            k = apply_rotary_emb(k, cos, sin, **rot)
        attn = dict(block_table=table, softmax_scale=self.softmax_scale,
                    causal=True, window_left=self.window_size[0],
                    softcap=self.softcap)
        if isinstance(entry, QuantPagedKV):
            # New K/V quantized on write with the pool's per-head descales;
            # the decode kernels dequantize in-kernel.
            if table is None or self.alibi_slopes is not None:
                raise ValueError("a quantized cache is a paged engine pool "
                                 "and takes no ALiBi")
            pool = entry.k
            k = quantize_to_cache_dtype(k, entry.k_scale, pool.dtype)
            v = quantize_to_cache_dtype(v, entry.v_scale, pool.dtype)
            scales = dict(k_scale=entry.k_scale, v_scale=entry.v_scale)
            if entry.fused:
                update_fused_paged_kv_cache(pool, k, v, offsets, table)
                out, _ = flash_attention_decode(
                    q, pool, None, offsets + s, fused_kv_dim=k.shape[-1],
                    fused_kv_dim_v=v.shape[-1], **scales, **attn)
            else:
                update_paged_kv_cache(pool, entry.v, k, v, offsets, table)
                out, _ = flash_attention_decode(
                    q, pool, entry.v, offsets + s, **scales, **attn)
            return out
        if isinstance(entry, tuple):
            if table is None:
                update_kv_cache(entry[0], entry[1], k, v, offsets)
            else:
                update_paged_kv_cache(entry[0], entry[1], k, v, offsets, table)
            out, _ = flash_attention_decode(
                q, entry[0], entry[1], offsets + s,
                alibi_slopes=self.alibi_slopes, **attn
            )
            return out
        if self.alibi_slopes is not None:
            raise ValueError("fused K|V page pools do not take ALiBi: "
                             "allocate split pools")
        update_fused_paged_kv_cache(entry, k, v, offsets, table)
        out, _ = flash_attention_decode(
            q, entry, None, offsets + s, fused_kv_dim=k.shape[-1],
            fused_kv_dim_v=v.shape[-1], **attn
        )
        return out
