"""Multi-head Latent Attention, DeepSeek-V2's attention (counterpart of
flash_attn_tpu/modules/mla.py), computed in the weight-absorbed latent space:

    O = softmax(scale * (Q K^T + Qv C^T)) C
    with Q = q_rope, K = the shared rope key, Qv = W_uk^T q_nope (the
    absorbed query) and C the latent (also V);

then W_uv un-absorbs the latent output per head. The cache holds one "kv
head" of (qk_rope_head_dim + kv_lora_rank) values per token, the MLA memory
saving. Without a cache the forward runs `flash_attn_func(qv=)` (kernel 1's
qv forward on the card, and in training kernels 3 and 2's qv backward, so
gradients reach every projection through the absorb and the un-absorb);
with one it appends the token's rope key and latent
and runs `flash_attention_decode(qv=)`: kernel 4's qv path over the engine's
fused rope|latent page pools or split (rope, latent) pools, kernel 5's over
`generate`'s contiguous (rope, latent) caches. The absorb and the
un-absorb are computed in fp32 and cast to the activation dtype, the JAX
module's rounding points (mla.py:99-104, :185-189).

Cache entries of `InferenceParams.key_value_memory_dict[layer]`: a tensor is
a fused rope|latent page pool (npages, 1, page, 128 + 512 padded sections;
`runtime.kv_cache.allocate_fused_paged_kv_cache`); a tuple is (rope,
latent), page pools under `block_table` or contiguous (b, 1, smax, .)
caches. MLA takes no 1-byte cache (the latent is the V operand).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from flash_attn_tpu_torch.flash_attn_interface import flash_attn_func
from flash_attn_tpu_torch.kernels.flash_decode import flash_attention_decode
from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding
from flash_attn_tpu_torch.modules.linear import Linear
from flash_attn_tpu_torch.modules.mha import InferenceParams
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb
from flash_attn_tpu_torch.runtime.kv_cache import (
    update_fused_paged_kv_cache,
    update_kv_cache,
    update_paged_kv_cache,
)
from flash_attn_tpu_torch.utils.device import resolve_device


class MLA(nn.Module):
    """DeepSeek-V2-style attention: a low-rank joint KV compression
    (`W_dkv` to the latent and the shared rope key), per-head up-projections
    `W_uk` (h, dn, dc) and `W_uv` (h, dc, dv) kept as tensors so that they
    fold into the query and the output, and a decoupled rope on its own
    `RotaryEmbedding(qk_rope_head_dim)`. The JAX module's names, order and
    defaults; the softmax scale is (dn + dr)^-0.5, over the per-head qk
    width, not the absorbed operands'."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        kv_lora_rank: int = 512,
        q_lora_rank: Optional[int] = None,
        qk_nope_head_dim: int = 128,
        qk_rope_head_dim: int = 64,
        v_head_dim: int = 128,
        rotary_emb_base: float = 10000.0,
        causal: bool = True,
        layer_idx: Optional[int] = None,
        device=None,
        dtype=torch.bfloat16,
        param_dtype=None,
    ):
        super().__init__()
        h = num_heads
        dn, dr = qk_nope_head_dim, qk_rope_head_dim
        dc, dv = kv_lora_rank, v_head_dim
        self.num_heads, self.kv_lora_rank = h, dc
        self.qk_nope_head_dim, self.qk_rope_head_dim = dn, dr
        self.v_head_dim, self.q_lora_rank = dv, q_lora_rank
        self.causal, self.layer_idx, self.dtype = causal, layer_idx, dtype
        kw = dict(bias=False, device=device, dtype=dtype,
                  param_dtype=param_dtype)
        if q_lora_rank:
            self.W_dq = Linear(embed_dim, q_lora_rank, **kw)
            self.W_uq = Linear(q_lora_rank, h * (dn + dr), **kw)
        else:
            self.W_q = Linear(embed_dim, h * (dn + dr), **kw)
        self.W_dkv = Linear(embed_dim, dc + dr, **kw)
        pdt = param_dtype or dtype
        self.W_uk = nn.Parameter(torch.empty(h, dn, dc, device=device,
                                             dtype=pdt))
        self.W_uv = nn.Parameter(torch.empty(h, dc, dv, device=device,
                                             dtype=pdt))
        self.out_proj = Linear(h * dv, embed_dim, **kw)
        self.rotary = RotaryEmbedding(dr, base=rotary_emb_base)
        self.softmax_scale = (dn + dr) ** -0.5

    @torch.no_grad()
    def init_up_projections(self, generator: torch.Generator):
        """W_uk and W_uv at flax lecun_normal's scale for their shapes:
        normal(0, 1 / sqrt(fan_in)), fan_in = h x the middle axis."""
        for w in (self.W_uk, self.W_uv):
            w.normal_(0.0, 1.0 / math.sqrt(w.shape[0] * w.shape[1]),
                      generator=generator)

    def _project(self, x, offsets, rot_len):
        """(q_rope (b, s, h, dr), qv (b, s, h, dc), k_rope (b, s, 1, dr),
        latent (b, s, 1, dc)): rope at per-row `offsets`, W_uk absorbed
        into qv in fp32."""
        b, s, _ = x.shape
        h, dn = self.num_heads, self.qk_nope_head_dim
        dr, dc = self.qk_rope_head_dim, self.kv_lora_rank
        q = self.W_uq(self.W_dq(x)) if self.q_lora_rank else self.W_q(x)
        q = q.reshape(b, s, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        ckv = self.W_dkv(x)
        c, k_rope = ckv[..., :dc], ckv[..., dc:]
        cos, sin = self.rotary.cos_sin(rot_len, device=x.device)
        q_rope = apply_rotary_emb(q_rope, cos, sin, seqlen_offsets=offsets)
        k_rope = apply_rotary_emb(k_rope[:, :, None], cos, sin,
                                  seqlen_offsets=offsets)
        qv = torch.einsum("bshn,hnc->bshc", q_nope.float(),
                          self.W_uk.float()).to(q_nope.dtype).contiguous()
        return q_rope, qv, k_rope, c[:, :, None]

    def forward(self, x: torch.Tensor,
                inference_params: Optional[InferenceParams] = None, *,
                dropout_seed: Optional[int] = None):
        """x: (b, s, embed_dim). Without `inference_params`: causal
        attention over the whole sequence; with them: append to the layer's
        latent cache and attend to it. `dropout_seed` is taken for the
        block's interface; MLA has no attention dropout."""
        del dropout_seed
        b, s, _ = x.shape
        h, dv = self.num_heads, self.v_head_dim
        if inference_params is None:
            q_rope, qv, k_rope, c = self._project(x, 0, s)
            o_lat = flash_attn_func(q_rope, k_rope, c, qv=qv,
                                    causal=self.causal,
                                    softmax_scale=self.softmax_scale)
        else:
            o_lat = self._decode_step(x, inference_params)
        out = torch.einsum("bshc,hcv->bshv", o_lat.float(),
                           self.W_uv.float()).to(x.dtype)
        return self.out_proj(out.reshape(b, s, h * dv))

    def _decode_step(self, x, inference_params: InferenceParams):
        """Append this call's rope keys and latents to the layer's cache
        (in place) and attend the new queries to it: (b, s, h, dc)."""
        b, s = x.shape[0], x.shape[1]
        layer = self.layer_idx if self.layer_idx is not None else 0
        entry = inference_params.key_value_memory_dict[layer]
        table = inference_params.block_table
        offset = inference_params.seqlen_offset
        if isinstance(offset, int):
            offsets = torch.full((b,), offset, dtype=torch.int32,
                                 device=x.device)
        else:
            offsets = offset.to(device=x.device, dtype=torch.int32)
        q_rope, qv, k_rope, c = self._project(x, offsets,
                                              inference_params.max_seqlen)
        attn = dict(qv=qv, block_table=table,
                    softmax_scale=self.softmax_scale, causal=True)
        if torch.is_tensor(entry):
            if table is None:
                raise ValueError("a fused rope|latent pool is paged: it "
                                 "needs a block table")
            update_fused_paged_kv_cache(entry, k_rope, c, offsets, table)
            out, _ = flash_attention_decode(
                q_rope, entry, None, offsets + s,
                fused_kv_dim=self.qk_rope_head_dim,
                fused_kv_dim_v=self.kv_lora_rank, **attn)
            return out
        if not isinstance(entry, tuple):
            raise ValueError("an MLA layer's cache is a fused rope|latent "
                             "pool or a (rope, latent) pair; 1-byte caches "
                             "are not supported")
        kr, cc = entry
        if table is None:
            update_kv_cache(kr, cc, k_rope, c, offsets)
        else:
            update_paged_kv_cache(kr, cc, k_rope, c, offsets, table)
        out, _ = flash_attention_decode(q_rope, kr, cc, offsets + s, **attn)
        return out

    def allocate_cache(self, batch: int, max_seqlen: int, dtype=None,
                       device=None):
        """This layer's latent cache: zeroed contiguous (rope (b, 1, smax,
        dr), latent (b, 1, smax, dc)), in `dtype` (the module's unless
        named), on `device` (the card unless named)."""
        device = resolve_device(device)
        return tuple(torch.zeros((batch, 1, max_seqlen, width),
                                 dtype=dtype or self.dtype, device=device)
                     for width in (self.qk_rope_head_dim, self.kv_lora_rank))
