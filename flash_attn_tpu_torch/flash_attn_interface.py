"""Public flash-attention API (counterpart of
flash_attn_tpu/flash_attn_interface.py): dense `flash_attn_func`, packed
varlen `flash_attn_varlen_func`, their qkv/kv-packed forms, and
`flash_attn_with_kvcache` over paged caches.

The JAX package's `custom_vjp` cores become `torch.autograd.Function`s:
`_FlashAttnCore` runs `kernels.flash_fwd` forward and `kernels.flash_bwd`
backward, `_FlashAttnVarlenCore` the varlen kernels of
`kernels.flash_varlen` (kernels on the card, their plain versions on the
CPU). The backwards are deterministic: no atomics.

Layouts: (batch, seqlen, nheads, headdim) ["bshd"] by default, or
["bhsd"]; varlen (total, nheads, headdim) ["thd"] or (nheads, total,
headdim) ["hsd"]. The kernels take strided inputs, so these go in as views
without a copy, and the outputs come back in the same layout as q.

`flash_attn_with_kvcache` attends over a contiguous or paged KV cache
through `kernels.flash_decode` (kernel 5, or kernel 4 for plain paged
calls); `flash_attn_combine` merges split-attention partials.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels.common import rows_dense
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_decode import (
    combine_partials,
    flash_attention_decode,
)
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
from flash_attn_tpu_torch.kernels.flash_varlen import (
    check_unported as check_varlen_unported,
)
from flash_attn_tpu_torch.kernels.flash_varlen import (
    flash_attention_varlen_bwd,
    flash_attention_varlen_fwd,
    resolve_max_seqlens,
)
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb
from flash_attn_tpu_torch.runtime.kv_cache import (
    update_kv_cache,
    update_paged_kv_cache,
)

__all__ = [
    "flash_attn_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_kvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_with_kvcache",
    "flash_attn_combine",
    "compile_flash_attn_varlen_func_from_specs",
    "sparse_attn_func",
]


class _FlashAttnCore(torch.autograd.Function):
    """out, lse = attention(q, k, v) in (b, h, s, d); the backward takes dO
    only (the LSE's cotangent is ignored, as in the JAX package) and needs
    no copy of out (see kernels.flash_bwd on delta)."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale, causal, window_size, softcap,
                extras):
        kw = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap)
        q, k, v = (rows_dense(x) for x in (q, k, v))
        out, lse = flash_attention_fwd(q, k, v, **kw, **extras)
        ctx.save_for_backward(q, k, v, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, rows_dense(dout),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attn_func(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    *,
    qv: Optional[torch.Tensor] = None,
    gather_kv_indices: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    bias_grad: bool = True,
    sink: Optional[torch.Tensor] = None,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_descale: Optional[torch.Tensor] = None,
    k_descale: Optional[torch.Tensor] = None,
    v_descale: Optional[torch.Tensor] = None,
    score_mod=None,
    mask_mod=None,
    aux_tensors=(),
    aux_scalars=(),
    block_sparse_tensors=None,
    dropout_seed: Optional[torch.Tensor] = None,
    layout: str = "bshd",
):
    """Dense attention, as the JAX package's `flash_attn_func`.

    q: (b, sq, h, d); k/v: (b, sk, hk, d) with h % hk == 0 (or (b, h, s, d)
    with layout="bhsd"). Returns out in q's layout; with
    return_attn_probs=True returns (out, softmax_lse (b, h, sq) fp32,
    None).

    `deterministic`, `bias_grad` and `dropout_seed` are taken so that calls
    written for the JAX API run unchanged, and nothing reads them: the
    backward is always deterministic, and a bias or dropout raises."""
    del deterministic, bias_grad, dropout_seed
    if gather_kv_indices is not None:
        raise NotImplementedError(
            "gather_kv_indices (top-k gathered attention) is not ported yet: "
            "ROADMAP queue 2, kernels 1-3: gather_kv_indices"
        )
    if block_sparse_tensors is not None:
        raise NotImplementedError(
            "block_sparse_tensors is not ported yet: ROADMAP queue 1, item 8 "
            "(block sparsity)"
        )
    if layout == "bshd":
        q_, k_, v_ = (x.transpose(1, 2) for x in (q, k, v))
    elif layout == "bhsd":
        q_, k_, v_ = q, k, v
    else:
        raise ValueError(f"unknown layout {layout!r}")
    extras = dict(
        qv=qv, bias=attn_bias, alibi_slopes=alibi_slopes, sink=sink,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale,
        attention_chunk=attention_chunk, sink_token_length=sink_token_length,
        dropout_p=dropout_p, score_mod=score_mod, mask_mod=mask_mod,
        aux_tensors=aux_tensors, aux_scalars=aux_scalars,
    )
    out, lse = _FlashAttnCore.apply(
        q_, k_, v_, softmax_scale, bool(causal),
        tuple(int(w) for w in window_size), float(softcap), extras,
    )
    if layout == "bshd":
        out = out.transpose(1, 2)
    if return_attn_probs:
        return out, lse, None
    return out


def flash_attn_qkvpacked_func(
    qkv: torch.Tensor,  # (b, s, 3, h, d)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    **kwargs,
):
    """`flash_attn_func` on q, k, v packed as (b, s, 3, h, d)."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return flash_attn_func(
        q, k, v, dropout_p, softmax_scale, causal, window_size, softcap,
        alibi_slopes, deterministic, return_attn_probs, **kwargs
    )


def flash_attn_kvpacked_func(
    q: torch.Tensor,   # (b, sq, h, d)
    kv: torch.Tensor,  # (b, sk, 2, hk, d)
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    **kwargs,
):
    """`flash_attn_func` on k, v packed as (b, sk, 2, hk, d)."""
    k, v = kv[:, :, 0], kv[:, :, 1]
    return flash_attn_func(
        q, k, v, dropout_p, softmax_scale, causal, window_size, softcap,
        alibi_slopes, deterministic, return_attn_probs, **kwargs
    )


def flash_attn_with_kvcache(
    q: torch.Tensor,        # (b, sq, h, d)
    k_cache: torch.Tensor,  # (b, smax, hk, d) | paged (npages, page, hk, d)
    v_cache: torch.Tensor,
    k: Optional[torch.Tensor] = None,  # (b, snew, hk, d) to append
    v: Optional[torch.Tensor] = None,
    rotary_cos: Optional[torch.Tensor] = None,  # (smax_rot, rot / 2)
    rotary_sin: Optional[torch.Tensor] = None,
    cache_seqlens=None,  # (b,) lengths BEFORE the append, or an int
    cache_batch_idx: Optional[torch.Tensor] = None,
    cache_leftpad: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,  # (b, max_pages) int32
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    rotary_interleaved: bool = False,
    alibi_slopes: Optional[torch.Tensor] = None,
    num_splits: int = 0,
    return_softmax_lse: bool = False,
    *,
    sink: Optional[torch.Tensor] = None,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    layout: str = "bshd",
    block_kv: Optional[int] = None,
):
    """Decode-step attention over a KV cache, as the JAX package's
    `flash_attn_with_kvcache` (flash_attn_interface.py:495).

    Caches are contiguous (b, smax, hk, d) or paged (npages, page, hk, d)
    ["bshd"], or (b, hk, smax, d) / (npages, hk, page, d) ["bhsd"]. New k/v
    are rotated (with rotary_cos/sin) and written into the caches IN PLACE
    (`runtime.kv_cache.update_kv_cache`, rows picked by cache_batch_idx, or
    `update_paged_kv_cache`; through head-major views of bshd caches), and
    attention runs through `kernels.flash_decode.flash_attention_decode`.
    Returns out[, lse][, (k_cache, v_cache)] as the JAX function does; the
    returned caches are the given tensors. `num_splits` and `block_kv` are
    taken for the JAX signature and not read."""
    del num_splits, block_kv
    paged = block_table is not None
    if layout == "bshd":
        kc, vc = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    elif layout == "bhsd":
        kc, vc = k_cache, v_cache
    else:
        raise ValueError(f"unknown layout {layout!r}")
    batch, sq = q.shape[0], q.shape[1]
    if cache_seqlens is None:
        smax = kc.shape[2] * (block_table.shape[1] if paged else 1)
        cache_seqlens = smax - (0 if k is None else k.shape[1])
    if not isinstance(cache_seqlens, torch.Tensor) or cache_seqlens.dim() == 0:
        cache_seqlens = torch.full((batch,), int(cache_seqlens),
                                   dtype=torch.int32, device=q.device)
    cache_seqlens = cache_seqlens.to(q.device, torch.int32)
    if rotary_cos is not None:
        rot = dict(interleaved=rotary_interleaved, seqlen_offsets=cache_seqlens)
        q = apply_rotary_emb(q, rotary_cos, rotary_sin, **rot)
        if k is not None:
            k = apply_rotary_emb(k, rotary_cos, rotary_sin, **rot)
    total = cache_seqlens
    if k is not None:
        if paged:
            update_paged_kv_cache(kc, vc, k, v, cache_seqlens, block_table)
        else:
            update_kv_cache(kc, vc, k, v, cache_seqlens,
                            cache_batch_idx=cache_batch_idx)
        total = cache_seqlens + k.shape[1]
    out, lse = flash_attention_decode(
        q, kc, vc, total,
        block_table=None if not paged else block_table.to(torch.int32),
        cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad,
        alibi_slopes=alibi_slopes, sink=sink, k_scale=k_scale,
        v_scale=v_scale, softmax_scale=softmax_scale,
        causal=causal or sq == 1, window_left=int(window_size[0]),
        attention_chunk=int(attention_chunk),
        sink_token_length=sink_token_length, softcap=softcap)
    ret = [out]
    if return_softmax_lse:
        ret.append(lse)
    if k is not None:
        ret.append((k_cache, v_cache))
    return ret[0] if len(ret) == 1 else tuple(ret)


def flash_attn_combine(
    out_partial: torch.Tensor,  # (nsplits, ..., h, d) fp32 partials
    lse_partial: torch.Tensor,  # (nsplits, ..., h)
    out: Optional[torch.Tensor] = None,
    out_dtype=None,
    return_lse: bool = True,
):
    """Merge split-attention partials (the JAX package's
    `flash_attn_combine`): batched (n, b, s, h, d) or varlen (n, total, h,
    d), each partial normalised by its own softmax sum, lse in natural log.
    `out` is taken for the JAX signature and not read, as there."""
    del out
    o, lse = combine_partials(out_partial.float(), lse_partial.float())
    if out_dtype is not None:
        o = o.to(out_dtype)
    return (o, lse) if return_lse else o


class _FlashAttnVarlenCore(torch.autograd.Function):
    """out, lse = varlen attention(q, k, v); like `_FlashAttnCore`, the
    backward takes dO only (the LSE's cotangent is ignored, as in the JAX
    package) and needs no copy of out."""

    @staticmethod
    def forward(ctx, q, k, v, cu_seqlens_q, cu_seqlens_k, seqused_q,
                seqused_k, kw, max_seqlen_q, max_seqlen_k, plan, extras):
        q, k, v = (rows_dense(x) for x in (q, k, v))
        out, lse = flash_attention_varlen_fwd(
            q, k, v, cu_seqlens_q, cu_seqlens_k, seqused_q=seqused_q,
            seqused_k=seqused_k, plan=plan, max_seqlen_q=max_seqlen_q,
            **kw, **extras)
        ctx.save_for_backward(q, k, v, lse, cu_seqlens_q, cu_seqlens_k,
                              seqused_q, seqused_k)
        ctx.kw = kw
        ctx.max_seqlens = (max_seqlen_q, max_seqlen_k)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, lse, cu_q, cu_k, used_q, used_k = ctx.saved_tensors
        dq, dk, dv = flash_attention_varlen_bwd(
            q, k, v, None, lse, rows_dense(dout), cu_q, cu_k,
            seqused_q=used_q, seqused_k=used_k,
            max_seqlen_q=ctx.max_seqlens[0], max_seqlen_k=ctx.max_seqlens[1],
            **ctx.kw)
        return (dq, dk, dv) + (None,) * 9


def flash_attn_varlen_func(
    q: torch.Tensor,  # (total_q, h, d)
    k: torch.Tensor,  # (total_k, hk, d)
    v: torch.Tensor,
    cu_seqlens_q: torch.Tensor,  # (nseq + 1,) int32
    cu_seqlens_k: torch.Tensor,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    *,
    qv: Optional[torch.Tensor] = None,
    gather_kv_indices: Optional[torch.Tensor] = None,
    attention_chunk: int = 0,
    seqused_q: Optional[torch.Tensor] = None,
    seqused_k: Optional[torch.Tensor] = None,
    dropout_seed: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    bias_grad: bool = False,
    score_mod=None,
    mask_mod=None,
    aux_tensors=(),
    aux_scalars=(),
    block_sparse_tensors=None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    layout: str = "thd",
    plan=None,
):
    """Packed variable-length attention, as the JAX package's
    `flash_attn_varlen_func`, differentiable in q, k and v.

    Bottom-right-aligned causal masking per sequence, sliding windows, GQA,
    softcap, seqused_q/k. Returns out in q's layout; with
    return_attn_probs=True, (out, softmax_lse (h, total_q) fp32, None).

    The CUDA grids are sized by max_seqlen_q/k: the caller's, else the
    plan's (`make_varlen_plan`), else one host read of cu_seqlens.
    `deterministic`, `dropout_seed`, `block_q` and `block_kv` are taken for
    calls written for the JAX API and not read: the backward is always
    deterministic and the CUDA tiles are fixed."""
    del deterministic, dropout_seed, block_q, block_kv
    if block_sparse_tensors is not None:
        raise NotImplementedError(
            "block_sparse_tensors is not ported yet: ROADMAP queue 1, item 8 "
            "(block sparsity)")
    if gather_kv_indices is not None:
        raise NotImplementedError(
            "gather_kv_indices (top-k gathered attention) is not ported yet: "
            "ROADMAP queue 1, item 6 (varlen leftovers)")
    if layout not in ("thd", "hsd"):
        raise ValueError(f"unknown varlen layout {layout!r}")
    if q.device.type != "cpu":
        max_seqlen_q, max_seqlen_k = resolve_max_seqlens(
            cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k, plan)
    kw = dict(softmax_scale=softmax_scale, causal=bool(causal),
              window_size=tuple(int(w) for w in window_size),
              softcap=float(softcap), layout=layout)
    extras = dict(qv=qv, alibi_slopes=alibi_slopes, dropout_p=dropout_p,
                  attention_chunk=attention_chunk, attn_bias=attn_bias,
                  score_mod=score_mod, mask_mod=mask_mod,
                  aux_tensors=aux_tensors, aux_scalars=aux_scalars)
    check_varlen_unported(bias_grad=bias_grad)
    out, lse = _FlashAttnVarlenCore.apply(
        q, k, v, cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k, kw,
        max_seqlen_q, max_seqlen_k, plan, extras)
    if return_attn_probs:
        return out, lse, None
    return out


def flash_attn_varlen_qkvpacked_func(
    qkv: torch.Tensor,  # (total, 3, h, d)
    cu_seqlens: torch.Tensor,
    max_seqlen: Optional[int] = None,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    **kwargs,
):
    """`flash_attn_varlen_func` on q, k, v packed as (total, 3, h, d)."""
    return flash_attn_varlen_func(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens, max_seqlen,
        max_seqlen, dropout_p, softmax_scale, causal, window_size, softcap,
        alibi_slopes, deterministic, return_attn_probs, **kwargs)


def flash_attn_varlen_kvpacked_func(
    q: torch.Tensor,
    kv: torch.Tensor,  # (total_k, 2, hk, d)
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = True,
    return_attn_probs: bool = False,
    **kwargs,
):
    """`flash_attn_varlen_func` on k, v packed as (total_k, 2, hk, d)."""
    return flash_attn_varlen_func(
        q, kv[:, 0], kv[:, 1], cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
        max_seqlen_k, dropout_p, softmax_scale, causal, window_size, softcap,
        alibi_slopes, deterministic, return_attn_probs, **kwargs)


def compile_flash_attn_varlen_func_from_specs(**specs):
    """Not ported: the JAX function compiles an XLA executable ahead of
    time; raises NotImplementedError."""
    raise NotImplementedError(
        "compile_flash_attn_varlen_func_from_specs is not ported yet: ROADMAP "
        "queue 1, item 6 (varlen leftovers)")


def sparse_attn_func(*args, **kwargs):
    """Not ported: vertical-slash sparse attention; raises
    NotImplementedError."""
    raise NotImplementedError(
        "sparse_attn_func is not ported yet: ROADMAP queue 1, item 9 "
        "(vertical-slash sparse)")
