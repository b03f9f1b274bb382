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
`sparse_attn_func` runs vertical-slash sparse attention through
`kernels.flash_sparse` (kernels 12-15) with `_SparseAttnCore`. With
`block_sparse_tensors=` (a `compute_block_sparsity` plan), `flash_attn_func`
and `flash_attn_varlen_func` run `mask_mod` attention block-sparsely through
`kernels.block_sparsity` (kernels 9-11) with `_BlockSparseCore`.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels.block_sparsity import (
    as_plan,
    check_score_mod,
    flash_attention_blocksparse_bwd,
    flash_attention_blocksparse_fwd,
    prepare_lists,
    varlen_key,
    varlen_lengths,
    wrap_varlen_mask_mod,
)
from flash_attn_tpu_torch.kernels._build import build_libraries
from flash_attn_tpu_torch.kernels.common import rows_dense, seed_int
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_decode import (
    combine_partials,
    flash_attention_decode,
)
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
from flash_attn_tpu_torch.kernels.flash_sparse import (
    check_metadata as check_sparse_metadata,
)
from flash_attn_tpu_torch.kernels.flash_sparse import (
    check_unported as check_sparse_unported,
)
from flash_attn_tpu_torch.kernels.flash_sparse import (
    flash_attention_sparse_bwd,
    flash_attention_sparse_fwd,
    plan_sparse,
    sparse_route,
)
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
from flash_attn_tpu_torch.utils.device import resolve_device
from flash_attn_tpu_torch.utils.fa_logging import get_logger

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


class _BlockSparseCore(torch.autograd.Function):
    """out, lse = block-sparse attention(q, k, v) in (b, h, s, d) over a
    plan: kernel 9 forward, kernels 11 and 10 backward (plain versions on
    the CPU). On the card the execution lists are looked up once (cached
    per plan, mod, aux and shape; `key` names a varlen call's own objects)
    and the backward reuses them. As in `_FlashAttnCore`, the LSE's
    cotangent is ignored and no copy of out is kept."""

    @staticmethod
    def forward(ctx, q, k, v, plan, kw, key):
        q, k, v = (rows_dense(x) for x in (q, k, v))
        lists = prepare_lists(q, k, v, plan, mask_mod=kw["mask_mod"],
                              aux_tensors=kw["aux_tensors"],
                              aux_scalars=kw["aux_scalars"], key=key)
        out, lse = flash_attention_blocksparse_fwd(q, k, v, plan, lists=lists,
                                                   **kw)
        ctx.save_for_backward(q, k, v, lse)
        ctx.plan, ctx.kw, ctx.lists = plan, kw, lists
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_blocksparse_bwd(
            q, k, v, lse, rows_dense(dout), ctx.plan, lists=ctx.lists,
            **ctx.kw)
        return dq, dk, dv, None, None, None


def _blocksparse_kw(mask_mod, aux_tensors, aux_scalars, softmax_scale,
                    softcap):
    return dict(mask_mod=mask_mod, aux_tensors=tuple(aux_tensors or ()),
                aux_scalars=tuple(aux_scalars or ()),
                softmax_scale=softmax_scale, softcap=float(softcap))


# Arguments of `flash_attention_fwd` that its backward takes too.
_BWD_FEATURES = ("alibi_slopes", "q_segment_ids", "kv_segment_ids",
                 "attention_chunk", "sink_token_length", "dropout_p",
                 "dropout_seed")


class _FlashAttnCore(torch.autograd.Function):
    """out, lse = attention(q, k, v) in (b, h, s, d); the backward takes dO
    only (the LSE's cotangent is ignored, as in the JAX package) and needs
    no copy of out (see kernels.flash_bwd on delta), except for the
    learnable sink's gradient. The sink (h,) is an input of its own so that
    its gradient flows: as the JAX vjp does (XLA glue there, plain torch
    here), dsink_h = -sum_{b,r} delta exp(sink_h - lse) with delta =
    rowsum(dO * O), 0 on rows whose lse is not finite."""

    @staticmethod
    def forward(ctx, q, k, v, sink, softmax_scale, causal, window_size,
                softcap, extras):
        kw = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap)
        q, k, v = (rows_dense(x) for x in (q, k, v))
        out, lse = flash_attention_fwd(q, k, v, **kw, sink=sink, **extras)
        sink_grad = sink is not None and ctx.needs_input_grad[3]
        ctx.save_for_backward(q, k, v, lse, sink if sink_grad else None,
                              out if sink_grad else None)
        ctx.kw = dict(kw, sink=sink,
                      **{name: extras[name] for name in _BWD_FEATURES
                         if name in extras})
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, lse, sink, out = ctx.saved_tensors
        dout = rows_dense(dout)
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, dout, **ctx.kw)
        dsink = None
        if sink is not None:
            delta = (dout.float() * out.float()).sum(-1)
            w = torch.exp(sink.float()[None, :, None] - lse)
            w = torch.where(torch.isfinite(lse), w, torch.zeros_like(w))
            dsink = -(delta * w).sum((0, 2)).to(sink.dtype)
        return dq, dk, dv, dsink, None, None, None, None, None


class _FlashAttnQvCore(torch.autograd.Function):
    """out, lse = attention(q, k, v) with MLA's absorbed query qv, in (b,
    h, s, d): kernel 1's qv forward, then kernels 3 and 2's qv backward
    (`csrc/flash_fwd_qv.cu` and `csrc/mla_bwd.cu` on the card), which
    return dq, dk, dv (with dS^T Qv) and dqv. As in `_FlashAttnCore`, the
    LSE's cotangent is ignored and no copy of out is kept."""

    @staticmethod
    def forward(ctx, q, k, v, qv, softmax_scale, causal, window_size,
                softcap, extras):
        q, k, v, qv = (rows_dense(x) for x in (q, k, v, qv))
        kw = dict(softmax_scale=softmax_scale, causal=causal,
                  window_size=window_size, softcap=softcap)
        out, lse = flash_attention_fwd(q, k, v, qv=qv, **kw, **extras)
        ctx.save_for_backward(q, k, v, qv, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, qv, lse = ctx.saved_tensors
        dq, dk, dv, dqv = flash_attention_bwd(q, k, v, lse, rows_dense(dout),
                                              qv=qv, **ctx.kw)
        return dq, dk, dv, dqv, None, None, None, None, None


def _gathered_probs(s, mask, scale, softcap):
    """Softmax over the gathered keys (last dim) of raw scores s, scaled or
    softcapped, masked; a row with no key gives 0."""
    s = (torch.tanh(s * (scale / softcap)) * softcap if softcap > 0.0
         else s * scale)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))


def _topk_gather_attention(q, k, v, qv, indices, *, softmax_scale=None,
                           causal=False, softcap=0.0):
    """Top-k gathered attention (the JAX package's `_topk_gather_attention`,
    XLA there, plain torch here; autograd gives its backward): query row i
    of q (b, sq, h, d) attends only the keys indices[b, i] (b, sq, topk),
    negative or out-of-range entries masked, with causal also keys past the
    row's bottom-right diagonal; qv (b, sq, h, dv) adds qv . v to the
    scores. Returns out (b, sq, h, dv) in q's dtype; a row with no key gives
    0."""
    b, sq, h, d = q.shape
    sk, hk, dv = v.shape[1], v.shape[2], v.shape[3]
    group = h // hk
    if softmax_scale is None:
        softmax_scale = (d + dv) ** -0.5 if qv is not None else d ** -0.5
    idx = indices.to(device=q.device, dtype=torch.int64)
    valid = (idx >= 0) & (idx < sk)
    safe = idx.clamp(0, sk - 1)  # (b, sq, t)
    rows = torch.arange(b, device=q.device)[:, None, None]
    kg = k[rows, safe].float()  # (b, sq, t, hk, d)
    vg = v[rows, safe].float()
    qg = q.reshape(b, sq, hk, group, d).float()
    s = torch.einsum("bsngd,bstnd->bsngt", qg, kg)
    if qv is not None:
        qvg = qv.reshape(b, sq, hk, group, dv).float()
        s = s + torch.einsum("bsnge,bstne->bsngt", qvg, vg)
    mask = valid[:, :, None, None, :]
    if causal:
        diag = (torch.arange(sq, device=q.device) + (sk - sq))[None, :, None]
        mask = mask & (safe <= diag)[:, :, None, None, :]
    p = _gathered_probs(s, mask, softmax_scale, softcap)
    out = torch.einsum("bsngt,bstne->bsnge", p, vg)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _topk_gather_attention_varlen(q, k, v, qv, indices, cu_q, cu_k, *,
                                  softmax_scale=None, causal=False,
                                  softcap=0.0):
    """Varlen top-k gathered attention (the JAX package's
    `_topk_gather_attention_varlen`, plain torch): indices (total_q, topk)
    are key positions relative to each row's own sequence, negative or
    past its keys masked, with causal also past the sequence's bottom-right
    diagonal. Returns out (total_q, h, dv) in q's dtype."""
    tq, h, d = q.shape
    tk, hk, dv = v.shape
    group = h // hk
    if softmax_scale is None:
        softmax_scale = (d + dv) ** -0.5 if qv is not None else d ** -0.5
    cu_q = cu_q.to(device=q.device, dtype=torch.int64)
    cu_k = cu_k.to(device=q.device, dtype=torch.int64)
    nseq = cu_q.shape[0] - 1
    rows = torch.arange(tq, device=q.device)
    qseg = (torch.searchsorted(cu_q, rows, right=True) - 1).clamp(0, nseq - 1)
    qpos = rows - cu_q[qseg]
    klen = cu_k[qseg + 1] - cu_k[qseg]
    qlen = cu_q[qseg + 1] - cu_q[qseg]
    idx = indices.to(device=q.device, dtype=torch.int64)  # (tq, t)
    valid = (idx >= 0) & (idx < klen[:, None])
    if causal:
        valid = valid & (idx <= (qpos + klen - qlen)[:, None])
    safe = (idx.clamp(0, tk - 1) + cu_k[qseg][:, None]).clamp(0, tk - 1)
    kg = k[safe].float()  # (tq, t, hk, d)
    vg = v[safe].float()
    qg = q.reshape(tq, hk, group, d).float()
    s = torch.einsum("qngd,qtnd->qngt", qg, kg)
    if qv is not None:
        qvg = qv.reshape(tq, hk, group, dv).float()
        s = s + torch.einsum("qnge,qtne->qngt", qvg, vg)
    p = _gathered_probs(s, valid[:, None, None, :], softmax_scale, softcap)
    out = torch.einsum("qngt,qtne->qnge", p, vg)
    return out.reshape(tq, h, dv).to(q.dtype)


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

    With `block_sparse_tensors` (a plan of `compute_block_sparsity`) the
    call runs `mask_mod` (with aux_tensors/aux_scalars) block-sparsely
    through kernels 9-11; it composes with softcap only, as in the JAX
    package (causal, windows and the other features raise ValueError), and
    a score_mod raises NotImplementedError.

    ALiBi slopes (h,) or (b, h), the learnable `sink` (h,) with its
    gradient, segment ids (b, sq) and (b, sk), attention_chunk,
    sink_token_length and dropout run in kernels 1-3 on the card.
    Dropout's mask is the JAX package's murmur3 hash of (dropout_seed,
    batch row, query head, row, column): the same seed gives the same bits
    in both packages; `dropout_seed` is an int or a scalar tensor (a CUDA
    one is read back), 0 when None, as in the JAX package.
    `gather_kv_indices` (b, sq, topk) runs top-k gathered attention in
    plain torch, as the JAX package runs it in XLA. `qv` (b, sq, h, dv) is
    MLA's absorbed query (v (b, sk, hk, dv) is the latent): the scores
    gain qv . v and the default scale is (d + dv)^-0.5; on the card it runs
    kernel 1's qv forward and kernels 2-3's qv backward (d 64, dv 512).

    `deterministic` and `bias_grad` are taken so that calls written for
    the JAX API run unchanged, and nothing reads them: the backward is
    always deterministic, and a bias raises."""
    del deterministic, bias_grad
    if gather_kv_indices is not None:
        if layout == "bhsd":
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
            qv = None if qv is None else qv.transpose(1, 2)
        out = _topk_gather_attention(q, k, v, qv, gather_kv_indices,
                                     softmax_scale=softmax_scale,
                                     causal=causal, softcap=softcap)
        if layout == "bhsd":
            out = out.transpose(1, 2)
        return (out, None, None) if return_attn_probs else out
    if layout == "bshd":
        q_, k_, v_ = (x.transpose(1, 2) for x in (q, k, v))
    elif layout == "bhsd":
        q_, k_, v_ = q, k, v
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if block_sparse_tensors is not None:
        bad = [name for name, val in (
            ("attn_bias", attn_bias), ("alibi_slopes", alibi_slopes),
            ("sink", sink), ("q_segment_ids", q_segment_ids), ("qv", qv),
            ("q_descale", q_descale), ("k_descale", k_descale),
            ("v_descale", v_descale)) if val is not None]
        if (causal or tuple(window_size) != (-1, -1) or attention_chunk
                or sink_token_length or dropout_p > 0.0 or bad):
            raise ValueError(
                "block_sparse_tensors composes with mask_mod/score_mod/"
                "softcap only — express causality/windows inside the "
                f"mask_mod (got causal={causal}, window={window_size}, "
                f"chunk={attention_chunk}, dropout={dropout_p}, "
                f"extras={bad})")
        check_score_mod(score_mod)
        out, lse = _BlockSparseCore.apply(
            q_, k_, v_, as_plan(block_sparse_tensors),
            _blocksparse_kw(mask_mod, aux_tensors, aux_scalars, softmax_scale,
                            softcap), None)
    else:
        extras = dict(
            bias=attn_bias, alibi_slopes=alibi_slopes,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            q_descale=q_descale, k_descale=k_descale, v_descale=v_descale,
            attention_chunk=attention_chunk,
            sink_token_length=sink_token_length, dropout_p=dropout_p,
            dropout_seed=seed_int(dropout_seed) if dropout_p > 0 else None,
            score_mod=score_mod, mask_mod=mask_mod, aux_tensors=aux_tensors,
            aux_scalars=aux_scalars,
        )
        args = (softmax_scale, bool(causal),
                tuple(int(w) for w in window_size), float(softcap))
        if qv is not None:
            if sink is not None:
                extras["sink"] = sink
            qv_ = qv.transpose(1, 2) if layout == "bshd" else qv
            out, lse = _FlashAttnQvCore.apply(q_, k_, v_, qv_, *args, extras)
        else:
            out, lse = _FlashAttnCore.apply(q_, k_, v_, sink, *args, extras)
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
    A 1-byte (int8 / float8_e4m3fn) cache takes its dequant scales
    `k_scale`/`v_scale`, (hk,) or (b, hk), and appended k/v are cast to its
    dtype (as the JAX function writes them; the engine quantizes with
    `runtime.kv_cache.quantize_to_cache_dtype`).
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


# The varlen features the backward kernels take again (the forward's seed:
# the backward regenerates the forward's keep mask from it).
_VARLEN_BWD_FEATURES = ("alibi_slopes", "attention_chunk", "dropout_p",
                        "dropout_seed")


class _FlashAttnVarlenCore(torch.autograd.Function):
    """out, lse = varlen attention(q, k, v); like `_FlashAttnCore`, the
    backward takes dO only (the LSE's cotangent is ignored, as in the JAX
    package) and needs no copy of out. ALiBi, attention_chunk and dropout
    go to both directions' kernels; dropout's seed is a host int, so the
    backward draws the forward's keep mask."""

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
        ctx.kw = dict(kw, **{name: extras[name]
                             for name in _VARLEN_BWD_FEATURES})
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
    softcap, seqused_q/k, ALiBi slopes (h,), attention_chunk and dropout
    (kernels 6-8's feature instances on the card). Dropout's keep mask is
    the JAX package's murmur3 hash of (dropout_seed, batch row 0, query
    head, packed row, packed key): the same seed gives the same bits in
    both packages; `dropout_seed` is an int or a scalar tensor (a CUDA one
    is read back), 0 when None, as in the JAX package. Returns out in q's
    layout; with return_attn_probs=True, (out, softmax_lse (h, total_q)
    fp32, None).

    The backward's CUDA grids are sized by max_seqlen_q/k: the caller's,
    else the plan's (`make_varlen_plan`), else one host read of cu_seqlens;
    the forward's comes from the shapes alone.

    With `block_sparse_tensors` (from `compute_block_sparsity_varlen`) the
    call runs `mask_mod` block-sparsely (`_varlen_blocksparse`); it
    composes with softcap and seqused_q/k only, as in the JAX package.
    `deterministic`, `block_q` and `block_kv` are taken for calls written
    for the JAX API and not read: the backward is always deterministic and
    the CUDA tiles are fixed."""
    del deterministic, block_q, block_kv
    if layout not in ("thd", "hsd"):
        raise ValueError(f"unknown varlen layout {layout!r}")
    if layout == "hsd" and (block_sparse_tensors is not None
                            or gather_kv_indices is not None):
        raise ValueError(
            "layout='hsd' is not supported with block_sparse_tensors/"
            "gather_kv_indices (those routes consume packed (total, h, d))")
    if block_sparse_tensors is not None:
        bad = [name for name, val in (
            ("attn_bias", attn_bias), ("alibi_slopes", alibi_slopes),
            ("qv", qv), ("gather_kv_indices", gather_kv_indices))
            if val is not None]
        if (causal or tuple(window_size) != (-1, -1) or attention_chunk
                or dropout_p > 0.0 or bad):
            raise ValueError(
                "varlen block_sparse_tensors composes with mask_mod/"
                "score_mod/softcap only — express causality inside the "
                f"mask_mod (got causal={causal}, extras={bad})")
        check_score_mod(score_mod)
        out, lse = _varlen_blocksparse(
            q, k, v, cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k,
            as_plan(block_sparse_tensors),
            _blocksparse_kw(mask_mod, aux_tensors, aux_scalars, softmax_scale,
                            softcap))
        return (out, lse, None) if return_attn_probs else out
    if gather_kv_indices is not None:
        out = _topk_gather_attention_varlen(
            q, k, v, qv, gather_kv_indices, cu_seqlens_q, cu_seqlens_k,
            softmax_scale=softmax_scale, causal=causal, softcap=softcap)
        return (out, None, None) if return_attn_probs else out
    if q.device.type != "cpu":
        max_seqlen_q, max_seqlen_k = resolve_max_seqlens(
            cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k, plan)
    kw = dict(softmax_scale=softmax_scale, causal=bool(causal),
              window_size=tuple(int(w) for w in window_size),
              softcap=float(softcap), layout=layout)
    extras = dict(qv=qv, alibi_slopes=alibi_slopes, dropout_p=dropout_p,
                  dropout_seed=(seed_int(dropout_seed) if dropout_p > 0
                                else None),
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


def _varlen_blocksparse(q, k, v, cu_seqlens_q, cu_seqlens_k, seqused_q,
                        seqused_k, plan, kw):
    """Varlen block-sparse attention (the JAX package's
    `_varlen_blocksparse`): the packed (total, h, d) tensors are unpacked
    by device gathers into a left-aligned (nseq, s, h, d) layout, s the
    plan's recorded seqlen (else its tiles' span); the mod is wrapped with
    each sequence's lengths (seqused_q/k applied) and run through
    `_BlockSparseCore`; out is repacked to (total_q, h, d) and the lse to
    (h, total_q), rows past a sequence's used length at out 0, lse -inf.
    No host read: the lengths stay on the device, and the execution lists
    are cached per the caller's own mod, aux and length tensors."""
    tm, tn = plan.block_size
    idx_shape = tuple(plan.mask_block_idx.shape)
    sq = plan.seqlen_q if plan.seqlen_q is not None else idx_shape[2] * tm
    sk = plan.seqlen_k if plan.seqlen_k is not None else idx_shape[3] * tn
    dev = q.device
    total_q, h, _ = q.shape
    nseq = cu_seqlens_q.shape[0] - 1
    lq, lk = varlen_lengths(cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k,
                            dev)

    def unpack(x, cu, smax):
        src = (cu.to(device=dev, dtype=torch.int64)[:-1, None]
               + torch.arange(smax, device=dev)[None])
        rows = x[src.clamp(0, max(x.shape[0] - 1, 0)).reshape(-1)]
        return rows.reshape(nseq, smax, *x.shape[1:]).transpose(1, 2), src

    qp, src = unpack(q, cu_seqlens_q, sq)
    kp, _ = unpack(k, cu_seqlens_k, sk)
    vp, _ = unpack(v, cu_seqlens_k, sk)
    user_aux, scalars = kw["aux_tensors"], kw["aux_scalars"]
    key = varlen_key(kw["mask_mod"], user_aux, scalars, cu_seqlens_q,
                     cu_seqlens_k, seqused_q, seqused_k)
    kw = dict(kw, mask_mod=wrap_varlen_mask_mod(
        kw["mask_mod"], len(user_aux), bool(user_aux or scalars)),
              aux_tensors=user_aux + (lq, lk))
    out_p, lse_p = _BlockSparseCore.apply(qp, kp, vp, plan, kw, key)
    valid = torch.arange(sq, device=dev)[None] < lq[:, None]
    dst = torch.where(valid, src, total_q).reshape(-1)
    flat_out = out_p.transpose(1, 2).reshape(nseq * sq, h, -1)
    out = torch.zeros((total_q + 1, h, flat_out.shape[-1]), dtype=q.dtype,
                      device=dev).index_copy(0, dst, flat_out)[:total_q]
    flat_lse = lse_p.transpose(1, 2).reshape(nseq * sq, h)
    lse = torch.full((total_q + 1, h), float("-inf"), device=dev).index_copy(
        0, dst, flat_lse)[:total_q].T
    return out, lse


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


def compile_flash_attn_varlen_func_from_specs(
    *,
    total_q: int,
    total_k: int,
    nseq: int,
    num_heads: int,
    num_heads_kv: Optional[int] = None,
    head_dim: int,
    head_dim_v: Optional[int] = None,
    has_qv: bool = False,
    dtype=torch.bfloat16,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    block_q: int = 256,
    block_kv: int = 256,
    device=None,
):
    """The JAX package's `compile_flash_attn_varlen_func_from_specs`
    (flash_attn_interface.py:1277): pays the compilation before traffic
    arrives and returns the callable `(q, k, v, cu_seqlens_q,
    cu_seqlens_k[, qv]) -> out` for these static specs. On the card
    (`device`, the card by default) it builds kernels 6-8's CUDA sources
    now (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`), so that the first call
    compiles nothing; on the CPU there is nothing to build. The callable
    runs `flash_attn_varlen_func` with the specs (differentiable, as that
    is) and refuses tensors of other shapes, dtypes or devices, as the
    JAX executable does. `has_qv` raises NotImplementedError, as `qv`
    does; specs the CUDA kernels do not take (a head dim other than 64 or
    128, head_dim_v != head_dim, a dtype other than bf16/fp16, heads that
    do not group) raise ValueError on the card. `block_q`/`block_kv` are
    the JAX tiles, taken and not read."""
    del block_q, block_kv
    check_varlen_unported(qv=True if has_qv else None)
    dev = resolve_device(device)
    hk = num_heads_kv or num_heads
    dv = head_dim_v or head_dim
    if dev.type == "cuda":
        if dtype not in (torch.bfloat16, torch.float16):
            raise ValueError(f"the CUDA kernels take bf16/fp16, got {dtype}")
        if head_dim not in (64, 128) or dv != head_dim:
            raise ValueError(f"the CUDA kernels take head dim 64 or 128 for "
                             f"q, k and v alike, got {head_dim} / {dv}")
        if num_heads % hk:
            raise ValueError(f"{num_heads} query heads do not group over "
                             f"{hk} kv heads")
        build_libraries(["flash_fwd", "flash_bwd"])
    want = dict(q=(total_q, num_heads, head_dim), k=(total_k, hk, head_dim),
                v=(total_k, hk, dv), cu_seqlens_q=(nseq + 1,),
                cu_seqlens_k=(nseq + 1,))
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap)

    def fn(q, k, v, cu_seqlens_q, cu_seqlens_k, qv=None):
        for name, t in zip(want, (q, k, v, cu_seqlens_q, cu_seqlens_k)):
            typed = name in ("q", "k", "v")
            if (tuple(t.shape) != want[name] or t.device.type != dev.type
                    or (typed and t.dtype != dtype)):
                raise ValueError(
                    f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                    f"compiled for {tuple(want[name])}"
                    + (f" {dtype}" if typed else "") + f" on {dev}")
        return flash_attn_varlen_func(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                      qv=qv, **kw)

    return fn


class _SparseAttnCore(torch.autograd.Function):
    """out, lse = vertical-slash sparse attention(q, k, v) in (b, h, s, d):
    the forward through `kernels.flash_sparse.flash_attention_sparse_fwd`
    (kernel 12 or 15), the backward through kernels 14 and 13. As in
    `_FlashAttnCore`, the LSE's cotangent is ignored and no copy of out is
    kept. On the card, when a gradient is wanted and the forward takes
    kernel 12, its plan (with its word table) is kept for the backward; on
    kernel 15's route the backward builds that plan itself, so no forward
    pays for a planner it does not use."""

    @staticmethod
    def forward(ctx, q, k, v, block_count, block_offset, column_count,
                column_index, alibi_slopes, seqlens_q, seqlens_k, kw):
        q, k, v = (rows_dense(x) for x in (q, k, v))
        meta = (block_count, block_offset, column_count, column_index)
        plan = None
        if (q.device.type != "cpu" and any(ctx.needs_input_grad[:3])
                and sparse_route(block_offset.shape[-1],
                                 column_index.shape[-1], k.shape[2])
                == "tiles"):
            check_sparse_metadata(q, *meta)
            plan = plan_sparse(
                *meta, seqlen_q=q.shape[2], seqlen_k=k.shape[2],
                causal=kw["causal"], seqlens_q=seqlens_q, seqlens_k=seqlens_k,
                keep_table=True)
        out, lse = flash_attention_sparse_fwd(
            q, k, v, *meta, alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
            seqlens_k=seqlens_k, plan=plan, **kw)
        ctx.save_for_backward(q, k, v, lse, *meta, alibi_slopes, seqlens_q,
                              seqlens_k)
        ctx.kw = kw
        ctx.plan = plan
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, lse, *meta, alibi, lens_q, lens_k = ctx.saved_tensors
        dq, dk, dv = flash_attention_sparse_bwd(
            q, k, v, lse, rows_dense(dout), *meta, alibi_slopes=alibi,
            seqlens_q=lens_q, seqlens_k=lens_k, plan=ctx.plan, **ctx.kw)
        return (dq, dk, dv) + (None,) * 8


def sparse_attn_func(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, hk, d)
    v: torch.Tensor,
    block_count: torch.Tensor,   # (b, h, cdiv(sq, 64)) int32
    block_offset: torch.Tensor,  # (b, h, nqb, NNZ_S) int32
    column_count: torch.Tensor,  # (b, h, nqb) int32
    column_index: torch.Tensor,  # (b, h, nqb, NNZ_V) int32
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,  # (h,) or (b, h) fp32
    deterministic: bool = False,
    return_attn_probs: bool = False,
    *,
    return_softmax_lse: bool = False,
    seqlens_q: Optional[torch.Tensor] = None,  # (b,) per-row lengths
    seqlens_k: Optional[torch.Tensor] = None,
    dropout_seed: Optional[torch.Tensor] = None,
    layout: str = "bshd",
):
    """Vertical-slash (MInference) sparse attention, as the JAX package's
    `sparse_attn_func` (flash_attn_interface.py:1119), differentiable in q,
    k and v. The metadata's meaning is `kernels.flash_sparse`'s: per 64-row
    query block, the union of slash ranges [off, off + 64) (unaligned
    offsets taken as they are) and vertical columns. With seqlens_q/k each
    batch row is a left-aligned sequence of its own lengths (rows past
    seqlens_q come out 0, lse -inf). Returns out in q's layout ["bshd" or
    "bhsd"], and the lse (b, h, sq) fp32 with return_softmax_lse.

    `deterministic`, `return_attn_probs` and `dropout_seed` are taken for
    calls written for the JAX API and not read: the backward is always
    deterministic, and dropout raises."""
    del deterministic, return_attn_probs, dropout_seed
    check_sparse_unported(dropout_p=dropout_p)
    if get_logger().isEnabledFor(logging.INFO):
        # The crossover advisory reads the counts on the host: only when
        # dispatch logging is on.
        from flash_attn_tpu_torch.utils.sparse_crossover import (
            metadata_density,
            warn_if_slow,
        )

        s_axis = 1 if layout == "bshd" else 2
        warn_if_slow(k.shape[s_axis], metadata_density(
            block_count, column_count, q.shape[s_axis], k.shape[s_axis]))
    if layout == "bshd":
        q_, k_, v_ = (x.transpose(1, 2) for x in (q, k, v))
    elif layout == "bhsd":
        q_, k_, v_ = q, k, v
    else:
        raise ValueError(f"unknown layout {layout!r}")
    kw = dict(softmax_scale=softmax_scale, causal=bool(causal),
              softcap=float(softcap))
    out, lse = _SparseAttnCore.apply(
        q_, k_, v_, block_count, block_offset, column_count, column_index,
        alibi_slopes, seqlens_q, seqlens_k, kw)
    if layout == "bshd":
        out = out.transpose(1, 2)
    return (out, lse) if return_softmax_lse else out
