"""Decode attention over a KV cache (counterpart of
flash_attn_tpu/kernels/flash_decode.py).

`flash_attention_decode` keeps the JAX routing (flash_decode.py:337-402): a
fused K|V page pool, and paged split pools whose call the multipage kernel
covers (causal, no leftpad, batch index, ALiBi, sink, chunk or sink
tokens), go to kernel 4 (`kernels.flash_decode_multipage`); everything else
goes to the general decode kernel, kernel 5, through
`flash_attention_decode_general`. On CUDA tensors that launches the
hand-written kernel in `csrc/decode.cu`; on CPU tensors it computes
`flash_attention_decode_ref`, the plain version of the same function, which
is also what the kernel is checked against on the card.

`combine_partials` is the LSE-weighted merge of attention partials, plain
torch as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels.common import check_rows_dense
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage,
)

# Keeps `pos - window_left` inside int32 in the kernel.
_WINDOW_CAP = 1 << 30


def _check_unported(q, k_cache, v_cache, qv, k_scale, v_scale) -> None:
    if qv is not None:
        raise NotImplementedError(
            "qv (MLA absorbed decode) is not ported yet: ROADMAP queue 1, "
            "item 10 (MLA)")
    if k_scale is not None or v_scale is not None or k_cache.element_size() == 1:
        raise NotImplementedError(
            "1-byte caches and k_scale/v_scale descales are not ported yet: "
            "ROADMAP queue 2, kernels 4 and 5 (quantized caches)")
    d = q.shape[-1]
    if d not in (64, 128):
        raise NotImplementedError(
            f"head dim {d}: the general decode kernel takes 64 or 128, ROADMAP "
            "queue 2, kernel 5 (other head dims)")
    if v_cache.shape[-1] != d:
        raise NotImplementedError(
            "a V head dim other than q's is MLA's: ROADMAP queue 1, item 10 "
            "(MLA)")


def flash_attention_decode(
    q: torch.Tensor,        # (b, sq, h, d) new query tokens
    k_cache: torch.Tensor,  # (b, hk, smax, d) or paged (npages, hk, page, d)
    v_cache: Optional[torch.Tensor],
    cache_seqlens: torch.Tensor,  # (b,) int32 TOTAL valid lengths
    *,
    qv: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,  # (b, max_pages) int32
    cache_batch_idx: Optional[torch.Tensor] = None,  # (b,) int32
    cache_leftpad: Optional[torch.Tensor] = None,    # (b,) int32
    alibi_slopes: Optional[torch.Tensor] = None,     # (h,) or (b, h)
    sink: Optional[torch.Tensor] = None,             # (h,)
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    window_left: int = -1,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    softcap: float = 0.0,
    fused_kv_dim: int = 0,
    fused_kv_dim_v: int = 0,
):
    """Decode attention over a KV cache. Returns (out (b, sq, h, d), lse
    (b, h, sq) fp32). Query token i of sq sits at position seqlen - sq + i;
    with causal it attends cache positions <= that."""
    paged = block_table is not None
    multipage_covers = (
        paged and causal and sink is None and alibi_slopes is None
        and cache_leftpad is None and cache_batch_idx is None
        and sink_token_length == 0 and attention_chunk == 0)
    kw = dict(softmax_scale=softmax_scale, window_left=window_left,
              softcap=softcap)
    if fused_kv_dim > 0:
        if not multipage_covers or v_cache is not None:
            raise ValueError(
                "a fused K|V pool is paged, causal, takes v_cache=None and "
                "none of leftpad, batch index, ALiBi, sink, chunk or sink "
                "tokens: allocate split pools for those")
        return flash_attention_decode_multipage(
            q, k_cache, None, cache_seqlens, block_table, qv=qv,
            fused_kv_dim=fused_kv_dim, fused_kv_dim_v=fused_kv_dim_v,
            k_scale=k_scale, v_scale=v_scale, **kw)
    if multipage_covers:
        return flash_attention_decode_multipage(
            q, k_cache, v_cache, cache_seqlens, block_table, qv=qv,
            k_scale=k_scale, v_scale=v_scale, **kw)
    _check_unported(q, k_cache, v_cache, qv, k_scale, v_scale)
    return flash_attention_decode_general(
        q, k_cache, v_cache, cache_seqlens, block_table=block_table,
        cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad,
        alibi_slopes=alibi_slopes, sink=sink, causal=causal,
        attention_chunk=attention_chunk,
        sink_token_length=sink_token_length, **kw)


def flash_attention_decode_general(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_seqlens: torch.Tensor,
    *,
    block_table: Optional[torch.Tensor] = None,
    cache_batch_idx: Optional[torch.Tensor] = None,
    cache_leftpad: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    window_left: int = -1,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5. CUDA tensors launch `csrc/decode.cu` (and count the launch
    in `flash_attention_decode_general.launches`); CPU tensors take
    `flash_attention_decode_ref`."""
    if block_table is not None and cache_batch_idx is not None:
        raise ValueError("cache_batch_idx picks rows of a contiguous cache; "
                         "a paged cache takes none")
    kw = dict(block_table=block_table, cache_batch_idx=cache_batch_idx,
              cache_leftpad=cache_leftpad, alibi_slopes=alibi_slopes,
              sink=sink, softmax_scale=softmax_scale, causal=causal,
              window_left=window_left, attention_chunk=attention_chunk,
              sink_token_length=sink_token_length, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_decode_ref(q, k_cache, v_cache, cache_seqlens,
                                          **kw)
    return _launch(q, k_cache, v_cache, cache_seqlens, **kw)


flash_attention_decode_general.launches = 0


def visible_columns(seqlen, pos, ncols, *, leftpad, causal, window_left,
             attention_chunk, sink_token_length):
    """Bool, broadcastable to (1, sq, ncols): column c visible from query
    position pos (csrc/decode.cu's rule; `pos` (1, sq, 1), `seqlen` and
    `leftpad` scalars)."""
    cols = torch.arange(ncols, device=pos.device).reshape(1, 1, ncols)
    vis = (cols < seqlen) & (cols >= leftpad)
    if causal:
        vis = vis & (cols <= pos)
    if window_left >= 0:
        in_window = cols >= pos - window_left
        if sink_token_length > 0:
            in_window = in_window | (cols < leftpad + sink_token_length)
        vis = vis & in_window
    if attention_chunk > 0:
        ch_lo = pos - torch.remainder(pos - leftpad, attention_chunk)
        vis = vis & (cols >= ch_lo) & (cols < ch_lo + attention_chunk)
    return vis


def flash_attention_decode_ref(
    q: torch.Tensor,        # (b, sq, h, d)
    k_cache: torch.Tensor,  # (B, hk, smax, d) or paged (npages, hk, page, d)
    v_cache: torch.Tensor,
    cache_seqlens: torch.Tensor,  # (b,) total lengths
    *,
    block_table: Optional[torch.Tensor] = None,
    cache_batch_idx: Optional[torch.Tensor] = None,
    cache_leftpad: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    window_left: int = -1,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 5, step by step in fp32, one batch row
    at a time: the row's K/V (its cache row, or its pages through the block
    table; pages outside the pool read as zeros), scores, softcap, ALiBi,
    mask, softmax with the sink in its denominator. Returns (out (b, sq, h,
    dv) in q's dtype, lse (b, h, sq) fp32); a row that sees nothing gives out
    0 and lse -inf, or lse = sink with a sink."""
    b, sq, h, d = q.shape
    hk = k_cache.shape[1]
    group = h // hk
    dv = v_cache.shape[3]
    dev = q.device
    if softmax_scale is None:
        softmax_scale = d**-0.5
    window_left = min(window_left, _WINDOW_CAP)
    seqlens = cache_seqlens.to(dev).long()
    leftpad = (cache_leftpad.to(dev).long() if cache_leftpad is not None
               else torch.zeros(b, dtype=torch.long, device=dev))
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(dev, torch.float32).reshape(-1, h)
    sink_f = None if sink is None else sink.to(dev, torch.float32)
    out = torch.empty(b, sq, h, dv, dtype=q.dtype, device=dev)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    for i in range(b):
        if block_table is not None:
            npages = k_cache.shape[0]
            table = block_table[i].to(dev).long()
            valid = ((table >= 0) & (table < npages))[:, None, None, None]
            ids = table.clamp(0, npages - 1)
            k = (k_cache[ids].float() * valid).permute(1, 0, 2, 3).reshape(
                hk, -1, d)
            v = (v_cache[ids].float() * valid).permute(1, 0, 2, 3).reshape(
                hk, -1, dv)
        else:
            row = i if cache_batch_idx is None else int(cache_batch_idx[i])
            k, v = k_cache[row].float(), v_cache[row].float()
        ncols = k.shape[1]
        qf = q[i].float().reshape(sq, hk, group, d)
        s = torch.einsum("tkgd,kcd->ktgc", qf, k) * softmax_scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        pos = (seqlens[i] - sq + torch.arange(sq, device=dev)).reshape(
            1, sq, 1)
        if slopes is not None:
            sl = slopes[i if slopes.shape[0] > 1 else 0].reshape(
                hk, 1, group, 1)
            cols = torch.arange(ncols, device=dev).reshape(1, 1, ncols)
            rel = (cols - pos).abs().float()[:, :, None]  # (1, sq, 1, ncols)
            s = s - sl * rel
        vis = visible_columns(seqlens[i], pos, ncols, leftpad=leftpad[i],
                       causal=causal, window_left=window_left,
                       attention_chunk=attention_chunk,
                       sink_token_length=sink_token_length)
        s = s.masked_fill(~vis[:, :, None, :], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)  # (hk, sq, group, 1)
        if sink_f is not None:
            sk = sink_f.reshape(hk, 1, group, 1)
            m = torch.where(torch.isfinite(m), torch.maximum(m, sk), sk)
        else:
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)  # exp(-inf) = 0 on masked columns
        l = p.sum(dim=-1, keepdim=True)
        if sink_f is not None:
            l = l + torch.exp(sk - m)
        o = torch.einsum("ktgc,kcd->tkgd", p, v)
        lt = l.permute(1, 0, 2, 3)  # (sq, hk, group, 1)
        o = torch.where(lt > 0, o / lt.clamp_min(1e-37), torch.zeros_like(o))
        out[i] = o.reshape(sq, h, dv).to(q.dtype)
        row_lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)),
                              torch.full_like(l, float("-inf")))
        lse[i] = row_lse[..., 0].permute(0, 2, 1).reshape(h, sq)
    return out, lse


@functools.lru_cache(maxsize=None)
def _kernel():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("decode").decode_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                   + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _int32(name, x, b, dev):
    if x is None:
        return None
    x = x.to(dev, torch.int32).contiguous()
    if x.shape != (b,):
        raise ValueError(f"{name} must be ({b},), got {tuple(x.shape)}")
    return x


def _launch(q, k_cache, v_cache, cache_seqlens, *, block_table,
            cache_batch_idx, cache_leftpad, alibi_slopes, sink, softmax_scale,
            causal, window_left, attention_chunk, sink_token_length, softcap):
    b, sq, h, d = q.shape
    nrows, hk, page, _ = k_cache.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"general decode runs on cuda or cpu, not {dev}")
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the CUDA kernel takes bf16/fp16 q, got {q.dtype}")
    if h % hk != 0:
        raise ValueError(f"{h} query heads do not group over {hk} kv heads")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"k_cache {tuple(k_cache.shape)} and v_cache "
                         f"{tuple(v_cache.shape)} differ")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("q and the caches must share one dtype")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_seqlens", cache_seqlens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    check_rows_dense("k_cache", k_cache)
    check_rows_dense("v_cache", v_cache)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if b == 0 or sq == 0:
        return out, lse
    seqlens = _int32("cache_seqlens", cache_seqlens, b, dev)
    batch_idx = _int32("cache_batch_idx", cache_batch_idx, b, dev)
    leftpad = _int32("cache_leftpad", cache_leftpad, b, dev)
    if block_table is not None:
        table = block_table.to(dev, torch.int32).contiguous()
        if table.dim() != 2 or table.shape[0] != b:
            raise ValueError("block_table must be (b, max_pages)")
        max_pages = table.shape[1]
    else:
        table, max_pages = None, 1  # one "page" per cache row: page = smax
    slopes, slopes_bstride = None, 0
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(dev, torch.float32).contiguous()
        if slopes.shape not in ((h,), (1, h), (b, h)):
            raise ValueError(f"alibi_slopes must be ({h},) or ({b}, {h})")
        if slopes.dim() == 2 and slopes.shape[0] == b and b > 1:
            slopes_bstride = h
    sink_f = None
    if sink is not None:
        sink_f = sink.to(dev, torch.float32).contiguous()
        if sink_f.shape != (h,):
            raise ValueError(f"sink must be ({h},)")
    if softmax_scale is None:
        softmax_scale = d**-0.5
    pool_strides = [t.stride(i) for t in (k_cache, v_cache) for i in range(3)]
    if (page - 1) * max(pool_strides[2], pool_strides[5]) + 8 * d >= 2**31:
        raise ValueError("the kernel's in-page offsets are 32-bit: the "
                         f"caches' slot strides {pool_strides[2::3]} are too "
                         f"large for {page} slots")

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _kernel()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lse.data_ptr(), seqlens.data_ptr(), ptr(table), ptr(batch_idx),
        ptr(leftpad), ptr(slopes), slopes_bstride, ptr(sink_f),
        b, sq, h, hk, d, page, max_pages, nrows,
        (ctypes.c_longlong * 6)(*pool_strides), float(softmax_scale),
        int(bool(causal)), int(min(window_left, _WINDOW_CAP)),
        int(attention_chunk), int(sink_token_length), float(softcap),
        int(q.dtype == torch.float16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode launch failed: CUDA error {rc}")
    flash_attention_decode_general.launches += 1
    return out, lse


def combine_partials(o_parts: torch.Tensor, lse_parts: torch.Tensor):
    """LSE-weighted merge of attention partials (the JAX package's
    `combine_partials`): o_parts (n, ..., d) fp32, each normalised by its own
    softmax sum; lse_parts (n, ...) fp32. Returns (o, lse); a position whose
    every partial is empty (lse -inf) gives o 0 and lse -inf."""
    lse_max = lse_parts.amax(dim=0)
    safe_max = torch.where(torch.isfinite(lse_max), lse_max,
                           torch.zeros_like(lse_max))
    w = torch.exp(lse_parts - safe_max)
    w = torch.where(torch.isfinite(lse_parts), w, torch.zeros_like(w))
    denom = w.sum(dim=0)
    o = (w[..., None] * o_parts).sum(dim=0)
    o = torch.where(denom[..., None] == 0.0, torch.zeros_like(o),
                    o / denom[..., None].clamp_min(1e-37))
    lse = torch.where(denom == 0.0, torch.full_like(denom, float("-inf")),
                      safe_max + torch.log(denom.clamp_min(1e-37)))
    return o, lse
