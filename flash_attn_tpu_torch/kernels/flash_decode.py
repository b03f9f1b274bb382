"""Decode attention over a KV cache (counterpart of
flash_attn_tpu/kernels/flash_decode.py).

`flash_attention_decode` keeps the JAX routing (flash_decode.py:337-402): a
fused K|V page pool, and paged split pools whose call the multipage kernel
covers (causal, no leftpad, batch index, ALiBi, sink, chunk or sink
tokens), go to kernel 4 (`kernels.flash_decode_multipage`); everything else
goes to the general decode kernel, kernel 5, through
`flash_attention_decode_general`. On CUDA tensors that launches the
hand-written kernels in `csrc/decode.cu`; on CPU tensors it computes
`flash_attention_decode_ref`, the plain version of the same function, which
is also what the kernel is checked against on the card.

Calls of at most 64 packed rows (sq * h / hk) whose grid would leave the
card idle run split-KV: `num_splits_for` picks the splits, the kernel cuts
its walk of kv tiles (`walk_tiles`) into them (`walk_ranges`), and a combine
kernel merges the partials with the sink.
`flash_attention_decode_general_split_ref` is the plain version of that
schedule.

Caches hold q's 16-bit type, or one byte (int8 or float8_e4m3fn). A 1-byte
cache takes its dequant scales `k_scale`/`v_scale`, (hk,) or (b, hk): the
kernels read it at half the bytes and upcast it exactly (as kernel 4
does), K's descale folding into the softmax scale and V's into the output
scale.
A 16-bit cache may take descales too (kernel 5 only, as in the JAX
package). Unlike the JAX wrapper, which upcasts a contiguous fp8 cache in
one pass before its kernel (a TPU workaround for a slow convert), every
1-byte cache is dequantized in-kernel here.

`combine_partials` is the LSE-weighted merge of attention partials, plain
torch as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels import mla_attn
from flash_attn_tpu_torch.kernels.common import (
    QUANT_DTYPES,
    check_rows_dense,
    descale_of,
    upcast_quant_tile,
)
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    BLOCKS_PER_SM,
    KV_CODES,
    MIN_SPLIT_TOKENS,
    SPLIT_ROWS,
    SPLIT_TILE,
    check_quant,
    descale_args,
    flash_attention_decode_multipage,
    sm_count,
)
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    num_splits_for as num_splits_mp,
)

# Keeps `pos - window_left` inside int32 in the kernel.
_WINDOW_CAP = 1 << 30


def _check_unported(q, k_cache, v_cache, qv=None, **features) -> None:
    """What kernel 5 does not take yet. Without qv: head dims other than
    64/128 and a V head dim other than q's. With qv (MLA's absorbed decode
    over a latent cache, causal only: the MLA kernel's): any of the
    features in `features` (leftpad, batch index, ALiBi, sink, descales,
    window, chunk, sink tokens, softcap); its (d, dv) pair is checked on
    the card (`mla_attn.check_pair`), since the plain version takes any."""
    d = q.shape[-1]
    if qv is not None:
        used = [name for name, val in features.items()
                if torch.is_tensor(val) or val not in (None, 0, -1)]
        if used:
            raise NotImplementedError(
                f"qv with {', '.join(used)} is not ported yet: ROADMAP "
                "queue 2, kernels 4 and 5 (qv with features)")
        return
    if d not in (64, 128):
        raise NotImplementedError(
            f"head dim {d}: the general decode kernel takes 64 or 128, ROADMAP "
            "queue 2, kernel 5 (other head dims)")
    if v_cache.shape[-1] != d:
        raise NotImplementedError(
            f"a V head dim ({v_cache.shape[-1]}) other than q's ({d}) without "
            "qv: ROADMAP queue 2, kernel 5 (other (d, dv) pairs)")


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
    """Decode attention over a KV cache. Returns (out (b, sq, h, dv), lse
    (b, h, sq) fp32). Query token i of sq sits at position seqlen - sq + i;
    with causal it attends cache positions <= that. `qv` (b, sq, h, dv) is
    MLA's absorbed query over a latent cache (k_cache the rope key,
    v_cache the latent): the scores gain qv . V and the default scale is
    (d + dv)^-0.5."""
    paged = block_table is not None
    quant = check_quant(q, k_cache, qv)
    descaled = k_scale is not None or v_scale is not None
    multipage_covers = (
        paged and causal and sink is None and alibi_slopes is None
        and cache_leftpad is None and cache_batch_idx is None
        and sink_token_length == 0 and attention_chunk == 0
        # descales on a 16-bit cache: kernel 5 only, as in the JAX package
        and (quant or not descaled))
    kw = dict(softmax_scale=softmax_scale, window_left=window_left,
              softcap=softcap)
    if fused_kv_dim > 0:
        if not quant and descaled:
            raise ValueError(
                "k_scale/v_scale are a 1-byte pool's dequant scales; a "
                "16-bit fused pool takes none (fold them into "
                "softmax_scale)")
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
    _check_unported(q, k_cache, v_cache, qv, cache_leftpad=cache_leftpad,
                    cache_batch_idx=cache_batch_idx,
                    alibi_slopes=alibi_slopes, sink=sink, k_scale=k_scale,
                    v_scale=v_scale, window_left=window_left,
                    attention_chunk=attention_chunk,
                    sink_token_length=sink_token_length, softcap=softcap)
    return flash_attention_decode_general(
        q, k_cache, v_cache, cache_seqlens, qv=qv, block_table=block_table,
        cache_batch_idx=cache_batch_idx, cache_leftpad=cache_leftpad,
        alibi_slopes=alibi_slopes, sink=sink, causal=causal,
        attention_chunk=attention_chunk,
        sink_token_length=sink_token_length, k_scale=k_scale,
        v_scale=v_scale, **kw)


def flash_attention_decode_general(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_seqlens: torch.Tensor,
    *,
    qv: Optional[torch.Tensor] = None,
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
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5. CUDA tensors launch `csrc/decode.cu` (`decode_scaled.cu`,
    `decode_int8.cu` or `decode_e4m3.cu` for a cache with descales, int8 or
    e4m3; each launch counted in `flash_attention_decode_general.launches`,
    a split-KV call's combine kernel in `.combine_launches`), or with `qv`
    `csrc/mla_decode.cu` over the latent cache (counted also in
    `.qv_launches`); CPU tensors take `flash_attention_decode_ref`."""
    if block_table is not None and cache_batch_idx is not None:
        raise ValueError("cache_batch_idx picks rows of a contiguous cache; "
                         "a paged cache takes none")
    kw = dict(block_table=block_table, cache_batch_idx=cache_batch_idx,
              cache_leftpad=cache_leftpad, alibi_slopes=alibi_slopes,
              sink=sink, softmax_scale=softmax_scale, causal=causal,
              window_left=window_left, attention_chunk=attention_chunk,
              sink_token_length=sink_token_length, softcap=softcap,
              k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return flash_attention_decode_ref(q, k_cache, v_cache, cache_seqlens,
                                          qv=qv, **kw)
    if qv is not None:
        return _launch_qv(q, qv, k_cache, v_cache, cache_seqlens,
                          block_table, softmax_scale, causal)
    return _launch(q, k_cache, v_cache, cache_seqlens, **kw)


flash_attention_decode_general.launches = 0
flash_attention_decode_general.qv_launches = 0
flash_attention_decode_general.combine_launches = 0


def _launch_qv(q, qv, k_cache, v_cache, cache_seqlens, block_table,
               softmax_scale, causal):
    """Kernel 5's qv path: csrc/mla_decode.cu over contiguous (b, hk, smax,
    .) latent caches (or paged ones), split-KV as kernel 4's qv path for
    calls of at most 16 packed rows."""
    d, dv = q.shape[-1], v_cache.shape[-1]
    if softmax_scale is None:
        softmax_scale = (d + dv) ** -0.5
    if cache_seqlens.device != q.device:
        raise ValueError(f"cache_seqlens is on {cache_seqlens.device}, q on "
                         f"{q.device}")
    table = (None if block_table is None
             else block_table.to(q.device, torch.int32).contiguous())
    b, sq, h, _ = q.shape
    hk, page = k_cache.shape[1], k_cache.shape[2]
    ctx = page * (1 if table is None else table.shape[1])
    n = num_splits_mp(b, hk, sq, h // hk, ctx, -1,
                      sm_count(q.device.index or 0))
    out = mla_attn.decode(q, qv, k_cache, v_cache,
                          cache_seqlens.to(torch.int32), table, n,
                          softmax_scale, causal)
    flash_attention_decode_general.launches += 1
    flash_attention_decode_general.qv_launches += 1
    flash_attention_decode_general.combine_launches += n > 1
    return out

# Calls of at most SPLIT_MAX_ROWS packed rows (one block of csrc/decode.cu)
# may run split-KV: up to SPLIT_ROWS every warp holds all the rows and takes
# a quarter of each tile's keys, above it one warp per 16 rows.
SPLIT_MAX_ROWS = 64


def num_splits_for(batch: int, hk: int, sq: int, group: int, max_cols: int,
                   *, window_left: int, sink_token_length: int,
                   attention_chunk: int, sm_count: int) -> int:
    """How many splits kernel 5 takes, from what the host knows without
    reading the device: the batch, kv heads and packed rows, the longest
    range a row can see (`max_cols`: smax for a contiguous cache, max_pages
    x page for a paged one) cut by the window, the sink tokens and the
    chunk, and the SM count: about BLOCKS_PER_SM blocks per SM, at least
    MIN_SPLIT_TOKENS tokens a split. Calls of more than SPLIT_MAX_ROWS
    packed rows take one."""
    if sq * group > SPLIT_MAX_ROWS:
        return 1
    tokens = max_cols
    if window_left >= 0:
        tokens = min(tokens, window_left + sq + sink_token_length)
    if attention_chunk > 0:
        tokens = min(tokens, attention_chunk + sq)
    want = BLOCKS_PER_SM * sm_count // max(batch * hk, 1)
    return max(1, min(want, tokens // MIN_SPLIT_TOKENS))


def visible_span(pos: int, seqlen: int, leftpad: int, *, causal: bool,
                 window_left: int, attention_chunk: int,
                 sink_token_length: int) -> Tuple[int, int, int, int]:
    """The columns the row at position pos sees, as csrc/decode.cu's
    `visible_span` computes them: [lo1, hi1) (the window's) and [lo2, hi2)
    (the sink tokens', empty without them)."""
    lo = leftpad
    hi = min(seqlen, pos + 1) if causal else seqlen
    if attention_chunk > 0:
        ch_lo = pos - (pos - leftpad) % attention_chunk  # floor modulo
        lo, hi = max(lo, ch_lo), min(hi, ch_lo + attention_chunk)
    lo1 = max(lo, pos - window_left) if window_left >= 0 else lo
    hi2 = (min(hi, leftpad + sink_token_length)
           if window_left >= 0 and sink_token_length > 0 else lo)
    return lo1, hi, lo, hi2


def walk_tiles(seqlen: int, leftpad: int, sq: int, **mask) -> list:
    """The kv tiles (of SPLIT_TILE tokens) the split kernel walks for one
    batch row's sq query tokens, in order (csrc/decode.cu's `walk_of` from
    the first and the last token's spans): the sink tokens' tiles, then the
    window's that are not among them, never the gap between them. `mask`:
    visible_span's keyword arguments."""
    lo1, _, lo2, _ = visible_span(seqlen - sq, seqlen, leftpad, **mask)
    _, hi1, _, hi2 = visible_span(seqlen - 1, seqlen, leftpad, **mask)
    t = SPLIT_TILE
    sink = range(lo2 // t, -(-hi2 // t)) if hi2 > lo2 else range(0)
    win_lo = lo1 // t
    win_hi = -(-hi1 // t) if hi1 > lo1 else win_lo
    if len(sink):
        win_lo = max(win_lo, sink.stop)
    return list(sink) + list(range(win_lo, win_hi))


def walk_ranges(seqlen: int, leftpad: int, sq: int, num_splits: int,
                **mask) -> list:
    """The column range [lo, hi) of each split for one batch row, as the
    kernel cuts its walk: split s takes items [s n / S, (s + 1) n / S) of
    the n tiles of `walk_tiles`, from its first tile's start to its last
    tile's end (the gap between the sink tokens' tiles and the window's
    holds no visible column). An empty split has lo == hi == 0."""
    tiles = walk_tiles(seqlen, leftpad, sq, **mask)
    n = len(tiles)
    ranges = []
    for s in range(num_splits):
        a, z = s * n // num_splits, (s + 1) * n // num_splits
        ranges.append((tiles[a] * SPLIT_TILE, (tiles[z - 1] + 1) * SPLIT_TILE)
                      if z > a else (0, 0))
    return ranges


def flash_attention_decode_general_split_ref(
    q, k_cache, v_cache, cache_seqlens, num_splits: int, *,
    ranges: Optional[list] = None, **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 5's split-KV schedule: each split's chunk
    (`walk_ranges` per batch row, or `ranges[b][s]` given) through
    `flash_attention_decode_ref` restricted to it, without the sink, in
    fp32; then `combine_partials` over the partials and the sink, which
    joins the merge once as a partial whose output is 0 and whose LSE is
    the sink. Returns (out in q's dtype, lse). Reads cache_seqlens and
    cache_leftpad on the host."""
    b, sq, h, d = q.shape
    sink = kw.pop("sink", None)
    if ranges is None:
        mask = dict(causal=kw.get("causal", True),
                    window_left=min(kw.get("window_left", -1), _WINDOW_CAP),
                    attention_chunk=kw.get("attention_chunk", 0),
                    sink_token_length=kw.get("sink_token_length", 0))
        lp = kw.get("cache_leftpad")
        lp = [0] * b if lp is None else lp.tolist()
        ranges = [walk_ranges(int(n), lp[i], sq, num_splits, **mask)
                  for i, n in enumerate(cache_seqlens.tolist())]
    o_parts, lse_parts = [], []
    for s in range(num_splits):
        lo, hi = (torch.tensor([r[s][i] for r in ranges], device=q.device)
                  for i in (0, 1))
        o, lse = flash_attention_decode_ref(
            q, k_cache, v_cache, cache_seqlens, col_range=(lo, hi),
            out_dtype=torch.float32, **kw)
        o_parts.append(o)
        lse_parts.append(lse.permute(0, 2, 1))  # (b, sq, h), as o's rows
    if sink is not None:
        sink_f = sink.to(q.device, torch.float32)
        o_parts.append(torch.zeros_like(o_parts[0]))
        lse_parts.append(sink_f.expand(b, sq, h))
    o, lse = combine_partials(torch.stack(o_parts), torch.stack(lse_parts))
    return o.to(q.dtype), lse.permute(0, 2, 1)


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
    qv: Optional[torch.Tensor] = None,
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
    col_range: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    out_dtype: Optional[torch.dtype] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 5, step by step in fp32, one batch row
    at a time: the row's K/V (its cache row, or its pages through the block
    table; pages outside the pool read as zeros; a 1-byte cache upcast
    exactly), scores (times K's descale), softcap, ALiBi, mask, softmax with
    the sink in its denominator, output (times V's descale). Returns (out
    (b, sq, h, dv) in `out_dtype` or q's dtype, lse (b, h, sq) fp32); a row
    that sees nothing gives out 0 and lse -inf, or lse = sink with a sink.
    `col_range` = (lo, hi), (b,) each, keeps only columns lo <= c < hi of
    each batch row (one split's chunk). `qv` (b, sq, h, dv) adds qv . V to
    the scores (MLA's absorbed query; V, the latent, is also the P V
    operand), and the default scale is then (d + dv)^-0.5."""
    b, sq, h, d = q.shape
    hk = k_cache.shape[1]
    group = h // hk
    dv = v_cache.shape[3]
    dev = q.device
    if softmax_scale is None:
        softmax_scale = (d + dv)**-0.5 if qv is not None else d**-0.5
    window_left = min(window_left, _WINDOW_CAP)
    seqlens = cache_seqlens.to(dev).long()
    leftpad = (cache_leftpad.to(dev).long() if cache_leftpad is not None
               else torch.zeros(b, dtype=torch.long, device=dev))
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(dev, torch.float32).reshape(-1, h)
    sink_f = None if sink is None else sink.to(dev, torch.float32)
    kd = descale_of(k_scale, b, hk, dev)  # (b, hk); ones when None
    vd = descale_of(v_scale, b, hk, dev)
    up = upcast_quant_tile
    out = torch.empty(b, sq, h, dv, dtype=out_dtype or q.dtype, device=dev)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    for i in range(b):
        if block_table is not None:
            npages = k_cache.shape[0]
            table = block_table[i].to(dev).long()
            valid = ((table >= 0) & (table < npages))[:, None, None, None]
            ids = table.clamp(0, npages - 1)
            k = (up(k_cache[ids]).float() * valid).permute(1, 0, 2, 3).reshape(
                hk, -1, d)
            v = (up(v_cache[ids]).float() * valid).permute(1, 0, 2, 3).reshape(
                hk, -1, dv)
        else:
            row = i if cache_batch_idx is None else int(cache_batch_idx[i])
            k, v = up(k_cache[row]).float(), up(v_cache[row]).float()
        ncols = k.shape[1]
        qf = q[i].float().reshape(sq, hk, group, d)
        s = torch.einsum("tkgd,kcd->ktgc", qf, k)
        if qv is not None:
            qvf = qv[i].float().reshape(sq, hk, group, dv)
            s = s + torch.einsum("tkge,kce->ktgc", qvf, v)
        s = s * (softmax_scale * kd[i]).reshape(hk, 1, 1, 1)
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
        if col_range is not None:
            cols = torch.arange(ncols, device=dev)
            vis = vis & ((cols >= col_range[0][i]) & (cols < col_range[1][i]))
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
        o = torch.einsum("ktgc,kcd->tkgd", p, v) * vd[i].reshape(1, hk, 1, 1)
        lt = l.permute(1, 0, 2, 3)  # (sq, hk, group, 1)
        o = torch.where(lt > 0, o / lt.clamp_min(1e-37), torch.zeros_like(o))
        out[i] = o.reshape(sq, h, dv).to(out.dtype)
        row_lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-37)),
                              torch.full_like(l, float("-inf")))
        lse[i] = row_lse[..., 0].permute(0, 2, 1).reshape(h, sq)
    return out, lse


# The source of each cache kind (KV_CODES' code, descales given): each
# builds its own instantiations of csrc/decode_kernel.cuh.
SOURCES = {(0, False): "decode", (0, True): "decode_scaled",
           (1, True): "decode_int8", (2, True): "decode_e4m3"}


@functools.lru_cache(maxsize=None)
def _kernels(source: str = "decode") -> ctypes.CDLL:
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library(source)
    args = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 8
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int]
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
    lib.decode_fwd.argtypes = args + [ctypes.c_void_p]
    lib.decode_split_fwd.argtypes = args + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.decode_fwd, lib.decode_split_fwd):
        fn.restype = ctypes.c_int
    return lib


def _int32(name, x, b, dev):
    if x is None:
        return None
    x = x.to(dev, torch.int32).contiguous()
    if x.shape != (b,):
        raise ValueError(f"{name} must be ({b},), got {tuple(x.shape)}")
    return x


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(q, k_cache, v_cache, cache_seqlens, num_splits, *, block_table,
         cache_batch_idx, cache_leftpad, alibi_slopes, sink, softmax_scale,
         causal, window_left, attention_chunk, sink_token_length, softcap,
         k_scale=None, v_scale=None):
    """Launches kernel 5 once and returns (out, lse): the split-KV kernel
    for calls of at most SPLIT_ROWS packed rows or more than one split
    (with more, its combine kernel in the same C call), else the kernel
    that tiles the rows."""
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
    if v_cache.dtype != k_cache.dtype or (k_cache.dtype != q.dtype and
                                          k_cache.dtype not in QUANT_DTYPES):
        raise ValueError("the caches hold q's dtype, or both int8 or both "
                         "float8_e4m3fn")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_seqlens", cache_seqlens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    check_rows_dense("k_cache", k_cache)
    check_rows_dense("v_cache", v_cache)
    split = num_splits > 1 or sq * (h // hk) <= SPLIT_ROWS
    if split and sq * (h // hk) > SPLIT_MAX_ROWS:
        raise ValueError(f"{sq * (h // hk)} packed rows are more than the "
                         f"split kernel's {SPLIT_MAX_ROWS}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if b == 0 or sq == 0:
        return out, lse
    parts = (None, None)
    if num_splits > 1:
        # o_part (n, b, sq, h, d) and lse_part (n, b, h, sq), fp32, in one
        # allocation (one allocation less on a call the host bounds).
        rows = num_splits * b * sq * h
        work = torch.empty(rows * (d + 1), dtype=torch.float32, device=dev)
        parts = (work.data_ptr(), work.data_ptr() + rows * d * 4)
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
    args = (
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lse.data_ptr(), seqlens.data_ptr(), _ptr(table), _ptr(batch_idx),
        _ptr(leftpad), _ptr(slopes), slopes_bstride, _ptr(sink_f),
        b, sq, h, hk, d, page, max_pages, nrows,
        (ctypes.c_longlong * 6)(*pool_strides), float(softmax_scale),
        int(bool(causal)), int(min(window_left, _WINDOW_CAP)),
        int(attention_chunk), int(sink_token_length), float(softcap),
        int(q.dtype == torch.float16))
    kv_code = KV_CODES.get(k_cache.dtype, 0)
    scaled = kv_code > 0 or k_scale is not None or v_scale is not None
    if scaled:  # kd and vd stay alive through the launch
        kd, vd, bstride = descale_args(k_scale, v_scale, b, hk, dev)
        args += (kv_code, kd.data_ptr(), vd.data_ptr(), bstride)
    else:
        args += (kv_code, None, None, 0)
    # The raw stream without torch.cuda.current_stream's Python wrapping,
    # which costs an eager decode step several microseconds.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    lib = _kernels(SOURCES[kv_code, scaled])
    if split:
        rc = lib.decode_split_fwd(*args, *parts, int(num_splits), stream)
    else:
        rc = lib.decode_fwd(*args, stream)
    if rc != 0:
        raise RuntimeError(f"decode launch failed: CUDA error {rc}")
    flash_attention_decode_general.launches += 1
    flash_attention_decode_general.combine_launches += num_splits > 1
    return out, lse


def splits_of(q, k_cache, block_table, *, window_left, attention_chunk,
              sink_token_length) -> int:
    """`num_splits_for` at this call's shapes and card."""
    b, sq, h, _ = q.shape
    hk, page = k_cache.shape[1], k_cache.shape[2]
    pages = 1 if block_table is None else block_table.shape[1]
    return num_splits_for(
        b, hk, sq, h // hk, page * pages,
        window_left=min(window_left, _WINDOW_CAP),
        sink_token_length=sink_token_length, attention_chunk=attention_chunk,
        sm_count=sm_count(q.device.index or 0))


def _launch(q, k_cache, v_cache, cache_seqlens, **kw):
    n = 1 if q.numel() == 0 else splits_of(
        q, k_cache, kw["block_table"], window_left=kw["window_left"],
        attention_chunk=kw["attention_chunk"],
        sink_token_length=kw["sink_token_length"])
    return _run(q, k_cache, v_cache, cache_seqlens, n, **kw)


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
