"""Paged decode over small pages (counterpart of
flash_attn_tpu/kernels/flash_decode_multipage.py).

`flash_attention_decode_multipage` attends new query tokens to a paged KV
pool: decode steps (sq = 1) and chunked-prefill steps alike. On CUDA tensors
it launches the hand-written kernel in `csrc/paged_decode.cu`; on CPU
tensors it computes `flash_attention_decode_multipage_ref`, the plain
version of the same function, which is also what the kernel is checked
against on the card.

Pools are (npages, hk, page, d), or one fused pool (npages, hk, page,
Kpad + Vpad) with K at [:d] and V at [Kpad:Kpad + dv] (Kpad = d rounded up
to 128, as `runtime.kv_cache.allocate_fused_paged_kv_cache` lays it out).
The kernel reads pools through their strides, so a view such as vLLM's
(num_blocks, page, hk, d) pool transposed to (num_blocks, hk, page, d) goes
in without a copy.

Pools hold q's 16-bit type, or one byte (int8 or float8_e4m3fn) with
per-kv-head dequant scales `k_scale`/`v_scale` of shape (hk,) or (b, hk):
x = x_q * scale. The kernel copies the 1-byte tiles as they are and
upcasts them exactly (the split-KV kernel fragment by fragment in
registers, the rows kernel tile by tile in shared memory); K's descale
folds into the softmax scale and V's into the output scale, as the JAX
kernel does. The JAX wrapper takes (hk,)
descales only; (b, hk) is what vLLM passes (one scale per layer, expanded
over its sequences), and is held to the exact oracle (ROADMAP §3).

Decode steps (sq * group <= 16 packed rows) run split-KV: `num_splits_for`
picks the number of splits on the host, from shapes alone (no read of
cache_seqlens, so a vLLM layer call stays free of host syncs); the kernel
cuts each row's visible range as `split_ranges` does, writes fp32 partials
into one workspace, and a second kernel merges them as `combine_partials`
does, both launched by one C call on the raw stream. The wrapper reads
nothing on the device and allocates only on the caching allocator, so a
step that calls it can be captured in a CUDA graph.
`flash_attention_decode_multipage_split_ref` is the plain version of that
schedule, split by split.
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
    round_up,
    upcast_quant_tile,
)

_LANES = 128  # section padding of the fused K|V pool (runtime/kv_cache.py)


def _fused_split(k_pages, fused_kv_dim, fused_kv_dim_v):
    """(K view, V view, dv) of a fused K|V pool."""
    kpad = round_up(fused_kv_dim, _LANES)
    dv = fused_kv_dim_v if fused_kv_dim_v else k_pages.shape[3] - kpad
    if k_pages.shape[3] != kpad + round_up(dv, _LANES):
        raise ValueError(
            f"fused pool width {k_pages.shape[3]} does not hold K ({fused_kv_dim}) "
            f"and V ({dv}) padded to {_LANES}"
        )
    return k_pages[..., :fused_kv_dim], k_pages[..., kpad : kpad + dv], dv


def check_quant(q, k_pages, qv=None) -> bool:
    """Whether the pool is 1-byte (int8 / e4m3); raises on what the kernels
    do not take: 1-byte queries, another 1-byte type, and qv (MLA) over a
    1-byte pool (ValueError, as both the JAX kernels and engine refuse
    it: the latent is the V operand and stays 16-bit)."""
    if q.element_size() == 1:
        raise NotImplementedError(
            "1-byte (fp8) queries are not ported yet: ROADMAP queue 2, "
            "kernels 1 and 6 (fp8 queries and descales)")
    quant = k_pages.element_size() == 1
    if quant and k_pages.dtype not in QUANT_DTYPES:
        raise ValueError(f"a 1-byte pool holds int8 or float8_e4m3fn, not "
                         f"{k_pages.dtype}")
    if quant and qv is not None:
        raise ValueError("qv (MLA absorbed scores) is not supported with a "
                         "1-byte (int8/fp8) cache: the latent is V")
    return quant


def check_qv_features(qv, window_left: int, softcap: float) -> None:
    """qv calls on the MLA kernels are causal, with no window and no
    softcap; raises NotImplementedError on the others, on the CPU as on
    the card."""
    if qv is not None and (window_left >= 0 or softcap > 0.0):
        raise NotImplementedError(
            "qv with a window or a softcap is not ported yet: ROADMAP queue "
            "2, kernels 4 and 5 (qv with features)")


def _check_descales(quant, k_scale, v_scale):
    if not quant and (k_scale is not None or v_scale is not None):
        raise ValueError(
            "k_scale/v_scale are the dequant scales of a 1-byte pool; a "
            "16-bit pool takes none here (the general decode kernel takes "
            "them)")


def flash_attention_decode_multipage_ref(
    q: torch.Tensor,          # (b, sq, h, d)
    k_pages: torch.Tensor,    # (npages, hk, page, d), or fused (.., Kpad+Vpad)
    v_pages: Optional[torch.Tensor],
    cache_seqlens: torch.Tensor,  # (b,) total lengths, new tokens included
    block_table: torch.Tensor,    # (b, max_pages) int32
    *,
    qv: Optional[torch.Tensor] = None,
    fused_kv_dim: int = 0,
    fused_kv_dim_v: int = 0,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
    softcap: float = 0.0,
    col_range: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    out_dtype: Optional[torch.dtype] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step by step in fp32: gather the
    pages through the block table (a 1-byte pool upcast exactly), scores
    (times K's descale), mask, softmax, output (times V's descale). Returns
    (out (b, sq, h, dv) in `out_dtype` (default q's), lse (b, h, sq) fp32).
    `col_range`, two (b,) tensors (lo, hi), keeps only columns lo <= c < hi
    of each batch row visible (one split's chunk). `qv` (b, sq, h, dv), MLA's
    absorbed query, adds qv . V to the scores (V, the latent, is also the
    P V operand), and the default scale is then (d + dv)^-0.5."""
    b, sq, h, d = q.shape
    npages, hk, page, _ = k_pages.shape
    group = h // hk
    kd = descale_of(k_scale, b, hk, q.device)  # (b, hk); ones when None
    vd = descale_of(v_scale, b, hk, q.device)
    if fused_kv_dim > 0:
        k_pool, v_pool, dv = _fused_split(k_pages, fused_kv_dim, fused_kv_dim_v)
    else:
        k_pool, v_pool, dv = k_pages, v_pages, v_pages.shape[3]
    if softmax_scale is None:
        softmax_scale = (d + dv)**-0.5 if qv is not None else d**-0.5
    table = block_table.long()
    # Page ids outside the pool read as zeros, as in the kernel.
    valid = (table >= 0) & (table < npages)
    ids = table.clamp(0, npages - 1)

    def gather(pool, width):
        x = upcast_quant_tile(pool[ids]).float() * valid[:, :, None, None, None]
        # (b, max_pages, hk, page, w) -> (b, hk, max_pages * page, w)
        return x.permute(0, 2, 1, 3, 4).reshape(b, hk, -1, width)

    k = gather(k_pool, d)
    v = gather(v_pool, dv)
    ncols = k.shape[2]
    qf = q.float().reshape(b, sq, hk, group, d)
    s = torch.einsum("btkgd,bkcd->bktgc", qf, k)
    if qv is not None:
        qvf = qv.float().reshape(b, sq, hk, group, dv)
        s = s + torch.einsum("btkge,bkce->bktgc", qvf, v)
    s = s * (softmax_scale * kd).reshape(b, hk, 1, 1, 1)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    seqlen = cache_seqlens.long().reshape(b, 1, 1)
    pos = seqlen - sq + torch.arange(sq, device=q.device).reshape(1, sq, 1)
    cols = torch.arange(ncols, device=q.device).reshape(1, 1, ncols)
    visible = (cols < seqlen) & (cols <= pos)
    if window_left >= 0:
        visible &= cols >= pos - window_left
    if col_range is not None:
        lo, hi = (x.long().reshape(b, 1, 1) for x in col_range)
        visible &= (cols >= lo) & (cols < hi)
    visible = visible[:, None, :, None, :]  # (b, 1, sq, 1, ncols)
    s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # exp(-inf) = 0 on masked columns
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bktgc,bkcd->btkgd", p, v) * vd.reshape(b, 1, hk, 1, 1)
    out = out / l.permute(0, 2, 1, 3, 4).clamp_min(1e-37)
    out = torch.where(
        l.permute(0, 2, 1, 3, 4) > 0, out, torch.zeros_like(out)
    ).reshape(b, sq, h, dv)
    lse = torch.where(
        l > 0, m + torch.log(l.clamp_min(1e-37)),
        torch.full_like(l, float("-inf")),
    )  # (b, hk, sq, group, 1)
    lse = lse[..., 0].permute(0, 1, 3, 2).reshape(b, h, sq)
    return out.to(out_dtype or q.dtype), lse


# The split-KV schedule of csrc/paged_decode.cu: calls with at most
# SPLIT_ROWS packed rows (sq * group) run split-KV, over visible ranges cut
# into SPLIT_TILE-token tiles; the host asks for BLOCKS_PER_SM blocks per
# SM and at least MIN_SPLIT_TOKENS tokens a split.
SPLIT_ROWS = 16
SPLIT_TILE = 64
BLOCKS_PER_SM = 2
MIN_SPLIT_TOKENS = 256


def num_splits_for(batch: int, hk: int, sq: int, group: int, max_ctx: int,
                   window_left: int, sm_count: int) -> int:
    """How many splits a call takes, from what the host knows without
    reading the device: the batch, kv heads and packed rows, the longest
    context the block table can hold (`max_ctx`), the window and the SM
    count. Prefill chunks (more than SPLIT_ROWS packed rows) take one."""
    if sq * group > SPLIT_ROWS:
        return 1
    tokens = max_ctx if window_left < 0 else min(max_ctx, window_left + sq)
    want = BLOCKS_PER_SM * sm_count // max(batch * hk, 1)
    return max(1, min(want, tokens // MIN_SPLIT_TOKENS))


def split_ranges(seqlen: int, sq: int, window_left: int,
                 num_splits: int) -> list:
    """The column chunk [lo, hi) of each split for one batch row, as the
    kernel cuts it: the visible range of the row's sq query tokens (from the
    window's first visible column, not from 0) in SPLIT_TILE-token tiles,
    split s taking tiles [s n / S, (s + 1) n / S) of the n. An empty chunk
    has lo == hi."""
    lo = max(seqlen - sq - window_left, 0) if window_left >= 0 else 0
    hi = seqlen
    tile_lo = lo // SPLIT_TILE
    n = -(-(hi - tile_lo * SPLIT_TILE) // SPLIT_TILE) if hi > lo else 0
    ranges = []
    for s in range(num_splits):
        a = (tile_lo + s * n // num_splits) * SPLIT_TILE
        z = (tile_lo + (s + 1) * n // num_splits) * SPLIT_TILE
        start = max(lo, a)
        ranges.append((start, max(start, min(hi, z))))
    return ranges


def flash_attention_decode_multipage_split_ref(
    q, k_pages, v_pages, cache_seqlens, block_table, num_splits: int, *,
    ranges: Optional[list] = None, **kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the split-KV schedule: each split's chunk
    (`split_ranges` per batch row, or `ranges[b][s]` given) through
    `flash_attention_decode_multipage_ref` in fp32, then
    `combine_partials`. Returns (out in q's dtype, lse). Reads
    cache_seqlens on the host."""
    from flash_attn_tpu_torch.kernels.flash_decode import combine_partials

    b, sq = q.shape[:2]
    if ranges is None:
        ranges = [split_ranges(int(n), sq, kw.get("window_left", -1),
                               num_splits) for n in cache_seqlens.tolist()]
    o_parts, lse_parts = [], []
    for s in range(num_splits):
        lo, hi = (torch.tensor([r[s][i] for r in ranges], device=q.device)
                  for i in (0, 1))
        o, lse = flash_attention_decode_multipage_ref(
            q, k_pages, v_pages, cache_seqlens, block_table,
            col_range=(lo, hi), out_dtype=torch.float32, **kw)
        o_parts.append(o)
        lse_parts.append(lse.permute(0, 2, 1))  # (b, sq, h), as o's rows
    o, lse = combine_partials(torch.stack(o_parts), torch.stack(lse_parts))
    return o.to(q.dtype), lse.permute(0, 2, 1)


def flash_attention_decode_multipage(
    q: torch.Tensor,          # (b, sq, h, d)
    k_pages: torch.Tensor,    # (npages, hk, page, d), or fused (.., Kpad+Vpad)
    v_pages: Optional[torch.Tensor],
    cache_seqlens: torch.Tensor,  # (b,) int32 total lengths
    block_table: torch.Tensor,    # (b, max_pages) int32
    *,
    qv: Optional[torch.Tensor] = None,
    fused_kv_dim: int = 0,
    fused_kv_dim_v: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window_left: int = -1,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged decode. Returns (out (b, sq, h, dv), lse (b, h, sq) fp32).
    A 1-byte pool takes its descales `k_scale`/`v_scale`, (hk,) or (b, hk)
    fp32 (1 where None). `qv` (b, sq, h, dv) is MLA's absorbed query over
    a latent pool (rope key K, latent V; fused, or split pools of unequal
    widths): the scores gain qv . V, and the default scale is
    (d + dv)^-0.5.

    CUDA tensors launch `csrc/paged_decode.cu`, or with qv
    `csrc/mla_decode.cu` (and count the launch in
    `flash_attention_decode_multipage.launches`, a qv launch also in
    `.qv_launches`; a split-KV call's combine in `.combine_launches`); CPU
    tensors take `flash_attention_decode_multipage_ref`."""
    _check_descales(check_quant(q, k_pages, qv), k_scale, v_scale)
    check_qv_features(qv, window_left, softcap)
    kw = dict(fused_kv_dim=fused_kv_dim, fused_kv_dim_v=fused_kv_dim_v,
              softmax_scale=softmax_scale, window_left=window_left,
              softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return flash_attention_decode_multipage_ref(
            q, k_pages, v_pages, cache_seqlens, block_table, qv=qv, **kw
        )
    if qv is not None:
        return _launch_qv(q, qv, k_pages, v_pages, cache_seqlens, block_table,
                          fused_kv_dim, fused_kv_dim_v, softmax_scale)
    return _launch(q, k_pages, v_pages, cache_seqlens, block_table, **kw)


flash_attention_decode_multipage.launches = 0
flash_attention_decode_multipage.qv_launches = 0
flash_attention_decode_multipage.combine_launches = 0


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library("paged_decode")
    args = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    for fn in (lib.paged_decode_fwd, lib.paged_decode_fwd_merged):
        fn.restype = ctypes.c_int
        fn.argtypes = args
    lib.paged_decode_combine.restype = ctypes.c_int
    lib.paged_decode_combine.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's SM count, queried once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(q, k_pages, v_pages, cache_seqlens, block_table, fused_kv_dim,
           fused_kv_dim_v):
    """The kernel's input checks; returns (K view, V view)."""
    b, sq, h, d = q.shape
    npages, hk, page, width = k_pages.shape
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the CUDA kernel takes bf16/fp16 q, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"the CUDA kernel takes head dim 64 or 128, got {d}")
    if h % hk != 0:
        raise ValueError(f"{h} query heads do not group over {hk} kv heads")
    if fused_kv_dim > 0:
        if v_pages is not None or fused_kv_dim != d:
            raise ValueError("a fused pool takes v_pages=None and "
                             "fused_kv_dim == head dim")
        k_view, v_view, dv = _fused_split(k_pages, fused_kv_dim,
                                          fused_kv_dim_v)
    else:
        if v_pages is None or v_pages.shape != k_pages.shape or width != d:
            raise ValueError(
                f"split pools must both be (npages, hk, page, {d}); got "
                f"{tuple(k_pages.shape)} and "
                f"{None if v_pages is None else tuple(v_pages.shape)}"
            )
        k_view, v_view, dv = k_pages, v_pages, d
    if dv != d:
        raise ValueError(f"the CUDA kernel takes dv == d, got {dv} and {d}")
    tensors = dict(q=q, k_pages=k_view, v_pool=v_view,
                   cache_seqlens=cache_seqlens, block_table=block_table)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name in ("q", "cache_seqlens", "block_table"):
        if not tensors[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_rows_dense("k_pages", k_view)
    check_rows_dense("v_pages", v_view)
    if v_view.dtype != k_pages.dtype or (k_pages.dtype != q.dtype
                                        and k_pages.dtype not in QUANT_DTYPES):
        raise ValueError("the pools hold q's dtype, or both int8 or both "
                         "float8_e4m3fn")
    if cache_seqlens.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise ValueError("cache_seqlens and block_table must be int32")
    if cache_seqlens.shape != (b,) or block_table.shape[0] != b:
        raise ValueError("cache_seqlens is (b,) and block_table (b, max_pages)")
    pool_strides = [t.stride(i) for t in (k_view, v_view) for i in range(3)]
    if (page - 1) * max(pool_strides[2], pool_strides[5]) + 8 * d >= 2**31:
        raise ValueError("the kernel's in-page offsets are 32-bit: the pools' "
                         f"slot strides {pool_strides[2::3]} are too large "
                         f"for page {page}")
    return k_view, v_view


# The C entries' codes of the pool's element kinds: q's own type, int8 and
# e4m3 (csrc/decode_tile.cuh KvKind).
KV_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}


def descale_args(k_scale, v_scale, b, hk, dev):
    """The kernels' descale arguments: (k, v, bstride), fp32 contiguous on
    `dev`, both (hk,) with bstride 0 when neither varies over the batch,
    else both (b, hk) with bstride hk; None is 1."""
    def flat(x):
        return (torch.ones(hk, dtype=torch.float32, device=dev) if x is None
                else x.to(dev, torch.float32))

    # One scale per kv head expanded over the batch (vLLM's (nseq, hk) of
    # a per-layer scale, a stride-0 view) is (hk,) as it is.
    ks, vs = (x[0] if x.dim() == 2 and x.stride(0) == 0 else x
              for x in (flat(k_scale), flat(v_scale)))
    if ks.numel() == hk and vs.numel() == hk:
        return ks.reshape(hk).contiguous(), vs.reshape(hk).contiguous(), 0
    return (descale_of(ks, b, hk, dev).contiguous(),
            descale_of(vs, b, hk, dev).contiguous(), hk)


def _run(q, k_pages, v_pages, cache_seqlens, block_table, num_splits, *,
         merge=False, fused_kv_dim=0, fused_kv_dim_v=0, softmax_scale=None,
         window_left=-1, softcap=0.0, k_scale=None, v_scale=None):
    """Launches kernel 4 once. One split, or `merge`: returns (out, lse),
    the partials of more splits merged by the combine kernel in the same C
    call (`paged_decode_fwd_merged`). More splits without `merge`: returns
    the fp32 partials (o_part (n, b, sq, h, d), lse_part (n, b, h, sq)),
    views of one workspace."""
    b, sq, h, d = q.shape
    npages, hk, page, _ = k_pages.shape
    dev = q.device
    k_view, v_view = _check(q, k_pages, v_pages, cache_seqlens, block_table,
                            fused_kv_dim, fused_kv_dim_v)
    kv_code = KV_CODES.get(k_pages.dtype, 0)
    kd = vd = None  # the descales, kept alive through the launch
    kptr = vptr = None
    bstride = 0
    if kv_code:
        kd, vd, bstride = descale_args(k_scale, v_scale, b, hk, dev)
        kptr, vptr = kd.data_ptr(), vd.data_ptr()
    if softmax_scale is None:
        softmax_scale = d**-0.5
    parts, work = (None, None), None
    rows = num_splits * b * sq * h
    if num_splits > 1:
        # o_part and lse_part, fp32, in one allocation.
        work = torch.empty(rows * (d + 1), dtype=torch.float32, device=dev)
        parts = (work.data_ptr(), work.data_ptr() + rows * d * 4)
    out = lse = None
    if num_splits == 1 or merge:
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    pool_strides = [t.stride(i) for t in (k_view, v_view) for i in range(3)]
    lib = _kernels()
    entry = lib.paged_decode_fwd_merged if merge else lib.paged_decode_fwd
    rc = entry(
        q.data_ptr(), k_view.data_ptr(), v_view.data_ptr(), _ptr(out),
        _ptr(lse), cache_seqlens.data_ptr(), block_table.data_ptr(),
        b, sq, h, hk, d, page, block_table.shape[1], npages,
        (ctypes.c_longlong * 6)(*pool_strides), float(softmax_scale),
        int(window_left), float(softcap), int(q.dtype == torch.float16),
        *parts, int(num_splits), kv_code, kptr, vptr, bstride,
        # The raw stream without torch.cuda.current_stream's Python
        # wrapping, which costs an eager decode step several microseconds.
        torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {rc}")
    flash_attention_decode_multipage.launches += 1
    if out is not None:
        flash_attention_decode_multipage.combine_launches += num_splits > 1
        return out, lse
    return (work[:rows * d].view(num_splits, b, sq, h, d),
            work[rows * d:].view(num_splits, b, h, sq))


def _ptr(t):
    return None if t is None else t.data_ptr()


def combine_splits(o_part: torch.Tensor, lse_part: torch.Tensor,
                   dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4's combine on the card: merges o_part (n, b, sq, h, d) and
    lse_part (n, b, h, sq), fp32, in split order into (out (b, sq, h, d) in
    `dtype`, lse (b, h, sq)), as `combine_partials` does; counted in
    `flash_attention_decode_multipage.combine_launches`."""
    n, b, sq, h, d = o_part.shape
    if lse_part.shape != (n, b, h, sq):
        raise ValueError(f"lse_part {tuple(lse_part.shape)} does not match "
                         f"o_part {tuple(o_part.shape)}")
    o_part, lse_part = o_part.contiguous(), lse_part.contiguous()
    out = torch.empty((b, sq, h, d), dtype=dtype, device=o_part.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=o_part.device)
    rc = _kernels().paged_decode_combine(
        o_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(), lse.data_ptr(),
        n, b, sq, h, d, int(dtype == torch.float16),
        torch._C._cuda_getCurrentRawStream(o_part.device.index))
    if rc != 0:
        raise RuntimeError(f"paged_decode combine failed: CUDA error {rc}")
    flash_attention_decode_multipage.combine_launches += 1
    return out, lse


def splits_of(q, k_pages, block_table, window_left) -> int:
    """`num_splits_for` at this call's shapes and card."""
    b, sq, h, _ = q.shape
    hk, page = k_pages.shape[1], k_pages.shape[2]
    return num_splits_for(b, hk, sq, h // hk, block_table.shape[1] * page,
                          window_left, sm_count(q.device.index or 0))


def latent_views(k_pages, v_pages, fused_kv_dim, fused_kv_dim_v):
    """(rope view, latent view) of a fused rope|latent pool, or of split
    pools (which may differ in width)."""
    if fused_kv_dim > 0:
        if v_pages is not None:
            raise ValueError("a fused pool takes v_pages=None")
        k_view, v_view, _ = _fused_split(k_pages, fused_kv_dim,
                                         fused_kv_dim_v)
        return k_view, v_view
    if v_pages is None or v_pages.shape[:3] != k_pages.shape[:3]:
        raise ValueError(
            f"split pools must both be (npages, hk, page, .); got "
            f"{tuple(k_pages.shape)} and "
            f"{None if v_pages is None else tuple(v_pages.shape)}")
    return k_pages, v_pages


def _launch_qv(q, qv, k_pages, v_pages, cache_seqlens, block_table,
               fused_kv_dim, fused_kv_dim_v, softmax_scale):
    """Kernel 4's qv path: csrc/mla_decode.cu over a latent pool, split-KV
    for decode steps as `num_splits_for` says, one split for prefill
    chunks."""
    k_view, v_view = latent_views(k_pages, v_pages, fused_kv_dim,
                                  fused_kv_dim_v)
    d, dv = q.shape[-1], v_view.shape[-1]
    if softmax_scale is None:
        softmax_scale = (d + dv) ** -0.5
    for name, t in (("cache_seqlens", cache_seqlens),
                    ("block_table", block_table)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    n = splits_of(q, k_view, block_table, -1)
    out = mla_attn.decode(q, qv, k_view, v_view, cache_seqlens, block_table,
                          n, softmax_scale)
    flash_attention_decode_multipage.launches += 1
    flash_attention_decode_multipage.qv_launches += 1
    flash_attention_decode_multipage.combine_launches += n > 1
    return out


def _launch(q, k_pages, v_pages, cache_seqlens, block_table, **kw):
    n = splits_of(q, k_pages, block_table, kw["window_left"])
    return _run(q, k_pages, v_pages, cache_seqlens, block_table, n,
                merge=True, **kw)
