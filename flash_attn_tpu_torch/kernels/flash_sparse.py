"""Vertical-slash (MInference) sparse attention, forward and backward
(counterpart of flash_attn_tpu/kernels/flash_sparse.py).

Metadata, per (batch row b, query head h, 64-row query block m), int32:

  * block_count (b, h, nqb) and block_offset (b, h, nqb, NNZ_S): "slash"
    ranges of key columns [off, off + 64), the first block_count entries;
  * column_count (b, h, nqb) and column_index (b, h, nqb, NNZ_V): single
    "vertical" key columns, the first column_count entries.

nqb = cdiv(sq, 64). The rows of block m attend the UNION of those columns
that lie in [0, seqlen_k): an overlap or a repeated column counts once,
entries past a count are ignored, and an unaligned offset attends exactly
[off, off + 64), as MInference's kernel and vLLM's converter mean it. (The
JAX package rounds an unaligned offset down to its 64-column block,
flash_sparse.py:87-93 and flash_sparse_gather.py:70; the port does not.)
On top of that the dense rules: query row i sees column j only if
i < len_q and j < len_k (per batch row from `seqlens_q`/`seqlens_k`, else
sq/sk) and, with causal, j <= i + len_k - len_q. ALiBi subtracts
slope * |j - i - (len_k - len_q)| after the softcap.

The planner (`plan_sparse`, torch ops on the device, no host read, no
shape that depends on values) turns the metadata into each block's
ascending list of 64-wide key tiles that hold an attended column, with one
64-bit membership word per tile, after dropping columns that no row of the
block can see. Kernels, each with a `.launches` count and a plain PyTorch
version that the wrapper takes for CPU tensors:

  * `flash_attention_sparse_tiles_fwd` (kernel 12, `csrc/flash_sparse_fwd.cu`
    over `csrc/flash_fwd_tile.cuh`): walks the tile lists;
  * `flash_attention_sparse_gather_fwd` (kernel 15, in
    `kernels/flash_sparse_gather.py`): the same function over compact
    column lists;
  * `flash_attention_sparse_bwd_dq` (kernel 14, `csrc/flash_sparse_bwd.cu`):
    dQ and delta = sum_j P dP over the forward's lists;
  * `flash_attention_sparse_bwd_dkv` (kernel 13): dK/dV per 64-key tile over
    the inverse lists (`plan_inverse`), the GQA group summed in-kernel.

The plain versions build the dense membership mask from the metadata
itself (not from the planner), a few query blocks at a time, so they run at
32k keys. `flash_attention_sparse_fwd` picks the forward route
(`sparse_route`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels.common import cdiv, raise_unported
from flash_attn_tpu_torch.kernels.flash_fwd import (
    _scale,
    check_kernel_inputs,
    check_shapes,
    strides_arg,
)

META_BLOCK = 64  # the reference's BLOCK_M = BLOCK_N (flash_api_sparse.cpp)

# Arguments of the JAX sparse signature the port does not take yet:
# name -> (value that means "not used", ROADMAP item).
_UNPORTED = {
    "dropout_p": (0.0, "queue 2, kernels 1-3 / 12-14: murmur3 dropout"),
}


def check_unported(**extras) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for an argument
    the port does not take yet."""
    raise_unported(_UNPORTED, extras)


def check_metadata(q, block_count, block_offset, column_count,
                   column_index) -> None:
    """Refuse metadata of the wrong shape, type or device: counts (b, h,
    cdiv(sq, 64)) and lists (b, h, cdiv(sq, 64), NNZ), int32, on q's device.
    An NNZ of 0 is legal."""
    b, h, sq = q.shape[:3]
    want = (b, h, cdiv(sq, META_BLOCK))
    for name, t, ndim in (("block_count", block_count, 3),
                          ("block_offset", block_offset, 4),
                          ("column_count", column_count, 3),
                          ("column_index", column_index, 4)):
        if (not isinstance(t, torch.Tensor) or t.dim() != ndim
                or tuple(t.shape[:3]) != want or t.dtype != torch.int32
                or t.device != q.device):
            got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(
                f"{name} must be int32 {want}{' + (NNZ,)' if ndim == 4 else ''}"
                f" on {q.device}; got {got}")


def _lengths(seqlens, default: int, b: int, device) -> torch.Tensor:
    if seqlens is None:
        return torch.full((b,), default, dtype=torch.int64, device=device)
    return seqlens.to(device=device, dtype=torch.int64)


def column_limits(b: int, sq: int, sk: int, causal: bool, seqlens_q=None,
                  seqlens_k=None, device=None) -> torch.Tensor:
    """(b, cdiv(sq, 64)) int64: for each 64-row block, the exclusive bound
    of the columns any of its rows can see (its rows' keys, and under
    causal masking its last row's diagonal); 0 for a block past the rows."""
    uq = _lengths(seqlens_q, sq, b, device)
    uk = _lengths(seqlens_k, sk, b, device)
    rows = uq.clamp(0, sq)[:, None]
    keys = uk.clamp(0, sk)[:, None]
    first = torch.arange(cdiv(sq, META_BLOCK), device=device)[None] * META_BLOCK
    lim = keys.expand(b, first.shape[1])
    if causal:
        last = torch.minimum(first + META_BLOCK - 1, rows - 1)
        lim = torch.minimum(lim, last + (uk - uq)[:, None] + 1)
    return torch.where(first < rows, lim, torch.zeros_like(lim)).clamp_min(0)


def _prefix_mask(n: torch.Tensor) -> torch.Tensor:
    """int64 words with the low n bits set, n in [0, 64]."""
    ones = torch.full_like(n, -1)
    return torch.where(n >= 64, ones,
                       torch.bitwise_not(ones << n.clamp(max=63)))


def word_table(block_count, block_offset, column_count, column_index,
               lim: torch.Tensor, nkb: int) -> torch.Tensor:
    """(b, h, nqb, nkb) int64: the membership word of every (64-row block,
    64-key tile), bit c for column 64 * tile + c, cut to the block's column
    limit `lim` (b, nqb). The union is taken exactly: a slash range
    [off, off + 64) is a suffix of tile off // 64 and a prefix of the next
    tile, so the union of the suffixes starting in a tile is the one with
    the least start (scatter "amin") and that of the prefixes the longest
    (scatter "amax"); vertical columns are sorted and deduplicated, so their
    bits add."""
    b, h, nqb, ns = block_offset.shape
    nv = column_index.shape[-1]
    rows = b * h * nqb
    dev = block_offset.device
    lim_r = lim[:, None, :].expand(b, h, nqb).reshape(rows, 1)
    words = torch.zeros(rows, nkb, dtype=torch.int64, device=dev)
    if ns:
        off = block_offset.reshape(rows, ns).long()
        ok = (torch.arange(ns, device=dev)[None]
              < block_count.reshape(rows, 1)) & (off < lim_r) & (off > -64)
        t0, r0 = off >> 6, (off & 63).int()
        suffix = torch.full((rows, nkb + 1), 64, dtype=torch.int32, device=dev)
        suffix.scatter_reduce_(
            1, torch.where(ok & (t0 >= 0) & (t0 < nkb), t0, nkb), r0, "amin")
        prefix = torch.zeros((rows, nkb + 1), dtype=torch.int32, device=dev)
        prefix.scatter_reduce_(
            1, torch.where(ok & (r0 > 0) & (t0 + 1 < nkb), t0 + 1, nkb), r0,
            "amax")
        s = suffix[:, :nkb].long()
        words |= torch.where(s < 64, torch.full_like(s, -1) << s.clamp(max=63),
                             torch.zeros_like(s))
        words |= _prefix_mask(prefix[:, :nkb].long())
    if nv:
        col = column_index.reshape(rows, nv).long()
        ok = ((torch.arange(nv, device=dev)[None]
               < column_count.reshape(rows, 1)) & (col >= 0) & (col < lim_r))
        big = nkb * META_BLOCK
        col = torch.where(ok, col, big).sort(-1).values
        keep = col < big
        keep[:, 1:] &= col[:, 1:] != col[:, :-1]
        bits = torch.where(keep, torch.ones_like(col) << (col & 63),
                           torch.zeros_like(col))
        vert = torch.zeros((rows, nkb + 1), dtype=torch.int64, device=dev)
        vert.scatter_add_(1, torch.where(keep, col >> 6, nkb), bits)
        words |= vert[:, :nkb]
    tile0 = torch.arange(nkb, device=dev)[None] * META_BLOCK
    words &= _prefix_mask((lim_r - tile0).clamp(0, 64))
    return words.reshape(b, h, nqb, nkb)


def _compact(active: torch.Tensor, values, length: int):
    """Per row of `active` (rows, n), its active positions' `values` (each
    (rows, n)) moved to the front in order, in (rows, length + 1) tensors
    whose last column is scratch; and the counts (rows,) int32."""
    rows = active.shape[0]
    dst = torch.where(active, active.cumsum(-1) - 1, length)
    out = [torch.zeros((rows, length + 1), dtype=v.dtype,
                       device=active.device).scatter_(1, dst, v)
           for v in values]
    return out, active.sum(-1, dtype=torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class SparsePlan:
    """Kernel 12's lists, per (b, h, 64-row block): `counts` (b, h, nqb)
    int32 listed tiles; `tiles` (b, h, nqb, T + 1) int32 ascending key-tile
    indices and `words` (b, h, nqb, T + 1) int64 membership words, their
    first `counts` entries used (the last entry is scratch); `table` (b, h,
    nqb, nkb) the word of every tile, from which `plan_inverse` builds the
    backward's lists (None when no backward will run)."""

    counts: torch.Tensor
    tiles: torch.Tensor
    words: torch.Tensor
    table: Optional[torch.Tensor]


def max_tiles(nnz_s: int, nnz_v: int, nkb: int) -> int:
    """Static bound of a tile list: an unaligned slash spans two tiles, a
    vertical column one."""
    return max(1, min(nkb, 2 * nnz_s + nnz_v))


def plan_sparse(block_count, block_offset, column_count, column_index, *,
                seqlen_q: int, seqlen_k: int, causal: bool, seqlens_q=None,
                seqlens_k=None, keep_table: bool = False) -> SparsePlan:
    """Kernel 12's lists from the metadata (see the module docstring), on
    the metadata's device with no host read."""
    b, h, nqb, ns = block_offset.shape
    nkb = cdiv(seqlen_k, META_BLOCK)
    lim = column_limits(b, seqlen_q, seqlen_k, causal, seqlens_q, seqlens_k,
                        block_offset.device)
    table = word_table(block_count, block_offset, column_count, column_index,
                       lim, nkb)
    t = max_tiles(ns, column_index.shape[-1], nkb)
    flat = table.reshape(-1, nkb)
    ids = torch.arange(nkb, dtype=torch.int32, device=table.device)
    (tiles, words), counts = _compact(
        flat != 0, (ids.expand(flat.shape[0], nkb), flat), t)
    return SparsePlan(counts.reshape(b, h, nqb),
                      tiles.reshape(b, h, nqb, t + 1),
                      words.reshape(b, h, nqb, t + 1),
                      table if keep_table else None)


def plan_inverse(table: torch.Tensor, hk: int):
    """Kernel 13's lists from the word table (b, h, nqb, nkb): per (b, kv
    head, 64-key tile), the (query head in the group, 64-row block) pairs
    that attend any of its keys, as idx = head_in_group * nqb + block in
    ascending order, with their membership words. Returns (counts (b, hk,
    nkb) int32, idx (b, hk, nkb, g * nqb + 1) int32, words int64 alike; the
    last entry is scratch)."""
    b, h, nqb, nkb = table.shape
    g = h // hk
    t = table.reshape(b, hk, g, nqb, nkb).permute(0, 1, 4, 2, 3).reshape(
        b * hk * nkb, g * nqb)
    ids = torch.arange(g * nqb, dtype=torch.int32, device=table.device)
    (idx, words), counts = _compact(t != 0, (ids.expand_as(t), t), g * nqb)
    return (counts.reshape(b, hk, nkb), idx.reshape(b, hk, nkb, -1),
            words.reshape(b, hk, nkb, -1))


# -- plain versions ----------------------------------------------------------

def membership(block_count, block_offset, column_count, column_index,
               bi: int, hi: int, m0: int, m1: int, sk: int) -> torch.Tensor:
    """(m1 - m0, sk) bool: the columns that 64-row blocks m0..m1 of (bi, hi)
    attend, straight from the metadata (slash ranges as +1/-1 steps summed
    along the keys, vertical columns scattered)."""
    dev = block_offset.device
    off = block_offset[bi, hi, m0:m1].long()
    n = m1 - m0
    ns, nv = off.shape[-1], column_index.shape[-1]
    steps = torch.zeros((n, sk + 1), dtype=torch.int32, device=dev)
    if ns:
        ok = torch.arange(ns, device=dev)[None] < block_count[bi, hi, m0:m1,
                                                              None]
        lo, hi_ = off.clamp(0, sk), (off + META_BLOCK).clamp(0, sk)
        ok &= lo < hi_
        steps.scatter_add_(1, torch.where(ok, lo, sk), ok.int())
        steps.scatter_add_(1, torch.where(ok, hi_, sk), -ok.int())
    member = steps[:, :sk].cumsum(-1) > 0
    if nv:
        col = column_index[bi, hi, m0:m1].long()
        ok = ((torch.arange(nv, device=dev)[None]
               < column_count[bi, hi, m0:m1, None]) & (col >= 0) & (col < sk))
        vert = torch.zeros((n, sk + 1), dtype=torch.bool, device=dev)
        vert.scatter_(1, torch.where(ok, col, sk), True)
        member |= vert[:, :sk]
    return member


def _row_chunk(sk: int) -> int:
    """64-row blocks per chunk of the plain versions: ~32 M scores."""
    return max(1, (1 << 25) // (META_BLOCK * max(sk, 1)))


def visible_chunks(meta, b, h, sq, sk, causal, seqlens_q, seqlens_k, alibi):
    """Yields (bi, hi, rows slice, visible (rows, sk) bool, ALiBi bias
    (rows, sk) or None) over every batch row, head and chunk of rows."""
    dev = meta[1].device
    uq = _lengths(seqlens_q, sq, b, dev).tolist()
    uk = _lengths(seqlens_k, sk, b, dev).tolist()
    nqb = cdiv(sq, META_BLOCK)
    step = _row_chunk(sk)
    col = torch.arange(sk, device=dev)[None]
    for bi in range(b):
        rows_b, keys_b, off = min(uq[bi], sq), min(uk[bi], sk), uk[bi] - uq[bi]
        for hi in range(h):
            for m0 in range(0, nqb, step):
                m1 = min(m0 + step, nqb)
                r0, r1 = m0 * META_BLOCK, min(m1 * META_BLOCK, sq)
                row = torch.arange(r0, r1, device=dev)[:, None]
                vis = membership(*meta, bi, hi, m0, m1, sk).repeat_interleave(
                    META_BLOCK, 0)[: r1 - r0]
                vis &= (row < rows_b) & (col < keys_b)
                if causal:
                    vis &= col <= row + off
                bias = None
                if alibi is not None:
                    slope = alibi[bi if alibi.shape[0] > 1 else 0, hi]
                    bias = -slope * (col - row - off).abs().float()
                yield bi, hi, slice(r0, r1), vis, bias


def _slopes(alibi_slopes, device) -> Optional[torch.Tensor]:
    """ALiBi slopes as (1 or b, h) fp32."""
    if alibi_slopes is None:
        return None
    s = alibi_slopes.to(device=device, dtype=torch.float32)
    return s[None] if s.dim() == 1 else s


def _scores(q, k, scale, softcap, bias):
    s = torch.matmul(q.float(), k.float().T)
    t = None
    if softcap > 0.0:
        t = torch.tanh(s * (scale / softcap))
        s = t * softcap
    else:
        s = s * scale
    return (s if bias is None else s + bias), t


def flash_attention_sparse_fwd_ref(
    q, k, v, block_count, block_offset, column_count, column_index, *,
    softmax_scale=None, causal=False, softcap=0.0, alibi_slopes=None,
    seqlens_q=None, seqlens_k=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernels 12 and 15, in fp32: (out (b, h, sq,
    d) in q's dtype, lse (b, h, sq) fp32); a row that sees no column (or
    lies past its seqlens_q) gives out 0 and lse -inf."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    scale = _scale(d, softmax_scale)
    meta = (block_count, block_offset, column_count, column_index)
    out = torch.zeros_like(q)
    lse = torch.full((b, h, sq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    for bi, hi, rows, vis, bias in visible_chunks(
            meta, b, h, sq, sk, causal, seqlens_q, seqlens_k,
            _slopes(alibi_slopes, q.device)):
        g = hi // group
        s, _ = _scores(q[bi, hi, rows], k[bi, g], scale, softcap, bias)
        s = s.masked_fill(~vis, float("-inf"))
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p, v[bi, g].float()) / l.clamp_min(1e-37)
        out[bi, hi, rows] = torch.where(l > 0, o, torch.zeros_like(o)).to(
            q.dtype)
        lse[bi, hi, rows] = torch.where(
            l > 0, m + torch.log(l.clamp_min(1e-37)),
            torch.full_like(l, float("-inf")))[:, 0]
    return out, lse


def _p_ds(q, k, v, do, lse, delta, bi, hi, g, rows, vis, bias, scale,
          softcap):
    """P, dP and dS (delta=None: dS not formed) of one chunk, fp32."""
    s, t = _scores(q[bi, hi, rows], k[bi, g], scale, softcap, bias)
    lse_r = lse[bi, hi, rows, None]
    keep = vis & torch.isfinite(lse_r)
    p = torch.where(keep, torch.exp(s - lse_r), torch.zeros_like(s))
    dp = torch.matmul(do[bi, hi, rows].float(), v[bi, g].float().T)
    if delta is None:
        return p, dp, None
    ds = p * (dp - delta[bi, hi, rows, None]) * scale
    return p, dp, (ds if t is None else ds * (1.0 - t * t))


def _sparse_dq_ref(q, k, v, do, lse, block_count, block_offset, column_count,
                   column_index, *, softmax_scale=None, causal=False,
                   softcap=0.0, alibi_slopes=None, seqlens_q=None,
                   seqlens_k=None):
    """Plain version of kernel 14: (dq in q's dtype, delta (b, h, sq) fp32
    = sum_j P dP), P recomputed from the scores and the LSE, in fp32."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    scale = _scale(d, softmax_scale)
    meta = (block_count, block_offset, column_count, column_index)
    dq = torch.zeros_like(q)
    delta = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for bi, hi, rows, vis, bias in visible_chunks(
            meta, b, h, sq, sk, causal, seqlens_q, seqlens_k,
            _slopes(alibi_slopes, q.device)):
        g = hi // (h // hk)
        p, dp, _ = _p_ds(q, k, v, do, lse, None, bi, hi, g, rows, vis, bias,
                         scale, softcap)
        delta[bi, hi, rows] = (p * dp).sum(-1)
        _, _, ds = _p_ds(q, k, v, do, lse, delta, bi, hi, g, rows, vis, bias,
                         scale, softcap)
        dq[bi, hi, rows] = torch.matmul(ds, k[bi, g].float()).to(q.dtype)
    return dq, delta


def _sparse_dkv_ref(q, k, v, do, lse, delta, block_count, block_offset,
                    column_count, column_index, *, softmax_scale=None,
                    causal=False, softcap=0.0, alibi_slopes=None,
                    seqlens_q=None, seqlens_k=None):
    """Plain version of kernel 13: (dk, dv) in k's and v's dtypes, each kv
    head's group of query heads summed in fp32."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    scale = _scale(d, softmax_scale)
    meta = (block_count, block_offset, column_count, column_index)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for bi, hi, rows, vis, bias in visible_chunks(
            meta, b, h, sq, sk, causal, seqlens_q, seqlens_k,
            _slopes(alibi_slopes, q.device)):
        g = hi // (h // hk)
        p, _, ds = _p_ds(q, k, v, do, lse, delta, bi, hi, g, rows, vis, bias,
                         scale, softcap)
        dv[bi, g] += torch.matmul(p.T, do[bi, hi, rows].float())
        dk[bi, g] += torch.matmul(ds.T, q[bi, hi, rows].float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernels -----------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_args(q, k, v, meta, *, alibi_slopes, seqlens_q, seqlens_k):
    """Checks what the sparse kernels take and returns the shared launch
    arguments: (seqlens_q, seqlens_k, slopes, alibi batch stride), each
    tensor int32/fp32 contiguous on q's device or None."""
    check_shapes(q, k, v)
    b, h, sq, d = q.shape
    check_kernel_inputs(d, h, k.shape[1], q=q, k=k, v=v)
    check_metadata(q, *meta)

    def lens(t):
        if t is None:
            return None
        if t.shape != (b,):
            raise ValueError(f"seqlens must be ({b},); got {tuple(t.shape)}")
        return t.to(device=q.device, dtype=torch.int32).contiguous()

    slopes = _slopes(alibi_slopes, q.device)
    if slopes is not None:
        if slopes.shape not in ((1, h), (b, h)):
            raise ValueError(f"alibi_slopes must be ({h},) or ({b}, {h}); "
                             f"got {tuple(alibi_slopes.shape)}")
        slopes = slopes.contiguous()
    return (lens(seqlens_q), lens(seqlens_k), slopes,
            h if slopes is not None and slopes.shape[0] > 1 else 0)


def _outputs(q, seqlens_q):
    """out and lse; zero-filled and -inf where rows past seqlens_q are not
    written by the kernel."""
    b, h, sq = q.shape[:3]
    if seqlens_q is None:
        return (torch.empty_like(q),
                torch.empty((b, h, sq), dtype=torch.float32, device=q.device))
    return (torch.zeros_like(q),
            torch.full((b, h, sq), float("-inf"), dtype=torch.float32,
                       device=q.device))


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("flash_sparse_fwd").flash_sparse_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])
    return fn


def launch_fwd(q, k, v, lens_q, lens_k, slopes, alibi_b, counts, tiles,
               words, cols, *, softmax_scale, causal, softcap):
    """One launch of csrc/flash_sparse_fwd.cu: kernel 12 (tiles and words)
    or kernel 15 (cols). Returns (out, lse)."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    lst = tiles if cols is None else cols
    out, lse = _outputs(q, lens_q)
    rc = _fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides_arg(q, k, v, out), counts.data_ptr(),
        _ptr(tiles), _ptr(words), _ptr(cols), lst.shape[-1], _ptr(lens_q),
        _ptr(lens_k), _ptr(slopes), alibi_b, b, h, hk, sq, sk, d,
        _scale(d, softmax_scale), int(causal), float(softcap),
        int(q.dtype == torch.float16), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_sparse_fwd launch failed: CUDA error {rc}")
    return out, lse


def flash_attention_sparse_tiles_fwd(
    q, k, v, block_count, block_offset, column_count, column_index, *,
    softmax_scale=None, causal=False, softcap=0.0, alibi_slopes=None,
    seqlens_q=None, seqlens_k=None, plan: Optional[SparsePlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 12: the sparse forward over the planner's key-tile lists.
    Returns (out (b, h, sq, d) in q's dtype, lse (b, h, sq) fp32). CUDA
    tensors launch csrc/flash_sparse_fwd.cu (counted in
    `flash_attention_sparse_tiles_fwd.launches`), with `plan` when given;
    CPU tensors take `flash_attention_sparse_fwd_ref`."""
    meta = (block_count, block_offset, column_count, column_index)
    kw = dict(softmax_scale=softmax_scale, causal=causal, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_sparse_fwd_ref(
            q, k, v, *meta, alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
            seqlens_k=seqlens_k, **kw)
    lens_q, lens_k, slopes, alibi_b = kernel_args(
        q, k, v, meta, alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
        seqlens_k=seqlens_k)
    if plan is None:
        plan = plan_sparse(*meta, seqlen_q=q.shape[2], seqlen_k=k.shape[2],
                           causal=causal,
                           seqlens_q=lens_q, seqlens_k=lens_k)
    res = launch_fwd(q, k, v, lens_q, lens_k, slopes, alibi_b, plan.counts,
                     plan.tiles, plan.words, None, **kw)
    flash_attention_sparse_tiles_fwd.launches += 1
    return res


flash_attention_sparse_tiles_fwd.launches = 0


def sparse_route(nnz_s: int, nnz_v: int, seqlen_k: int) -> str:
    """"gather" (kernel 15) or "tiles" (kernel 12) for metadata of NNZ_S
    slash and NNZ_V vertical entries over seqlen_k keys, from these static
    sizes only (no host read, no fitted constant).

    Per 64-row block, kernel 15 computes at most 64 NNZ_S + NNZ_V columns
    and kernel 12 at most 64 min(nkb, 2 NNZ_S + NNZ_V), whatever the
    metadata holds. Gather while its bound is below seqlen_k, so below
    kernel 12's; at or past seqlen_k both bounds are the whole row, and
    kernel 12's planner, which costs less than kernel 15's at every size
    timed on the H100 from 8192 keys up (PERF.md), decides. Where between
    the two the routes cross with their planners depends on where the
    attended columns lie, which the metadata's shapes do not say."""
    return "gather" if META_BLOCK * nnz_s + nnz_v < seqlen_k else "tiles"


def flash_attention_sparse_fwd(
    q, k, v, block_count, block_offset, column_count, column_index, *,
    alibi_slopes=None, softmax_scale=None, causal=False, softcap=0.0,
    seqlens_q=None, seqlens_k=None, dropout_p: float = 0.0,
    plan: Optional[SparsePlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertical-slash sparse forward, q (b, h, sq, d), k/v (b, hk, sk, d).
    Returns (out, lse (b, h, sq) fp32), through kernel 12 or 15 as
    `sparse_route` picks; a kernel-12 `plan` is used on that route. CPU
    tensors take the plain version on either route."""
    check_unported(dropout_p=dropout_p)
    meta = (block_count, block_offset, column_count, column_index)
    check_metadata(q, *meta)
    from flash_attn_tpu_torch.kernels.flash_sparse_gather import (
        flash_attention_sparse_gather_fwd,
    )
    from flash_attn_tpu_torch.utils.fa_logging import log_dispatch

    route = sparse_route(block_offset.shape[-1], column_index.shape[-1],
                         k.shape[2])
    log_dispatch("sparse", route=route, shape=tuple(q.shape))
    kw = dict(softmax_scale=softmax_scale, causal=causal, softcap=softcap,
              alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
              seqlens_k=seqlens_k)
    if route == "gather":
        return flash_attention_sparse_gather_fwd(q, k, v, *meta, **kw)
    return flash_attention_sparse_tiles_fwd(q, k, v, *meta, plan=plan, **kw)


@functools.lru_cache(maxsize=None)
def _bwd_kernels() -> ctypes.CDLL:
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library("flash_sparse_bwd")
    strides = ctypes.POINTER(ctypes.c_longlong)
    tail = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
               ctypes.c_void_p])
    lib.flash_sparse_bwd_dkv.argtypes = (
        [ctypes.c_void_p] * 8 + [strides] + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong] + tail)
    lib.flash_sparse_bwd_dq.argtypes = (
        [ctypes.c_void_p] * 7 + [strides] + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong] + tail)
    lib.flash_sparse_bwd_dkv.restype = ctypes.c_int
    lib.flash_sparse_bwd_dq.restype = ctypes.c_int
    return lib


def _check_bwd(q, do, stats):
    if do.shape != q.shape:
        raise ValueError(f"dout {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    check_kernel_inputs(q.shape[3], q.shape[1], q.shape[1], q=q, dout=do)
    for name, t in stats.items():
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 "
                             f"{tuple(q.shape[:3])} on {q.device}")


def flash_attention_sparse_bwd_dq(
    q, k, v, do, lse, block_count, block_offset, column_count, column_index,
    *, softmax_scale=None, causal=False, softcap=0.0, alibi_slopes=None,
    seqlens_q=None, seqlens_k=None, plan: Optional[SparsePlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 14: (dq in q's dtype, delta (b, h, sq) fp32). CUDA tensors
    launch flash_sparse_bwd_dq over the forward's lists (counted in
    `flash_attention_sparse_bwd_dq.launches`); CPU tensors take
    `_sparse_dq_ref`."""
    meta = (block_count, block_offset, column_count, column_index)
    kw = dict(softmax_scale=softmax_scale, causal=causal, softcap=softcap,
              alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
              seqlens_k=seqlens_k)
    if q.device.type == "cpu":
        return _sparse_dq_ref(q, k, v, do, lse, *meta, **kw)
    lens_q, lens_k, slopes, alibi_b = kernel_args(
        q, k, v, meta, alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
        seqlens_k=seqlens_k)
    _check_bwd(q, do, dict(lse=lse))
    if plan is None:
        plan = plan_sparse(*meta, seqlen_q=q.shape[2], seqlen_k=k.shape[2],
                           causal=causal,
                           seqlens_q=lens_q, seqlens_k=lens_k)
    b, h, sq, d = q.shape
    fill = torch.zeros_like if lens_q is not None else torch.empty_like
    dq = fill(q)
    delta = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    rc = _bwd_kernels().flash_sparse_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        strides_arg(q, k, v, do, dq), plan.counts.data_ptr(),
        plan.tiles.data_ptr(), plan.words.data_ptr(), plan.tiles.shape[-1],
        _ptr(lens_q), _ptr(lens_k), _ptr(slopes), alibi_b, b, h, k.shape[1],
        sq, k.shape[2], d, _scale(d, softmax_scale), int(causal),
        float(softcap), int(q.dtype == torch.float16), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_sparse_bwd_dq launch failed: CUDA error {rc}")
    flash_attention_sparse_bwd_dq.launches += 1
    return dq, delta


flash_attention_sparse_bwd_dq.launches = 0


def flash_attention_sparse_bwd_dkv(
    q, k, v, do, lse, delta, block_count, block_offset, column_count,
    column_index, *, softmax_scale=None, causal=False, softcap=0.0,
    alibi_slopes=None, seqlens_q=None, seqlens_k=None, inverse=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 13: (dk, dv) in k's dtype, GQA groups summed. CUDA tensors
    launch flash_sparse_bwd_dkv over `plan_inverse`'s lists (`inverse`, when
    given; counted in `flash_attention_sparse_bwd_dkv.launches`); CPU
    tensors take `_sparse_dkv_ref`."""
    meta = (block_count, block_offset, column_count, column_index)
    kw = dict(softmax_scale=softmax_scale, causal=causal, softcap=softcap,
              alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
              seqlens_k=seqlens_k)
    if q.device.type == "cpu":
        return _sparse_dkv_ref(q, k, v, do, lse, delta, *meta, **kw)
    lens_q, lens_k, slopes, alibi_b = kernel_args(
        q, k, v, meta, alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
        seqlens_k=seqlens_k)
    _check_bwd(q, do, dict(lse=lse, delta=delta))
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if inverse is None:
        plan = plan_sparse(*meta, seqlen_q=sq, seqlen_k=sk, causal=causal,
                           seqlens_q=lens_q, seqlens_k=lens_k,
                           keep_table=True)
        inverse = plan_inverse(plan.table, hk)
    counts, idx, words = inverse
    fill = torch.zeros_like if lens_k is not None else torch.empty_like
    dk, dv = fill(k), fill(v)
    rc = _bwd_kernels().flash_sparse_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        strides_arg(q, k, v, do, dk, dv), counts.data_ptr(), idx.data_ptr(),
        words.data_ptr(), idx.shape[-1], _ptr(lens_q), _ptr(lens_k),
        _ptr(slopes), alibi_b, b, h, hk, sq, sk, d,
        _scale(d, softmax_scale), int(causal), float(softcap),
        int(q.dtype == torch.float16), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_sparse_bwd_dkv launch failed: CUDA error {rc}")
    flash_attention_sparse_bwd_dkv.launches += 1
    return dk, dv


flash_attention_sparse_bwd_dkv.launches = 0


def flash_attention_sparse_bwd(
    q, k, v, lse, do, block_count, block_offset, column_count, column_index,
    *, softmax_scale=None, causal=False, softcap=0.0, alibi_slopes=None,
    seqlens_q=None, seqlens_k=None, dropout_p: float = 0.0,
    plan: Optional[SparsePlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vertical-slash sparse backward: (dq, dk, dv), dk/dv per kv head.
    Kernel 14 first (dq and delta = sum_j P dP), then kernel 13 with that
    delta. Unlike the JAX function it takes no `out` (delta comes from the
    dQ kernel, as in kernels.flash_bwd). A `plan` that keeps its word table
    serves both kernels."""
    check_unported(dropout_p=dropout_p)
    meta = (block_count, block_offset, column_count, column_index)
    kw = dict(softmax_scale=softmax_scale, causal=causal, softcap=softcap,
              alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
              seqlens_k=seqlens_k)
    inverse = None
    if q.device.type != "cpu":
        if plan is None or plan.table is None:
            lens_q, lens_k, _, _ = kernel_args(
                q, k, v, meta, alibi_slopes=alibi_slopes, seqlens_q=seqlens_q,
                seqlens_k=seqlens_k)
            plan = plan_sparse(*meta, seqlen_q=q.shape[2], seqlen_k=k.shape[2],
                               causal=causal, seqlens_q=lens_q,
                               seqlens_k=lens_k, keep_table=True)
        inverse = plan_inverse(plan.table, k.shape[1])
    dq, delta = flash_attention_sparse_bwd_dq(q, k, v, do, lse, *meta,
                                              plan=plan, **kw)
    dk, dv = flash_attention_sparse_bwd_dkv(q, k, v, do, lse, delta, *meta,
                                            inverse=inverse, **kw)
    return dq, dk, dv
