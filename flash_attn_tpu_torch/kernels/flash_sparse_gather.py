"""Vertical-slash sparse forward over compact column lists (counterpart of
flash_attn_tpu/kernels/flash_sparse_gather.py): kernel 15.

Kernel 12 (`kernels/flash_sparse.py`) computes whole 64-wide key tiles and
masks the columns that are not attended, so a tile with one vertical column
costs as much as a full one. Kernel 15 computes the same function over each
64-row block's sorted, deduplicated list of attended columns, 64 at a time:
the planner (`plan_gather`, torch ops on the device, no host read) builds
the lists, and the Hopper kernel (`csrc/flash_sparse_gather_sm90.cuh`)
gathers each 64-column step's K/V rows with cp.async into the swizzled
tiles wgmma reads, masking only causality and bounds. The JAX kernel's
route rule (`_G_est * 64 <= 4096`, a VMEM budget) is not kept;
the port's is `flash_sparse.sparse_route`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from flash_attn_tpu_torch.kernels.common import round_up
from flash_attn_tpu_torch.kernels.flash_sparse import (
    META_BLOCK,
    column_limits,
    flash_attention_sparse_fwd_ref,
    kernel_args,
    launch_fwd,
)

_BIG = 1 << 40  # sorts after every real column


def max_columns(nnz_s: int, nnz_v: int, seqlen_k: int) -> int:
    """Static length of a gather list: at most 64 columns per slash entry,
    one per vertical entry, and seqlen_k, rounded up to a 64-column step."""
    return round_up(max(1, min(seqlen_k, META_BLOCK * nnz_s + nnz_v)),
                    META_BLOCK)


def _gather_rows(off, bc, col, cc, lim, length):
    """The column lists of `rows` 64-row blocks: (cols (rows, length + 1)
    int32, -1 past the count, the last column scratch; counts (rows,)).

    Slash ranges are clipped to [0, lim), sorted by start, and cut to the
    columns no earlier range covers (each range's start raised to the
    running maximum of the earlier ends), which leaves disjoint segments in
    ascending order. Vertical columns are sorted and dropped when repeated
    or inside a segment. A column's place in the list is the number of
    attended columns before it: segment lengths summed before its segment
    plus the kept verticals before that segment's start, or for a vertical
    its rank plus the segment columns before it (searchsorted)."""
    rows, dev = lim.shape[0], lim.device
    out = torch.full((rows, length + 1), -1, dtype=torch.int32, device=dev)
    n_slash = torch.zeros(rows, dtype=torch.int64, device=dev)
    ns, nv = off.shape[-1], col.shape[-1]
    if ns:
        ok = ((torch.arange(ns, device=dev)[None] < bc) & (off < lim)
              & (off > -META_BLOCK))
        start = torch.where(ok, off.clamp_min(0), _BIG)
        end = torch.where(ok, torch.minimum(off + META_BLOCK, lim), _BIG)
        start, order = start.sort(-1)
        end = end.gather(-1, order)
        reach = torch.cat([torch.full_like(end[:, :1], -1),
                           end.cummax(-1).values[:, :-1]], -1)
        seg = torch.maximum(start, reach)
        seg_len = (end - seg).clamp_min(0)
        seg_end = seg_len.cumsum(-1)  # slash columns up to each segment's end
        n_slash = seg_end[:, -1]
    if nv:
        ok = ((torch.arange(nv, device=dev)[None] < cc) & (col >= 0)
              & (col < lim))
        col = torch.where(ok, col, _BIG).sort(-1).values
        keep = col < _BIG
        keep[:, 1:] &= col[:, 1:] != col[:, :-1]
        slash_before = torch.zeros_like(col)
        if ns:
            i = torch.searchsorted(seg, col, right=True) - 1
            ic = i.clamp_min(0)
            inside = (i >= 0) & (col < seg.gather(-1, ic) + seg_len.gather(-1, ic))
            keep &= ~inside
            slash_before = torch.where(i >= 0, seg_end.gather(-1, ic), 0)
        kept = keep.cumsum(-1)
        pos = torch.where(keep, kept - 1 + slash_before, length)
        out.scatter_(1, pos, col.int())
    if ns:
        v_before = torch.zeros_like(seg)
        if nv:
            j = torch.searchsorted(col, seg)  # verticals (kept or not) < seg
            v_before = torch.where(j > 0, kept.gather(-1, (j - 1).clamp_min(0)),
                                   0)
        step = torch.arange(META_BLOCK, device=dev)
        pos = (seg_end - seg_len + v_before)[..., None] + step
        pos = torch.where(step < seg_len[..., None], pos, length)
        out.scatter_(1, pos.reshape(rows, -1),
                     (seg.clamp_max(1 << 30)[..., None] + step).int().reshape(
                         rows, -1))
    counts = n_slash + (kept[:, -1] if nv else 0)
    return out, counts.int()


def plan_gather(block_count, block_offset, column_count, column_index, *,
                seqlen_q: int, seqlen_k: int, causal: bool, seqlens_q=None,
                seqlens_k=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 15's lists from the metadata: (counts (b, h, nqb) int32, cols
    (b, h, nqb, L + 1) int32 ascending attended columns, -1 past the count,
    the last entry scratch), after dropping the columns no row of the block
    can see (`flash_sparse.column_limits`). L = `max_columns`. Rows of
    blocks go through in chunks so that no intermediate exceeds ~32 M
    entries."""
    b, h, nqb, ns = block_offset.shape
    nv = column_index.shape[-1]
    rows = b * h * nqb
    length = max_columns(ns, nv, seqlen_k)
    lim = column_limits(b, seqlen_q, seqlen_k, causal, seqlens_q, seqlens_k,
                        block_offset.device)
    lim = lim[:, None, :].expand(b, h, nqb).reshape(rows, 1)
    flat = (block_offset.reshape(rows, ns).long(),
            block_count.reshape(rows, 1), column_index.reshape(rows, nv).long(),
            column_count.reshape(rows, 1))
    step = max(1, (1 << 25) // (META_BLOCK * max(ns, 1) + nv + length))
    cols, counts = [], []
    for r0 in range(0, rows, step):
        c, n = _gather_rows(*(x[r0:r0 + step] for x in flat),
                            lim[r0:r0 + step], length)
        cols.append(c)
        counts.append(n)
    cols = torch.cat(cols) if len(cols) > 1 else cols[0]
    counts = torch.cat(counts) if len(counts) > 1 else counts[0]
    return counts.reshape(b, h, nqb), cols.reshape(b, h, nqb, length + 1)


def flash_attention_sparse_gather_fwd(
    q, k, v, block_count, block_offset, column_count, column_index, *,
    softmax_scale=None, causal=False, softcap=0.0, alibi_slopes=None,
    seqlens_q=None, seqlens_k=None, plan=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 15: the sparse forward over compact column lists, the same
    function as kernel 12. Returns (out (b, h, sq, d) in q's dtype, lse (b,
    h, sq) fp32). CUDA tensors launch csrc/flash_sparse_fwd.cu in its
    gather mode (counted in `flash_attention_sparse_gather_fwd.launches`),
    over `plan` ((counts, cols) of `plan_gather`) when given; CPU tensors
    take `flash_sparse.flash_attention_sparse_fwd_ref`. The Hopper kernel
    reads q, k and v through their strides (multiples of 8 elements, bases
    16-byte aligned)."""
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
        plan = plan_gather(*meta, seqlen_q=q.shape[2], seqlen_k=k.shape[2],
                           causal=causal, seqlens_q=lens_q, seqlens_k=lens_k)
    counts, cols = plan
    res = launch_fwd(q, k, v, lens_q, lens_k, slopes, alibi_b, counts, None,
                     None, cols, **kw)
    flash_attention_sparse_gather_fwd.launches += 1
    return res


flash_attention_sparse_gather_fwd.launches = 0
