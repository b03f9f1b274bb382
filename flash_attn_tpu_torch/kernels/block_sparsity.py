"""Block-sparse execution of programmable masks (counterpart of
flash_attn_tpu/kernels/block_sparsity.py).

  * plan: `compute_block_sparsity` classifies every (batch, head, q-tile,
    kv-tile) of a `mask_mod` as skipped, full or partial, evaluated with
    torch on the device (exact, or by 5-point sampling);
    `compute_block_sparsity_varlen` does so over packed sequences;
  * carrier: `BlockSparseTensors`, per-(b, h, q-tile) lists of partial and
    full kv-tiles; the port's planners also record the grid they were built
    for, which a call must match exactly;
  * execute: kernels 9 (forward), 11 (dQ) and 10 (dK/dV) visit only live
    tiles.

Semantics (those of the JAX kernels, tile by tile): a FULL tile is
computed with no mask, except for the bounds (rows < seqlen_q, columns <
seqlen_k) where it crosses them; a PARTIAL tile gets the bounds and, when a
`mask_mod` is given, the mod; skipped tiles contribute nothing. A query row
that sees nothing comes out 0 with lse -inf. A fast-sampling plan may call
a tile FULL that the mod would mask in part: it is computed unmasked, as in
the JAX package.

The CUDA kernels cannot call a Python mod. So before the first launch the
live plan tiles are cut into 64 x 64 sub-tiles and each gets a mode
(`build_execution_lists`): 0 interior, 1 bounds, or 2 per-row words, 64
uint64 per sub-tile, bit c of row r set iff column c is kept, from the
call's own `mask_mod` evaluated in torch over the partial tiles and ANDed
with the bounds (exact for any mod). A partial sub-tile whose words are
all zero is dropped, and one whose words equal the bounds runs as mode 0
or 1. The lists (per (b, h, 64-row block) the live 64-column sub-tiles
ascending, and per (b, h, 64-key block) the live 64-row sub-blocks) are
built on the device and cached per (plan, mod, aux, shapes), so every
layer of a step and the backward reuse them with no host read; the build
reads the number of partial tiles to the host once. On a CUDA device
`compute_block_sparsity` builds them right away for its own mod and aux.

Kernels, each with a `.launches` count and a plain PyTorch version that
the wrapper takes for CPU tensors:

  * `flash_attention_blocksparse_fwd` (kernel 9, `csrc/block_sparse_fwd.cu`
    on wgmma, TMA and mbarriers, `csrc/block_sparse_fwd_sm90.cuh`; plain
    `flash_attention_blocksparse_fwd_ref`); `bs_fwd_walks` is a plain
    mirror of its walks, each block merging the lists of two 64-row blocks;
    an input its TMA tensor maps cannot take as it is is copied first,
    counted in `flash_attention_blocksparse_fwd.tma_copies`;
  * `flash_attention_blocksparse_bwd_dq` (kernel 11, `csrc/block_sparse_bwd.cu`
    on wgmma, TMA and mbarriers, `csrc/block_sparse_bwd_sm90.cuh`, walking
    the forward's merged lists twice; plain `_blocksparse_dq_ref`): dQ and
    delta = sum_j P dP; inputs its TMA tensor maps cannot take are copied
    first, counted in `flash_attention_blocksparse_bwd_dq.tma_copies`;
  * `flash_attention_blocksparse_bwd_dkv` (kernel 10, `csrc/block_sparse_bwd.cu`
    on wgmma, TMA and mbarriers, `csrc/block_sparse_bwd_sm90.cuh`, each
    block merging the inverse lists of two 64-key blocks, one query head
    of the group after another; plain `_blocksparse_dkv_ref`): dK/dV, the
    GQA group summed in-kernel; inputs its TMA tensor maps cannot take are
    copied first, counted in `flash_attention_blocksparse_bwd_dkv.tma_copies`.

The plain versions compute dense fp32 attention under the expanded
keep-mask (`keep_chunks`), a head and a band of rows at a time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from flash_attn_tpu_torch.kernels.common import (
    AuxData,
    aux_at,
    call_mod,
    cdiv,
    pad_aux_table,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (
    _scale,
    check_kernel_inputs,
    check_shapes,
    scores,
    stats_ready,
    strides_arg,
    tma_ready,
)
from flash_attn_tpu_torch.kernels.flash_sparse import _compact
from flash_attn_tpu_torch.utils.device import resolve_device

SUB = 64  # the kernels' sub-tile: 64 query rows x 64 key columns


class BlockSparseTensors(NamedTuple):
    """Block-sparsity plan (the JAX package's `BlockSparseTensors`).

    mask_block_cnt (b, h, num_m) int32: per q-tile count of PARTIAL
    kv-tiles; mask_block_idx (b, h, num_m, n) their indices, ascending.
    full_block_cnt / full_block_idx: the same for FULL kv-tiles, or None
    (every live tile is then in the mask lists). block_size: (tile_m,
    tile_n). b and h may be 1 (broadcast). The lists may be numpy arrays,
    as the JAX planner returns them, or torch tensors on any device.

    seqlen_q, seqlen_k, num_m, num_n: the grid the plan was built for, set
    by the port's planners (the JAX five-field form leaves them None). A
    call must match a recorded grid exactly."""

    mask_block_cnt: object
    mask_block_idx: object
    full_block_cnt: object = None
    full_block_idx: object = None
    block_size: Tuple[int, int] = (512, 512)
    seqlen_q: Optional[int] = None
    seqlen_k: Optional[int] = None
    num_m: Optional[int] = None
    num_n: Optional[int] = None


def _as_int32(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x), np.int32),
                           device=device)


def as_plan(block_sparse_tensors) -> BlockSparseTensors:
    """`block_sparse_tensors` as the port's BlockSparseTensors (a JAX
    plan, or a plain tuple of its fields, is taken as it is)."""
    if isinstance(block_sparse_tensors, BlockSparseTensors):
        return block_sparse_tensors
    return BlockSparseTensors(*tuple(block_sparse_tensors))


def make_aux(aux_tensors, aux_scalars, device) -> Optional[AuxData]:
    """AuxData on `device`: 1-D tables edge-padded as the JAX package
    pads them, scalars as fp32 0-d tensors; None without captures."""
    if not aux_tensors and not aux_scalars:
        return None
    tensors = []
    for a in aux_tensors:
        a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a, device=device)
        if a.dim() <= 1:
            a = pad_aux_table(a.reshape(-1))
        tensors.append(a)
    scalars = tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                    for x in aux_scalars)
    return AuxData(tuple(tensors), scalars)


def _keep_of(mask_mod, aux, b, h, q_idx, kv_idx) -> torch.Tensor:
    keep = call_mod(mask_mod, b, h, q_idx, kv_idx, aux=aux)
    return torch.as_tensor(keep, dtype=torch.bool, device=q_idx.device)


# -- planners ----------------------------------------------------------------

def _pack(flags: torch.Tensor):
    """(count, indices) of each row's set flags, set ones first and each
    group ascending (the JAX planner's stable argsort of ~flags)."""
    cnt = flags.sum(-1, dtype=torch.int32)
    order = torch.sort((~flags).to(torch.uint8), dim=-1, stable=True).indices
    return cnt, order.to(torch.int32)


def _classify(mask_mod, aux, batch, num_heads, seqlen_q, seqlen_k, tile_m,
              tile_n, use_fast_sampling, dev):
    """(has_unmasked, has_masked) bool (batch, num_heads, nm, nn)."""
    nm, nn = cdiv(seqlen_q, tile_m), cdiv(seqlen_k, tile_n)
    i32 = dict(dtype=torch.int32, device=dev)
    b_arr = torch.arange(batch, **i32).reshape(-1, 1, 1, 1)
    h_arr = torch.arange(num_heads, **i32).reshape(1, -1, 1, 1)
    shape = (batch, num_heads, nm, nn)
    if use_fast_sampling:
        # 4 corners + center of every tile (the JAX planner's :167-186).
        m_base = torch.arange(nm, **i32) * tile_m
        m_last = (m_base + tile_m - 1).clamp(max=seqlen_q - 1)
        m_mid = m_base + (seqlen_q - m_base).clamp(max=tile_m) // 2
        n_base = torch.arange(nn, **i32) * tile_n
        n_last = (n_base + tile_n - 1).clamp(max=seqlen_k - 1)
        n_mid = n_base + (seqlen_k - n_base).clamp(max=tile_n) // 2
        q_s = torch.stack([m_base, m_base, m_last, m_last, m_mid], -1)
        k_s = torch.stack([n_base, n_last, n_base, n_last, n_mid], -1)
        keep = _keep_of(mask_mod, aux, b_arr[..., None], h_arr[..., None],
                        q_s.reshape(1, 1, nm, 1, 5), k_s.reshape(1, 1, 1, nn, 5))
        keep = keep.broadcast_to(shape + (5,))
        return keep.any(-1), (~keep).any(-1)
    # Exact: one row of q-tiles at a time, reduced before the broadcast to
    # (batch, num_heads), so memory stays at one mod result per row.
    kv_idx = torch.arange(nn * tile_n, **i32).reshape(1, 1, 1, -1)
    unm, msk = [], []
    for mi in range(nm):
        q_idx = (mi * tile_m + torch.arange(tile_m, **i32)).reshape(1, 1, -1, 1)
        keep = _keep_of(mask_mod, aux, b_arr, h_arr, q_idx, kv_idx)
        keep = keep.reshape((1,) * (4 - keep.dim()) + tuple(keep.shape))
        inb = (q_idx < seqlen_q) & (kv_idx < seqlen_k)
        for dst, x in ((unm, keep & inb), (msk, ~keep & inb)):
            x = x.broadcast_to(x.shape[:2] + (tile_m, nn * tile_n))
            x = x.reshape(x.shape[:2] + (tile_m, nn, tile_n)).any(4).any(2)
            dst.append(x.expand(batch, num_heads, nn))
    return torch.stack(unm, 2), torch.stack(msk, 2)


def _plan(mask_mod, *, batch_size, num_heads, seqlen_q, seqlen_k, tile_m,
          tile_n, aux, compute_full_blocks, use_fast_sampling, dev):
    use_fast_sampling = getattr(mask_mod, "use_fast_sampling",
                                use_fast_sampling)
    unm, msk = _classify(mask_mod, aux, batch_size, num_heads, seqlen_q,
                         seqlen_k, tile_m, tile_n, use_fast_sampling, dev)
    if compute_full_blocks:
        partial, full = unm & msk, unm & ~msk
    else:
        # Every live tile takes the masked path (the JAX planner's :217).
        partial, full = unm, torch.zeros_like(unm)
    mask_cnt, mask_idx = _pack(partial)
    full_cnt, full_idx = _pack(full)
    return BlockSparseTensors(
        mask_cnt, mask_idx,
        full_cnt if compute_full_blocks else None,
        full_idx if compute_full_blocks else None,
        (tile_m, tile_n), seqlen_q, seqlen_k,
        cdiv(seqlen_q, tile_m), cdiv(seqlen_k, tile_n))


def compute_block_sparsity(
    mask_mod,
    *,
    batch_size: int,
    num_heads: int,
    seqlen_q: int,
    seqlen_k: int,
    tile_m: int = 512,
    tile_n: int = 512,
    aux_tensors=(),
    aux_scalars=(),
    compute_full_blocks: bool = True,
    use_fast_sampling: bool = False,
    device="cuda",
) -> BlockSparseTensors:
    """Per-(b, h, q-tile) live kv-tile lists of `mask_mod`, as the JAX
    package's `compute_block_sparsity`: a tile is PARTIAL (some in-bounds
    element masked, some kept), FULL (every in-bounds element kept) or
    skipped. The mod is called as mask_mod(b, h, q_idx, kv_idx[, aux]) on
    broadcast int32 coordinate tensors on `device`; exact mode sweeps one
    row of q-tiles at a time; `use_fast_sampling` (or
    `mask_mod.use_fast_sampling`) samples each tile's 4 corners and center.
    The lists stay on `device`, and the plan records its grid. On a CUDA
    device the kernels' execution lists for this mod and aux are built too
    (`execution_lists`), so calls with the plan read nothing to the host."""
    dev = resolve_device(device)
    aux = make_aux(aux_tensors, aux_scalars, dev)
    plan = _plan(mask_mod, batch_size=batch_size, num_heads=num_heads,
                 seqlen_q=seqlen_q, seqlen_k=seqlen_k, tile_m=tile_m,
                 tile_n=tile_n, aux=aux, compute_full_blocks=compute_full_blocks,
                 use_fast_sampling=use_fast_sampling, dev=dev)
    if _kernel_ready(dev, plan):
        execution_lists(plan, mask_mod, aux_tensors, aux_scalars, batch_size,
                        num_heads, seqlen_q, seqlen_k, dev)
    return plan


def wrap_varlen_mask_mod(mask_mod, num_user_aux: int, user_has_aux: bool):
    """Per-sequence bounds around a varlen mod (the JAX package's
    `wrap_varlen_mask_mod`): the wrapped mod reads the q and kv lengths
    appended to the user's aux tensors (at num_user_aux and num_user_aux +
    1); `b` is the sequence, q_idx / kv_idx in-sequence positions, and
    elements past a sequence's lengths count as masked."""

    def wrapped(b, h, q_idx, kv_idx, aux):
        lq = aux_at(aux.tensors[num_user_aux], b)
        lk = aux_at(aux.tensors[num_user_aux + 1], b)
        keep = (q_idx < lq) & (kv_idx < lk)
        if mask_mod is not None:
            inner = (mask_mod(b, h, q_idx, kv_idx, aux) if user_has_aux
                     else mask_mod(b, h, q_idx, kv_idx))
            keep = keep & inner
        return keep

    return wrapped


def varlen_lengths(cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k, device):
    """Per-sequence (q lengths, kv lengths) int32 on `device`, with
    seqused_q/k applied as the varlen block-sparse route applies them (a
    used length cuts its sequence's)."""

    def diff(cu):
        cu = torch.as_tensor(cu, device=device).to(torch.int32)
        return cu[1:] - cu[:-1]

    lq = diff(cu_seqlens_q)
    if seqused_q is not None:
        lq = torch.minimum(lq, torch.as_tensor(seqused_q, device=device).int())
    if cu_seqlens_k is None:
        lk = torch.as_tensor(seqused_k, device=device).int()
    else:
        lk = diff(cu_seqlens_k)
        if seqused_k is not None:
            lk = torch.minimum(lk, torch.as_tensor(seqused_k,
                                                   device=device).int())
    return lq, lk


def varlen_key(mask_mod, aux_tensors, aux_scalars, cu_seqlens_q,
               cu_seqlens_k, seqused_q, seqused_k):
    """The execution-list cache key of a varlen call (the user's objects,
    not the per-call wrapped mod)."""
    return (mask_mod, *tuple(aux_tensors or ()), *tuple(aux_scalars or ()),
            cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k)


def compute_block_sparsity_varlen(
    mask_mod,
    *,
    cu_seqlens_q,
    cu_seqlens_k=None,
    seqused_k=None,
    num_heads: int,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
    tile_m: int = 512,
    tile_n: int = 512,
    aux_tensors=(),
    aux_scalars=(),
    compute_full_blocks: bool = True,
    use_fast_sampling: bool = False,
    device="cuda",
):
    """Varlen plan (the JAX package's `compute_block_sparsity_varlen`):
    classification over the left-aligned padded layout, with per-sequence
    bounds folded into the mod. Returns (plan, wrapped mask_mod,
    aux_tensors with the q and kv length tables appended). The lengths stay
    tensors on `device`; the grid (max_seqlen_q/k, unless given) takes one
    host read."""
    dev = resolve_device(device)
    cu_q = torch.as_tensor(cu_seqlens_q, device=dev).to(torch.int32)
    lq = cu_q[1:] - cu_q[:-1]
    if seqused_k is not None:
        lk = torch.as_tensor(seqused_k, device=dev).to(torch.int32)
    else:
        cu_k = torch.as_tensor(cu_seqlens_k, device=dev).to(torch.int32)
        lk = cu_k[1:] - cu_k[:-1]
    sq = int(max_seqlen_q if max_seqlen_q is not None else lq.max())
    sk = int(max_seqlen_k if max_seqlen_k is not None else lk.max())
    user_aux = tuple(aux_tensors or ())
    wrapped = wrap_varlen_mask_mod(mask_mod, len(user_aux),
                                   user_has_aux=bool(user_aux or aux_scalars))
    aux_ext = user_aux + (lq, lk)
    plan = _plan(wrapped, batch_size=lq.shape[0], num_heads=num_heads,
                 seqlen_q=sq, seqlen_k=sk, tile_m=tile_m, tile_n=tile_n,
                 aux=make_aux(aux_ext, aux_scalars, dev),
                 compute_full_blocks=compute_full_blocks,
                 use_fast_sampling=use_fast_sampling, dev=dev)
    if _kernel_ready(dev, plan) and cu_seqlens_k is not None:
        # The lists a varlen call with these very tensors (and no seqused_q)
        # would build.
        lq_c, lk_c = varlen_lengths(cu_seqlens_q, cu_seqlens_k, None,
                                    seqused_k, dev)
        execution_lists(
            plan, wrapped, user_aux + (lq_c, lk_c), aux_scalars, lq.shape[0],
            num_heads, sq, sk, dev,
            key=varlen_key(mask_mod, user_aux, aux_scalars, cu_seqlens_q,
                           cu_seqlens_k, None, seqused_k))
    return plan, wrapped, aux_ext


# -- plan checks -------------------------------------------------------------

def _lists_of(plan: BlockSparseTensors):
    pairs = [("mask_block", plan.mask_block_cnt, plan.mask_block_idx)]
    if plan.full_block_cnt is not None:
        pairs.append(("full_block", plan.full_block_cnt, plan.full_block_idx))
    return pairs


def _check_plan_lists(cnt, idx, name, batch, num_heads, num_m, num_n,
                      block_size, values: bool = True):
    """The JAX package's checks of one list pair: num_m q-tiles, (b, h)
    that broadcast to the call's, and (with `values`, a read of the
    indices) no kv-tile index at or past num_n."""
    for label, a in ((f"{name}_cnt", cnt), (f"{name}_idx", idx)):
        shape = tuple(a.shape)
        if shape[2] != num_m:
            raise ValueError(
                f"block-sparse plan {label} covers {shape[2]} q-blocks but "
                f"the call's seqlen_q needs {num_m} at tile_m={block_size[0]}"
                " — the plan was built for a different seqlen_q or tile size")
        if batch % shape[0] or num_heads % shape[1]:
            raise ValueError(
                f"block-sparse plan {label} (b={shape[0]}, h={shape[1]}) "
                f"does not broadcast to the call's (b={batch}, h={num_heads})")
    if not values:
        return
    cnt = _as_int32(cnt, "cpu")
    idx = _as_int32(idx, "cpu")
    valid = torch.arange(idx.shape[3])[None, None, None] < cnt[..., None]
    if valid.any():
        mx = int(idx[valid].max())
        if mx >= num_n:
            raise ValueError(
                f"block-sparse plan references kv-block {mx} but the call's "
                f"seqlen_k has only {num_n} kv-blocks at tile_n="
                f"{block_size[1]} — the plan was built for a different "
                "seqlen_k or tile size")


def check_plan(plan: BlockSparseTensors, batch: int, num_heads: int,
               seqlen_q: int, seqlen_k: int) -> None:
    """Refuse a plan that does not fit the call, reading no values: a
    recorded grid must equal the call's exactly (the JAX package accepts a
    plan built for a shorter seqlen_k as long as its indices fit); and every
    plan gets the JAX shape checks. A plan without a recorded grid gets the
    JAX index check when its lists are first densified (`live_tiles`)."""
    tm, tn = plan.block_size
    nm, nn = cdiv(seqlen_q, tm), cdiv(seqlen_k, tn)
    if plan.seqlen_q is not None:
        built = (plan.seqlen_q, plan.seqlen_k, plan.num_m, plan.num_n)
        if built != (seqlen_q, seqlen_k, nm, nn):
            raise ValueError(
                f"block-sparse plan was built for seqlen_q={built[0]}, "
                f"seqlen_k={built[1]} ({built[2]} x {built[3]} tiles of "
                f"{tm} x {tn}) but the call has seqlen_q={seqlen_q}, "
                f"seqlen_k={seqlen_k} — the plan was built for a different "
                "grid")
    for name, cnt, idx in _lists_of(plan):
        _check_plan_lists(cnt, idx, name, batch, num_heads, nm, nn,
                          plan.block_size, values=False)


def live_tiles(plan: BlockSparseTensors, batch: int, num_heads: int,
               seqlen_q: int, seqlen_k: int, device):
    """(partial, full) bool (batch, num_heads, nm, nn) on `device`: the
    plan's lists densified and broadcast as np.tile would (a plan without a
    recorded grid first gets the JAX index check, one read of its
    lists)."""
    tm, tn = plan.block_size
    nm, nn = cdiv(seqlen_q, tm), cdiv(seqlen_k, tn)

    def densify(name, cnt, idx):
        if plan.num_n is None:
            _check_plan_lists(cnt, idx, name, batch, num_heads, nm, nn,
                              plan.block_size)
        cnt = _as_int32(cnt, device).long()
        idx = _as_int32(idx, device).long()
        b, h, m, mx = idx.shape
        valid = torch.arange(mx, device=device) < cnt[..., None]
        safe = torch.where(valid, idx, nn).clamp(0, nn)
        out = torch.zeros((b, h, m, nn + 1), dtype=torch.bool, device=device)
        out.scatter_(3, safe, valid)
        out = out[..., :nn]
        reps = (batch // b, num_heads // h, 1, 1)
        return out.repeat(reps) if reps[:2] != (1, 1) else out

    lists = {name: densify(name, cnt, idx) for name, cnt, idx in _lists_of(plan)}
    partial = lists["mask_block"]
    full = lists.get("full_block", torch.zeros_like(partial))
    return partial, full


# -- the expanded keep-mask and the plain versions ---------------------------

def keep_chunks(plan: BlockSparseTensors, batch: int, num_heads: int,
                seqlen_q: int, seqlen_k: int, *, mask_mod=None,
                aux_tensors=(), aux_scalars=(), device=None,
                max_elems: int = 1 << 26):
    """Yields (b, h, rows slice, keep (rows, seqlen_k) bool) over every
    batch row, head and band of at most `max_elems` elements: the function
    the kernels compute, element by element. keep = in bounds and (a FULL
    tile, or a PARTIAL tile where the mod keeps the element; without a mod
    a PARTIAL tile keeps all)."""
    partial, full = live_tiles(plan, batch, num_heads, seqlen_q, seqlen_k,
                               device)
    aux = make_aux(aux_tensors, aux_scalars, device)
    tm, tn = plan.block_size
    step = max(1, max_elems // max(seqlen_k, 1))
    kv = torch.arange(seqlen_k, dtype=torch.int32, device=device)[None]
    i32 = dict(dtype=torch.int32, device=device)
    for bi in range(batch):
        for hi in range(num_heads):
            rows_p = partial[bi, hi].repeat_interleave(tn, 1)[:, :seqlen_k]
            rows_f = full[bi, hi].repeat_interleave(tn, 1)[:, :seqlen_k]
            for r0 in range(0, seqlen_q, step):
                r1 = min(r0 + step, seqlen_q)
                q = torch.arange(r0, r1, **i32)[:, None]
                p, f = rows_p[q[:, 0] // tm], rows_f[q[:, 0] // tm]
                mod = p
                if mask_mod is not None:
                    mod = p & _keep_of(mask_mod, aux, torch.tensor(bi, **i32),
                                       torch.tensor(hi, **i32), q, kv)
                # A tile in both lists takes the mod, as in the JAX kernels.
                yield bi, hi, slice(r0, r1), torch.where(p, mod, f)


def block_sparse_keep_mask(plan, batch, num_heads, seqlen_q, seqlen_k, *,
                           mask_mod=None, aux_tensors=(), aux_scalars=(),
                           device=None) -> torch.Tensor:
    """The whole expanded keep-mask, (batch, num_heads, seqlen_q, seqlen_k)
    bool (for oracles and small shapes)."""
    keep = torch.zeros((batch, num_heads, seqlen_q, seqlen_k),
                       dtype=torch.bool, device=device)
    for bi, hi, rows, k in keep_chunks(
            plan, batch, num_heads, seqlen_q, seqlen_k, mask_mod=mask_mod,
            aux_tensors=aux_tensors, aux_scalars=aux_scalars, device=device):
        keep[bi, hi, rows] = k
    return keep


def _chunks(q, k, plan, mask_mod, aux_tensors, aux_scalars):
    b, h, sq = q.shape[:3]
    return keep_chunks(plan, b, h, sq, k.shape[2], mask_mod=mask_mod,
                       aux_tensors=aux_tensors, aux_scalars=aux_scalars,
                       device=q.device)


def flash_attention_blocksparse_fwd_ref(
    q, k, v, block_sparse, *, mask_mod=None, aux_tensors=(), aux_scalars=(),
    softmax_scale=None, softcap=0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 9, in fp32: (out (b, h, sq, dv) in
    q's dtype, lse (b, h, sq) fp32); a row that keeps nothing gives out 0,
    lse -inf."""
    plan = as_plan(block_sparse)
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    scale = _scale(d, softmax_scale)
    out = torch.zeros((b, h, sq, v.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.full((b, h, sq), float("-inf"), dtype=torch.float32,
                     device=q.device)
    for bi, hi, rows, keep in _chunks(q, k, plan, mask_mod, aux_tensors,
                                      aux_scalars):
        g = hi // group
        s, _ = scores(q[bi, hi, rows], k[bi, g], scale, softcap)
        s = s.masked_fill(~keep, float("-inf"))
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


def _p_ds(q, k, v, do, lse, delta, bi, hi, g, rows, keep, scale, softcap):
    """P, dP and dS (delta=None: dS not formed) of one band, fp32."""
    s, t = scores(q[bi, hi, rows], k[bi, g], scale, softcap)
    lse_r = lse[bi, hi, rows, None]
    keep = keep & torch.isfinite(lse_r)
    p = torch.where(keep, torch.exp(s - lse_r), torch.zeros_like(s))
    dp = torch.matmul(do[bi, hi, rows].float(), v[bi, g].float().T)
    if delta is None:
        return p, dp, None
    ds = p * (dp - delta[bi, hi, rows, None]) * scale
    return p, dp, (ds if t is None else ds * (1.0 - t * t))


def _blocksparse_dq_ref(q, k, v, do, lse, block_sparse, *, mask_mod=None,
                        aux_tensors=(), aux_scalars=(), softmax_scale=None,
                        softcap=0.0):
    """Plain version of kernel 11: (dq in q's dtype, delta (b, h, sq) fp32
    = sum_j P dP), P recomputed from the scores and the LSE, in fp32."""
    plan = as_plan(block_sparse)
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    scale = _scale(d, softmax_scale)
    dq = torch.zeros_like(q)
    delta = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for bi, hi, rows, keep in _chunks(q, k, plan, mask_mod, aux_tensors,
                                      aux_scalars):
        g = hi // group
        p, dp, _ = _p_ds(q, k, v, do, lse, None, bi, hi, g, rows, keep, scale,
                         softcap)
        delta[bi, hi, rows] = (p * dp).sum(-1)
        _, _, ds = _p_ds(q, k, v, do, lse, delta, bi, hi, g, rows, keep, scale,
                         softcap)
        dq[bi, hi, rows] = torch.matmul(ds, k[bi, g].float()).to(q.dtype)
    return dq, delta


def _blocksparse_dkv_ref(q, k, v, do, lse, delta, block_sparse, *,
                         mask_mod=None, aux_tensors=(), aux_scalars=(),
                         softmax_scale=None, softcap=0.0):
    """Plain version of kernel 10: (dk, dv) in k's and v's dtypes, each kv
    head's group of query heads summed in fp32."""
    plan = as_plan(block_sparse)
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    scale = _scale(d, softmax_scale)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for bi, hi, rows, keep in _chunks(q, k, plan, mask_mod, aux_tensors,
                                      aux_scalars):
        g = hi // group
        p, _, ds = _p_ds(q, k, v, do, lse, delta, bi, hi, g, rows, keep, scale,
                         softcap)
        dv[bi, g] += torch.matmul(p.T, do[bi, hi, rows].float())
        dk[bi, g] += torch.matmul(ds.T, q[bi, hi, rows].float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- execution lists (the kernels' input) ------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ExecLists:
    """The kernels' lists for one call shape (batch, heads, seqlen_q,
    seqlen_k), on the device. Entries are int32 (index << 2) | mode, mode
    0 interior, 1 bounds, 2 words; `wofs` gives a mode-2 entry's group of
    64 words in `words` (n, 64) int64 (row r of the sub-tile at [g, r], bit
    c for column c).

    counts (b, h, nqb), tiles / wofs (b, h, nqb, nkb + 1): per 64-row
    block the live 64-column sub-tiles ascending (kernels 9 and 11);
    inv_counts (b, h, nkb), inv_rows / inv_wofs (b, h, nkb, nqb + 1): per
    64-key block the live 64-row sub-blocks of each query head (kernel
    10). The last entry of every list is scratch."""

    counts: torch.Tensor
    tiles: torch.Tensor
    wofs: torch.Tensor
    inv_counts: torch.Tensor
    inv_rows: torch.Tensor
    inv_wofs: torch.Tensor
    words: torch.Tensor


def _low_bits(n: torch.Tensor) -> torch.Tensor:
    """int64 words with the low n bits set, n in [0, 64]."""
    ones = torch.full_like(n, -1)
    return torch.where(n >= 64, ones, torch.bitwise_not(ones << n.clamp(max=63)))


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 64) bool -> (...) int64 with bit c = bits[..., c]."""
    b8 = bits.reshape(bits.shape[:-1] + (8, 8)).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    octets = (b8 << shifts).sum(-1, dtype=torch.uint8).contiguous()
    return octets.view(torch.int64)[..., 0]


def _tile_words(mask_mod, aux, tiles: torch.Tensor, tm: int, tn: int,
                seqlen_q: int, seqlen_k: int) -> torch.Tensor:
    """The per-row words of every sub-tile of the listed plan tiles
    (tiles (P, 4) int64 rows of (b, h, q-tile, kv-tile)): (P, tm / 64, tn
    / 64, 64) int64, the mod ANDed with the bounds, a few tiles at a time."""
    dev = tiles.device
    rm, rn = tm // SUB, tn // SUB
    words = torch.empty((tiles.shape[0], rm, rn, SUB), dtype=torch.int64,
                        device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ar_m = torch.arange(tm, **i32).reshape(1, -1, 1)
    ar_n = torch.arange(tn, **i32).reshape(1, 1, -1)
    step = max(1, (1 << 24) // (tm * tn))
    for c0 in range(0, tiles.shape[0], step):
        t = tiles[c0:c0 + step].to(torch.int32)
        c = t.shape[0]
        q_idx = t[:, 2].reshape(-1, 1, 1) * tm + ar_m
        kv_idx = t[:, 3].reshape(-1, 1, 1) * tn + ar_n
        keep = _keep_of(mask_mod, aux, t[:, 0].reshape(-1, 1, 1),
                        t[:, 1].reshape(-1, 1, 1), q_idx, kv_idx)
        keep = keep & (q_idx < seqlen_q) & (kv_idx < seqlen_k)
        keep = keep.reshape(c, rm, SUB, rn, SUB).permute(0, 1, 3, 2, 4)
        words[c0:c0 + c] = _pack_bits(keep)
    return words


def _kernel_ready(dev: torch.device, plan: BlockSparseTensors) -> bool:
    return (dev.type == "cuda" and plan.block_size[0] % SUB == 0
            and plan.block_size[1] % SUB == 0)


def _check_tiles(plan: BlockSparseTensors) -> None:
    tm, tn = plan.block_size
    if tm % SUB or tn % SUB:
        raise NotImplementedError(
            f"block-sparse plan tiles {tm} x {tn} are not multiples of 64 on "
            "the card: ROADMAP queue 2, kernels 9-11: plan tiles not a "
            "multiple of 64")


def build_execution_lists(plan: BlockSparseTensors, mask_mod, aux,
                          batch: int, num_heads: int, seqlen_q: int,
                          seqlen_k: int, device) -> ExecLists:
    """The kernels' lists (ExecLists) of `plan` for a call of (batch,
    num_heads, seqlen_q, seqlen_k) with `mask_mod` and `aux` (AuxData or
    None); one host read, the number of partial plan tiles. Counted in
    `build_execution_lists.builds`."""
    _check_tiles(plan)
    tm, tn = plan.block_size
    rm, rn = tm // SUB, tn // SUB
    partial, full = live_tiles(plan, batch, num_heads, seqlen_q, seqlen_k,
                               device)
    nm, nn = partial.shape[2:]
    nqb, nkb = cdiv(seqlen_q, SUB), cdiv(seqlen_k, SUB)
    i64 = dict(dtype=torch.int64, device=device)
    row0 = torch.arange(nm * rm, **i64) * SUB
    col0 = torch.arange(nn * rn, **i64) * SUB
    inside = (row0 < seqlen_q)[:, None] & (col0 < seqlen_k)[None]
    interior = (((row0 + SUB) <= seqlen_q)[:, None]
                & ((col0 + SUB) <= seqlen_k)[None])
    bounds_mode = torch.where(interior, 0, 1)
    if mask_mod is None:
        plain, with_mod = full | partial, torch.zeros_like(partial)
    else:
        plain, with_mod = full & ~partial, partial
    sub_plain = plain.repeat_interleave(rm, 2).repeat_interleave(rn, 3)
    code = torch.where(sub_plain & inside, bounds_mode, -1)
    words = torch.zeros((1, SUB), **i64)
    if mask_mod is not None:
        tiles = torch.nonzero(with_mod)  # the one host read
        if tiles.shape[0]:
            words = _tile_words(mask_mod, aux, tiles, tm, tn, seqlen_q,
                                seqlen_k)
            # The bounds words of those sub-tiles: mode 0/1 where equal.
            r = (tiles[:, 2, None, None] * tm
                 + torch.arange(rm, **i64)[None, :, None] * SUB
                 + torch.arange(SUB, **i64)[None, None])        # (P, rm, 64)
            cstart = (tiles[:, 3, None] * tn
                      + torch.arange(rn, **i64)[None] * SUB)   # (P, rn)
            bw = torch.where((r < seqlen_q)[:, :, None],
                             _low_bits((seqlen_k - cstart).clamp(0, SUB))[
                                 :, None, :, None],
                             torch.zeros((), **i64))           # (P, rm, rn, 64)
            dead = (words == 0).all(-1)
            same = (words == bw).all(-1)
            group = torch.arange(words.shape[0] * rm * rn, **i64).reshape(
                words.shape[:3])
            sub_mode = bounds_mode.reshape(nm, rm, nn, rn).permute(0, 2, 1, 3)[
                tiles[:, 2], tiles[:, 3]]                     # (P, rm, rn)
            vals = torch.where(dead, -1, torch.where(same, sub_mode,
                                                     2 | (group << 2)))
            view = code.view(batch, num_heads, nm, rm, nn, rn).permute(
                0, 1, 2, 4, 3, 5)
            view[tiles[:, 0], tiles[:, 1], tiles[:, 2], tiles[:, 3]] = vals
            words = words.reshape(-1, SUB)
    code = code[:, :, :nqb, :nkb]

    def lists(c, n):
        flat = c.reshape(-1, c.shape[-1])
        ids = torch.arange(c.shape[-1], **i64).expand_as(flat)
        (ent, wofs), counts = _compact(
            flat >= 0, ((ids << 2) | (flat & 3), flat >> 2), n)
        shape = c.shape[:3]
        return (counts.reshape(shape), ent.to(torch.int32).reshape(shape + (-1,)),
                wofs.clamp_min(0).to(torch.int32).reshape(shape + (-1,)))

    counts, tiles_l, wofs = lists(code, nkb)
    inv_counts, inv_rows, inv_wofs = lists(code.transpose(2, 3), nqb)
    build_execution_lists.builds += 1
    return ExecLists(counts, tiles_l, wofs, inv_counts, inv_rows, inv_wofs,
                     words.contiguous())


build_execution_lists.builds = 0

_CACHE_SIZE = 8
_cache: list = []  # (objects kept alive, key, lists), most recent last


def _key_part(o):
    if o is None or isinstance(o, (bool, int, float, str)):
        return ("value", o)
    return ("id", id(o), getattr(o, "_version", None))


def execution_lists(plan: BlockSparseTensors, mask_mod, aux_tensors,
                    aux_scalars, batch: int, num_heads: int, seqlen_q: int,
                    seqlen_k: int, device, *, key=None) -> ExecLists:
    """`build_execution_lists`, cached per (plan lists, `key`, call shape):
    `key` defaults to (mask_mod, *aux_tensors, *aux_scalars). Tensors and
    callables count by identity (and a tensor by its version, so an
    in-place change to an aux table builds anew), numbers by value."""
    objs = (plan.mask_block_cnt, plan.mask_block_idx, plan.full_block_cnt,
            plan.full_block_idx) + tuple(
                key if key is not None
                else (mask_mod, *tuple(aux_tensors or ()),
                      *tuple(aux_scalars or ())))
    full_key = (tuple(_key_part(o) for o in objs), tuple(plan.block_size),
                batch, num_heads, seqlen_q, seqlen_k, str(torch.device(device)))
    for i, (_, k, found) in enumerate(_cache):
        if k == full_key:
            _cache.append(_cache.pop(i))
            return found
    found = build_execution_lists(
        plan, mask_mod, make_aux(tuple(aux_tensors or ()),
                                 tuple(aux_scalars or ()), device),
        batch, num_heads, seqlen_q, seqlen_k, device)
    _cache.append((objs, full_key, found))
    del _cache[:-_CACHE_SIZE]
    return found


# -- kernels -----------------------------------------------------------------

def check_score_mod(score_mod) -> None:
    if score_mod is not None:
        raise NotImplementedError(
            "score_mod with block_sparse_tensors is not ported yet: ROADMAP "
            "queue 2, kernels 9-11: score_mod catalog")


def _check_cuda(q, k, v, plan):
    if v.shape[3] != q.shape[3]:
        raise NotImplementedError(
            "block-sparse attention with head_dim_v != head_dim is not ported "
            "to the card yet: ROADMAP queue 2, kernels 9-11: dv != d")
    if q.dtype == torch.float32:
        raise NotImplementedError(
            "block-sparse attention takes bf16/fp16 on the card; fp32 is not "
            "ported yet: ROADMAP queue 2, kernels 9-11: fp32 inputs")
    check_shapes(q, k, v)
    check_kernel_inputs(q.shape[3], q.shape[1], k.shape[1], q=q, k=k, v=v)
    _check_tiles(plan)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def prepare_lists(q, k, v, plan: BlockSparseTensors, *, mask_mod=None,
                  aux_tensors=(), aux_scalars=(), key=None
                  ) -> Optional[ExecLists]:
    """Checks a call and returns the execution lists its kernels walk
    (None for CPU tensors, whose plain versions need none): the plan
    against the call's grid, the inputs against what the kernels take,
    then `execution_lists` (cached; `key` as there)."""
    b, h, sq = q.shape[:3]
    check_plan(plan, b, h, sq, k.shape[2])
    if q.device.type == "cpu":
        return None
    _check_cuda(q, k, v, plan)
    return execution_lists(plan, mask_mod, aux_tensors, aux_scalars, b, h, sq,
                           k.shape[2], q.device, key=key)


def _call_lists(q, k, v, plan, mask_mod, aux_tensors, aux_scalars, lists):
    if lists is not None:
        return lists
    return prepare_lists(q, k, v, plan, mask_mod=mask_mod,
                         aux_tensors=aux_tensors, aux_scalars=aux_scalars)


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("block_sparse_fwd").block_sparse_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


def bs_fwd_walks(lists: ExecLists) -> dict:
    """Plain mirror of kernel 9's walks over one call's forward lists: {(b,
    head, pair): steps}, the block of 64-row blocks 2 pair and 2 pair + 1
    walking the ascending merge of their two lists (thread 0's two-pointer
    merge), each step (key tile, (mode, word group) of block 2 pair or
    None, the same of block 2 pair + 1 or None); warpgroup i owns block
    2 pair + i. The second list of a last pair with an odd number of row
    blocks is empty: the kernel reads no count past a head's row."""
    b, h, nqb = lists.counts.shape
    counts = lists.counts.reshape(-1).tolist()
    tiles = lists.tiles.reshape(len(counts), -1).tolist()
    wofs = lists.wofs.reshape(len(counts), -1).tolist()
    walks = {}
    for r in range(b * h):
        for pair in range(cdiv(nqb, 2)):
            heads = []
            for m in (2 * pair, 2 * pair + 1):
                at = r * nqb + m
                n = counts[at] if m < nqb else 0
                heads.append({e >> 2: (e & 3, w) for e, w in
                              zip(tiles[at][:n], wofs[at][:n])} if n else {})
            walks[r // h, r % h, pair] = [
                (t, heads[0].get(t), heads[1].get(t))
                for t in sorted(set(heads[0]) | set(heads[1]))]
    return walks


def fwd_ready(q, k, v):
    """q, k, v as kernel 9's TMA tensor maps take them: each itself, or a
    contiguous copy (`tma_ready`), counted in
    `flash_attention_blocksparse_fwd.tma_copies`."""
    return tuple(tma_ready(x, flash_attention_blocksparse_fwd)
                 for x in (q, k, v))


def flash_attention_blocksparse_fwd(
    q, k, v, block_sparse, *, mask_mod=None, score_mod=None, aux_tensors=(),
    aux_scalars=(), softmax_scale=None, softcap=0.0,
    lists: Optional[ExecLists] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 9: block-sparse forward, q (b, h, sq, d), k/v (b, hk, sk, d).
    Returns (out in q's dtype, lse (b, h, sq) fp32). CUDA tensors launch
    csrc/block_sparse_fwd.cu over the execution lists (`lists`, else the
    cached ones; counted in `flash_attention_blocksparse_fwd.launches`);
    CPU tensors take `flash_attention_blocksparse_fwd_ref`."""
    check_score_mod(score_mod)
    plan = as_plan(block_sparse)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    check_plan(plan, b, h, sq, sk)
    kw = dict(mask_mod=mask_mod, aux_tensors=aux_tensors,
              aux_scalars=aux_scalars, softmax_scale=softmax_scale,
              softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_blocksparse_fwd_ref(q, k, v, plan, **kw)
    q, k, v = fwd_ready(q, k, v)
    _check_cuda(q, k, v, plan)
    lists = _call_lists(q, k, v, plan, mask_mod, aux_tensors, aux_scalars,
                        lists)
    if lists.words.data_ptr() % 16:
        raise ValueError("the execution lists' words must start on a 16-byte "
                         "boundary (the kernel's bulk copies)")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _fwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides_arg(q, k, v, out), lists.counts.data_ptr(),
        lists.tiles.data_ptr(), lists.wofs.data_ptr(), lists.words.data_ptr(),
        lists.tiles.shape[-1], b, h, k.shape[1], sq, sk, d,
        _scale(d, softmax_scale), float(softcap), int(q.dtype == torch.float16),
        _stream(q))
    if rc == -2:
        raise RuntimeError("block_sparse_fwd: cuTensorMapEncodeTiled refused "
                           "a tensor map")
    if rc != 0:
        raise RuntimeError(f"block_sparse_fwd launch failed: CUDA error {rc}")
    flash_attention_blocksparse_fwd.launches += 1
    return out, lse


flash_attention_blocksparse_fwd.launches = 0
flash_attention_blocksparse_fwd.tma_copies = 0


@functools.lru_cache(maxsize=None)
def _bwd_kernels() -> ctypes.CDLL:
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library("block_sparse_bwd")
    strides = ctypes.POINTER(ctypes.c_longlong)
    tail = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.block_sparse_bwd_dq.argtypes = (
        [ctypes.c_void_p] * 7 + [strides] + tail)
    lib.block_sparse_bwd_dkv.argtypes = (
        [ctypes.c_void_p] * 8 + [strides] + tail)
    lib.block_sparse_bwd_dq.restype = ctypes.c_int
    lib.block_sparse_bwd_dkv.restype = ctypes.c_int
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


def flash_attention_blocksparse_bwd_dq(
    q, k, v, do, lse, block_sparse, *, mask_mod=None, score_mod=None,
    aux_tensors=(), aux_scalars=(), softmax_scale=None, softcap=0.0,
    lists: Optional[ExecLists] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 11: (dq in q's dtype, delta (b, h, sq) fp32 = sum_j P dP).
    CUDA tensors launch block_sparse_bwd_dq over the forward's lists
    (counted in `flash_attention_blocksparse_bwd_dq.launches`; inputs its
    TMA tensor maps cannot take are copied first, counted in
    `.tma_copies`); CPU tensors take `_blocksparse_dq_ref`."""
    check_score_mod(score_mod)
    plan = as_plan(block_sparse)
    b, h, sq, d = q.shape
    check_plan(plan, b, h, sq, k.shape[2])
    kw = dict(mask_mod=mask_mod, aux_tensors=aux_tensors,
              aux_scalars=aux_scalars, softmax_scale=softmax_scale,
              softcap=softcap)
    if q.device.type == "cpu":
        return _blocksparse_dq_ref(q, k, v, do, lse, plan, **kw)
    owner = flash_attention_blocksparse_bwd_dq
    q, k, v, do = (tma_ready(x, owner) for x in (q, k, v, do))
    _check_cuda(q, k, v, plan)
    _check_bwd(q, do, dict(lse=lse))
    lists = _call_lists(q, k, v, plan, mask_mod, aux_tensors, aux_scalars,
                        lists)
    if lists.words.data_ptr() % 16:
        raise ValueError("the execution lists' words must start on a 16-byte "
                         "boundary (the kernel's bulk copies)")
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _bwd_kernels().block_sparse_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        strides_arg(q, k, v, do, dq), lists.counts.data_ptr(),
        lists.tiles.data_ptr(), lists.wofs.data_ptr(), lists.words.data_ptr(),
        lists.tiles.shape[-1], b, h, k.shape[1], sq, k.shape[2], d,
        _scale(d, softmax_scale), float(softcap), int(q.dtype == torch.float16),
        _stream(q))
    if rc == -2:
        raise RuntimeError("block_sparse_bwd_dq: cuTensorMapEncodeTiled "
                           "refused a tensor map")
    if rc != 0:
        raise RuntimeError(f"block_sparse_bwd_dq launch failed: CUDA error {rc}")
    owner.launches += 1
    return dq, delta


flash_attention_blocksparse_bwd_dq.launches = 0
flash_attention_blocksparse_bwd_dq.tma_copies = 0


def flash_attention_blocksparse_bwd_dkv(
    q, k, v, do, lse, delta, block_sparse, *, mask_mod=None, score_mod=None,
    aux_tensors=(), aux_scalars=(), softmax_scale=None, softcap=0.0,
    lists: Optional[ExecLists] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10: (dk, dv) in k's dtype, each GQA group summed in-kernel.
    CUDA tensors launch block_sparse_bwd_dkv over the inverse lists
    (counted in `flash_attention_blocksparse_bwd_dkv.launches`; inputs its
    TMA tensor maps cannot take, q, k, v, dO, the LSE or delta, are copied
    first, counted in `.tma_copies`); CPU tensors take
    `_blocksparse_dkv_ref`."""
    check_score_mod(score_mod)
    plan = as_plan(block_sparse)
    b, h, sq, d = q.shape
    check_plan(plan, b, h, sq, k.shape[2])
    kw = dict(mask_mod=mask_mod, aux_tensors=aux_tensors,
              aux_scalars=aux_scalars, softmax_scale=softmax_scale,
              softcap=softcap)
    if q.device.type == "cpu":
        return _blocksparse_dkv_ref(q, k, v, do, lse, delta, plan, **kw)
    owner = flash_attention_blocksparse_bwd_dkv
    q, k, v, do = (tma_ready(x, owner) for x in (q, k, v, do))
    _check_cuda(q, k, v, plan)
    _check_bwd(q, do, dict(lse=lse, delta=delta))
    lse, delta = stats_ready(lse, owner), stats_ready(delta, owner)
    lists = _call_lists(q, k, v, plan, mask_mod, aux_tensors, aux_scalars,
                        lists)
    if lists.words.data_ptr() % 16:
        raise ValueError("the execution lists' words must start on a 16-byte "
                         "boundary (the kernel's bulk copies)")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bwd_kernels().block_sparse_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        strides_arg(q, k, v, do, dk, dv), lists.inv_counts.data_ptr(),
        lists.inv_rows.data_ptr(), lists.inv_wofs.data_ptr(),
        lists.words.data_ptr(), lists.inv_rows.shape[-1], b, h, k.shape[1],
        sq, k.shape[2], d, _scale(d, softmax_scale), float(softcap),
        int(q.dtype == torch.float16), _stream(q))
    if rc == -2:
        raise RuntimeError("block_sparse_bwd_dkv: b * h * sq passes 2^31 or "
                           "cuTensorMapEncodeTiled refused a tensor map")
    if rc != 0:
        raise RuntimeError(f"block_sparse_bwd_dkv launch failed: CUDA error {rc}")
    owner.launches += 1
    return dk, dv


flash_attention_blocksparse_bwd_dkv.launches = 0
flash_attention_blocksparse_bwd_dkv.tma_copies = 0


def flash_attention_blocksparse_bwd(
    q, k, v, lse, do, block_sparse, *, mask_mod=None, score_mod=None,
    aux_tensors=(), aux_scalars=(), softmax_scale=None, softcap=0.0,
    lists: Optional[ExecLists] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-sparse backward: (dq, dk, dv). Kernel 11 first (dq and delta =
    sum_j P dP), then kernel 10 with that delta. Unlike the JAX function it
    takes no `out` (delta comes from the dQ kernel)."""
    kw = dict(mask_mod=mask_mod, score_mod=score_mod, aux_tensors=aux_tensors,
              aux_scalars=aux_scalars, softmax_scale=softmax_scale,
              softcap=softcap, lists=lists)
    dq, delta = flash_attention_blocksparse_bwd_dq(q, k, v, do, lse,
                                                   block_sparse, **kw)
    dk, dv = flash_attention_blocksparse_bwd_dkv(q, k, v, do, lse, delta,
                                                 block_sparse, **kw)
    return dq, dk, dv
