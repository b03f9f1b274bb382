"""Packed variable-length flash attention, forward and backward (counterpart
of flash_attn_tpu/kernels/flash_varlen.py).

Sequences are packed along one token axis, (total, h, d) ["thd"] or
(h, total, d) ["hsd"], with boundaries in `cu_seqlens` (nseq + 1, int32).
Within a sequence, masking is the dense kernels' bottom-right-aligned rule
with the sequence's own lengths: `seqused_q`/`seqused_k` cut a sequence to
its first used rows/keys, and the diagonal aligns used_k against used_q.
`make_varlen_metadata` gives every packed query row its visible column
interval [lo, hi] in packed coordinates; that is the definition the plain
versions use.

Three kernels, each with a `.launches` count and a plain PyTorch version
that the wrapper takes for CPU tensors:

  * `flash_attention_varlen_fwd` (`csrc/flash_fwd.cu` flash_varlen_fwd,
    the Hopper kernel of `csrc/flash_varlen_fwd_sm90.cuh`; plain
    `flash_attention_varlen_fwd_ref`). K/V packed, or read from page pools
    (`kv_pools`) through a page table (`block_table`, vLLM's form).
    `trace_schedule` lets a check on the card read the blocks of its flat
    tile schedule;
  * `flash_attention_varlen_bwd_dq` (`csrc/flash_bwd.cu`
    flash_varlen_bwd_dq, the Hopper kernel of
    `csrc/flash_varlen_bwd_sm90.cuh`; plain `_varlen_dq_ref`), which also
    returns delta = sum_j P dP per row, as the dense dQ kernel does;
    `trace_schedule(..., kernel="dq")` reads its flat tile schedule;
  * `flash_attention_varlen_bwd_dkv` (flash_varlen_bwd_dkv, the Hopper
    kernel of `csrc/flash_varlen_bwd_sm90.cuh`; plain `_varlen_dkv_ref`),
    GQA groups summed in-kernel; `trace_schedule(..., kernel="dkv")` reads
    its flat schedule of key tiles.

ALiBi slopes (h,), attention_chunk and dropout (the JAX varlen kernel's
features, `varlen_features`) run in the three kernels' feature instances
(`csrc/flash_varlen_features.cu` for kernel 6, packed or on pools;
`csrc/flash_varlen_bwd_features.cu` for kernels 7-8), counted in each
wrapper's `.feature_launches` beside `.launches`; the plain versions take
them as `features`. Their rules are kernels 1-3's in packed coordinates:
ALiBi's distance from a row's bottom-right diagonal, the chunk in the
sequence's key positions, the keep mask of batch row 0 at the packed query
row and key.

The three Hopper kernels' grids come from the shapes alone (the packed
row or key count and the sequence count). Only the forward on pools whose
page size is not a multiple of 8 (the sm80 route, `launches_sm80`) is sized
by the longest sequence (`max_seqlen_q`), from the caller, from a
`VarlenPlan`, or else from one host read of cu_seqlens_q; that kernel
covers every tile of every sequence whatever that size, so a wrong size
costs time, never the answer. The TPU worklist (`build_worklist`, page ids
in its flags) is a Mosaic grid device and is not ported.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from flash_attn_tpu_torch.kernels.common import (
    Features,
    keep_threshold,
    make_features,
    raise_unported,
)
from flash_attn_tpu_torch.kernels.flash_bwd import _bwd_dkv_ref, _bwd_dq_ref
from flash_attn_tpu_torch.kernels.flash_decode_multipage import _fused_split
from flash_attn_tpu_torch.kernels.flash_fwd import (
    _scale,
    check_kernel_inputs,
    flash_attention_fwd_ref,
    stats_ready,
    tma_ready,
)

# Arguments of the JAX varlen signature the port does not take yet:
# name -> (value that means "not used", ROADMAP item).
_UNPORTED = {
    "qv": (None, "queue 1, item 10: MLA (qv)"),
    "attn_bias": (None, "queue 1, item 14: additive bias and dBias on "
                        "kernels 1-3 and 6-8"),
    "bias_grad": (False, "queue 1, item 14: additive bias and dBias on "
                         "kernels 1-3 and 6-8"),
    "score_mod": (None, "queue 2, kernels 6-8: score_mod/mask_mod, with "
                        "kernel 9's compiled catalog"),
    "mask_mod": (None, "queue 2, kernels 6-8: score_mod/mask_mod, with "
                       "kernel 9's compiled catalog"),
    "aux_tensors": ((), "queue 2, kernels 6-8: score_mod/mask_mod, with "
                        "kernel 9's compiled catalog"),
    "aux_scalars": ((), "queue 2, kernels 6-8: score_mod/mask_mod, with "
                        "kernel 9's compiled catalog"),
    "cp_world_size": (1, "queue 1, item 12: context parallelism"),
    "cp_rank": (0, "queue 1, item 12: context parallelism"),
    "cp_tot_seqused_k": (None, "queue 1, item 12: context parallelism"),
}


def check_unported(**extras) -> None:
    raise_unported(_UNPORTED, {
        k: tuple(v or ()) if k.startswith("aux_") else v
        for k, v in extras.items()})


def varlen_features(h: int, *, alibi_slopes=None, attention_chunk: int = 0,
                    dropout_p: float = 0.0, dropout_seed=None
                    ) -> Optional[Features]:
    """The varlen kernels' features as `Features` (None when none is set):
    ALiBi slopes (h,), attention_chunk, and dropout with its seed (None is
    0, as in the JAX package). Slopes of another shape raise ValueError,
    where the JAX varlen kernel asserts per-head slopes
    (flash_varlen.py:1394)."""
    if alibi_slopes is not None and tuple(alibi_slopes.shape) != (h,):
        raise ValueError(f"varlen ALiBi takes per-head slopes ({h},), got "
                         f"{tuple(alibi_slopes.shape)}")
    return make_features(alibi_slopes=alibi_slopes,
                         attention_chunk=int(attention_chunk),
                         dropout_p=float(dropout_p), dropout_seed=dropout_seed)


def varlen_window(window_size, causal: bool) -> Tuple[int, int]:
    """(left, right) as the JAX varlen planner reads them: causal bounds the
    right edge at the diagonal only when no right edge is given
    (flash_varlen.py:156); a negative value is unbounded."""
    left, right = (-1 if w is None else int(w) for w in window_size)
    if causal and right < 0:
        right = 0
    return max(left, -1), max(right, -1)


# ---------------------------------------------------------------------------
# Host-side metadata and plans.
# ---------------------------------------------------------------------------

VarlenMetadata = collections.namedtuple("VarlenMetadata", ["qseg", "lo", "hi"])


def make_varlen_metadata(
    cu_seqlens_q: torch.Tensor,  # (nseq + 1,) int
    cu_seqlens_k: torch.Tensor,
    total_q: int,
    *,
    seqused_q: Optional[torch.Tensor] = None,
    seqused_k: Optional[torch.Tensor] = None,
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    attention_chunk: int = 0,
) -> VarlenMetadata:
    """Per packed query row (total_q,), int64 on cu_seqlens_q's device:

    qseg      its sequence, -1 for an inert row (past seqused_q, or past
              cu_seqlens_q[-1]);
    lo, hi    its visible key columns, [lo, hi] in packed coordinates:
              segment, bottom-right causal, window, attention_chunk (the
              keys of the row's chunk, [c, c + chunk) with c = qpos_adj -
              qpos_adj mod chunk in the sequence's key positions, mod
              towards -inf) and seqused_q/k in one interval; empty (hi =
              lo - 1) for a row that sees nothing.

    As flash_attn_tpu's `make_varlen_metadata` without its tile bounds. Two
    differences on malformed input only: rows past cu_seqlens_q[-1] are
    inert (the reference counts them into the last sequence), and a
    seqused_k above the sequence's length is cut to it (the reference's
    interval then reaches into the next sequence's keys)."""
    left, right = varlen_window(window, causal)
    dev = cu_seqlens_q.device
    cu_q = cu_seqlens_q.to(dev, torch.int64)
    cu_k = cu_seqlens_k.to(dev, torch.int64)
    nseq = cu_q.numel() - 1
    len_q = cu_q[1:] - cu_q[:-1]
    len_k = cu_k[1:] - cu_k[:-1]
    used_q = len_q if seqused_q is None else seqused_q.to(dev, torch.int64)
    used_k = len_k if seqused_k is None else seqused_k.to(dev, torch.int64)
    qidx = torch.arange(total_q, device=dev)
    qseg = torch.searchsorted(cu_q, qidx, right=True) - 1
    valid = (qseg >= 0) & (qseg < nseq)
    seg = qseg.clamp(0, max(nseq - 1, 0))
    qpos = qidx - cu_q[seg]
    if seqused_q is not None:
        valid &= qpos < used_q[seg]
    qpos_adj = qpos + (used_k - used_q)[seg]
    hi_rel = torch.minimum(used_k, len_k)[seg] - 1
    if right >= 0:
        hi_rel = torch.minimum(hi_rel, qpos_adj + right)
    lo_rel = torch.zeros_like(qpos_adj)
    if left >= 0:
        lo_rel = torch.maximum(lo_rel, qpos_adj - left)
    if attention_chunk > 0:
        c_lo = qpos_adj - torch.remainder(qpos_adj, attention_chunk)
        lo_rel = torch.maximum(lo_rel, c_lo)
        hi_rel = torch.minimum(hi_rel, c_lo + attention_chunk - 1)
    lo = torch.where(valid, cu_k[seg] + lo_rel, 1)
    hi = torch.where(valid, cu_k[seg] + hi_rel, 0)
    hi = torch.maximum(hi, lo - 1)
    return VarlenMetadata(torch.where(valid, qseg, -1), lo, hi)


def _host(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, dtype=np.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class VarlenPlan:
    """What the CUDA grids need, built once on the host from concrete
    lengths (the reference's scheduler metadata; `make_varlen_plan`):
    the sequence count, the longest sequence's rows and keys (the backward
    grids' first dimension; the forward's grid needs neither), the masking
    it was built for, and the lengths it was built from. Reuse it across
    layers; a call whose lengths, causal, window or attention_chunk differ
    is refused (`plan_mismatch`). The kernels cover every tile whatever the grid size,
    so even a plan that slipped through could not change an answer, only
    its time."""

    nseq: int
    max_seqlen_q: int
    max_seqlen_k: int
    causal: bool
    window: Tuple[int, int]  # as `varlen_window` normalises it
    cu_q: np.ndarray
    cu_k: Optional[np.ndarray]
    used_q: Optional[np.ndarray]
    used_k: Optional[np.ndarray]
    attention_chunk: int = 0
    # name -> (tensor, its version counter when the plan was built): a call
    # handing in the very same, unmodified tensor matches without a host
    # read. Held so that its memory cannot be reused by another tensor.
    sources: dict = dataclasses.field(default_factory=dict, repr=False)


def make_varlen_plan(
    cu_seqlens_q,
    cu_seqlens_k=None,
    *,
    seqused_q=None,
    seqused_k=None,
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    attention_chunk: int = 0,
    cp_world_size: int = 1,
    cp_rank: int = 0,
    cp_tot_seqused_k=None,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
) -> VarlenPlan:
    """Build a VarlenPlan from the step's lengths: one host read of each
    length tensor given. `cu_seqlens_k=None` is the paged form (keys are
    seqused_k). The plan records causal, window and attention_chunk, which
    a call must match. `block_q`/`block_kv` are the JAX planner's TPU tile
    sizes, taken so that calls written for it run unchanged; the CUDA tiles
    are fixed."""
    del block_q, block_kv
    check_unported(cp_world_size=cp_world_size, cp_rank=cp_rank,
                   cp_tot_seqused_k=cp_tot_seqused_k)
    if attention_chunk < 0:
        raise ValueError("attention_chunk must be >= 0")
    cu_q, cu_k = _host(cu_seqlens_q), _host(cu_seqlens_k)
    used_q, used_k = _host(seqused_q), _host(seqused_k)
    if cu_k is None and used_k is None:
        raise ValueError("a plan needs cu_seqlens_k or seqused_k")
    rows = np.diff(cu_q)
    if used_q is not None:
        rows = np.minimum(rows, used_q)
    keys = np.diff(cu_k) if cu_k is not None else used_k
    if cu_k is not None and used_k is not None:
        keys = np.minimum(keys, used_k)
    sources = {
        name: (t, t._version) for name, t in (
            ("cu_seqlens_q", cu_seqlens_q), ("cu_seqlens_k", cu_seqlens_k),
            ("seqused_q", seqused_q), ("seqused_k", seqused_k))
        if isinstance(t, torch.Tensor)
    }
    return VarlenPlan(
        nseq=len(cu_q) - 1, max_seqlen_q=int(rows.max(initial=0)),
        max_seqlen_k=int(keys.max(initial=0)), causal=bool(causal),
        window=varlen_window(window, causal), cu_q=cu_q, cu_k=cu_k,
        used_q=used_q, used_k=used_k, attention_chunk=int(attention_chunk),
        sources=sources)


def _same_tensor(plan: VarlenPlan, name: str, t: torch.Tensor) -> bool:
    src = plan.sources.get(name)
    if src is None:
        return False
    s, version = src
    return (t.data_ptr() == s.data_ptr() and t._version == version
            and t.shape == s.shape and t.stride() == s.stride()
            and t.dtype == s.dtype and t.device == s.device)


def plan_mismatch(plan: VarlenPlan, *, cu_seqlens_q, cu_seqlens_k=None,
                  seqused_q=None, seqused_k=None, causal: bool,
                  window_size, attention_chunk: int = 0,
                  host_read: bool = True) -> Optional[str]:
    """Why `plan` does not fit a call, or None. The masking must match
    (the reference's scheduler-metadata reuse does not check causal or
    window, vllm_compat.py:300), attention_chunk included. Each length
    tensor matches when it is the very tensor the plan was built from,
    unmodified; otherwise its values are compared, which for a CUDA tensor
    is a host read. With host_read=False such a tensor counts as a mismatch
    instead."""
    window = varlen_window(window_size, causal)
    mask = (bool(causal), window, int(attention_chunk))
    if (plan.causal, plan.window, plan.attention_chunk) != mask:
        return (f"built for causal={plan.causal}, window={plan.window}, "
                f"attention_chunk={plan.attention_chunk}; the call has "
                f"causal={mask[0]}, window={mask[1]}, "
                f"attention_chunk={mask[2]}")
    for name, snap, t in (("cu_seqlens_q", plan.cu_q, cu_seqlens_q),
                          ("cu_seqlens_k", plan.cu_k, cu_seqlens_k),
                          ("seqused_q", plan.used_q, seqused_q),
                          ("seqused_k", plan.used_k, seqused_k)):
        if snap is None and t is None:
            continue
        if (snap is None) != (t is None):
            return f"{name} given to one of plan and call only"
        if isinstance(t, torch.Tensor):
            if _same_tensor(plan, name, t):
                continue
            if t.device.type != "cpu" and not host_read:
                return f"{name} is not the tensor the plan was built from"
        if not np.array_equal(snap, _host(t)):
            return f"the call's {name} differs from the plan's"
    return None


def resolve_max_seqlens(cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, plan) -> Tuple[int, int]:
    """(max_seqlen_q, max_seqlen_k): the caller's, else the plan's, else
    read from cu_seqlens in one host read (a sync when they live on the
    card)."""
    if max_seqlen_q is None and plan is not None:
        max_seqlen_q = plan.max_seqlen_q
    if max_seqlen_k is None and plan is not None:
        max_seqlen_k = plan.max_seqlen_k
    missing = [cu for cu, m in ((cu_seqlens_q, max_seqlen_q),
                                (cu_seqlens_k, max_seqlen_k))
               if m is None and cu is not None]
    if missing:
        dev = missing[0].device
        read = torch.stack([
            (cu[1:] - cu[:-1]).max().to(dev, torch.int64) if cu.numel() > 1
            else torch.zeros((), dtype=torch.int64, device=dev)
            for cu in missing]).tolist()
        if max_seqlen_q is None and cu_seqlens_q is not None:
            max_seqlen_q = read.pop(0)
        if max_seqlen_k is None and cu_seqlens_k is not None:
            max_seqlen_k = read.pop(0)
    return (None if max_seqlen_q is None else int(max_seqlen_q),
            None if max_seqlen_k is None else int(max_seqlen_k))


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def _thd(x: torch.Tensor, layout: str) -> torch.Tensor:
    """A (total, h, d) view of a thd or hsd tensor."""
    if layout == "thd":
        return x
    if layout == "hsd":
        return x.transpose(0, 1)
    raise ValueError(f"unknown varlen layout {layout!r}")


def _sequences(cu_seqlens_q, cu_seqlens_k, total_q, seqused_q, seqused_k,
               causal, window_size, features=None):
    """(q0, q1, k0, k1, visible (q1 - q0, k1 - k0) bool, features) of every
    sequence with rows and keys, visibility from `make_varlen_metadata`
    (with `features`' attention_chunk). A sequence's features (None without
    any) hold its slice's coordinates: the keep mask's origin (q0, k0) in
    packed rows and keys, batch row 0, and ALiBi's diagonal offset used_k -
    used_q, as the JAX kernels' packed coordinates have them."""
    chunk = 0 if features is None else features.attention_chunk
    meta = make_varlen_metadata(
        cu_seqlens_q, cu_seqlens_k, total_q, seqused_q=seqused_q,
        seqused_k=seqused_k, causal=causal, window=window_size,
        attention_chunk=chunk)
    cu_q, cu_k = _host(cu_seqlens_q), _host(cu_seqlens_k)
    used_q, used_k = _host(seqused_q), _host(seqused_k)
    for j in range(len(cu_q) - 1):
        q0, q1, k0, k1 = int(cu_q[j]), int(cu_q[j + 1]), int(cu_k[j]), int(cu_k[j + 1])
        if q1 > q0 and k1 > k0:
            cols = torch.arange(k0, k1, device=meta.lo.device)
            uq = q1 - q0 if used_q is None else int(used_q[j])
            uk = k1 - k0 if used_k is None else int(used_k[j])
            fs = None if features is None else features._replace(
                origin=(q0, k0), diag_offset=uk - uq)
            yield q0, q1, k0, k1, ((cols >= meta.lo[q0:q1, None])
                                   & (cols <= meta.hi[q0:q1, None])), fs


def _bhsd(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Rows a:b of a (total, h, d) tensor as (1, h, b - a, d)."""
    return x[a:b].transpose(0, 1)[None]


def _gather_pages(kv_pools, block_table, seqused_k, head_dim, head_dim_v):
    """K and V of every sequence's used pages, packed page-aligned, and the
    matching cu_seqlens_k: what the gather route of the reference's
    vllm_compat builds (vllm_compat.py:339-402). Pages outside the pool read
    as zeros, as in the kernel."""
    k_pool, v_pool = _pool_views(kv_pools, head_dim, head_dim_v)
    npages, _, page, _ = k_pool.shape
    used = _host(seqused_k)
    table = _host(block_table)
    pages = [table[j, :max(1, -(-int(u) // page))] for j, u in enumerate(used)]
    ids = torch.from_numpy(np.concatenate(pages)).to(k_pool.device)
    ok = ((ids >= 0) & (ids < npages))[:, None, None, None]
    ids = ids.clamp(0, npages - 1)

    def gather(pool):
        x = pool[ids] * ok  # (n, hk, page, d)
        return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])

    cu_k = np.concatenate([[0], np.cumsum([len(p) * page for p in pages])])
    return (gather(k_pool), gather(v_pool),
            torch.from_numpy(cu_k.astype(np.int32)).to(k_pool.device))


def flash_attention_varlen_fwd_ref(
    q, k, v, cu_seqlens_q, cu_seqlens_k, *, seqused_q=None, seqused_k=None,
    softmax_scale=None, causal=False, window_size=(-1, -1), softcap=0.0,
    layout="thd", kv_pools=None, block_table=None, head_dim_v=None,
    features: Optional[Features] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel, in fp32, sequence by sequence
    through the dense plain version with each sequence's visibility from
    `make_varlen_metadata`. Paged K/V are first gathered (`_gather_pages`).
    `features` (`varlen_features`: ALiBi, attention_chunk, dropout) as the
    JAX varlen kernel takes them, in packed coordinates: the keep mask of
    batch row 0 at packed rows and keys, ALiBi's |col - diag| with diag a
    row's bottom-right diagonal. Returns (out in q's layout and dtype, lse
    (h, total_q) fp32); inert rows and rows that see nothing give out 0 and
    lse -inf."""
    if kv_pools is not None:
        k, v, cu_seqlens_k = _gather_pages(kv_pools, block_table, seqused_k,
                                           q.shape[-1], head_dim_v)
        layout_kv = "thd"
    else:
        layout_kv = layout
    qt, kt, vt = _thd(q, layout), _thd(k, layout_kv), _thd(v, layout_kv)
    total_q, h, _ = qt.shape
    out = qt.new_zeros((total_q, h, vt.shape[2]))
    lse = torch.full((h, total_q), float("-inf"), device=q.device)
    for q0, q1, k0, k1, vis, fs in _sequences(
            cu_seqlens_q, cu_seqlens_k, total_q, seqused_q, seqused_k,
            causal, window_size, features):
        o, l = flash_attention_fwd_ref(
            _bhsd(qt, q0, q1), _bhsd(kt, k0, k1), _bhsd(vt, k0, k1),
            softmax_scale=softmax_scale, softcap=softcap, visible=vis,
            features=fs)
        out[q0:q1] = o[0].transpose(0, 1)
        lse[:, q0:q1] = l[0]
    return (out if layout == "thd" else out.transpose(0, 1)), lse


def _varlen_dq_ref(q, k, v, do, lse, cu_seqlens_q, cu_seqlens_k, *,
                   seqused_q=None, seqused_k=None, softmax_scale=None,
                   causal=False, window_size=(-1, -1), softcap=0.0,
                   layout="thd", features: Optional[Features] = None):
    """Plain version of the dQ kernel: (dq in q's layout and dtype, delta
    (h, total_q) fp32 = sum_j P dP), P recomputed from Q, K and the LSE as
    the reference's `_varlen_recompute` does (flash_varlen.py:790-882):
    with `features` as the forward's, the ALiBi term, and with dropout dP
    Z / (1 - p) in delta and dS."""
    qt, kt, vt, dot = (_thd(x, layout) for x in (q, k, v, do))
    total_q, h, _ = qt.shape
    dq = torch.zeros_like(qt)
    delta = torch.zeros((h, total_q), device=q.device)
    for q0, q1, k0, k1, vis, fs in _sequences(
            cu_seqlens_q, cu_seqlens_k, total_q, seqused_q, seqused_k,
            causal, window_size, features):
        dq_j, delta_j = _bwd_dq_ref(
            _bhsd(qt, q0, q1), _bhsd(kt, k0, k1), _bhsd(vt, k0, k1),
            _bhsd(dot, q0, q1), lse[None, :, q0:q1],
            softmax_scale=softmax_scale, softcap=softcap, visible=vis,
            features=fs)
        dq[q0:q1] = dq_j[0].transpose(0, 1)
        delta[:, q0:q1] = delta_j[0]
    return (dq if layout == "thd" else dq.transpose(0, 1)), delta


def _varlen_dkv_ref(q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, *,
                    seqused_q=None, seqused_k=None, softmax_scale=None,
                    causal=False, window_size=(-1, -1), softcap=0.0,
                    layout="thd", features: Optional[Features] = None):
    """Plain version of the dK/dV kernel: (dk, dv) in k's layout and dtype,
    each kv head's group of query heads summed, from the dQ kernel's delta;
    with `features` as the forward's (dropout: dV from P Z / (1 - p), dS
    from dP Z / (1 - p))."""
    qt, kt, vt, dot = (_thd(x, layout) for x in (q, k, v, do))
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    for q0, q1, k0, k1, vis, fs in _sequences(
            cu_seqlens_q, cu_seqlens_k, qt.shape[0], seqused_q, seqused_k,
            causal, window_size, features):
        dk_j, dv_j = _bwd_dkv_ref(
            _bhsd(qt, q0, q1), _bhsd(kt, k0, k1), _bhsd(vt, k0, k1),
            _bhsd(dot, q0, q1), lse[None, :, q0:q1], delta[None, :, q0:q1],
            softmax_scale=softmax_scale, softcap=softcap, visible=vis,
            features=fs)
        dk[k0:k1] = dk_j[0].transpose(0, 1)
        dv[k0:k1] = dv_j[0].transpose(0, 1)
    if layout == "hsd":
        return dk.transpose(0, 1), dv.transpose(0, 1)
    return dk, dv


# ---------------------------------------------------------------------------
# The Hopper forward's schedule (csrc/flash_varlen_fwd_sm90.cuh).
# ---------------------------------------------------------------------------

SM90_BLOCK_N = 128  # keys per K/V tile (kBlockN)


def sm90_block_m(d: int) -> int:
    """Query rows per block (block_m): three 64-row consumer warpgroups at
    d 64, two at d 128."""
    return 192 if d == 64 else 128


def sm90_grid_tiles(total_q: int, nseq: int, d: int) -> int:
    """grid.x of the flat schedule (grid_tiles): an upper bound on the
    sequences' row tiles, sum cdiv(rows_b, block_m), from the shapes alone
    (sum floor(x) <= floor(sum x) with rows_b <= length_b)."""
    bm = sm90_block_m(d)
    return (total_q + nseq * (bm - 1)) // bm


def pages_on_tma(page: int) -> bool:
    """Whether the Hopper kernel reads pools of this page size (TMA boxes of
    gcd(page, 128) >= 8 slots); the others take the sm80 route."""
    return page % 8 == 0


def piece_rows(page: int) -> int:
    """Slots per TMA box of a pool (piece_rows): gcd(page, 128)."""
    return int(np.gcd(page, SM90_BLOCK_N))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _pool_views(kv_pools, head_dim, head_dim_v=None):
    """(K, V) views (npages, hk, page, d) of split pools, or of the two
    sections of a fused K|V pool (v_pool None), split as kernel 4 splits
    it."""
    k_pool, v_pool = kv_pools
    if v_pool is not None:
        return k_pool, v_pool
    if head_dim_v is None:
        raise ValueError("a fused K|V pool needs head_dim_v")
    k_view, v_view, _ = _fused_split(k_pool, head_dim, head_dim_v)
    return k_view, v_view


def _int32(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return t.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _packed_strides(x: torch.Tensor, layout: str):
    """(unused, head, token) element strides of a thd or hsd tensor."""
    if layout == "thd":
        return [0, x.stride(1), x.stride(0)]
    return [0, x.stride(0), x.stride(1)]


def _strides_arg(flat):
    return (ctypes.c_longlong * len(flat))(*flat)


def _dims(q, k, layout):
    """(total_q, h, d, hk) of packed q and k."""
    if layout == "thd":
        (total_q, h, d), hk = q.shape, k.shape[1]
    else:
        (h, total_q, d), hk = q.shape, k.shape[0]
    return total_q, h, d, hk


@functools.lru_cache(maxsize=None)
def _fwd_kernel():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("flash_fwd").flash_varlen_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def trace_schedule(trace: Optional[torch.Tensor], kernel: str = "fwd"
                   ) -> None:
    """Makes the later launches of a Hopper kernel with the flat schedule,
    the forward (kernel 6, `kernel="fwd"`), the dQ (kernel 8, "dq") or the
    dK/dV (kernel 7, "dkv"), write their schedule into `trace` (int32 on the
    card, four ints a block at 4 (blockIdx.y grid.x + blockIdx.x):
    blockIdx.x, blockIdx.y (the query head, or the kv head for "dkv"), the
    block's sequence and its tile's first row (key for "dkv"), the last two
    -1 for a block past the last tile; blocks past its end write nothing),
    or stops it (None). Hold on to `trace` until it is stopped."""
    from flash_attn_tpu_torch.kernels._build import load_library

    lib, name = {"fwd": ("flash_fwd", "flash_varlen_fwd_trace"),
                 "dq": ("flash_bwd", "flash_varlen_bwd_dq_trace"),
                 "dkv": ("flash_bwd", "flash_varlen_bwd_dkv_trace")}[kernel]
    fn = getattr(load_library(lib), name)
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    if trace is None:
        fn(None, 0)
        return
    if trace.dtype != torch.int32 or trace.device.type != "cuda":
        raise ValueError("the trace is an int32 tensor on the card")
    fn(trace.data_ptr(), trace.numel())


# ctypes types of the feature arguments of csrc/flash_varlen_features.cu's
# and csrc/flash_varlen_bwd_features.cu's entry points (_feature_args):
# slopes, chunk, dropout, seed, keep_threshold, keep_scale.
_FEATURE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_uint, ctypes.c_uint, ctypes.c_float]


def _feature_args(f: Features, dev) -> tuple:
    """(the slopes on `dev`, kept alive by the caller, and the C feature
    arguments of `f`)."""
    slopes = (None if f.alibi_slopes is None else
              f.alibi_slopes.to(dev, torch.float32).contiguous())
    drop = f.dropout_p > 0
    return slopes, (_ptr(slopes), f.attention_chunk, int(drop),
                    f.dropout_seed & 0xFFFFFFFF,
                    keep_threshold(1.0 - f.dropout_p) if drop else 0,
                    1.0 / (1.0 - f.dropout_p))


@functools.lru_cache(maxsize=None)
def _fwd_features_kernel():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("flash_varlen_features").flash_varlen_fwd_features
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int] + _FEATURE_ARGTYPES
                   + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_features_kernels() -> ctypes.CDLL:
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library("flash_varlen_bwd_features")
    tail = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int] + _FEATURE_ARGTYPES + [ctypes.c_void_p])
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_varlen_bwd_dkv_features.argtypes = ([ctypes.c_void_p] * 8
                                                  + [strides] + tail)
    lib.flash_varlen_bwd_dq_features.argtypes = ([ctypes.c_void_p] * 7
                                                 + [strides] + tail)
    lib.flash_varlen_bwd_dkv_features.restype = ctypes.c_int
    lib.flash_varlen_bwd_dq_features.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_kernels() -> ctypes.CDLL:
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library("flash_bwd")
    tail = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p])
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_varlen_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + [strides] + tail
    lib.flash_varlen_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + [strides] + tail
    lib.flash_varlen_bwd_dkv.restype = ctypes.c_int
    lib.flash_varlen_bwd_dq.restype = ctypes.c_int
    return lib


def flash_attention_varlen_fwd(
    q: torch.Tensor,  # (total_q, h, d), or (h, total_q, d) with layout="hsd"
    k: Optional[torch.Tensor],  # (total_k, hk, d) as q; None with kv_pools
    v: Optional[torch.Tensor],
    cu_seqlens_q: torch.Tensor,  # (nseq + 1,) int32
    cu_seqlens_k: Optional[torch.Tensor],
    *,
    qv=None,
    seqused_q: Optional[torch.Tensor] = None,
    seqused_k: Optional[torch.Tensor] = None,
    alibi_slopes=None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    attention_chunk: int = 0,
    softcap: float = 0.0,
    dropout_p: float = 0.0,
    dropout_seed=None,
    cp_world_size: int = 1,
    cp_rank: int = 0,
    cp_tot_seqused_k=None,
    attn_bias=None,
    score_mod=None,
    mask_mod=None,
    aux_tensors=(),
    aux_scalars=(),
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    layout: str = "thd",
    kv_pools=None,
    block_table: Optional[torch.Tensor] = None,
    head_dim_v: Optional[int] = None,
    plan: Optional[VarlenPlan] = None,
    max_seqlen_q: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed varlen forward. Returns (out in q's layout and dtype, lse
    (h, total_q) fp32 natural log); inert rows give out 0 and lse -inf.

    Paged K/V: `kv_pools=(k_pool, v_pool)`, each (npages, hk, page, d) —
    any strides, so vLLM's (npages, page, hk, d) pools go in as transposed
    views — or `(fused_pool, None)` with `head_dim_v`, and vLLM's page table
    `block_table` (nseq, max_pages) in place of the reference's flat
    `kv_page_of_block`. Keys are then `seqused_k` (or the cu_seqlens_k
    lengths).

    `plan` (from `make_varlen_plan`) is refused (ValueError) when its
    lengths, causal, window or attention_chunk differ from the call's. The
    Hopper kernel's grid needs no max_seqlen_q; pools whose page size is
    not a multiple of 8 take the sm80 route (counted in
    `flash_attention_varlen_fwd.launches_sm80` as well), whose grid
    max_seqlen_q sizes: the caller's, the plan's, or else one host read of
    cu_seqlens_q. `block_q`/`block_kv` are taken for calls written for the
    JAX API and not read. CUDA tensors launch `csrc/flash_fwd.cu`
    flash_varlen_fwd (counted in `flash_attention_varlen_fwd.launches`;
    inputs its TMA tensor maps cannot take are copied first, counted in
    `.tma_copies`); CPU tensors take `flash_attention_varlen_fwd_ref`.

    ALiBi slopes (h,), attention_chunk and dropout (`dropout_seed` an int
    or a scalar tensor, None 0) run in kernel 6's feature instances
    (`csrc/flash_varlen_features.cu`, counted in `.launches` and
    `.feature_launches`), ALiBi and chunk on pools too. Dropout on pools
    and features on the sm80 route raise NotImplementedError."""
    del block_q, block_kv
    check_unported(
        qv=qv, cp_world_size=cp_world_size, cp_rank=cp_rank,
        cp_tot_seqused_k=cp_tot_seqused_k, attn_bias=attn_bias,
        score_mod=score_mod, mask_mod=mask_mod, aux_tensors=aux_tensors,
        aux_scalars=aux_scalars)
    _thd(q, layout)  # checks the layout
    features = varlen_features(
        q.shape[1 if layout == "thd" else 0], alibi_slopes=alibi_slopes,
        attention_chunk=attention_chunk, dropout_p=dropout_p,
        dropout_seed=dropout_seed)
    if kv_pools is not None and features is not None:
        page = _pool_views(kv_pools, q.shape[-1], head_dim_v)[0].shape[2]
        if features.dropout_p > 0:
            raise NotImplementedError(
                "flash attention argument 'dropout_p' with page pools is "
                "not ported yet: ROADMAP queue 2, kernel 6: dropout on page "
                "pools (vLLM's entry takes none)")
        if not pages_on_tma(page):
            raise NotImplementedError(
                "flash attention features on pools whose page size is not "
                "a multiple of 8 (the sm80 route) are not ported yet: "
                "ROADMAP queue 2, kernel 6: features on the sm80 route")
    if kv_pools is not None:
        if block_table is None:
            raise ValueError("paged K/V need a block_table")
        if seqused_k is None:
            if cu_seqlens_k is None:
                raise ValueError("paged K/V need seqused_k or cu_seqlens_k")
            seqused_k = cu_seqlens_k[1:] - cu_seqlens_k[:-1]
        cu_seqlens_k = None
    if plan is not None:
        why = plan_mismatch(plan, cu_seqlens_q=cu_seqlens_q,
                            cu_seqlens_k=cu_seqlens_k, seqused_q=seqused_q,
                            seqused_k=seqused_k, causal=causal,
                            window_size=window_size,
                            attention_chunk=attention_chunk)
        if why:
            raise ValueError(f"stale VarlenPlan: {why}; rebuild it "
                             "(make_varlen_plan) when lengths or masking "
                             "change")
    kw = dict(seqused_q=seqused_q, seqused_k=seqused_k,
              softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap, layout=layout)
    if q.device.type == "cpu":
        return flash_attention_varlen_fwd_ref(
            q, k, v, cu_seqlens_q, cu_seqlens_k, kv_pools=kv_pools,
            block_table=block_table, head_dim_v=head_dim_v,
            features=features, **kw)
    return _launch_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, kv_pools,
                       block_table, head_dim_v, max_seqlen_q, plan, features,
                       **kw)


flash_attention_varlen_fwd.launches = 0
flash_attention_varlen_fwd.feature_launches = 0
flash_attention_varlen_fwd.launches_sm80 = 0
flash_attention_varlen_fwd.tma_copies = 0


def _launch_fwd(q, k, v, cu_seqlens_q, cu_seqlens_k, kv_pools, block_table,
                head_dim_v, max_seqlen_q, plan, features, *, seqused_q,
                seqused_k, softmax_scale, causal, window_size, softcap,
                layout):
    dev = q.device
    owner = flash_attention_varlen_fwd
    q = tma_ready(q, owner)
    sm80 = False
    if kv_pools is not None:
        total_q, h, d = _thd(q, layout).shape
        k_view, v_view = _pool_views(kv_pools, d, head_dim_v)
        npages, hk, page, _ = k_view.shape
        sm80 = not pages_on_tma(page)
        if sm80:  # the sm80 route's grid is sized by the longest sequence
            max_seqlen_q, _ = resolve_max_seqlens(cu_seqlens_q, None,
                                                  max_seqlen_q, None, plan)
        else:
            k_view, v_view = tma_ready(k_view, owner), tma_ready(v_view, owner)
        kv_strides = [k_view.stride(i) for i in range(3)] + [
            v_view.stride(i) for i in range(3)]
        table = _int32(block_table, dev)
        table_args = (table.data_ptr(), table.stride(0), page,
                      table.shape[1], npages)
    else:
        k_view, v_view = tma_ready(k, owner), tma_ready(v, owner)
        total_q, h, d, hk = _dims(q, k_view, layout)
        total_k = _thd(k_view, layout).shape[0]
        kv_strides = (_packed_strides(k_view, layout)
                      + _packed_strides(v_view, layout))
        # The kernel's K/V tensor maps span the packed tokens.
        table_args = (None, 0, 0, 0, total_k)
    if k_view.shape[-1] != d or v_view.shape[-1] != d:
        raise ValueError(f"the CUDA kernel takes K and V of head dim {d}")
    check_kernel_inputs(d, h, hk, q=q, k=k_view, v=v_view)
    cu_q = _int32(cu_seqlens_q, dev)
    cu_k = _int32(cu_seqlens_k, dev)
    used_q, used_k = _int32(seqused_q, dev), _int32(seqused_k, dev)
    nseq = cu_q.numel() - 1
    left, right = varlen_window(window_size, causal)
    out = torch.zeros_like(q)
    lse = torch.full((h, total_q), float("-inf"), dtype=torch.float32,
                     device=dev)
    if nseq <= 0 or total_q == 0 or (kv_pools is None
                                     and table_args[-1] == 0):
        return out, lse
    strides = (_packed_strides(q, layout) + kv_strides[:3] + kv_strides[3:]
               + _packed_strides(out, layout))
    args = (q.data_ptr(), k_view.data_ptr(), v_view.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _strides_arg(strides),
            cu_q.data_ptr(), _ptr(cu_k), _ptr(used_q), _ptr(used_k),
            *table_args, nseq)
    tail = (total_q, h, hk, d, _scale(d, softmax_scale), left, right,
            float(softcap), int(q.dtype == torch.float16))
    if features is None:
        rc = _fwd_kernel()(*args, int(max_seqlen_q or 0), *tail, _stream(q))
    else:
        slopes, fargs = _feature_args(features, dev)
        rc = _fwd_features_kernel()(*args, *tail, *fargs, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_varlen_fwd launch failed: CUDA error {rc}")
    owner.launches += 1
    owner.feature_launches += features is not None
    owner.launches_sm80 += sm80
    return out, lse


def _bwd_prepare(q, k, v, do, lse, cu_seqlens_q, cu_seqlens_k, seqused_q,
                 seqused_k, layout):
    if do.shape != q.shape:
        raise ValueError(f"dout {tuple(do.shape)} must match q {tuple(q.shape)}")
    total_q, h, d, hk = _dims(q, k, layout)
    check_kernel_inputs(d, h, hk, q=q, k=k, v=v, dout=do)
    if (lse.shape != (h, total_q) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be contiguous fp32 (h, total_q) on "
                         f"{q.device}; got {lse.dtype} {tuple(lse.shape)}")
    dev = q.device
    ints = [_int32(t, dev) for t in (cu_seqlens_q, cu_seqlens_k, seqused_q,
                                     seqused_k)]
    return total_q, h, d, hk, ints


def flash_attention_varlen_bwd_dq(
    q, k, v, do, lse, cu_seqlens_q, cu_seqlens_k, *, seqused_q=None,
    seqused_k=None, softmax_scale=None, causal=False, window_size=(-1, -1),
    softcap=0.0, layout="thd", alibi_slopes=None, attention_chunk=0,
    dropout_p=0.0, dropout_seed=None,
):
    """(dq in q's layout and dtype, delta (h, total_q) fp32). CUDA tensors
    launch flash_varlen_bwd_dq (counted in
    `flash_attention_varlen_bwd_dq.launches`; inputs its TMA tensor maps
    cannot take are copied first, counted in `.tma_copies`), whose flat
    schedule needs no max_seqlen_q (its C argument is passed as 0), or with
    the forward's features (`flash_attention_varlen_fwd`) kernel 8's
    feature instances (`csrc/flash_varlen_bwd_features.cu`, counted in
    `.launches` and `.feature_launches`); CPU tensors take
    `_varlen_dq_ref`."""
    kw = dict(seqused_q=seqused_q, seqused_k=seqused_k,
              softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap, layout=layout)
    features = varlen_features(
        q.shape[1 if layout == "thd" else 0], alibi_slopes=alibi_slopes,
        attention_chunk=attention_chunk, dropout_p=dropout_p,
        dropout_seed=dropout_seed)
    if q.device.type == "cpu":
        return _varlen_dq_ref(q, k, v, do, lse, cu_seqlens_q, cu_seqlens_k,
                              features=features, **kw)
    owner = flash_attention_varlen_bwd_dq
    q, k, v, do = (tma_ready(x, owner) for x in (q, k, v, do))
    total_q, h, d, hk, ints = _bwd_prepare(
        q, k, v, do, lse, cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k,
        layout)
    dq = torch.zeros_like(q)
    delta = torch.zeros((h, total_q), dtype=torch.float32, device=q.device)
    nseq = ints[0].numel() - 1
    if nseq <= 0:
        return dq, delta
    left, right = varlen_window(window_size, causal)
    strides = sum((_packed_strides(x, layout) for x in (q, k, v, do, dq)), [])
    # k's and v's first entries carry their token counts: the extents of
    # the kernel's K/V tensor maps.
    strides[3] = strides[6] = _thd(k, layout).shape[0]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides_arg(strides), *(_ptr(t) for t in ints), nseq)
    tail = (total_q, h, hk, d, _scale(d, softmax_scale), left, right,
            float(softcap), int(q.dtype == torch.float16))
    if features is None:
        rc = _bwd_kernels().flash_varlen_bwd_dq(*args, 0, *tail, _stream(q))
    else:
        slopes, fargs = _feature_args(features, q.device)
        rc = _bwd_features_kernels().flash_varlen_bwd_dq_features(
            *args, *tail, *fargs, _stream(q))
    if rc == -2:
        raise RuntimeError("flash_varlen_bwd_dq: h * total_q passes 2^31 or "
                           "cuTensorMapEncodeTiled refused a tensor map")
    if rc != 0:
        raise RuntimeError(f"flash_varlen_bwd_dq launch failed: CUDA error {rc}")
    owner.launches += 1
    owner.feature_launches += features is not None
    return dq, delta


flash_attention_varlen_bwd_dq.launches = 0
flash_attention_varlen_bwd_dq.feature_launches = 0
flash_attention_varlen_bwd_dq.tma_copies = 0


def flash_attention_varlen_bwd_dkv(
    q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, *, seqused_q=None,
    seqused_k=None, softmax_scale=None, causal=False, window_size=(-1, -1),
    softcap=0.0, layout="thd", alibi_slopes=None, attention_chunk=0,
    dropout_p=0.0, dropout_seed=None,
):
    """(dk, dv) in k's layout and dtype, GQA groups summed, from the dQ
    kernel's delta (h, total_q). CUDA tensors launch flash_varlen_bwd_dkv
    (counted in `flash_attention_varlen_bwd_dkv.launches`; inputs its TMA
    tensor maps cannot take, q, k, v, dO, the LSE or delta, are copied
    first, counted in `.tma_copies`), whose flat schedule of key tiles
    needs no max_seqlen_k (its C argument is passed as 0), or with the
    forward's features kernel 7's feature instances
    (`csrc/flash_varlen_bwd_features.cu`, counted in `.launches` and
    `.feature_launches`); CPU tensors take `_varlen_dkv_ref`."""
    kw = dict(seqused_q=seqused_q, seqused_k=seqused_k,
              softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap, layout=layout)
    features = varlen_features(
        q.shape[1 if layout == "thd" else 0], alibi_slopes=alibi_slopes,
        attention_chunk=attention_chunk, dropout_p=dropout_p,
        dropout_seed=dropout_seed)
    if q.device.type == "cpu":
        return _varlen_dkv_ref(q, k, v, do, lse, delta, cu_seqlens_q,
                               cu_seqlens_k, features=features, **kw)
    owner = flash_attention_varlen_bwd_dkv
    q, k, v, do = (tma_ready(x, owner) for x in (q, k, v, do))
    total_q, h, d, hk, ints = _bwd_prepare(
        q, k, v, do, lse, cu_seqlens_q, cu_seqlens_k, seqused_q, seqused_k,
        layout)
    if delta.shape != lse.shape or delta.dtype != torch.float32 or \
            not delta.is_contiguous() or delta.device != q.device:
        raise ValueError("delta must be contiguous fp32 (h, total_q)")
    lse, delta = stats_ready(lse, owner), stats_ready(delta, owner)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    nseq = ints[0].numel() - 1
    total_k = _thd(k, layout).shape[0]
    if nseq <= 0 or total_k == 0:
        return dk, dv
    left, right = varlen_window(window_size, causal)
    strides = sum((_packed_strides(x, layout) for x in (q, k, v, do, dk, dv)),
                  [])
    # k's and v's first entries carry their token counts: the extents of
    # the kernel's K/V tensor maps.
    strides[3] = strides[6] = total_k
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides_arg(strides), *(_ptr(t) for t in ints), nseq)
    tail = (total_q, h, hk, d, _scale(d, softmax_scale), left, right,
            float(softcap), int(q.dtype == torch.float16))
    if features is None:
        rc = _bwd_kernels().flash_varlen_bwd_dkv(*args, 0, *tail, _stream(q))
    else:
        slopes, fargs = _feature_args(features, q.device)
        rc = _bwd_features_kernels().flash_varlen_bwd_dkv_features(
            *args, *tail, *fargs, _stream(q))
    if rc == -2:
        raise RuntimeError("flash_varlen_bwd_dkv: h * total_q passes 2^31 or "
                           "cuTensorMapEncodeTiled refused a tensor map")
    if rc != 0:
        raise RuntimeError(f"flash_varlen_bwd_dkv launch failed: CUDA error {rc}")
    owner.launches += 1
    owner.feature_launches += features is not None
    return dk, dv


flash_attention_varlen_bwd_dkv.launches = 0
flash_attention_varlen_bwd_dkv.feature_launches = 0
flash_attention_varlen_bwd_dkv.tma_copies = 0


def flash_attention_varlen_bwd(
    q, k, v, out, lse, do, cu_seqlens_q, cu_seqlens_k, *, qv=None,
    seqused_q=None, seqused_k=None, alibi_slopes=None, softmax_scale=None,
    causal=False, window_size=(-1, -1), attention_chunk=0, softcap=0.0,
    dropout_p=0.0, dropout_seed=None, attn_bias=None, bias_grad=False,
    score_mod=None, mask_mod=None, aux_tensors=(), aux_scalars=(),
    block_q=None, block_kv=None, layout="thd", max_seqlen_q=None,
    max_seqlen_k=None,
):
    """Packed varlen backward: (dq, dk, dv) in the inputs' layout. `out` is
    taken for the reference's signature and not read: delta = sum_j P dP
    comes from the dQ kernel, not from rowsum(dO * O)
    (flash_varlen.py:1586; see csrc/flash_bwd.cu). max_seqlen_q and
    max_seqlen_k are not read: the dQ and dK/dV kernels' flat schedules
    need none. ALiBi, attention_chunk and dropout (the forward's seed, so
    the keep mask is the forward's) run in kernels 7-8's feature
    instances."""
    del out, block_q, block_kv, max_seqlen_q, max_seqlen_k
    check_unported(qv=qv, attn_bias=attn_bias, bias_grad=bias_grad,
                   score_mod=score_mod, mask_mod=mask_mod,
                   aux_tensors=aux_tensors, aux_scalars=aux_scalars)
    kw = dict(seqused_q=seqused_q, seqused_k=seqused_k,
              softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap, layout=layout,
              alibi_slopes=alibi_slopes, attention_chunk=attention_chunk,
              dropout_p=dropout_p, dropout_seed=dropout_seed)
    dq, delta = flash_attention_varlen_bwd_dq(
        q, k, v, do, lse, cu_seqlens_q, cu_seqlens_k, **kw)
    dk, dv = flash_attention_varlen_bwd_dkv(
        q, k, v, do, lse, delta, cu_seqlens_q, cu_seqlens_k, **kw)
    return dq, dk, dv
