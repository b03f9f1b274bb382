"""vLLM's attention entry points (counterpart of flash_attn_tpu/vllm_compat.py).

"For vLLM we only care about flash_attn_varlen_func and
flash_attn_with_kvcache" (vllm_flash_attn/flash_attn_interface.py:84-86):
this module gives both in vLLM's calling convention, with the scheduler
metadata hook. vLLM calls `get_scheduler_metadata` once per step and then
`flash_attn_varlen_func` once per layer; the routes are those of the JAX
module:

  * no block table: packed varlen attention (`flash_attn_varlen_func` of
    the interface: kernel 6 forward, kernels 7-8 backward);
  * a block table and max_seqlen_q > 4 (chunked prefill, or prefill and
    decode rows mixed), no `s_aux`: kernel 6 reading K/V from the pools
    through the block table (`kernels.flash_varlen`, route
    "paged-prefill-inkernel");
  * a block table and max_seqlen_q <= 4 (decode only): the paged-decode
    kernel (kernel 4, route "paged-decode"), the pools as strided views;
    the q rows go in as they are when every sequence has one, else
    right-aligned into (nseq, max_seqlen_q);
  * a block table and `s_aux` sinks (gpt-oss), any max_seqlen_q: the same
    decode route with the sinks, which only the general decode kernel
    takes (kernel 5, route "paged-decode-sinks");
  * ALiBi slopes (h,) (Baichuan, MPT, BLOOM) on each of these routes:
    kernel 6's feature instances without a block table and on a paged
    prefill, kernel 5 on decode rows (route "paged-decode-alibi"), which
    kernel 4 does not take. Dropout, and `s_aux` without a block table,
    raise: the JAX entry ignores both.

Pools are vLLM's (num_blocks, page, hk, d) ["phd"], head-major (num_blocks,
hk, page, d) ["hpd"], or a fused K|V pool ["hpd_fused"]; every route reads
them in place, with no copy, but one: a 1-byte (int8 / fp8 e4m3) pool with
k_descale/v_descale ((hk,) or (nseq, hk)). Its decode-only calls go to
kernel 4 (kernel 5 with sinks), which dequantizes in-kernel; its mixed and
prefill calls take the JAX module's route for 1-byte pools, a dequant pass
and then the packed kernel: one pass over the pages the block table lists
(`dequant_pages`: every entry, ids clamped, no host read) writes a bf16
scratch pool with the descales applied, which kernel 6 reads through an
identity table (in q's 16-bit type, bf16 for an fp32 q, as the JAX module
writes it). q_descale folds into the K descale and takes the decode route,
as in the JAX module. The reference also has a gather route (one
copy of the used pages, then the packed kernel), taken below page 512 after
a TPU measurement. The port does not keep it: on the H100 it measured 0-7%
faster than reading pages in place, at page 16 and 512 alike, but it needs
every call's page counts on the host and a copy of the used K/V per layer
call (PERF.md). `fa_version` and `num_splits` are taken and not read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.flash_attn_interface import (
    flash_attn_varlen_func as _varlen_packed,
)
from flash_attn_tpu_torch.flash_attn_interface import (
    flash_attn_with_kvcache,
    sparse_attn_func,
)
from flash_attn_tpu_torch.kernels.common import descale_of, upcast_quant_tile
from flash_attn_tpu_torch.kernels.flash_decode import flash_attention_decode
from flash_attn_tpu_torch.kernels.flash_varlen import (
    VarlenPlan,
    flash_attention_varlen_fwd,
    make_varlen_plan,
    plan_mismatch,
    resolve_max_seqlens,
)
from flash_attn_tpu_torch.utils.fa_logging import log_dispatch

__all__ = [
    "SchedulerMetadata",
    "flash_attn_varlen_func",
    "flash_attn_with_kvcache",
    "get_scheduler_metadata",
    "sparse_attn_func",
    "sparse_attn_varlen_func",
]

# Decode-shaped steps (every sequence's q rows <= this) go to kernel 4.
_DECODE_MAX_Q = 4


@dataclasses.dataclass(frozen=True, eq=False)
class SchedulerMetadata:
    """One step's scheduler metadata (the reference's consumable plan,
    hopper/flash_api.cpp:584): `plan` is the port's VarlenPlan, built once
    per step from the step's lengths and reused by every layer's call."""

    batch_size: int
    max_seqlen_q: int
    max_seqlen_k: int
    num_heads_q: int
    num_heads_kv: int
    headdim: int
    causal: bool
    plan: Optional[VarlenPlan] = None
    page_size: Optional[int] = None


def get_scheduler_metadata(
    batch_size: int,
    max_seqlen_q: int,
    max_seqlen_k: int,
    num_heads_q: int,
    num_heads_kv: int,
    headdim: int,
    cache_seqlens: Optional[torch.Tensor] = None,
    qkv_dtype=torch.bfloat16,
    headdim_v: Optional[int] = None,
    cu_seqlens_q: Optional[torch.Tensor] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    has_softcap: bool = False,
    num_splits: int = 0,
    page_size: Optional[int] = None,
    **_unused,
) -> SchedulerMetadata:
    """As the JAX `get_scheduler_metadata` (vllm_compat.py:62). Whenever
    cu_seqlens_q and cache_seqlens are given it builds the step's plan
    (one host read of each, here rather than in the layers' calls). The
    reference builds one only for pages of 512 or more, a TPU threshold
    that the port does not keep."""
    del qkv_dtype, headdim_v, has_softcap, num_splits
    plan = None
    if cu_seqlens_q is not None and cache_seqlens is not None:
        plan = make_varlen_plan(cu_seqlens_q, None, seqused_k=cache_seqlens,
                                causal=causal, window=window_size)
    return SchedulerMetadata(batch_size, max_seqlen_q, max_seqlen_k,
                             num_heads_q, num_heads_kv, headdim, causal,
                             plan=plan, page_size=page_size)


def dequant_pages(pool: torch.Tensor, table: torch.Tensor,
                  descale: Optional[torch.Tensor],
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The pages a block table lists, dequantized: a 1-byte head-major pool
    (npages, hk, page, w) read at table (nseq, max_pages) (every entry, its
    id clamped into the pool; no host read) into a contiguous (nseq *
    max_pages, hk, page, w) pool in `dtype`, entry i holding page
    table.flat[i] times its sequence's descale ((hk,) or (nseq, hk); 1 where
    None), rounded once. Plain torch, as the JAX module's XLA glue:
    gather, exact upcast, one scaled multiply."""
    nseq, max_pages = table.shape
    hk = pool.shape[1]
    ids = table.reshape(-1).long().clamp(0, pool.shape[0] - 1)
    pages = upcast_quant_tile(pool.view(torch.uint8)[ids].view(pool.dtype))
    scale = descale_of(descale, nseq, hk, pool.device)
    scale = scale.repeat_interleave(max_pages, dim=0).reshape(-1, hk, 1, 1)
    return torch.mul(pages, scale, out=torch.empty(pages.shape, dtype=dtype,
                                                   device=pool.device))


def _unported(what: str, item: str):
    return NotImplementedError(
        f"vllm_compat.flash_attn_varlen_func with {what} is not ported yet: "
        f"ROADMAP {item}")


def _held(what: str):
    return NotImplementedError(
        f"vllm_compat.flash_attn_varlen_func does not take {what}: the JAX "
        "entry ignores it (ROADMAP section 3, held differences)")


def flash_attn_varlen_func(
    q: torch.Tensor,   # (total_q, h, d) packed
    k: torch.Tensor,   # paged: (npages, page, hk, d); else (total_k, hk, d)
    v: Optional[torch.Tensor],
    max_seqlen_q: Optional[int] = None,
    cu_seqlens_q: Optional[torch.Tensor] = None,
    max_seqlen_k: Optional[int] = None,
    cu_seqlens_k: Optional[torch.Tensor] = None,
    seqused_k: Optional[torch.Tensor] = None,
    q_v=None,
    dropout_p: float = 0.0,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softmax_scale: Optional[float] = None,
    alibi_slopes=None,
    block_table: Optional[torch.Tensor] = None,
    softcap: float = 0.0,
    return_softmax_lse: bool = False,
    out: Optional[torch.Tensor] = None,
    scheduler_metadata: Optional[SchedulerMetadata] = None,
    fa_version: int = 0,
    q_descale=None, k_descale=None, v_descale=None,
    num_splits: int = 0,
    s_aux=None,
    cp_world_size: int = 1,
    cp_rank: int = 0,
    cp_tot_seqused_k=None,
    kv_cache_layout: str = "phd",
    **kwargs,
):
    """vLLM's varlen entry (vllm_flash_attn/flash_attn_interface.py:136),
    with the JAX module's signature, defaults and routes (see the module
    docstring). Returns out (total_q, h, d), and lse (h, total_q) fp32 with
    return_softmax_lse; `out`, when given, receives the result in place (as
    vLLM passes its output buffer) and is returned. A paged call makes no
    host read: the forward's grid comes from the shapes alone, and on pools
    whose page size is not a multiple of 8 (the sm80 route) from
    max_seqlen_q, or from the scheduler metadata's plan when its lengths and
    masking match the call's (the very tensors it was built from; otherwise
    the plan is not used). ALiBi slopes (h,) run on every route: kernel 6's
    feature instances (packed, and on the pools of a paged prefill), and
    kernel 5 on decode rows, where kernel 4 has no ALiBi."""
    del fa_version, num_splits, kwargs
    if q_v is not None:
        raise _unported("q_v", "queue 1, item 10 (MLA)")
    if dropout_p > 0.0:
        raise _held("dropout")
    if q.element_size() == 1:
        raise _unported("1-byte (fp8) queries", "queue 2, kernels 1 and 6 "
                                                "(fp8 queries and descales)")
    descaled = (q_descale is not None or k_descale is not None
                or v_descale is not None)
    if cp_world_size > 1:
        raise _unported("cp_world_size > 1",
                        "queue 1, item 12 (context parallelism)")

    if block_table is None:
        if descaled:
            raise _unported("descales and no block table",
                            "queue 2, kernels 1 and 6 (fp8 queries and "
                            "descales)")
        if s_aux is not None:
            raise _held("s_aux (sinks) without a block table")
        log_dispatch("varlen", route="packed", total_q=q.shape[0])
        res, lse, _ = _varlen_packed(
            q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
            softmax_scale=softmax_scale, causal=causal,
            window_size=window_size, softcap=softcap,
            alibi_slopes=alibi_slopes, seqused_k=seqused_k,
            return_attn_probs=True)
        return _finish(res, lse, out, return_softmax_lse)

    if cu_seqlens_q is None or seqused_k is None or max_seqlen_q is None:
        raise ValueError("a block_table call needs cu_seqlens_q, seqused_k "
                         "and max_seqlen_q")
    total_q, num_heads, head_dim = q.shape
    sm = scheduler_metadata
    if sm is not None and sm.num_heads_q != num_heads:
        raise ValueError(f"scheduler metadata for {sm.num_heads_q} query "
                         f"heads, call with {num_heads}")
    if kv_cache_layout == "phd":
        kc, vc = k.transpose(1, 2), v.transpose(1, 2)  # (npages, hk, page, d)
    elif kv_cache_layout == "hpd":
        kc, vc = k, v
    elif kv_cache_layout == "hpd_fused":
        kc, vc = k, None
    else:
        raise ValueError(f"unknown kv_cache_layout {kv_cache_layout!r}")
    fused = vc is None
    nseq = cu_seqlens_q.shape[0] - 1
    sq = int(max_seqlen_q)
    quant = kc.element_size() == 1
    if q_descale is not None:
        # q's descale enters the scores multiplicatively: it folds exactly
        # into the K descale (per sequence and kv head), on the decode route.
        hk = kc.shape[1]
        qd = q_descale.to(q.device, torch.float32).reshape(-1, hk)
        kd = (torch.ones(1, hk, dtype=torch.float32, device=q.device)
              if k_descale is None
              else k_descale.to(q.device, torch.float32).reshape(-1, hk))
        k_descale = kd * qd

    if (sq > _DECODE_MAX_Q and s_aux is None and q_descale is None
            and (quant or (k_descale is None and v_descale is None))):
        plan = None
        if sm is not None and sm.plan is not None and plan_mismatch(
                sm.plan, cu_seqlens_q=cu_seqlens_q, seqused_k=seqused_k,
                causal=True, window_size=window_size, host_read=False) is None:
            plan = sm.plan
        pools, table = (kc, vc), block_table
        if quant:
            # The JAX module's route for 1-byte pools: the listed pages
            # dequantized into a bf16 scratch pool, read through an
            # identity table.
            if fused:
                kpad = -(-head_dim // 128) * 128
                kc, vc = kc[..., :head_dim], kc[..., kpad:kpad + head_dim]
            table = torch.arange(block_table.numel(), dtype=torch.int32,
                                 device=q.device).reshape(block_table.shape)
            dt = q.dtype if q.element_size() == 2 else torch.bfloat16
            pools = (dequant_pages(kc, block_table, k_descale, dt),
                     dequant_pages(vc, block_table, v_descale, dt))
            fused = False
        log_dispatch("varlen", route="paged-prefill-dequant" if quant
                     else "paged-prefill-inkernel", page=kc.shape[2],
                     nseq=nseq, total_q=total_q, fused=fused,
                     plan=plan is not None)
        res, lse = flash_attention_varlen_fwd(
            q, None, None, cu_seqlens_q, None, seqused_k=seqused_k,
            alibi_slopes=alibi_slopes, softmax_scale=softmax_scale,
            causal=True, window_size=window_size, softcap=softcap,
            kv_pools=pools,
            block_table=table, head_dim_v=head_dim if fused else None,
            plan=plan, max_seqlen_q=None if plan is not None else sq)
        return _finish(res, lse, out, return_softmax_lse)

    route = ("paged-decode-sinks" if s_aux is not None else
             "paged-decode-alibi" if alibi_slopes is not None else
             "paged-decode")
    log_dispatch("varlen", route=route, page=kc.shape[2], nseq=nseq,
                 total_q=total_q, fused=fused)
    fused_kw = dict(fused_kv_dim=head_dim, fused_kv_dim_v=head_dim) if fused \
        else {}
    decode_kw = dict(block_table=block_table.to(torch.int32).contiguous(),
                     softmax_scale=softmax_scale, causal=True,
                     window_left=int(window_size[0]), softcap=softcap,
                     alibi_slopes=alibi_slopes, sink=s_aux, k_scale=k_descale,
                     v_scale=v_descale, **fused_kw)
    used = seqused_k.to(torch.int32).contiguous()
    if sq == 1 and total_q == nseq:
        # One row per sequence (vLLM's decode steps): the rows are already
        # right-aligned, so the packed rows are the kernel's batch.
        out_b, lse_b = flash_attention_decode(
            q.reshape(nseq, 1, num_heads, head_dim).contiguous(), kc, vc,
            used, **decode_kw)
        return _finish(out_b.reshape(total_q, num_heads, -1),
                       lse_b.reshape(nseq, num_heads).T, out,
                       return_softmax_lse)
    # Otherwise right-align each sequence's q rows into (nseq, sq), so the
    # decode kernel's pos = seqused_k - sq + i indexing lines up; the
    # left-pad rows are dropped on the repack.
    cu_q = cu_seqlens_q.to(q.device, torch.int64)
    lens = cu_q[1:] - cu_q[:-1]
    row = torch.arange(sq, device=q.device)[None]
    src = cu_q[:-1, None] + row - (sq - lens[:, None])
    valid = row >= sq - lens[:, None]
    q_pad = q[src.clamp(0, max(total_q - 1, 0)).reshape(-1)].reshape(
        nseq, sq, num_heads, head_dim)
    out_pad, lse_pad = flash_attention_decode(q_pad, kc, vc, used,
                                              **decode_kw)
    dst = torch.where(valid, src, total_q).reshape(-1)  # left pad -> dropped
    res = q.new_zeros((total_q + 1, num_heads, out_pad.shape[-1]))
    res[dst] = out_pad.reshape(nseq * sq, num_heads, -1)
    lse = torch.zeros((total_q + 1, num_heads), dtype=torch.float32,
                      device=q.device)
    lse[dst] = lse_pad.transpose(1, 2).reshape(nseq * sq, num_heads)
    return _finish(res[:total_q], lse[:total_q].T, out, return_softmax_lse)


def _finish(res, lse, out, return_softmax_lse):
    if out is not None:
        out.copy_(res)
        res = out
    return (res, lse) if return_softmax_lse else res


def sparse_attn_varlen_func(
    q: torch.Tensor,  # (total_q, h, d) packed
    k: torch.Tensor,  # (total_k, hk, d)
    v: torch.Tensor,
    block_count: torch.Tensor,   # (nseq, h, cdiv(max_seqlen_q, 64)) int32
    block_offset: torch.Tensor,  # (nseq, h, nqb, NNZ_S): each sequence's keys
    column_count: torch.Tensor,
    column_index: torch.Tensor,
    cu_seqlens_q: Optional[torch.Tensor] = None,
    cu_seqlens_k: Optional[torch.Tensor] = None,
    max_seqlen_q: Optional[int] = None,
    max_seqlen_k: Optional[int] = None,
    dropout_p: float = 0.0,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    deterministic: bool = False,
    return_attn_probs: bool = False,
    *,
    return_softmax_lse: bool = False,
    out: Optional[torch.Tensor] = None,
):
    """vLLM's varlen vertical-slash prefill call (vllm_flash_attn
    flash_attn_interface.py:388; the JAX module's :469). The metadata
    indexes each sequence's own keys, so the packed batch is unpacked into
    left-aligned (nseq, max_seqlen, h, d) rows, `sparse_attn_func` runs
    with each sequence's lengths as seqlens_q/k (causal bottom-right per
    sequence), and the rows are packed back. Returns out (total_q, h, d),
    and lse (h, total_q) fp32 with return_softmax_lse; `out`, when given,
    receives the result in place and is returned. Differentiable: the
    unpack and repack are gathers. With max_seqlen_q and max_seqlen_k given
    the call makes no host read; without, one read of cu_seqlens sizes
    them. `deterministic` and `return_attn_probs` are taken and not read."""
    del deterministic, return_attn_probs
    if dropout_p > 0.0:
        raise NotImplementedError(
            "vllm_compat.sparse_attn_varlen_func with dropout is not ported "
            "yet: ROADMAP queue 2, kernels 1-3 / 12-14: murmur3 dropout")
    if cu_seqlens_q is None or cu_seqlens_k is None:
        raise ValueError("sparse_attn_varlen_func needs cu_seqlens_q and "
                         "cu_seqlens_k")
    if max_seqlen_q is None or max_seqlen_k is None:
        max_seqlen_q, max_seqlen_k = resolve_max_seqlens(
            cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k, None)
    sq, sk = int(max_seqlen_q), int(max_seqlen_k)
    cu_q = cu_seqlens_q.to(q.device, torch.int64)
    cu_k = cu_seqlens_k.to(q.device, torch.int64)
    lens_q, lens_k = cu_q[1:] - cu_q[:-1], cu_k[1:] - cu_k[:-1]
    total_q, num_heads, head_dim = q.shape
    log_dispatch("sparse_varlen", route="unpack", nseq=cu_q.shape[0] - 1,
                 total_q=total_q)

    def unpack(x, cu, lens, smax):
        row = torch.arange(smax, device=x.device)[None]
        src = (cu[:-1, None] + row).clamp(0, max(x.shape[0] - 1, 0))
        xp = x[src.reshape(-1)].reshape(len(lens), smax, *x.shape[1:])
        return torch.where((row < lens[:, None])[..., None, None], xp,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    res, lse = sparse_attn_func(
        unpack(q, cu_q, lens_q, sq), unpack(k, cu_k, lens_k, sk),
        unpack(v, cu_k, lens_k, sk), block_count, block_offset,
        column_count, column_index, softmax_scale=softmax_scale,
        causal=causal, softcap=softcap, alibi_slopes=alibi_slopes,
        return_softmax_lse=True, seqlens_q=lens_q.to(torch.int32),
        seqlens_k=lens_k.to(torch.int32))
    # Repack: packed row t of sequence j is padded row (j, t - cu_q[j]).
    tok = torch.arange(total_q, device=q.device)
    seq = torch.searchsorted(cu_q[1:], tok, right=True).clamp_max(
        cu_q.shape[0] - 2)
    row = tok - cu_q[seq]
    valid = (tok < cu_q[-1]) & (row < sq)
    idx = torch.where(valid, seq * sq + row, 0)
    res = torch.where(valid[:, None, None],
                      res.reshape(-1, num_heads, res.shape[-1])[idx],
                      torch.zeros((), dtype=res.dtype, device=q.device))
    lse = torch.where(valid[None], lse.transpose(0, 1).reshape(
        num_heads, -1)[:, idx], torch.zeros((), device=q.device))
    return _finish(res, lse, out, return_softmax_lse)
