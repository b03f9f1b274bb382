"""The port's vLLM entry points against the JAX package's.

`vllm_compat.flash_attn_varlen_func` over vLLM-layout ("phd") paged pools
with page 16, on a step that mixes prefill chunks and 1-token decode rows
(kernel 6 reading pages) and on a decode-only step (kernel 4), and paged
`flash_attn_with_kvcache` with an append, each against flash_attn_tpu run
in interpret mode on the CPU, where the port's wrappers take their plain
versions. The CUDA kernels are held against those on the card by
chip_smoke.py (phases `varlen_kernels` and `vllm`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.flash_attn_interface import (
    flash_attn_with_kvcache as jax_kvcache,
)
from flash_attn_tpu.vllm_compat import flash_attn_varlen_func as jax_vllm
from flash_attn_tpu_torch import flash_attn_varlen_func as packed_varlen
from flash_attn_tpu_torch import vllm_compat
from flash_attn_tpu_torch.kernels.flash_varlen import (
    flash_attention_varlen_fwd_ref,
    plan_mismatch,
)
from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding
from flash_attn_tpu_torch.utils.fa_logging import dispatch_counts
from flash_attn_tpu_torch.utils.testing import attention_ref
from flash_attn_tpu_torch.vllm_compat import (
    flash_attn_varlen_func,
    flash_attn_with_kvcache,
    get_scheduler_metadata,
)

H, HK, D, PAGE = 4, 2, 64, 16
# float32 on both sides; the JAX paged routes gather pages (prefill) or run
# the multipage decode kernel, in base-2 online softmax.
RTOL = 1e-4
MIXED = dict(qlens=(1, 30, 1, 12), used=(50, 100, 7, 40), window=(24, 0))
DECODE = dict(qlens=(1, 1), used=(20, 35), window=(-1, -1))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _step(seed, qlens, used, window):
    rng = np.random.default_rng(seed)
    max_pages = -(-max(used) // PAGE)
    npages = len(used) * max_pages + 1
    table = rng.permutation(npages)[: len(used) * max_pages].reshape(
        len(used), max_pages).astype(np.int32)
    cu_q = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    return dict(
        q=rng.standard_normal((int(cu_q[-1]), H, D)).astype(np.float32),
        k=rng.standard_normal((npages, PAGE, HK, D)).astype(np.float32),
        v=rng.standard_normal((npages, PAGE, HK, D)).astype(np.float32),
        table=table, cu_q=cu_q, used=np.asarray(used, np.int32),
        max_q=max(qlens), max_k=max(used), window=window)


def _port_call(s, pools=None, **kw):
    t = torch.from_numpy
    k, v = pools or (t(s["k"]), t(s["v"]))
    args = dict(max_seqlen_q=s["max_q"], cu_seqlens_q=t(s["cu_q"]),
                max_seqlen_k=s["max_k"], seqused_k=t(s["used"]), causal=True,
                window_size=s["window"], block_table=t(s["table"]),
                return_softmax_lse=True)
    return flash_attn_varlen_func(t(s["q"]), k, v, **dict(args, **kw))


@pytest.fixture(scope="module", params=["mixed", "decode"])
def step_case(request):
    """One step and the JAX package's answer to it."""
    s = _step(len(request.param), **(MIXED if request.param == "mixed"
                                     else DECODE))
    out, lse = jax_vllm(
        jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
        max_seqlen_q=s["max_q"], cu_seqlens_q=s["cu_q"],
        max_seqlen_k=s["max_k"], seqused_k=s["used"], causal=True,
        window_size=s["window"], block_table=s["table"],
        return_softmax_lse=True)
    return request.param, s, np.asarray(out), np.asarray(lse)


def test_paged_step_matches_jax(step_case):
    route, s, out_j, lse_j = step_case
    dispatch_counts.clear()
    out, lse = _port_call(s)
    _close(out.numpy(), out_j)
    _close(lse.numpy(), lse_j)
    want = "paged-prefill-inkernel" if route == "mixed" else "paged-decode"
    assert dict(dispatch_counts) == {("varlen", want): 1}


def test_head_major_and_fused_pools_equal_phd(step_case):
    """The same pools as "hpd" (head-major) and "hpd_fused" (K|V on the last
    dim, each section padded to 128) give the "phd" answer: the same fp32
    values gathered from other strides (tolerance 1e-6)."""
    _, s, _, _ = step_case
    want, want_lse = _port_call(s)
    k, v = (torch.from_numpy(x).transpose(1, 2).contiguous()
            for x in (s["k"], s["v"]))
    fused = torch.cat([torch.nn.functional.pad(x, (0, 128 - D))
                       for x in (k, v)], dim=-1)
    for layout, pools in (("hpd", (k, v)), ("hpd_fused", (fused, None))):
        out, lse = _port_call(s, pools=pools, kv_cache_layout=layout)
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-6)


def test_decode_route_reads_phd_pools_as_views(monkeypatch):
    """Kernel 4 receives the vLLM pools as head-major views of the same
    memory: no copy of a pool per layer and step."""
    s = _step(2, **DECODE)
    seen = []
    original = vllm_compat.flash_attention_decode

    def spy(q, k_cache, v_cache, *args, **kw):
        seen.append((k_cache.data_ptr(), v_cache.data_ptr(),
                     k_cache.is_contiguous(), tuple(k_cache.shape)))
        return original(q, k_cache, v_cache, *args, **kw)

    monkeypatch.setattr(vllm_compat, "flash_attention_decode", spy)
    k, v = torch.from_numpy(s["k"]), torch.from_numpy(s["v"])
    _port_call(s, pools=(k, v))
    npages = s["k"].shape[0]
    assert seen == [(k.data_ptr(), v.data_ptr(), False, (npages, HK, PAGE, D))]


def test_one_row_decode_equals_right_aligned_decode():
    """A step whose every sequence has one row takes the direct path; the
    right-aligned path (forced by a larger max_seqlen_q, with left-pad rows
    dropped) gives the same bits, and so does a step with a 3-row sequence
    against the per-sequence reference."""
    s = _step(6, **DECODE)
    direct = _port_call(s)
    aligned = _port_call(s, max_seqlen_q=3)
    for got, want in zip(aligned, direct):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    multi = _step(8, qlens=(1, 3), used=(20, 35), window=(7, 0))
    out, _ = _port_call(multi)
    t = torch.from_numpy
    ref, _ = flash_attention_varlen_fwd_ref(
        t(multi["q"]), None, None, t(multi["cu_q"]), None,
        seqused_k=t(multi["used"]), causal=True, window_size=(7, 0),
        kv_pools=(t(multi["k"]).transpose(1, 2), t(multi["v"]).transpose(1, 2)),
        block_table=t(multi["table"]))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_scheduler_metadata_plan_reused_and_checked():
    """A step's plan serves the calls whose lengths and masking it was
    built for; a stale plan, or one built for another window, is not used
    and the call's answer is unchanged."""
    s = _step(3, **MIXED)
    t = torch.from_numpy
    cu_q, used = t(s["cu_q"]), t(s["used"])
    meta = dict(batch_size=4, max_seqlen_q=s["max_q"], max_seqlen_k=s["max_k"],
                num_heads_q=H, num_heads_kv=HK, headdim=D, causal=True,
                page_size=PAGE)
    sm = get_scheduler_metadata(**meta, cache_seqlens=used, cu_seqlens_q=cu_q,
                                window_size=s["window"])
    call = dict(cu_seqlens_q=cu_q, seqused_k=used, causal=True,
                window_size=s["window"])
    assert plan_mismatch(sm.plan, **call, host_read=False) is None
    assert (sm.plan.nseq, sm.plan.max_seqlen_q, sm.plan.max_seqlen_k) == (
        4, 30, 100)
    want, _ = _port_call(s)
    stale = get_scheduler_metadata(**meta, cache_seqlens=used + 1,
                                   cu_seqlens_q=cu_q, window_size=s["window"])
    other = get_scheduler_metadata(**meta, cache_seqlens=used,
                                   cu_seqlens_q=cu_q, window_size=(-1, -1))
    assert "seqused_k" in plan_mismatch(stale.plan, **call)
    assert "window" in plan_mismatch(other.plan, **call)
    for m in (sm, stale, other):
        out, _ = _port_call(s, scheduler_metadata=m)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    used.add_(0)  # an in-place write: the tensor is no longer the plan's
    assert plan_mismatch(sm.plan, **call) is None  # values still agree


def test_kvcache_paged_append_matches_jax():
    """Paged flash_attn_with_kvcache: rotary on q and the new k, the append
    into "phd" pools in place, and decode attention, against the JAX
    function (which returns new pools)."""
    s = _step(4, **DECODE)
    rng = np.random.default_rng(5)
    b = len(s["used"])
    q = rng.standard_normal((b, 1, H, D)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((b, 1, HK, D)).astype(np.float32)
                    for _ in range(2))
    cos, sin = (x.numpy() for x in RotaryEmbedding(32).cos_sin(64))
    lens = s["used"] - 1  # before the append
    out_j, lse_j, (kc_j, vc_j) = jax_kvcache(
        jnp.asarray(q), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
        k=jnp.asarray(k_new), v=jnp.asarray(v_new), rotary_cos=cos,
        rotary_sin=sin, cache_seqlens=lens, block_table=s["table"],
        causal=True, return_softmax_lse=True)
    t = torch.from_numpy
    k_cache, v_cache = t(s["k"].copy()), t(s["v"].copy())
    out, lse, (kc, vc) = flash_attn_with_kvcache(
        t(q), k_cache, v_cache, k=t(k_new), v=t(v_new), rotary_cos=t(cos),
        rotary_sin=t(sin), cache_seqlens=t(lens), block_table=t(s["table"]),
        causal=True, return_softmax_lse=True)
    assert kc is k_cache and vc is v_cache
    _close(out.numpy(), out_j)
    _close(lse.numpy(), lse_j)
    # The rotated k rows: fp32 rotary on both sides, 1e-6 for rounding.
    np.testing.assert_allclose(kc.numpy(), np.asarray(kc_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(vc.numpy(), np.asarray(vc_j))


def test_packed_route_and_out_buffer():
    """Without a block table the call is packed varlen attention; `out`
    receives the result in place."""
    rng = np.random.default_rng(6)
    cu = torch.tensor([0, 5, 17, 18], dtype=torch.int32)
    q, k, v = (torch.from_numpy(rng.standard_normal((18, n, D)).astype(
        np.float32)) for n in (H, HK, HK))
    want = packed_varlen(q, k, v, cu, cu, causal=True)
    buf = torch.empty_like(q)
    got = flash_attn_varlen_func(q, k, v, 12, cu, 12, cu, causal=True, out=buf)
    assert got is buf
    torch.testing.assert_close(buf, want, rtol=0, atol=0)


def test_unported_arguments_raise():
    s = _step(7, **DECODE)
    t = torch.from_numpy
    for extra in (dict(q_v=t(s["q"])),
                  dict(q_descale=torch.ones(1), block_table=None),
                  dict(k_descale=torch.ones(1), block_table=None),
                  dict(s_aux=torch.ones(H), block_table=None),
                  dict(cp_world_size=2), dict(dropout_p=0.1)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port_call(s, **extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attn_varlen_func(t(s["q"]).to(torch.float8_e4m3fn), t(s["k"]),
                               t(s["v"]), max_seqlen_q=s["max_q"],
                               cu_seqlens_q=t(s["cu_q"]),
                               seqused_k=t(s["used"]),
                               block_table=t(s["table"]))
    # The sparse entry points are ported; dropout is what they do not take.
    for fn in (vllm_compat.sparse_attn_func, vllm_compat.sparse_attn_varlen_func):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(*[None] * 7, dropout_p=0.1)


def test_sinks_step_matches_oracle_not_reference_interior_tiles():
    """A mixed step with s_aux sinks (gpt-oss) goes to the general decode
    kernel's paged route, every sequence's rows right-aligned, and equals
    the exact answer (out, and lse with the sink in its sum). The JAX
    kernel does not: it skips the mask on tiles that its FIRST query row
    sees whole (flash_decode.py:152-156), so later rows of a window attend
    keys left of their window."""
    s = _step(5, **MIXED)
    sinks = np.random.default_rng(6).standard_normal(H).astype(np.float32)
    dispatch_counts.clear()
    out, lse = _port_call(s, s_aux=torch.from_numpy(sinks))
    assert dict(dispatch_counts) == {("varlen", "paged-decode-sinks"): 1}
    t = torch.from_numpy
    cu = s["cu_q"]
    want = torch.zeros_like(out)
    for j, used in enumerate(s["used"].tolist()):
        rows = slice(int(cu[j]), int(cu[j + 1]))
        pages = t(s["table"][j]).long()
        k, v = (t(x)[pages].reshape(-1, HK, D)[:used][None]
                for x in (s["k"], s["v"]))
        q = t(s["q"])[rows][None]
        want[rows] = attention_ref(q, k, v, causal=True,
                                   window_size=s["window"],
                                   learnable_sink=t(sinks))[0][0]
        scores = torch.einsum("thd,shd->hts", q[0] * D**-0.5,
                              k[0].repeat_interleave(H // HK, dim=1))
        pos = used - q.shape[1] + torch.arange(q.shape[1])[:, None]
        col = torch.arange(used)[None]
        seen = (col <= pos) & (col >= pos - s["window"][0])
        scores = scores.masked_fill(~seen, float("-inf"))
        sink_col = t(sinks)[:, None, None].expand(H, q.shape[1], 1)
        _close(lse[:, rows].numpy(),
               torch.logsumexp(torch.cat([scores, sink_col], -1), -1).numpy())
    _close(out.numpy(), want.numpy())
    out_j = jax_vllm(
        jnp.asarray(s["q"]), jnp.asarray(s["k"]), jnp.asarray(s["v"]),
        max_seqlen_q=s["max_q"], cu_seqlens_q=s["cu_q"],
        max_seqlen_k=s["max_k"], seqused_k=s["used"], causal=True,
        window_size=s["window"], block_table=s["table"],
        s_aux=jnp.asarray(sinks))
    assert np.abs(np.asarray(out_j) - want.numpy()).max() > 0.1
