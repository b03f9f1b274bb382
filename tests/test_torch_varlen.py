"""The port's packed varlen attention against the JAX package's.

The same numpy-seeded packed q, k, v and output cotangent go through
flash_attn_tpu's `flash_attn_varlen_func` (Pallas in interpret mode on the
CPU) and the port's, forward and `torch.autograd.grad`. On the CPU the
port's kernel wrappers run their plain versions
(`flash_attention_varlen_fwd_ref`, `_varlen_dq_ref`, `_varlen_dkv_ref`);
chip_smoke.py holds the CUDA kernels against those on the card. Each JAX
result is built once per module: the interpret-mode calls cost seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.flash_attn_interface import (
    flash_attn_varlen_func as jax_varlen,
)
from flash_attn_tpu.kernels.flash_varlen import (
    make_varlen_metadata as jax_metadata,
)
from flash_attn_tpu.utils import padding as jax_padding
from flash_attn_tpu_torch import (
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
    make_varlen_plan,
)
from flash_attn_tpu_torch.kernels.flash_varlen import (
    flash_attention_varlen_fwd,
    make_varlen_metadata,
    resolve_max_seqlens,
)
from flash_attn_tpu_torch.utils import padding
from flash_attn_tpu_torch.utils.testing import (
    generate_random_padding_mask,
    varlen_attention_ref,
)

H, HK, D = 4, 2, 64
LENS = (37, 64, 5, 90)
# float32 on both sides: they differ in summation order and in the JAX
# kernel's base-2 online softmax.
RTOL = 1e-4


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _inputs(seed, lens_q, lens_k):
    rng = np.random.default_rng(seed)
    tq, tk = sum(lens_q), sum(lens_k)
    return (rng.standard_normal((tq, H, D)).astype(np.float32),
            rng.standard_normal((tk, HK, D)).astype(np.float32),
            rng.standard_normal((tk, HK, D)).astype(np.float32),
            rng.standard_normal((tq, H, D)).astype(np.float32))


@pytest.fixture(scope="module")
def causal_window_case():
    """Causal GQA, window (31, 0): the JAX forward, LSE and gradients."""
    q, k, v, do = _inputs(0, LENS, LENS)
    cu = _cu(LENS)
    kw = dict(causal=True, window_size=(31, 0))

    def fwd(q, k, v):
        return jax_varlen(q, k, v, cu, cu, return_attn_probs=True, **kw)[:2]

    (out, lse), vjp = jax.vjp(fwd, *map(jnp.asarray, (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return dict(inputs=(q, k, v, do), cu=cu, kw=kw, out=np.asarray(out),
                lse=np.asarray(lse), grads=[np.asarray(g) for g in grads])


def _port(inputs, cu_q, cu_k, **kw):
    q, k, v, do = (torch.from_numpy(x).requires_grad_() for x in inputs)
    out, lse, _ = flash_attn_varlen_func(
        q, k, v, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
        return_attn_probs=True, **kw)
    grads = torch.autograd.grad(out, (q, k, v), do.detach())
    return out.detach(), lse, grads


def test_causal_window_gqa_matches_jax(causal_window_case):
    c = causal_window_case
    out, lse, grads = _port(c["inputs"], c["cu"], c["cu"], **c["kw"])
    _close(out.numpy(), c["out"])
    _close(lse.numpy(), c["lse"])
    for got, want in zip(grads, c["grads"]):
        _close(got.numpy(), want)


def test_noncausal_seqused_k_matches_jax():
    lens_k = (50, 64, 9, 100)
    used = np.array([41, 64, 3, 77], np.int32)
    q, k, v, do = _inputs(1, LENS, lens_k)
    cu_q, cu_k = _cu(LENS), _cu(lens_k)
    out_j, lse_j = jax_varlen(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              cu_q, cu_k, seqused_k=used,
                              return_attn_probs=True)[:2]
    out, lse, _ = flash_attn_varlen_func(
        *map(torch.from_numpy, (q, k, v, cu_q, cu_k)),
        seqused_k=torch.from_numpy(used), return_attn_probs=True)
    _close(out.numpy(), out_j)
    _close(lse.numpy(), lse_j)


def test_hsd_layout_equals_thd(causal_window_case):
    """The reference has no hsd test: hold the port's hsd against its thd.
    The same fp32 arithmetic on transposed views: 1e-6 covers a summation
    order that may differ with the strides."""
    c = causal_window_case
    out, lse, grads = _port(c["inputs"], c["cu"], c["cu"], **c["kw"])
    hsd = [np.ascontiguousarray(x.transpose(1, 0, 2)) for x in c["inputs"]]
    out_h, lse_h, grads_h = _port(hsd, c["cu"], c["cu"], layout="hsd",
                                  **c["kw"])
    torch.testing.assert_close(out_h.transpose(0, 1), out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_h, lse, rtol=1e-6, atol=1e-6)
    for got, want in zip(grads_h, grads):
        torch.testing.assert_close(got.transpose(0, 1), want, rtol=1e-6,
                                   atol=1e-6)


def test_packed_forms_equal_separate_tensors(causal_window_case):
    c = causal_window_case
    q, k, v, _ = map(torch.from_numpy, c["inputs"])
    cu = torch.from_numpy(c["cu"])
    want = flash_attn_varlen_func(q, k, v, cu, cu, **c["kw"])
    kv = torch.stack([k, v], 1)
    torch.testing.assert_close(
        flash_attn_varlen_kvpacked_func(q, kv, cu, cu, **c["kw"]), want,
        rtol=0, atol=0)
    qkv = torch.stack([q[:, :HK], k, v], 1)  # h = hk for the qkv form
    torch.testing.assert_close(
        flash_attn_varlen_qkvpacked_func(qkv, cu, **c["kw"]),
        flash_attn_varlen_func(q[:, :HK], k, v, cu, cu, **c["kw"]),
        rtol=0, atol=0)


@pytest.mark.parametrize("causal,window", [(True, (-1, -1)), (True, (7, 0)),
                                           (False, (5, 3))])
def test_plain_versions_match_per_sequence_reference(causal, window):
    """Lengths 0 and 1, seqused_q > seqused_k and seqused_k = 0: rows that
    see nothing give out 0, lse -inf and zero, finite gradients. fp32 on
    both sides (tolerance 1e-5)."""
    lens_q, lens_k = (12, 0, 1, 20, 9), (15, 4, 1, 6, 9)
    used_q = torch.tensor([12, 0, 1, 14, 9], dtype=torch.int32)
    used_k = torch.tensor([15, 4, 1, 5, 0], dtype=torch.int32)
    q, k, v, do = map(torch.from_numpy, _inputs(3, lens_q, lens_k))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    cu_q, cu_k = (torch.from_numpy(_cu(x)) for x in (lens_q, lens_k))
    kw = dict(causal=causal, window_size=window)
    used = dict(seqused_q=used_q, seqused_k=used_k)
    out, lse, _ = flash_attn_varlen_func(q, k, v, cu_q, cu_k,
                                         return_attn_probs=True, **used, **kw)
    ref = varlen_attention_ref(q, k, v, cu_q, cu_k, **used, **kw)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    empty = torch.isinf(lse).all(0)
    # Rows past seqused_q (8 of sequence 3), the sequence with seqused_k 0
    # (9), and rows above the diagonal of sequence 3 (used_q 14 > used_k 5).
    assert empty.sum() >= 17
    assert not out[empty].any()
    grads = torch.autograd.grad(out, (q, k, v), do)
    grads_ref = torch.autograd.grad(ref, (q, k, v), do)
    for got, want in zip(grads, grads_ref):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not grads[0][empty].any()


def test_metadata_intervals_match_jax():
    """Every row's visible interval [lo, hi] and segment, against the JAX
    planner run in numpy, with seqused_q/k, causal and a window."""
    lens_q, lens_k = (5, 0, 17, 3), (9, 2, 20, 3)
    used_q, used_k = np.array([5, 0, 11, 3]), np.array([9, 1, 20, 0])
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    kw = dict(causal=True, window=(4, -1))
    want = jax_metadata(cu_q, cu_k, int(cu_q[-1]), int(cu_k[-1]),
                        seqused_q=used_q, seqused_k=used_k, block_q=8,
                        block_kv=8, xp=np, **kw)
    got = make_varlen_metadata(torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                               int(cu_q[-1]), seqused_q=torch.from_numpy(used_q),
                               seqused_k=torch.from_numpy(used_k), **kw)
    total_q = int(cu_q[-1])  # the JAX rows run on to a whole tile
    qseg, lo, hi = (want[i][:total_q, 0] for i in (0, 3, 4))
    np.testing.assert_array_equal(got.qseg.numpy(), qseg)
    live = qseg >= 0
    np.testing.assert_array_equal(got.lo.numpy()[live], lo[live])
    np.testing.assert_array_equal(got.hi.numpy()[live], hi[live])
    np.testing.assert_array_equal((got.hi - got.lo).numpy() < 0,
                                  (hi - lo) < 0)


def test_unpad_pad_round_trip_matches_jax():
    """unpad_input / pad_input against the JAX padding functions (plain
    XLA, no Pallas), bit for bit."""
    gen = torch.Generator().manual_seed(4)
    mask = generate_random_padding_mask(24, 5, mode="random", zero_lengths=True,
                                        generator=gen)
    x = torch.randn(5, 24, 3, 8, generator=gen)
    got = padding.unpad_input(x, mask)
    want = jax_padding.unpad_input(jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = padding.pad_input(got[0], got[1], 5, 24)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_padding.pad_input(want[0], want[1], 5, 24)))
    # Every row goes back, padding rows included (the buffer holds b * s).
    torch.testing.assert_close(back, x, rtol=0, atol=0)
    total = int(mask.sum())
    packed, idx, *_ = padding.unpad_input(x, mask, total_tokens=total)
    torch.testing.assert_close(padding.pad_input(packed, idx, 5, 24),
                               x * mask[..., None, None], rtol=0, atol=0)


def test_unpad_concatenated_sequences_matches_jax():
    lengths = np.array([[3, 4, 0, 0, 0, 0], [6, 0, 0, 0, 0, 0],
                        [1, 1, 2, 0, 0, 0]], np.int32)
    x = np.random.default_rng(5).standard_normal((3, 6, 4)).astype(np.float32)
    got = padding.unpad_input_for_concatenated_sequences(
        torch.from_numpy(x), torch.from_numpy(lengths))
    want = jax_padding.unpad_input_for_concatenated_sequences(
        jnp.asarray(x), jnp.asarray(lengths))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_plan_refuses_stale_lengths_and_other_masking(causal_window_case):
    """A plan built for the call gives the plan-less answer; one built from
    other lengths, or for another causal or window, is refused."""
    c = causal_window_case
    q, k, v, _ = map(torch.from_numpy, c["inputs"])
    cu = torch.from_numpy(c["cu"])
    kw = dict(causal=True, window_size=(31, 0))
    plan = make_varlen_plan(cu, cu, causal=True, window=(31, 0))
    assert (plan.nseq, plan.max_seqlen_q, plan.max_seqlen_k) == (4, 90, 90)
    # The grid sizes: the caller's, else the plan's, else read from cu.
    assert resolve_max_seqlens(cu, cu, None, None, None) == (90, 90)
    assert resolve_max_seqlens(cu, cu, 7, None, plan) == (7, 90)
    want = flash_attn_varlen_func(q, k, v, cu, cu, **kw)
    torch.testing.assert_close(
        flash_attn_varlen_func(q, k, v, cu, cu, plan=plan, **kw), want,
        rtol=0, atol=0)
    stale = make_varlen_plan(torch.from_numpy(_cu((37, 64, 6, 89))), cu,
                             causal=True, window=(31, 0))
    for bad, call_kw in ((stale, kw), (plan, dict(kw, window_size=(15, 0))),
                         (plan, dict(causal=False, window_size=(31, 0)))):
        with pytest.raises(ValueError, match="stale VarlenPlan"):
            flash_attn_varlen_func(q, k, v, cu, cu, plan=bad, **call_kw)


def test_unported_arguments_raise():
    q = torch.zeros(8, 2, 64)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    for extra in (dict(dropout_p=0.1), dict(qv=q), dict(alibi_slopes=q),
                  dict(attn_bias=q), dict(attention_chunk=4),
                  dict(score_mod=lambda s, *a: s), dict(cp_world_size=2),
                  dict(aux_tensors=(q,))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            flash_attention_varlen_fwd(q, q, q, cu, cu, **extra)
    for extra in (dict(bias_grad=True), dict(gather_kv_indices=q)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            flash_attn_varlen_func(q, q, q, cu, cu, **extra)
