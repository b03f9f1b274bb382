"""The port's dense flash attention against the JAX package's.

The same numpy-seeded q, k, v and output cotangent go through
flash_attn_tpu's `flash_attn_func` (Pallas in interpret mode on the CPU)
and `jax.vjp`, and through the port's `flash_attn_func` and
`torch.autograd.grad`. On the CPU the port's autograd function runs the
kernels' plain versions: `flash_attention_fwd_ref`, then `_bwd_dkv_ref` and
`_bwd_dq_ref`, which recompute P from Q, K and the LSE as the CUDA kernels
do. The CUDA kernels themselves are held against those plain versions on
the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.flash_attn_interface import flash_attn_func as jax_flash_attn
from flash_attn_tpu_torch.flash_attn_interface import (
    flash_attn_func,
    flash_attn_kvpacked_func,
)
from flash_attn_tpu_torch.kernels.common import dropout_keep_mask
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd

B, H, HK, D = 2, 4, 2, 32
# float32 on both sides: the two differ only in summation order.
RTOL = 1e-4

# (sq, sk, causal, window_size, softcap)
CASES = {
    "causal-gqa": (64, 64, True, (-1, -1), 0.0),
    "causal-window-15": (64, 64, True, (15, -1), 0.0),
    "causal-softcap": (48, 48, True, (-1, -1), 5.0),
    "noncausal-sq-lt-sk": (40, 64, False, (-1, -1), 0.0),
}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attn_matches_jax(case):
    sq, sk, causal, window, softcap = CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, sk, HK, D)).astype(np.float32)
    v = rng.standard_normal((B, sk, HK, D)).astype(np.float32)
    dout = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    kw = dict(causal=causal, window_size=window, softcap=softcap)

    @jax.jit
    def jax_fwd_bwd(q, k, v, dout):
        (out, lse), vjp = jax.vjp(
            lambda q, k, v: jax_flash_attn(q, k, v, return_attn_probs=True,
                                           **kw)[:2], q, k, v)
        return out, lse, vjp((dout, jnp.zeros_like(lse)))

    out_j, lse_j, grads_j = jax_fwd_bwd(*map(jnp.asarray, (q, k, v, dout)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse, _ = flash_attn_func(tq, tk, tv, return_attn_probs=True, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))

    _close(out.detach().numpy(), out_j)
    _close(lse.numpy(), lse_j)
    for got, want in zip(grads, grads_j):
        _close(got.numpy(), want)


def test_kvpacked_and_bhsd_layouts_agree():
    """The packed form and the bhsd layout are views of the same call."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, 24, H, D)).astype(np.float32))
    kv = torch.from_numpy(
        rng.standard_normal((B, 24, 2, HK, D)).astype(np.float32))
    want = flash_attn_func(q, kv[:, :, 0], kv[:, :, 1], causal=True)
    packed = flash_attn_kvpacked_func(q, kv, causal=True)
    bhsd = flash_attn_func(*(x.transpose(1, 2) for x in
                             (q, kv[:, :, 0], kv[:, :, 1])),
                           causal=True, layout="bhsd").transpose(1, 2)
    torch.testing.assert_close(packed, want, rtol=0, atol=0)
    torch.testing.assert_close(bhsd, want, rtol=0, atol=0)


@pytest.mark.parametrize("extra", [
    dict(qv=torch.zeros(1, 2, 8, 64), window_size=(2, 0)),
    dict(bias=torch.zeros(1)),
    dict(k_descale=torch.ones(1)), dict(score_mod=lambda s, *a: s),
    dict(cp_world_size=2),
], ids=lambda e: next(iter(e)))
def test_unported_arguments_raise(extra):
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention_fwd(q, q, q, **extra)


def _dense_answer(q, k, v, visible, bias=0.0, sink=None, keep=None, p=0.0):
    """softmax(q k^T / sqrt(d) + bias) v over the visible keys, written out:
    exp(sink) joins each row's sum, dropped entries leave P V, scaled by
    1 / (1 - p); a row that sees nothing gives 0."""
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5 + bias
    s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(-1, keepdim=True)
    if sink is not None:
        m = torch.maximum(m, sink.reshape(1, -1, 1, 1))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    if sink is not None:
        l = l + torch.exp(sink.reshape(1, -1, 1, 1) - m)
    if keep is not None:
        e = torch.where(keep, e, torch.zeros_like(e)) / (1.0 - p)
    return torch.where(l > 0, (e @ v) / l.clamp_min(1e-30), torch.zeros(()))


_S = 40
_ROW = torch.arange(_S)[:, None]
_COL = torch.arange(_S)[None]
_SEG = torch.tensor([[0] * 13 + [1] * 20 + [-1] * 7])


@pytest.mark.parametrize("extra", [
    dict(dropout_p=0.1), dict(alibi_slopes=torch.tensor([0.5, 0.125])),
    dict(sink=torch.tensor([0.3, -1.0])), dict(attention_chunk=16),
    dict(sink_token_length=4, window_size=(8, -1), causal=True),
    dict(q_segment_ids=_SEG, kv_segment_ids=torch.where(_SEG < 0, -2, _SEG)),
    dict(qv=torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 2, _S, 64)).astype(np.float32)), softmax_scale=0.125),
], ids=lambda e: next(iter(e)))
def test_ported_arguments_answer(extra):
    """The arguments of the JAX signature that kernels 1-3 took in their
    feature instances, and kernel 1's qv forward, give the answer written
    out by hand (the JAX
    package's rules; tests/test_torch_attn_features.py holds them to the
    JAX package itself)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, _S, 64)).astype(
        np.float32)) for _ in range(3))
    out, _ = flash_attention_fwd(q, k, v, **extra)
    visible, bias, keep = torch.ones(_S, _S, dtype=torch.bool), 0.0, None
    if "dropout_p" in extra:
        keep = dropout_keep_mask(0, 0, torch.arange(2).reshape(1, 2, 1, 1),
                                 0, 0, (_S, _S), 0.9)
    if "alibi_slopes" in extra:
        bias = -extra["alibi_slopes"].reshape(1, 2, 1, 1) * (_COL - _ROW).abs()
    if "attention_chunk" in extra:
        visible = _COL // 16 == _ROW // 16
    if "sink_token_length" in extra:
        visible = (_COL <= _ROW) & ((_COL >= _ROW - 8) | (_COL < 4))
    if "q_segment_ids" in extra:
        visible = (_SEG[0, :, None] == _SEG[0, None, :]) & (_SEG[0, :, None] >= 0)
    if "qv" in extra:  # MLA's absorbed scores, at the scale 1/8 given
        bias = extra["qv"] @ v.transpose(-1, -2) * 0.125
    want = _dense_answer(q, k, v, visible, bias, extra.get("sink"), keep,
                         extra.get("dropout_p", 0.0))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
