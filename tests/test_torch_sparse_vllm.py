"""The port's `vllm_compat.sparse_attn_varlen_func` (vLLM's packed
vertical-slash prefill call) against the JAX package's.

The same numpy-seeded packed q, k, v and per-sequence metadata go through
both modules' functions (the JAX side's Pallas kernels in interpret mode on
the CPU; the port's wrappers take their plain versions there): out and the
lse layout. The gradients through the unpack and repack are held against
the exact oracle run on each sequence alone (`sparse_attn_func`'s own
gradients are held against the JAX package's in test_torch_sparse.py).
Each JAX result is built once per module. Both sides run in fp32 (see
test_torch_sparse.py on the tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.vllm_compat import (
    sparse_attn_varlen_func as jax_sparse_varlen,
)
from flash_attn_tpu_torch import vllm_compat
from flash_attn_tpu_torch.utils.testing import sparse_attention_ref

H, HK, D = 2, 1, 32
LENS = (128, 40, 97)
MAX = 128
RTOL = 1e-4


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    t = sum(LENS)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (t, H, D), (t, HK, D), (t, HK, D), (t, H, D)))


def _meta(seed, unaligned=False):
    """Per-sequence metadata (nseq, h, cdiv(MAX, 64), NNZ), offsets into
    each sequence's own keys; unaligned offsets only for the port-only
    oracle test (the JAX package rounds them, see test_torch_sparse.py)."""
    rng = np.random.default_rng(seed)
    shape = (len(LENS), H, -(-MAX // 64))
    bo = rng.integers(0, MAX // 64 + 1, shape + (2,)) * 64
    if unaligned:
        bo = bo + rng.integers(0, 64, bo.shape)
    return (rng.integers(1, 3, shape).astype(np.int32), bo.astype(np.int32),
            rng.integers(0, 6, shape).astype(np.int32),
            rng.integers(0, MAX, shape + (5,)).astype(np.int32))


def _port(inputs, meta, grads=False, **kw):
    q, k, v, do = (torch.from_numpy(x).requires_grad_(grads) for x in inputs)
    cu = torch.from_numpy(_cu(LENS))
    out, lse = vllm_compat.sparse_attn_varlen_func(
        q, k, v, *map(torch.from_numpy, meta), cu, cu, MAX, MAX,
        return_softmax_lse=True, **kw)
    res = [out.detach().numpy(), lse.numpy()]
    if grads:
        res += [g.numpy() for g in torch.autograd.grad(out, (q, k, v),
                                                       do.detach())]
    return res


def _jax(inputs, meta, **kw):
    q, k, v = map(jnp.asarray, inputs[:3])
    cu = jnp.asarray(_cu(LENS))
    out = jax_sparse_varlen(q, k, v, *map(jnp.asarray, meta), cu, cu, MAX,
                            MAX, return_softmax_lse=True, **kw)
    return [np.asarray(x) for x in out]


def _oracle(inputs, meta, grads=False, **kw):
    """Each sequence alone through `sparse_attention_ref` with its own
    metadata rows: (out, lse (h, total_q)[, dq, dk, dv])."""
    q, k, v, do = (torch.from_numpy(x).requires_grad_(grads) for x in inputs)
    cu = _cu(LENS)
    outs, lses = [], []
    for j, n in enumerate(LENS):
        rows = slice(cu[j], cu[j + 1])
        o, lse = sparse_attention_ref(
            q[rows][None], k[rows][None], v[rows][None],
            *(torch.from_numpy(m[j:j + 1, :, :-(-n // 64)]) for m in meta),
            **kw)
        outs.append(o[0])
        lses.append(lse[0])
    out, lse = torch.cat(outs), torch.cat(lses, 1)
    res = [out.detach().numpy(), lse.detach().numpy()]
    if grads:
        res += [g.numpy() for g in torch.autograd.grad(out, (q, k, v),
                                                       do.detach())]
    return res


@pytest.fixture(scope="module")
def causal_case():
    inputs, meta = _inputs(0), _meta(0)
    return inputs, meta, _jax(inputs, meta, causal=True)


def test_causal_forward_lse_and_grads_match_jax(causal_case):
    """Causal per sequence: out (total_q, h, d) and lse (h, total_q) equal
    the JAX package's; the gradients through the unpack and repack equal
    the exact oracle's."""
    inputs, meta, want = causal_case
    got = _port(inputs, meta, grads=True, causal=True)
    assert got[1].shape == (H, sum(LENS))
    for g, w in zip(got[:2], want):
        _close(g, w)
    for g, w in zip(got, _oracle(inputs, meta, grads=True, causal=True)):
        _close(g, w)


def test_noncausal_forward_matches_jax():
    inputs, meta = _inputs(1), _meta(1)
    for g, w in zip(_port(inputs, meta), _jax(inputs, meta)):
        _close(g, w)


def test_unaligned_offsets_match_oracle_per_sequence():
    """With unaligned offsets each sequence's rows equal the exact oracle
    run on that sequence alone with its own metadata."""
    inputs, meta = _inputs(2), _meta(2, unaligned=True)
    for g, w in zip(_port(inputs, meta, causal=True),
                    _oracle(inputs, meta, causal=True)):
        _close(g, w)


def test_out_buffer_receives_the_result(causal_case):
    """vLLM passes its output buffer: the result lands in it and it is
    what comes back."""
    inputs, meta, want = causal_case
    q, k, v = (torch.from_numpy(x) for x in inputs[:3])
    cu = torch.from_numpy(_cu(LENS))
    buf = torch.full((sum(LENS), H, D), 7.0)
    res = vllm_compat.sparse_attn_varlen_func(
        q, k, v, *map(torch.from_numpy, meta), cu, cu, MAX, MAX, causal=True,
        out=buf)
    assert res is buf
    _close(buf.numpy(), want[0])


def test_given_max_seqlens_read_nothing_on_the_host(monkeypatch):
    """With max_seqlen_q/k given, cu_seqlens stays on the device: the one
    host read (resolve_max_seqlens) is not made; without them, it is."""
    inputs, meta = _inputs(3), _meta(3)

    def no_read(*args):
        raise AssertionError("host read of cu_seqlens")

    monkeypatch.setattr(vllm_compat, "resolve_max_seqlens", no_read)
    _port(inputs, meta, causal=True)
    q, k, v = (torch.from_numpy(x) for x in inputs[:3])
    cu = torch.from_numpy(_cu(LENS))
    with pytest.raises(AssertionError, match="host read"):
        vllm_compat.sparse_attn_varlen_func(
            q, k, v, *map(torch.from_numpy, meta), cu, cu, causal=True)


def test_dropout_raises_with_its_roadmap_item():
    inputs, meta = _inputs(4), _meta(4)
    with pytest.raises(NotImplementedError, match="12-14: murmur3 dropout"):
        _port(inputs, meta, dropout_p=0.1)
