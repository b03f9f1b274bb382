"""The port's vertical-slash sparse attention against the JAX package's.

The same numpy-seeded q, k, v, metadata and output cotangent go through
flash_attn_tpu's `sparse_attn_func` (Pallas in interpret mode on the CPU,
its tile-list or gather route as its router picks) and the port's, forward
and `torch.autograd.grad`. On the CPU the port's kernel wrappers run their
plain versions (`flash_attention_sparse_fwd_ref`, `_sparse_dq_ref`,
`_sparse_dkv_ref`); chip_smoke.py holds kernels 12-15 against those on the
card. The planners, which only the card's kernels read, are held here
against a numpy brute-force bitmap. Each JAX result is built once per
module: an interpret-mode call costs seconds.

Both sides run in fp32 and differ only in summation order and the JAX
kernels' base-2 online softmax, so RTOL is far inside the numerics contract
(2 x the bf16-eager error against an fp32 oracle).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import sparse_attn_func as jax_sparse
from flash_attn_tpu.flash_blocksparse_attention import (
    convert_blockmask as jax_convert_blockmask,
)
from flash_attn_tpu_torch import (
    convert_blockmask,
    flash_blocksparse_attn_func,
    sparse_attn_func,
)
from flash_attn_tpu_torch.kernels.flash_sparse import (
    flash_attention_sparse_fwd,
    flash_attention_sparse_tiles_fwd,
    plan_inverse,
    plan_sparse,
    sparse_route,
)
from flash_attn_tpu_torch.kernels.flash_sparse_gather import (
    flash_attention_sparse_gather_fwd,
    plan_gather,
)
from flash_attn_tpu_torch.utils import sparse_crossover
from flash_attn_tpu_torch.utils.testing import (
    attention_ref,
    sparse_attention_ref,
)

RTOL = 1e-4


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL,
                               atol=RTOL * np.abs(want[finite]).max())


def _qkv(seed, b, sq, sk, h, hk, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d), (b, sq, h, d)))


def _partition(b, h, sq, sk, nnz_s):
    """Slash tiles over the first nnz_s * 64 keys and every other key as a
    vertical column: the union covers all keys, so sparse equals dense
    (the reference's construction, tests/test_vllm_flash_attn.py:387)."""
    nqb = -(-sq // 64)
    nnz_v = sk - 64 * nnz_s
    shape = (b, h, nqb)
    return (np.full(shape, nnz_s, np.int32),
            np.broadcast_to(np.arange(nnz_s, dtype=np.int32) * 64,
                            shape + (nnz_s,)).copy(),
            np.full(shape, nnz_v, np.int32),
            np.broadcast_to(64 * nnz_s + np.arange(nnz_v, dtype=np.int32),
                            shape + (nnz_v,)).copy())


def _random_meta(seed, b, h, sq, sk, nnz_s, nnz_v):
    """Aligned slash offsets that may overlap or repeat, vertical columns
    with repeats and columns inside slash ranges, garbage past the counts."""
    rng = np.random.default_rng(seed)
    nqb = -(-sq // 64)
    bo = (rng.integers(0, sk // 64, (b, h, nqb, nnz_s)) * 64).astype(np.int32)
    ci = rng.integers(0, sk, (b, h, nqb, nnz_v)).astype(np.int32)
    ci[..., 1] = ci[..., 0]
    ci[..., 2] = bo[..., 0] + 5
    bc = rng.integers(1, nnz_s + 1, (b, h, nqb)).astype(np.int32)
    cc = rng.integers(3, nnz_v + 1, (b, h, nqb)).astype(np.int32)
    past_s = np.arange(nnz_s) >= bc[..., None]
    past_v = np.arange(nnz_v) >= cc[..., None]
    bo[past_s] = rng.integers(-500, 5 * sk, past_s.sum())
    ci[past_v] = rng.integers(-500, 5 * sk, past_v.sum())
    return bc, bo, cc, ci


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _jax_run(inputs, meta, grads, **kw):
    """The JAX result: (out, lse[, dq, dk, dv]) as numpy."""
    q, k, v, do = map(jnp.asarray, inputs)
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}

    def fwd(q, k, v):
        return jax_sparse(q, k, v, *map(jnp.asarray, meta),
                          return_softmax_lse=True, **jkw)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        (out, lse), vjp = jax.vjp(fwd, q, k, v)
        return (out, lse, *vjp((do, jnp.zeros_like(lse))))

    if not grads:
        return [np.asarray(x) for x in jax.jit(fwd)(q, k, v)]
    return [np.asarray(x) for x in fwd_bwd(q, k, v, do)]


def _port_run(inputs, meta, grads, **kw):
    q, k, v, do = (torch.from_numpy(x).requires_grad_(grads) for x in inputs)
    tkw = {key: (_t(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    out, lse = sparse_attn_func(q, k, v, *map(_t, meta),
                                return_softmax_lse=True, **tkw)
    res = [out.detach().numpy(), lse.numpy()]
    if grads:
        res += [g.numpy() for g in torch.autograd.grad(out, (q, k, v),
                                                       do.detach())]
    return res


@pytest.fixture(scope="module")
def gqa_case():
    """Causal GQA (4 query heads over 2 kv heads), random pattern with
    overlaps, repeats and garbage, sq = sk = 128: the JAX forward, LSE and
    gradients."""
    inputs = _qkv(1, 1, 128, 128, 4, 2, 32)
    meta = _random_meta(1, 1, 4, 128, 128, 3, 9)
    kw = dict(causal=True)
    return inputs, meta, kw, _jax_run(inputs, meta, True, **kw)


@pytest.fixture(scope="module")
def alibi_case():
    """ALiBi slopes per batch row, softcap, seqlens_q/k (left-aligned
    sequences of their own lengths), causal."""
    inputs = _qkv(2, 2, 130, 160, 2, 1, 32)
    meta = _random_meta(2, 2, 2, 130, 160, 2, 7)
    kw = dict(causal=True, softcap=5.0,
              alibi_slopes=np.array([[0.5, 0.25], [0.3, 0.1]], np.float32),
              seqlens_q=np.array([130, 77], np.int32),
              seqlens_k=np.array([160, 100], np.int32))
    return inputs, meta, kw, _jax_run(inputs, meta, True, **kw)


@pytest.mark.parametrize("sq,sk,nnz_s", [(129, 129, 1), (128, 512, 3)])
def test_partition_matches_jax_and_dense(sq, sk, nnz_s):
    """Slashes and verticals that cover every key equal dense attention;
    (129, 129) runs the JAX tile-list route, (128, 512) its gather route."""
    inputs = _qkv(0, 1, sq, sk, 1, 1, 64)
    meta = _partition(1, 1, sq, sk, nnz_s)
    out_j, lse_j = _jax_run(inputs, meta, False)
    out, lse = _port_run(inputs, meta, False)
    _close(out, out_j)
    _close(lse, lse_j)
    dense, _ = attention_ref(*map(torch.from_numpy, inputs[:3]))
    _close(out, dense.numpy())


def test_gqa_causal_random_pattern_matches_jax(gqa_case):
    inputs, meta, kw, want = gqa_case
    for got, ref in zip(_port_run(inputs, meta, True, **kw), want):
        _close(got, ref)


def test_alibi_softcap_seqlens_matches_jax(alibi_case):
    """Forward and backward; rows past seqlens_q come out 0 with lse -inf,
    keys past seqlens_k get no gradient."""
    inputs, meta, kw, want = alibi_case
    got = _port_run(inputs, meta, True, **kw)
    for g, ref in zip(got, want):
        _close(g, ref)
    out, lse, _, dk, _ = got
    assert (out[1, 77:] == 0).all() and np.isneginf(lse[1, :, 77:]).all()
    assert (dk[1, 100:] == 0).all()


def test_unaligned_slash_matches_oracle_not_reference_rounding():
    """One slash at offset 100 and no vertical column: the port attends
    keys [100, 164), as MInference and vLLM mean it, and equals the exact
    oracle; the JAX package rounds the offset down to its block and attends
    [64, 128) (flash_sparse.py:87-93), so it differs from both."""
    inputs = _qkv(3, 1, 64, 256, 1, 1, 64)
    meta = (np.ones((1, 1, 1), np.int32), np.full((1, 1, 1, 1), 100, np.int32),
            np.zeros((1, 1, 1), np.int32), np.zeros((1, 1, 1, 0), np.int32))
    out_j, _ = _jax_run(inputs, meta, False)
    out, lse = _port_run(inputs, meta, False)
    ref, ref_lse = sparse_attention_ref(*map(torch.from_numpy, inputs[:3]),
                                        *map(_t, meta))
    _close(out, ref.numpy())
    _close(lse, ref_lse.numpy())
    q, k, v = map(torch.from_numpy, inputs[:3])
    rounded, _ = attention_ref(q, k[:, 64:128], v[:, 64:128])
    _close(out_j, rounded.numpy())
    assert np.abs(out_j - out).max() > 0.1


def _bitmap(meta, sq, sk, causal, lens_q=None, lens_k=None):
    """Numpy brute force: (b, h, nqb, sk) columns each 64-row block attends
    and some row of it can see."""
    bc, bo, cc, ci = meta
    b, h, nqb = bc.shape
    mem = np.zeros((b, h, nqb, sk), bool)
    for bi, hi, m in itertools.product(range(b), range(h), range(nqb)):
        for off in bo[bi, hi, m, :bc[bi, hi, m]]:
            mem[bi, hi, m, max(off, 0):max(min(off + 64, sk), 0)] = True
        for col in ci[bi, hi, m, :cc[bi, hi, m]]:
            if 0 <= col < sk:
                mem[bi, hi, m, col] = True
        uq = sq if lens_q is None else lens_q[bi]
        uk = sk if lens_k is None else lens_k[bi]
        rows, lim = min(uq, sq), min(uk, sk)
        if causal:
            lim = min(lim, min(64 * m + 63, rows - 1) + uk - uq + 1)
        mem[bi, hi, m, max(lim, 0) if 64 * m < rows else 0:] = False
    return mem


def _bits(word):
    """The 64 membership bits of a word, bit c for column c."""
    word = int(word) % 2**64
    return np.array([(word >> c) & 1 for c in range(64)], bool)


@pytest.mark.parametrize("causal,lens", [(True, None), (False, True)])
def test_planner_lists_match_bruteforce_bitmap(causal, lens):
    """Kernel 12's tile lists and words, kernel 13's inverse lists and
    kernel 15's column lists, against a numpy bitmap, on metadata with
    unaligned and negative offsets, overlaps, repeats, columns past the
    keys and garbage past the counts."""
    rng = np.random.default_rng(7)
    b, h, hk, sq, sk = 2, 4, 2, 200, 333
    nqb, nkb = 4, 6
    meta = (rng.integers(0, 5, (b, h, nqb)).astype(np.int32),
            rng.integers(-90, sk + 70, (b, h, nqb, 4)).astype(np.int32),
            rng.integers(0, 9, (b, h, nqb)).astype(np.int32),
            rng.integers(-20, sk + 20, (b, h, nqb, 8)).astype(np.int32))
    meta[3][..., 1] = meta[3][..., 0]
    lens_q = np.array([200, 150], np.int32) if lens else None
    lens_k = np.array([333, 101], np.int32) if lens else None
    want = _bitmap(meta, sq, sk, causal, lens_q, lens_k)
    kw = dict(seqlen_q=sq, seqlen_k=sk, causal=causal, seqlens_q=_t(lens_q),
              seqlens_k=_t(lens_k))
    plan = plan_sparse(*map(_t, meta), keep_table=True, **kw)
    words = plan.words.numpy().view(np.uint64)
    got = np.zeros((b, h, nqb, nkb * 64), bool)
    for bi, hi, m in itertools.product(range(b), range(h), range(nqb)):
        tiles = plan.tiles[bi, hi, m, :plan.counts[bi, hi, m]].numpy()
        assert (np.diff(tiles) > 0).all()
        for t, w in zip(tiles, words[bi, hi, m]):
            assert w != 0
            got[bi, hi, m, 64 * t:64 * t + 64] = _bits(w)
    np.testing.assert_array_equal(got[..., :sk], want)
    assert not got[..., sk:].any()

    counts, idx, iwords = plan_inverse(plan.table, hk)
    inv = np.zeros_like(got)
    for bi, g, t in itertools.product(range(b), range(hk), range(nkb)):
        for e in range(counts[bi, g, t]):
            j, w = int(idx[bi, g, t, e]), iwords[bi, g, t, e]
            inv[bi, g * (h // hk) + j // nqb, j % nqb, 64 * t:64 * t + 64] = (
                _bits(w))
    np.testing.assert_array_equal(inv, got)

    gcounts, cols = plan_gather(*map(_t, meta), **kw)
    for bi, hi, m in itertools.product(range(b), range(h), range(nqb)):
        n = int(gcounts[bi, hi, m])
        np.testing.assert_array_equal(cols[bi, hi, m, :n].numpy(),
                                      np.nonzero(want[bi, hi, m])[0])


def test_blocksparse_shim_matches_oracle_and_jax_conversion():
    """The legacy fixed-blockmask API: its metadata equals the JAX
    package's conversion, and its forward and gradients equal dense
    attention under the block mask."""
    blockmask = np.array([[1, 0, 1, 0], [0, 1, 1, 0], [1, 1, 0, 1]], bool)
    counts, offsets = convert_blockmask(torch.from_numpy(blockmask))
    counts_j, offsets_j = jax_convert_blockmask(jnp.asarray(blockmask))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    for m in range(3):
        n = int(counts[m])
        np.testing.assert_array_equal(offsets[m, :n].numpy(),
                                      np.asarray(offsets_j)[m, :n])
    q, k, v, do = (torch.from_numpy(x).requires_grad_()
                   for x in _qkv(4, 2, 150, 256, 2, 2, 32))
    out = flash_blocksparse_attn_func(q, k, v, torch.from_numpy(blockmask))
    keep = torch.from_numpy(blockmask).repeat_interleave(64, 0)[:150]
    keep = keep.repeat_interleave(64, 1)
    bias = torch.zeros(150, 256).masked_fill(~keep, float("-inf"))
    ref = torch.softmax(
        torch.einsum("bqhd,bkhd->bhqk", q, k) / 32**0.5 + bias, -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", ref, v)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=RTOL, atol=RTOL)
    for got, want in zip(torch.autograd.grad(out, (q, k, v), do.detach()),
                         torch.autograd.grad(ref, (q, k, v), do.detach())):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL * float(want.abs().max()))


def test_unported_and_malformed_raise():
    """Dropout names its ROADMAP item; metadata of the wrong shape or type
    is refused; an NNZ of 0 stays legal (every row sees nothing)."""
    q, k, v, _ = map(torch.from_numpy, _qkv(5, 1, 100, 100, 2, 2, 32))
    meta = tuple(map(_t, _partition(1, 2, 100, 100, 1)))
    with pytest.raises(NotImplementedError, match="12-14: murmur3 dropout"):
        sparse_attn_func(q, k, v, *meta, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="murmur3 dropout"):
        flash_blocksparse_attn_func(q, k, v, torch.ones(2, 2, dtype=torch.bool),
                                    dropout_p=0.1)
    with pytest.raises(ValueError, match="block_count must be int32"):
        sparse_attn_func(q, k, v, meta[0][:, :, :1], *meta[1:])
    with pytest.raises(ValueError, match="column_index must be int32"):
        sparse_attn_func(q, k, v, *meta[:3], meta[3].long())
    empty = (torch.zeros(1, 2, 2, dtype=torch.int32),
             torch.zeros(1, 2, 2, 0, dtype=torch.int32),
             torch.zeros(1, 2, 2, dtype=torch.int32),
             torch.zeros(1, 2, 2, 0, dtype=torch.int32))
    out, lse = sparse_attn_func(q, k, v, *empty, return_softmax_lse=True)
    assert (out == 0).all() and torch.isneginf(lse).all()


def test_routes_and_crossover_constants():
    """The forward route follows the static list bounds (kernel 15 while
    64 NNZ_S + NNZ_V < seqlen_k) and the crossover constants are the H100
    fits (PERF.md), not the JAX package's TPU ones; on the CPU both routes
    take the plain version and launch nothing."""
    assert sparse_route(93, 3500, 32768) == "gather"   # the vLLM prefill case
    assert sparse_route(86, 3500, 8192) == "tiles"
    assert sparse_route(1, 36, 101) == "gather"
    assert sparse_route(1, 37, 101) == "tiles"
    assert sparse_route(0, 0, 1) == "gather"
    assert (sparse_crossover.MIN_CONTEXT, sparse_crossover.MAX_DENSITY,
            sparse_crossover.MIN_SLASH_FRAC) == (8192, 0.118, 0.3)
    assert sparse_crossover.should_use_sparse(16384, 0.05, 0.7)
    assert not sparse_crossover.should_use_sparse(4096, 0.05, 0.7)
    assert not sparse_crossover.should_use_sparse(32768, 0.3, 0.7)
    cells = [dict(seqlen_k=s, density=d, slash_frac=f, speedup=x)
             for s, d, f, x in ((4096, 0.02, 0.3, 0.9), (8192, 0.02, 0.3, 1.5),
                                (8192, 0.1337, 0.3, 1.1), (8192, 0.3, 0.3, 0.5),
                                (8192, 0.02, 0.7, 1.6), (8192, 0.3, 0.7, 0.4))]
    assert sparse_crossover.fit_crossover(cells) == dict(
        MIN_CONTEXT=8192, MIN_SLASH_FRAC=0.3, MAX_DENSITY=0.133)
    q, k, v = (torch.from_numpy(x).transpose(1, 2)
               for x in _qkv(6, 1, 130, 140, 2, 1, 32)[:3])
    meta = tuple(map(_t, _random_meta(6, 1, 2, 130, 140, 2, 5)))
    launches = (flash_attention_sparse_tiles_fwd.launches,
                flash_attention_sparse_gather_fwd.launches)
    routed = flash_attention_sparse_fwd(q, k, v, *meta, causal=True)
    tiles = flash_attention_sparse_tiles_fwd(q, k, v, *meta, causal=True)
    gather = flash_attention_sparse_gather_fwd(q, k, v, *meta, causal=True)
    for a, b, c in zip(routed, tiles, gather):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert launches == (flash_attention_sparse_tiles_fwd.launches,
                        flash_attention_sparse_gather_fwd.launches)
