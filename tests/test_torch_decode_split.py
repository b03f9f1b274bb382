"""Split-KV paged decode (kernel 4) and the dense forward's TMA rule, on the
CPU.

The split schedule of csrc/paged_decode.cu is checked through its plain
pieces: `split_ranges` (the chunks each split takes), `num_splits_for` (the
host's choice), `flash_attention_decode_multipage_split_ref` (the function
the kernel computes, split by split, then merged) against the unsplit plain
version and against the JAX kernel, and the port's `combine_partials`
against the JAX one. The CUDA kernels themselves are held against these on
the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.flash_decode import (
    combine_partials as jax_combine_partials,
)
from flash_attn_tpu.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage as jax_decode_multipage,
)
from flash_attn_tpu_torch.kernels import flash_fwd
from flash_attn_tpu_torch.kernels.flash_decode import combine_partials
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    BLOCKS_PER_SM,
    MIN_SPLIT_TOKENS,
    SPLIT_TILE,
    flash_attention_decode_multipage_ref,
    flash_attention_decode_multipage_split_ref,
    num_splits_for,
    split_ranges,
)

B, H, HK, D = 2, 4, 2, 64  # test_torch_paged_decode.py's sizes
FUSED_WIDTH = 256


# (seqlen, sq, window_left, num_splits)
RANGE_CASES = {
    "shorter-than-a-tile": (40, 1, -1, 4),
    "window": (4500, 1, 4095, 5),
    "b1-most-splits": (4500, 1, -1, 17),
    "more-splits-than-tiles": (150, 1, -1, 8),
    "chunk-sq4-window": (1000, 4, 300, 3),
    "empty-row": (0, 1, -1, 3),
}


@pytest.mark.parametrize("case", list(RANGE_CASES))
def test_split_ranges_cover_each_visible_range_once(case):
    seqlen, sq, window, n = RANGE_CASES[case]
    ranges = split_ranges(seqlen, sq, window, n)
    assert len(ranges) == n
    count = np.zeros(max(seqlen, 1), np.int64)
    for lo, hi in ranges:
        assert 0 <= lo <= hi <= seqlen
        count[lo:hi] += 1
    assert count.max() <= 1  # no column in two chunks
    for t in range(sq):
        pos = seqlen - sq + t
        first = max(pos - window, 0) if window >= 0 else 0
        # Every column the query token sees lies in exactly one chunk.
        assert (count[first:pos + 1] == 1).all()
    # Chunks are whole tiles of the range (but for its two ends), in order.
    bounds = [lo for lo, hi in ranges if hi > lo]
    assert bounds == sorted(bounds)
    assert all(lo % SPLIT_TILE == 0 for lo in bounds[1:])


def test_num_splits_rule():
    # Decode at b 8, hk 8 on 132 SMs: as many splits as fill two blocks per
    # SM, every block at least 256 tokens.
    n = num_splits_for(8, 8, 1, 4, 6000, 4095, 132)
    assert 132 <= 8 * 8 * n <= BLOCKS_PER_SM * 132
    # b 1: the token floor binds (the window's 4096 tokens / 256).
    assert num_splits_for(1, 8, 1, 4, 6000, 4095, 132) == 4096 // MIN_SPLIT_TOKENS
    assert num_splits_for(1, 8, 1, 4, 6000, -1, 132) == 6000 // MIN_SPLIT_TOKENS
    # A short table gives one split; so does a prefill chunk (1024 rows).
    assert num_splits_for(1, 8, 1, 4, 200, -1, 132) == 1
    assert num_splits_for(8, 8, 256, 4, 6000, 4095, 132) == 1


def _pools(rng, fused, page, seqlens, permuted):
    max_pages = -(-max(seqlens) // page) + 1
    npages = B * max_pages + 1
    order = rng.permutation(npages - 1) if permuted else np.arange(npages - 1)
    table = order[: B * max_pages].reshape(B, max_pages).astype(np.int32)
    width = FUSED_WIDTH if fused else D
    k = rng.standard_normal((npages, HK, page, width)).astype(np.float32)
    v = None if fused else rng.standard_normal((npages, HK, page, D)).astype(
        np.float32)
    return k, v, table


def _inputs(seed, fused, sq, window, softcap, permuted, page, seqlens):
    rng = np.random.default_rng(seed)
    k, v, table = _pools(rng, fused, page, seqlens, permuted)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    lens = np.asarray(seqlens, np.int32)
    kw = dict(fused_kv_dim=D if fused else 0, window_left=window,
              softcap=softcap)
    return (q, k, v, lens, table), kw


def _torch(args):
    return tuple(None if a is None else torch.from_numpy(a) for a in args)


# (fused, sq, window_left, softcap, permuted, page, seqlens, num_splits)
SPLIT_CASES = {
    "fused-decode-3": (True, 1, -1, 0.0, False, 16, (200, 90), 3),
    "split-window-permuted-5": (False, 1, 70, 0.0, True, 16, (230, 41), 5),
    "fused-softcap-more-splits-than-tiles": (True, 1, -1, 5.0, True, 8,
                                             (100, 33), 7),
    "split-chunk-sq4-empty-row": (False, 4, 50, 0.0, True, 16, (160, 0), 4),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_ref_matches_unsplit_ref(case):
    *spec, n = SPLIT_CASES[case]
    args, kw = _inputs(len(case), *spec)
    t = _torch(args)
    want_out, want_lse = flash_attention_decode_multipage_ref(*t, **kw)
    got_out, got_lse = flash_attention_decode_multipage_split_ref(*t, n, **kw)
    # Both fp32; they differ only in the order of the sums.
    torch.testing.assert_close(got_out, want_out, rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.isfinite(got_lse), torch.isfinite(want_lse))
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-5, atol=1e-5)
    if 0 in spec[-1]:
        row = spec[-1].index(0)
        assert not got_out[row].any() and torch.isinf(got_lse[row]).all()


JAX_CASES = ("fused-decode-3", "split-window-permuted-5")


@pytest.fixture(scope="module")
def jax_results():
    """One interpret-mode JAX run per case, shared by the tests below."""
    results = {}
    for case in JAX_CASES:
        *spec, _ = SPLIT_CASES[case]
        args, kw = _inputs(len(case), *spec)
        q, k, v, lens, table = args
        out, lse = jax_decode_multipage(
            jnp.asarray(q), jnp.asarray(k),
            None if v is None else jnp.asarray(v), jnp.asarray(lens),
            jnp.asarray(table), **kw)
        results[case] = (np.asarray(out), np.asarray(lse))
    return results


@pytest.mark.parametrize("case", JAX_CASES)
def test_split_ref_matches_jax(case, jax_results):
    *spec, n = SPLIT_CASES[case]
    args, kw = _inputs(len(case), *spec)
    out, lse = flash_attention_decode_multipage_split_ref(*_torch(args), n,
                                                          **kw)
    want_out, want_lse = jax_results[case]
    # Both compute in fp32; they differ in summation order and exp base
    # (the JAX kernel's online softmax runs in base 2).
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isfinite(lse.numpy()),
                                  np.isfinite(want_lse))
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


def test_combine_partials_matches_jax():
    """Five partials over (3, 4) positions: some partials empty (lse -inf,
    o 0), and the whole last row empty in every partial."""
    rng = np.random.default_rng(11)
    o = rng.standard_normal((5, 3, 4, 16)).astype(np.float32)
    lse = rng.standard_normal((5, 3, 4)).astype(np.float32) * 3
    empty = rng.random((5, 3, 4)) < 0.3
    empty[:, 2] = True
    lse[empty] = -np.inf
    o[empty] = 0.0
    got_o, got_lse = combine_partials(torch.from_numpy(o), torch.from_numpy(lse))
    want_o, want_lse = jax_combine_partials(jnp.asarray(o), jnp.asarray(lse))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.isfinite(got_lse.numpy()),
                                  np.isfinite(np.asarray(want_lse)))
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-6, atol=1e-6)
    assert not got_o[2].any() and torch.isinf(got_lse[2]).all()


def test_tma_rule_copies_only_what_tma_cannot_address():
    """Kernel 1's wrapper hands TMA a (b, s, h, d) view as it is, and copies
    a tensor whose base or a stride is off 16 bytes."""
    b, s, h, d = 2, 24, 4, 64
    base = torch.randn(b, s, h, d, dtype=torch.bfloat16)
    flash_fwd.flash_attention_fwd.tma_copies = 0
    view = base.transpose(1, 2)  # (b, h, s, d), strides (s h d, d, h d, 1)
    assert flash_fwd.tma_ready(view) is view
    assert flash_fwd.flash_attention_fwd.tma_copies == 0
    wide = torch.randn(b, h, s, d + 8, dtype=torch.bfloat16)
    off_base = wide[..., 1:d + 1]  # base 2 bytes off
    off_stride = torch.randn(b, h, s, d + 1, dtype=torch.bfloat16)[..., :d]
    for t in (off_base, off_stride):
        copied = flash_fwd.tma_ready(t)
        assert copied.is_contiguous() and torch.equal(copied, t)
    assert flash_fwd.flash_attention_fwd.tma_copies == 2
    assert flash_fwd.tma_addressable(wide[..., 8:d + 8])  # 16 bytes in
    flash_fwd.flash_attention_fwd.tma_copies = 0
