"""Kernel 5's split-KV schedule (csrc/decode.cu `decode_split_kernel` and
its combine), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions. Here: the kernel's walk of kv tiles cut into splits
(`walk_tiles`, `walk_ranges`, mirrors of its `walk_of` and of its split
arithmetic) covers each column a query row can see exactly once; the
`num_splits_for` rule; `flash_attention_decode_general_split_ref`, the
plain version of the schedule (the splits through
`flash_attention_decode_ref` cut to their chunks, then the merge with the
sink added once), against the unsplit plain version and against the JAX
package's `flash_attention_decode` in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.flash_decode import (
    flash_attention_decode as jax_decode,
)
from flash_attn_tpu_torch.kernels import flash_decode as fd

B, H, HK, D, SMAX = 2, 4, 2, 32, 400
# Both plain versions compute in fp32 and differ only in summation order.
ATOL = 1e-5
# Against the JAX kernel (interpret mode, fp32), whose online softmax runs
# in base 2: as tests/test_torch_decode.py.
JAX_ATOL = 1e-4

# name: (sq, seqlens, leftpad or None, mask keywords of visible_span).
WALK_CASES = {
    # The sink tokens' tiles, then a window far from them: a gap of tiles
    # no split walks.
    "sinktok-window-gap": (3, (390, 300), None,
                           dict(causal=True, window_left=100,
                                attention_chunk=0, sink_token_length=70)),
    # Four tokens straddling a chunk boundary (row 1: 96 + 3 = 99 is one).
    "chunk-edges-leftpad": (4, (250, 101), (3, 2),
                            dict(causal=True, window_left=-1,
                                 attention_chunk=96, sink_token_length=0)),
    "leftpad-window": (2, (380, 399), (200, 7),
                       dict(causal=True, window_left=150, attention_chunk=0,
                            sink_token_length=0)),
    # Fewer tiles than splits: most chunks empty; row 1 sees nothing.
    "empty-chunks": (1, (70, 5), (0, 5),
                     dict(causal=True, window_left=-1, attention_chunk=0,
                          sink_token_length=0)),
    "noncausal-sq5": (5, (333, 64), None,
                      dict(causal=False, window_left=-1, attention_chunk=0,
                           sink_token_length=0)),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_splits_cover_each_visible_column_once(case):
    sq, lens, leftpads, mask = WALK_CASES[case]
    for i, seqlen in enumerate(lens):
        leftpad = leftpads[i] if leftpads else 0
        pos = torch.arange(seqlen - sq, seqlen).reshape(1, sq, 1)
        seen = fd.visible_columns(
            seqlen, pos, SMAX, leftpad=leftpad, causal=mask["causal"],
            window_left=mask["window_left"],
            attention_chunk=mask["attention_chunk"],
            sink_token_length=mask["sink_token_length"])
        seen = seen.expand(1, sq, SMAX).any(dim=1)[0].numpy()
        tiles = fd.walk_tiles(seqlen, leftpad, sq, **mask)
        assert tiles == sorted(set(tiles))
        for n in (1, 2, 3, 7):
            count = np.zeros(SMAX + fd.SPLIT_TILE, np.int64)
            for lo, hi in fd.walk_ranges(seqlen, leftpad, sq, n, **mask):
                assert lo % fd.SPLIT_TILE == 0 and hi % fd.SPLIT_TILE == 0
                count[lo:hi] += 1
            assert count.max() <= 1  # the chunks are disjoint
            np.testing.assert_array_equal(count[:SMAX][seen], 1)
        if case == "sinktok-window-gap":
            # Tile 2 lies between the sink tokens' tiles and the window's:
            # never walked (a split's range may span it; it holds no column
            # a row sees).
            assert tiles[:2] == [0, 1] and 2 not in tiles
            assert not seen[128:192].any()
    if case == "empty-chunks":
        assert fd.walk_tiles(5, 5, 1, **mask) == []
        assert fd.walk_ranges(5, 5, 1, 3, **mask) == [(0, 0)] * 3


def test_num_splits_rule():
    rule = functools.partial(fd.num_splits_for, sink_token_length=0,
                             attention_chunk=0, sm_count=132)
    # decode (b 8, Mistral-7B widths, window 4095): 64 blocks -> 4 splits.
    assert rule(8, 8, 1, 4, 4608, window_left=4095) == 4
    # generate's late decode step (b 4): 8 splits of 512 tokens.
    assert rule(4, 8, 1, 4, 4532, window_left=4095) == 8
    # The speculative verify (20 packed rows, 1093 slots): 256 tokens each.
    assert rule(1, 8, 5, 4, 1093, window_left=4095) == 4
    # More than 64 packed rows keep the unsplit kernel.
    assert rule(1, 8, 17, 4, 8192, window_left=-1) == 1
    # Enough blocks already, or too few tokens, give one split.
    assert rule(64, 8, 1, 4, 8192, window_left=-1) == 1
    assert rule(1, 8, 1, 4, 300, window_left=-1) == 1
    # The window, the sink tokens and the chunk cut the range.
    assert rule(1, 8, 1, 4, 1 << 20, window_left=511) == 2
    assert fd.num_splits_for(1, 8, 1, 4, 1 << 20, window_left=511,
                             sink_token_length=4, attention_chunk=0,
                             sm_count=132) == 2
    assert fd.num_splits_for(1, 8, 1, 4, 1 << 20, window_left=-1,
                             sink_token_length=0, attention_chunk=1024,
                             sm_count=132) == 4


# name: (sq, seqlens, extra arguments). Array extras are built by _inputs.
REF_CASES = {
    "sink": (1, (300, 390), dict(sink=True, window_left=150)),
    "sinktok-window": (3, (330, 395), dict(sink_token_length=70,
                                           window_left=100)),
    "chunk-leftpad": (4, (250, 390), dict(cache_leftpad=(3, 70),
                                          attention_chunk=96)),
    "alibi": (2, (200, 300), dict(alibi_slopes=True)),
    "batch-idx": (1, (200, 399), dict(cache_batch_idx=True)),
    "paged-sink": (2, (200, 355), dict(paged=16, sink=True, window_left=90)),
}


def _inputs(name, cases=None, d=D):
    sq, seqlens, extra = (cases or REF_CASES)[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    extra = dict(extra)
    q = rng.standard_normal((B, sq, H, d)).astype(np.float32)
    kw = {}
    page = extra.pop("paged", 0)
    if page:
        max_pages = -(-SMAX // page)
        npages = B * max_pages + 1
        k, v = (rng.standard_normal((npages, HK, page, d)).astype(np.float32)
                for _ in range(2))
        kw["block_table"] = rng.permutation(npages - 1)[
            : B * max_pages].reshape(B, max_pages).astype(np.int32)
    else:
        k, v = (rng.standard_normal((B + 1, HK, SMAX, d)).astype(np.float32)
                for _ in range(2))
    if extra.pop("cache_batch_idx", False):
        kw["cache_batch_idx"] = np.array([2, 0], np.int32)
    if "cache_leftpad" in extra:
        kw["cache_leftpad"] = np.asarray(extra.pop("cache_leftpad"), np.int32)
    if extra.pop("alibi_slopes", False):
        kw["alibi_slopes"] = rng.uniform(0.05, 0.5, (B, H)).astype(np.float32)
    if extra.pop("sink", False):
        kw["sink"] = rng.standard_normal(H).astype(np.float32)
    kw.update(extra)
    return q, k, v, np.asarray(seqlens, np.int32), kw


def _torch(q, k, v, lens, kw):
    t = torch.from_numpy
    return t(q), t(k), t(v), t(lens), {
        n: t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}


def _assert_close(got, want, atol):
    (out, lse), (out_w, lse_w) = got, want
    np.testing.assert_allclose(np.asarray(out), np.asarray(out_w), rtol=0,
                               atol=atol)
    lse, lse_w = np.asarray(lse), np.asarray(lse_w)
    finite = np.isfinite(lse_w)
    np.testing.assert_array_equal(np.isfinite(lse), finite)
    np.testing.assert_allclose(lse[finite], lse_w[finite], rtol=0, atol=atol)


@pytest.mark.parametrize("case", list(REF_CASES))
def test_split_ref_matches_unsplit(case):
    q, k, v, lens, kw = _torch(*_inputs(case))
    want = fd.flash_attention_decode_ref(q, k, v, lens, **kw)
    for n in (2, 3, 5):
        got = fd.flash_attention_decode_general_split_ref(q, k, v, lens, n,
                                                          **kw)
        _assert_close(got, want, ATOL)


JAX_CASES = {
    "window": (1, (150, 199), dict(window_left=60)),
    "sink-window": (1, (150, 199), dict(window_left=60, sink=True)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_split_ref_matches_jax(case):
    q, k, v, lens, kw = _inputs(case, JAX_CASES, d=64)
    arrays = {n: jnp.asarray(x) for n, x in kw.items()
              if isinstance(x, np.ndarray)}
    static = {n: x for n, x in kw.items() if n not in arrays}
    fn = jax.jit(functools.partial(jax_decode, **static))
    want = fn(jnp.asarray(q), jnp.asarray(k[:B]), jnp.asarray(v[:B]),
              jnp.asarray(lens), **arrays)
    tq, tk, tv, tl, tkw = _torch(q, k[:B], v[:B], lens, kw)
    got = fd.flash_attention_decode_general_split_ref(tq, tk, tv, tl, 3, **tkw)
    _assert_close(got, want, JAX_ATOL)


def test_row_that_sees_nothing_gets_lse_sink():
    """Row 1 lies wholly in its leftpad: every split's chunk is empty, and
    the merge gives out 0 and lse = sink, as the unsplit version does."""
    q, k, v, lens, kw = _torch(*_inputs("sink"))
    lens = torch.tensor([300, 40], dtype=torch.int32)
    kw["cache_leftpad"] = torch.tensor([0, 40], dtype=torch.int32)
    out, lse = fd.flash_attention_decode_general_split_ref(q, k, v, lens, 3,
                                                           **kw)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    torch.testing.assert_close(lse[1, :, 0], kw["sink"], rtol=0, atol=0)
    assert torch.isfinite(lse[0]).all()
    _assert_close((out, lse), fd.flash_attention_decode_ref(q, k, v, lens,
                                                            **kw), ATOL)
