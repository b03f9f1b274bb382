"""The vertical-slash sparse backward's Hopper kernels
(csrc/flash_sparse_bwd_sm90.cuh, kernels 13 and 14), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions. Here: `sparse_bwd_walks`, the plain mirror of their
merged walks over the planner's lists, computes every visible (query head,
row, key) triple of the brute-force membership exactly once per kernel, by
the warpgroup that owns it, and no merged step has both words 0 or repeats
an entry (its tile constants are the header's); and the sparse backward's
TMA copy rule. tests/test_torch_sparse.py holds the plain sparse backward
against the JAX package's; this file needs no interpret-mode call."""

import os
import re

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.kernels import flash_sparse
from flash_attn_tpu_torch.kernels.flash_fwd import stats_ready

CSRC = os.path.join(os.path.dirname(flash_sparse.__file__), os.pardir, "csrc")


def _meta(seed, b, h, sq, sk, nnz_s, nnz_v, variant=None):
    """Seeded metadata: unaligned and negative slash offsets that overlap or
    repeat, vertical columns with repeats, columns inside slash ranges and
    past the keys, garbage past the counts. "empty": every third block's
    counts 0 and (0, 0)'s all; "none": every count 0."""
    rng = np.random.default_rng(seed)
    nqb = -(-sq // 64)
    bo = rng.integers(-70, sk + 40, (b, h, nqb, nnz_s)).astype(np.int32)
    bo[..., 1] = bo[..., 0] + 17
    ci = rng.integers(-5, sk + 5, (b, h, nqb, nnz_v)).astype(np.int32)
    ci[..., 1] = ci[..., 0]
    ci[..., 2] = bo[..., 0] + 5
    bc = rng.integers(0, nnz_s + 1, (b, h, nqb)).astype(np.int32)
    cc = rng.integers(0, nnz_v + 1, (b, h, nqb)).astype(np.int32)
    bo[np.arange(nnz_s) >= bc[..., None]] = 10 * sk
    past = np.arange(nnz_v) >= cc[..., None]
    ci[past] = rng.integers(-500, 5 * sk, past.sum())
    if variant == "empty":
        bc[..., ::3] = cc[..., ::3] = 0
        bc[0, 0] = cc[0, 0] = 0
    elif variant == "none":
        bc[:] = cc[:] = 0
    return tuple(torch.from_numpy(x) for x in (bc, bo, cc, ci))


# (b, h, hk, sq, sk, causal, seqlens (q, k) or None, variant, seed)
WALK_CASES = {
    # nqb 5 and nkb 7: the last block of either kernel owns one 64-row
    # block or key tile.
    "odd-blocks": (1, 4, 2, 300, 420, True, None, None, 1),
    "empty-blocks": (1, 4, 2, 256, 320, False, None, "empty", 2),
    "overlap-dup-garbage-gqa4": (1, 8, 2, 260, 260, True, None, None, 3),
    "seqlens": (2, 4, 1, 320, 384, True, ((300, 150), (384, 201)), None, 4),
    "sq-lt-sk": (1, 4, 1, 130, 400, True, None, None, 5),
    "noncausal-mqa": (1, 6, 1, 200, 330, False, None, None, 6),
    "all-empty": (1, 2, 1, 192, 256, True, None, "none", 7),
}


def _bits(w):
    return np.nonzero([(w >> c) & 1 for c in range(64)])[0]


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walks_compute_each_visible_triple_once(case):
    b, h, hk, sq, sk, causal, lens, variant, seed = WALK_CASES[case]
    group, nqb, nkb = h // hk, -(-sq // 64), -(-sk // 64)
    meta = _meta(seed, b, h, sq, sk, 4, 9, variant)
    lens_q = lens_k = None
    if lens:
        lens_q, lens_k = (torch.tensor(x, dtype=torch.int32) for x in lens)
    plan = flash_sparse.plan_sparse(*meta, seqlen_q=sq, seqlen_k=sk,
                                    causal=causal, seqlens_q=lens_q,
                                    seqlens_k=lens_k, keep_table=True)
    inverse = flash_sparse.plan_inverse(plan.table, hk)
    table = plan.table.numpy().view(np.uint64)
    dkv, dq = flash_sparse.sparse_bwd_walks(plan, inverse)
    assert set(dq) == {(bi, hi, p) for bi in range(b) for hi in range(h)
                       for p in range(-(-nqb // 2))}
    assert set(dkv) == {(bi, g, p) for bi in range(b) for g in range(hk)
                        for p in range(-(-nkb // 2))}

    visible = np.zeros((b, h, sq, sk), bool)
    for bi, hi, rows, vis, _ in flash_sparse.visible_chunks(
            meta, b, h, sq, sk, causal, lens_q, lens_k, None):
        visible[bi, hi, rows] = vis.numpy()
    uq = lens[0] if lens else (sq,) * b
    uk = lens[1] if lens else (sk,) * b

    def computed(count, bi, head, block, tile, word):
        """What the kernel computes for one warpgroup's (64-row block, key
        tile, word): the word's keys inside the used keys, under each used
        row's diagonal (rows past the used ones take P = 0)."""
        rows = np.arange(block * 64, min(block * 64 + 64, sq, uq[bi]))
        cols = tile * 64 + _bits(word)
        cols = cols[cols < min(sk, uk[bi])]
        ok = np.ones((len(rows), len(cols)), bool)
        if causal:
            ok &= cols[None] <= rows[:, None] + uk[bi] - uq[bi]
        count[bi, head, rows[:, None], cols[None]] += ok

    # dQ: warpgroup i of pair p owns 64-row block 2p + i and its list.
    count = np.zeros((b, h, sq, sk), np.int64)
    for (bi, hi, pair), steps in dq.items():
        tiles = [t for t, *_ in steps]
        assert tiles == sorted(set(tiles))  # no tile loaded twice a pass
        for tile, *words in steps:
            assert any(words)
            for i, w in enumerate(words):
                m = 2 * pair + i
                assert w == (table[bi, hi, m, tile] if m < nqb else 0)
                if w:
                    computed(count, bi, hi, m, tile, w)
    np.testing.assert_array_equal(count, visible.astype(np.int64))

    # dK/dV: warpgroup i of pair p owns key tile 2p + i and its inverse
    # list of (head in group * nqb + 64-row block) entries.
    count[:] = 0
    for (bi, g, pair), steps in dkv.items():
        entries = [e for e, *_ in steps]
        assert entries == sorted(set(entries))
        for e, *words in steps:
            assert any(words)
            head, m = g * group + e // nqb, e % nqb
            for i, w in enumerate(words):
                t = 2 * pair + i
                assert w == (table[bi, head, m, t] if t < nkb else 0)
                if w:
                    computed(count, bi, head, m, t, w)
    np.testing.assert_array_equal(count, visible.astype(np.int64))
    if variant == "none":
        assert not any(dq.values()) and not any(dkv.values())


def test_walk_constants_are_the_kernels():
    """META_BLOCK and BWD_BLOCK_ROWS mirror the header's tile and block."""
    with open(os.path.join(CSRC, "flash_sparse_bwd_sm90.cuh")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == (
        flash_sparse.META_BLOCK)
    with open(os.path.join(CSRC, "flash_bwd_sm90.cuh")) as f:
        dense = f.read()
    groups = int(re.search(r"constexpr int kWarpgroups = (\d+);",
                           dense).group(1))
    rows = re.search(r"constexpr int kBlockRows = (\d+) \* kWarpgroups;", dense)
    assert int(rows.group(1)) * groups == flash_sparse.BWD_BLOCK_ROWS
    assert flash_sparse.BWD_BLOCK_ROWS == 2 * flash_sparse.META_BLOCK


def _strided(shape, pad, offset):
    """A (b, h, s, d) tensor whose last dim lies `offset` elements into rows
    of d + pad elements."""
    b, h, s, d = shape
    base = torch.zeros(b, h, s, d + pad, dtype=torch.bfloat16)
    return base[..., offset:offset + d]


# (q, k: the other inputs, copies expected): (b, s, h, d) views as
# sparse_attn_func hands them over, taken as they are; a q whose base is 2
# bytes off 16, copied; k and v broadcast over heads (stride 0), copied.
TMA_CASES = {
    "bshd-views": (lambda: torch.zeros(2, 100, 4, 64, dtype=torch.bfloat16)
                   .transpose(1, 2),
                   lambda: torch.zeros(2, 100, 2, 64, dtype=torch.bfloat16)
                   .transpose(1, 2), 0),
    "q-base-off-16": (lambda: _strided((2, 4, 100, 64), 8, 1),
                      lambda: torch.zeros(2, 2, 100, 64, dtype=torch.bfloat16),
                      1),
    "broadcast-kv-heads": (lambda: torch.zeros(2, 4, 100, 64,
                                               dtype=torch.bfloat16),
                           lambda: torch.zeros(2, 1, 100, 64,
                                               dtype=torch.bfloat16)
                           .expand(2, 2, 100, 64), 2),
}


@pytest.mark.parametrize("case", list(TMA_CASES))
def test_sparse_backward_tma_rule(case):
    make_q, make_kv, copies = TMA_CASES[case]
    q, k = make_q(), make_kv()
    v, do = k.clone() if k.stride(1) else k, q.clone()
    bwd = flash_sparse.flash_attention_sparse_bwd
    bwd.tma_copies = 0
    got = flash_sparse.bwd_ready(q, k, v, do)
    assert bwd.tma_copies == copies
    for x, y in zip(got, (q, k, v, do)):
        assert torch.equal(x, y)
        if x is not y:
            assert x.is_contiguous() and x.data_ptr() % 16 == 0
    assert (got[0] is q) == (case != "q-base-off-16")
    bwd.tma_copies = 0


def test_sparse_backward_stats_alignment():
    """An LSE or delta whose base is off 16 bytes is copied for the dK/dV
    kernel's 1-D tensor maps, counted in the sparse backward's own
    counter; an aligned one is not."""
    bwd = flash_sparse.flash_attention_sparse_bwd
    bwd.tma_copies = 0
    buf = torch.arange(2 * 4 * 100 + 1, dtype=torch.float32)
    aligned = buf[:800].view(2, 4, 100)
    assert stats_ready(aligned, bwd) is aligned
    off = buf[1:].view(2, 4, 100)
    got = stats_ready(off, bwd)
    assert got is not off and got.data_ptr() % 16 == 0
    assert torch.equal(got, off)
    assert bwd.tma_copies == 1
    bwd.tma_copies = 0
