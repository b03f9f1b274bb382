"""The block-sparse forward's Hopper kernel (csrc/block_sparse_fwd_sm90.cuh,
kernel 9), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it against its
plain version. Here: `bs_fwd_walks`, the plain mirror of its walks (each
block merging the forward lists of two 64-row blocks), computes every kept
(head, row, key) of `block_sparse_keep_mask` exactly once, by the
warpgroup that owns the row with its own mode and word, and no merged step
repeats a tile or lacks both lists; a mode-0 sub-tile never reaches past
the keys or the rows (TMA fills those with zeros, which only a mask turns
into -inf); the walk constants are the header's; and the forward's TMA
copy rule. tests/test_torch_block_sparsity.py holds the plain forward
against the JAX package's; this file needs no interpret-mode call."""

import os
import re

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.kernels import block_sparsity as bs

CSRC = os.path.join(os.path.dirname(bs.__file__), os.pardir, "csrc")
BIT = np.arange(64, dtype=np.uint64)


def _docs(s, bounds):
    ids = torch.zeros(s, dtype=torch.int32)
    for i, (a, z) in enumerate(zip(bounds[:-1], bounds[1:])):
        ids[a:z] = i
    return ids


def doc_causal(s, bounds):
    ids = _docs(s, bounds)

    def mod(b, h, q_idx, kv_idx):
        # The planner also asks about the padding past s.
        doc = lambda i: ids[i.clamp(0, s - 1)]  # noqa: E731
        return (doc(q_idx) == doc(kv_idx)) & (kv_idx <= q_idx)
    return mod


def head_dependent(b, h, q_idx, kv_idx):
    # Odd heads see a band, every head the keys up to half its row: tiles
    # that one row block of a pair lists and the other does not.
    return ((h % 2 == 1) & (q_idx - kv_idx < 70)) | (kv_idx <= q_idx // 2)


def rows_gap(b, h, q_idx, kv_idx):
    # Rows 128-319 keep nothing: whole row blocks with empty lists.
    return (kv_idx <= q_idx) & ((q_idx < 128) | (q_idx >= 320))


# name: (call batch, heads, seqlen, mod, plan (batch, heads), tile).
# Row blocks: 454 -> 8, 520 -> 9 (odd: the last pair's second list is
# empty), 389 -> 7.
CASES = {
    "odd-blocks-docs": (1, 2, 520, doc_causal(520, [0, 100, 230, 300, 520]),
                        (1, 2), 128),
    "broadcast-head-dependent": (2, 4, 454, head_dependent, (1, 1), 128),
    "empty-lists": (1, 3, 454, rows_gap, (1, 3), 64),
    "no-mod-ragged": (1, 4, 389, None, (1, 4), 128),
}


@pytest.mark.parametrize("case", list(CASES))
def test_walks_compute_each_kept_element_once(case):
    b, h, s, mod, (pb, ph), tile = CASES[case]
    plan = bs.compute_block_sparsity(
        mod or head_dependent, batch_size=pb, num_heads=ph, seqlen_q=s,
        seqlen_k=s, tile_m=tile, tile_n=tile, device="cpu")
    lists = bs.build_execution_lists(plan, mod, None, b, h, s, s, "cpu")
    keep = bs.block_sparse_keep_mask(plan, b, h, s, s, mask_mod=mod,
                                     device="cpu").numpy()
    walks = bs.bs_fwd_walks(lists)
    nqb = -(-s // 64)
    assert set(walks) == {(bi, hi, p) for bi in range(b) for hi in range(h)
                          for p in range(-(-nqb // 2))}
    words = lists.words.numpy().view(np.uint64)
    span = 64 * (nqb + 1)
    count = np.zeros((b, h, span, span), np.int64)
    for (bi, hi, pair), steps in walks.items():
        tiles = [t for t, *_ in steps]
        assert tiles == sorted(set(tiles))  # each K/V tile loaded once
        for t, *sides in steps:
            assert any(x is not None for x in sides)
            for i, side in enumerate(sides):
                if side is None:
                    continue
                m = 2 * pair + i  # warpgroup i owns row block 2 pair + i
                assert m < nqb
                mode, wofs = side
                rows = 64 * m + np.arange(64)
                if mode == 0:
                    # No mask: the sub-tile lies inside the keys and rows.
                    assert 64 * t + 64 <= s and 64 * m + 64 <= s
                    w = np.full(64, ~np.uint64(0))
                elif mode == 1:
                    w = np.where(rows < s, np.uint64((1 << min(s - 64 * t, 64))
                                                     - 1), np.uint64(0))
                else:
                    w = words[wofs]
                kept = ((w[:, None] >> BIT) & np.uint64(1)).astype(np.int64)
                count[bi, hi, 64 * m:64 * m + 64, 64 * t:64 * t + 64] += kept
    assert not count[:, :, s:].any() and not count[..., s:].any()
    np.testing.assert_array_equal(count[:, :, :s, :s], keep.astype(np.int64))
    if case == "empty-lists":
        # Row blocks 2-4 list nothing: pair 1 walks nothing, pair 2 only
        # its second block's list.
        assert walks[0, 0, 1] == []
        assert walks[0, 0, 2] and all(first is None
                                      for _, first, _ in walks[0, 0, 2])


def test_walk_constants_are_the_kernels():
    """The mirror's 64-row blocks, two to a block of 256 threads, and
    64-key tiles are the header's constants."""
    with open(os.path.join(CSRC, "block_sparse_fwd_sm90.cuh")) as f:
        src = f.read()
    groups = int(re.search(r"constexpr int kWarpgroups = (\d+);", src).group(1))
    assert groups == 2
    rows = re.search(r"constexpr int kBlockRows = (\d+) \* kWarpgroups;", src)
    assert int(rows.group(1)) == bs.SUB
    assert "constexpr int kTile = bs::kSub;" in src
    with open(os.path.join(CSRC, "block_sparse.cuh")) as f:
        assert int(re.search(r"constexpr int kSub = (\d+);",
                             f.read()).group(1)) == bs.SUB


def _strided(shape, pad, offset):
    """A (b, h, s, d) tensor whose last dim lies `offset` elements into rows
    of d + pad elements."""
    b, h, s, d = shape
    base = torch.zeros(b, h, s, d + pad, dtype=torch.bfloat16)
    return base[..., offset:offset + d]


# (q, k: the other inputs, copies expected): (b, s, h, d) views as
# flash_attn_func hands them over, taken as they are; a q whose base is 2
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
def test_forward_tma_rule(case):
    make_q, make_kv, copies = TMA_CASES[case]
    q, k = make_q(), make_kv()
    v = k.clone() if k.stride(1) else k
    fwd = bs.flash_attention_blocksparse_fwd
    fwd.tma_copies = 0
    got = bs.fwd_ready(q, k, v)
    assert fwd.tma_copies == copies
    for x, y in zip(got, (q, k, v)):
        assert torch.equal(x, y)
        if x is not y:
            assert x.is_contiguous() and x.data_ptr() % 16 == 0
    assert (got[0] is q) == (case != "q-base-off-16")
    fwd.tma_copies = 0
