"""The vertical-slash sparse forward's Hopper kernel over tile lists
(csrc/flash_sparse_fwd_sm90.cuh, kernel 12), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it against its
plain version. Here: `fwd_walks`, a plain mirror of its merged walk (thread
0 merging the ascending tile lists of a block's two 64-row blocks), computes
every visible (query head, row, column) triple of the brute-force
membership exactly once, by the warpgroup that owns the row with its own
word, and no merged step has both words 0 or repeats a tile; `walk_run`,
that walk run in torch (an online softmax per merged step and warpgroup,
masked as the kernel masks), gives the plain forward's out and lse; the
forward's TMA copy rule; and the mirror's constants are the header's.
tests/test_torch_sparse.py holds the plain sparse forward against the JAX
package's; this file needs no JAX call."""

import math
import os
import re

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.kernels import flash_sparse
from tests.test_torch_sparse_bwd_sm90 import WALK_CASES, _meta, _strided

CSRC = os.path.join(os.path.dirname(flash_sparse.__file__), os.pardir, "csrc")

TILE = 64  # keys per listed tile, and query rows per warpgroup
WARPGROUPS = 2  # 64-row blocks per kernel block


def fwd_walks(plan):
    """Plain mirror of kernel 12's merged walks over `plan_sparse`'s lists:
    {(b, head, pair): [(key tile, word of 64-row block 2 pair, word of block
    2 pair + 1)]} in the order thread 0 issues them; a word is 0 where the
    tile is not on that block's list. The second list of a last pair with
    an odd number of blocks is empty (its count is never read)."""
    b, h, nqb = plan.counts.shape
    counts = plan.counts.reshape(b * h, nqb).tolist()
    tiles = plan.tiles.reshape(b * h, nqb, -1).tolist()
    words = plan.words.reshape(b * h, nqb, -1).tolist()
    walks = {}
    for r in range(b * h):
        for pair in range(-(-nqb // WARPGROUPS)):
            lists = []
            for m in range(WARPGROUPS * pair, WARPGROUPS * pair + WARPGROUPS):
                n = counts[r][m] if m < nqb else 0
                lists.append((tiles[r][m][:n] if n else [],
                              [w & ((1 << 64) - 1) for w in words[r][m][:n]]
                              if n else []))
            at, steps = [0] * WARPGROUPS, []
            while True:
                heads = [ts[i] if i < len(ts) else math.inf
                         for (ts, _), i in zip(lists, at)]
                tile = min(heads)
                if tile == math.inf:
                    break
                step = [tile]
                for wg, (_, ws) in enumerate(lists):
                    step.append(ws[at[wg]] if heads[wg] == tile else 0)
                    at[wg] += heads[wg] == tile
                steps.append(tuple(step))
            walks[r // h, r % h, pair] = steps
    return walks


def _bits(w):
    return np.nonzero([(w >> c) & 1 for c in range(64)])[0]


def _plan(case, variant_override=None):
    b, h, hk, sq, sk, causal, lens, variant, seed = WALK_CASES[case]
    meta = _meta(seed, b, h, sq, sk, 4, 9, variant_override or variant)
    lens_q = lens_k = None
    if lens:
        lens_q, lens_k = (torch.tensor(x, dtype=torch.int32) for x in lens)
    plan = flash_sparse.plan_sparse(*meta, seqlen_q=sq, seqlen_k=sk,
                                    causal=causal, seqlens_q=lens_q,
                                    seqlens_k=lens_k, keep_table=True)
    return meta, plan, lens_q, lens_k


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_fwd_walk_computes_each_visible_triple_once(case):
    b, h, hk, sq, sk, causal, lens, variant, seed = WALK_CASES[case]
    nqb = -(-sq // TILE)
    meta, plan, lens_q, lens_k = _plan(case)
    table = plan.table.numpy().view(np.uint64)
    walks = fwd_walks(plan)
    assert set(walks) == {(bi, hi, p) for bi in range(b) for hi in range(h)
                          for p in range(-(-nqb // WARPGROUPS))}

    visible = np.zeros((b, h, sq, sk), bool)
    for bi, hi, rows, vis, _ in flash_sparse.visible_chunks(
            meta, b, h, sq, sk, causal, lens_q, lens_k, None):
        visible[bi, hi, rows] = vis.numpy()
    uq = lens[0] if lens else (sq,) * b
    uk = lens[1] if lens else (sk,) * b

    # Warpgroup i of pair p owns 64-row block 2p + i, its list and its word:
    # the word's keys inside the used keys, under each used row's diagonal
    # (rows past the used ones are not stored).
    count = np.zeros((b, h, sq, sk), np.int64)
    for (bi, hi, pair), steps in walks.items():
        tiles = [t for t, *_ in steps]
        assert tiles == sorted(set(tiles))  # each K/V tile loaded once
        for tile, *words in steps:
            assert any(words)
            for i, w in enumerate(words):
                m = WARPGROUPS * pair + i
                assert w == (table[bi, hi, m, tile] if m < nqb else 0)
                if not w:
                    continue
                rows = np.arange(m * TILE, min(m * TILE + TILE, sq, uq[bi]))
                cols = tile * TILE + _bits(w)
                cols = cols[cols < min(sk, uk[bi])]
                ok = np.ones((len(rows), len(cols)), bool)
                if causal:
                    ok &= cols[None] <= rows[:, None] + uk[bi] - uq[bi]
                count[bi, hi, rows[:, None], cols[None]] += ok
    np.testing.assert_array_equal(count, visible.astype(np.int64))
    if variant == "none":
        assert not any(walks.values())


def walk_run(q, k, v, walks, *, causal, softcap=0.0, slopes=None,
             lens_q=None, lens_k=None):
    """Kernel 12's arithmetic over `fwd_walks` in torch, fp32: per
    warpgroup an online softmax over its merged steps with its own word,
    the scores softcapped, then ALiBi, then masked by the word's bits, the
    used keys and the causal diagonal (keys past sk read as zeros, as TMA
    fills them). Returns (out fp32, lse); rows past the used ones keep out
    0 and lse -inf, as the wrapper fills them."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    nqb, nkb = -(-sq // TILE), -(-sk // TILE)
    scale = d ** -0.5
    pad = (0, 0, 0, nkb * TILE - sk)
    kp = torch.nn.functional.pad(k.float(), pad)
    vp = torch.nn.functional.pad(v.float(), pad)
    out = torch.zeros(b, h, sq, d)
    lse = torch.full((b, h, sq), -math.inf)
    lane = torch.arange(TILE)
    for (bi, hi, pair), steps in walks.items():
        uq = int(lens_q[bi]) if lens_q is not None else sq
        uk = int(lens_k[bi]) if lens_k is not None else sk
        rows_b, keys_b, off = min(uq, sq), min(uk, sk), uk - uq
        g = hi // (h // hk)
        for wg in range(WARPGROUPS):
            blk = WARPGROUPS * pair + wg
            if blk >= nqb:
                continue
            r = torch.arange(blk * TILE, min(blk * TILE + TILE, sq))
            m = torch.full((len(r),), -math.inf)
            l = torch.zeros(len(r))
            acc = torch.zeros(len(r), d)
            for tile, *words in steps:
                w = words[wg]
                if not w:
                    continue
                c = tile * TILE + lane
                s = q[bi, hi, r].float() @ kp[bi, g, c].T
                s = (torch.tanh(s * scale / softcap) * softcap if softcap
                     else s * scale)
                if slopes is not None:
                    s = s - slopes[bi, hi] * (c[None] - r[:, None] - off).abs()
                bits = torch.tensor([(w >> j) & 1 for j in range(TILE)],
                                    dtype=torch.bool)
                vis = (bits & (c < keys_b))[None].expand(len(r), TILE)
                if causal:
                    vis = vis & (c[None] <= r[:, None] + off)
                s = s.masked_fill(~vis, -math.inf)
                m_new = torch.maximum(m, s.amax(-1))
                safe = torch.where(torch.isfinite(m_new), m_new,
                                   torch.zeros_like(m_new))
                alpha = torch.exp(m - safe)
                p = torch.exp(s - safe[:, None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + p @ vp[bi, g, c]
                m = m_new
            keep = r < rows_b
            seen = keep & (l > 0)
            out[bi, hi, r[seen]] = acc[seen] / l[seen, None]
            lse[bi, hi, r[seen]] = m[seen] + torch.log(l[seen])
    return out, lse


# (WALK_CASES entry, metadata variant or None, dtype, softcap, ALiBi)
RUN_CASES = {
    "overlap-garbage-gqa4": ("overlap-dup-garbage-gqa4", None, torch.bfloat16,
                             0.0, False),
    "empty-blocks-noncausal": ("empty-blocks", None, torch.bfloat16, 0.0,
                               False),
    "seqlens-alibi-softcap-fp16": ("seqlens", None, torch.float16, 30.0,
                                   True),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_fwd_walk_run_matches_plain_forward(case):
    walk_case, variant, dtype, softcap, alibi = RUN_CASES[case]
    b, h, hk, sq, sk, causal, lens, _, seed = WALK_CASES[walk_case]
    meta, plan, lens_q, lens_k = _plan(walk_case, variant)
    rng = np.random.default_rng(seed)
    d = 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype) for shape in ((b, h, sq, d), (b, hk, sk, d),
                                        (b, hk, sk, d)))
    slopes = None
    if alibi:  # one set of slopes per batch row
        slopes = torch.from_numpy(
            rng.uniform(0.01, 0.5, (b, h)).astype(np.float32))
    out, lse = walk_run(q, k, v, fwd_walks(plan), causal=causal,
                        softcap=softcap, slopes=slopes, lens_q=lens_q,
                        lens_k=lens_k)
    ref_out, ref_lse = flash_sparse.flash_attention_sparse_fwd_ref(
        q, k, v, *meta, causal=causal, softcap=softcap, alibi_slopes=slopes,
        seqlens_q=lens_q, seqlens_k=lens_k)
    assert torch.equal(torch.isfinite(lse), torch.isfinite(ref_lse))
    fin = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[fin], ref_lse[fin], rtol=1e-5, atol=1e-5)
    # The plain version rounds its fp32 out to q's dtype once: the walk's
    # fp32 out lies within that rounding of it.
    torch.testing.assert_close(out, ref_out.float(),
                               rtol=torch.finfo(dtype).eps, atol=1e-5)
    assert (out[~fin] == 0).all()


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
def test_tiles_forward_tma_rule(case):
    make_q, make_kv, copies = TMA_CASES[case]
    q, k = make_q(), make_kv()
    v = k.clone() if k.stride(1) else k
    fwd = flash_sparse.flash_attention_sparse_tiles_fwd
    fwd.tma_copies = 0
    got = flash_sparse.tiles_ready(q, k, v)
    assert fwd.tma_copies == copies
    for x, y in zip(got, (q, k, v)):
        assert torch.equal(x, y)
        if x is not y:
            assert x.is_contiguous() and x.data_ptr() % 16 == 0
    assert (got[0] is q) == (case != "q-base-off-16")
    fwd.tma_copies = 0


def test_fwd_walk_constants_are_the_kernels():
    """The mirror's tile, warpgroups and block rows are the header's."""
    with open(os.path.join(CSRC, "flash_sparse_fwd_sm90.cuh")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == TILE
    assert TILE == flash_sparse.META_BLOCK
    assert int(re.search(r"constexpr int kWarpgroups = (\d+);",
                         src).group(1)) == WARPGROUPS
    rows = re.search(r"constexpr int kBlockRows = (\d+) \* kWarpgroups;", src)
    assert int(rows.group(1)) == TILE
