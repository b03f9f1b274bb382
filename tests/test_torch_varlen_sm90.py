"""The Hopper kernels of the varlen/paged forward (kernel 6,
csrc/flash_varlen_fwd_sm90.cuh) and the vertical-slash gather forward
(kernel 15, csrc/flash_sparse_gather_sm90.cuh), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions and reads kernel 6's schedule from the kernel itself
(`flash_varlen.trace_schedule`). Here plain mirrors of their schedules,
kept in this file: kernel 6's flat tile schedule (`varlen_sm90_tiles`)
visits every (sequence, row tile) with a visible row exactly once and its
grid bound is never short; its page boxes (`page_boxes`) cover each key of
a tile once, inside one page, with ids outside the pool read as zeros, and
pools of other page sizes take the sm80 route; the TMA rule takes vLLM's
pool views; kernel 15's walk (`gather_walks`) reaches every listed (row
block, column) once with its column, and run in torch (`gather_walk_fwd`)
it computes the plain forward's answer; the producer's swizzled cp.async
address is TMA's 128-byte swizzle; and the mirrors' constants are the
headers'. tests/test_torch_varlen.py and tests/test_torch_sparse.py hold
the plain versions against the JAX package; this file makes no JAX call.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.kernels import flash_sparse_gather as fsg
from flash_attn_tpu_torch.kernels import flash_varlen as fv
from flash_attn_tpu_torch.kernels.flash_decode_multipage import _fused_split
from flash_attn_tpu_torch.kernels.flash_fwd import _scale, tma_addressable
from flash_attn_tpu_torch.kernels.flash_sparse import (
    _slopes,
    flash_attention_sparse_fwd_ref,
)

CSRC = os.path.join(os.path.dirname(fv.__file__), os.pardir, "csrc")


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# -- plain mirrors of kernel 6's schedule and page boxes ---------------------

def varlen_sm90_tiles(cu_seqlens_q, seqused_q, total_q, d):
    """The flat schedule: (grid.x, [(sequence, first row) of block x for x
    in range(grid.x)], None past the last tile). As find_tile and the
    kernel's row0: the row tiles of every sequence in order, each
    sequence's last (longest causal rows) first."""
    cu = _np(cu_seqlens_q)
    lens = np.diff(cu)
    used = lens if seqused_q is None else _np(seqused_q)
    rows = np.maximum(np.minimum(used, lens), 0)
    bm = fv.sm90_block_m(d)
    grid = fv.sm90_grid_tiles(total_q, len(lens), d)
    blocks = [(j, (n - 1 - m) * bm) for j, r in enumerate(rows)
              for n in [-(-int(r) // bm)] for m in range(n)]
    if len(blocks) > grid:
        raise AssertionError(f"grid {grid} short of {len(blocks)} tiles")
    return grid, blocks + [None] * (grid - len(blocks))


def page_boxes(page, tile, keys, table_row):
    """The boxes of one 128-key K (or V) tile of one sequence, as the
    producer lanes issue them: [(row offset in the tile, page id or -1,
    first slot)] for each piece of `piece_rows(page)` slots; -1 (a piece
    past the keys) is an out-of-range coordinate, as is an id outside the
    pool: TMA fills those boxes with zeros."""
    piece = fv.piece_rows(page)
    out = []
    for j in range(fv.SM90_BLOCK_N // piece):
        key = tile * fv.SM90_BLOCK_N + j * piece
        pid = int(table_row[key // page]) if key < keys else -1
        out.append((j * piece, pid, key % page))
    return out


# -- plain mirrors of kernel 15's walk ---------------------------------------

# A block of SM90_ROWS query rows takes its list SM90_COLS columns a step.
SM90_ROWS = 64
SM90_COLS = 64


def swizzled(r, c, rows):
    """Byte offset at which the producer's cp.async puts 16-byte chunk c of
    row r of a tile of `rows` rows (the header's `swizzled`): column block
    c // 8, then chunk c % 8 ^ r % 8 of the row's 128 bytes."""
    return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4)


def gather_walks(counts, cols, keys):
    """The columns the producer writes beside each stage, per (b, head,
    64-row block): a (steps, SM90_COLS) int64 tensor, -1 past the block's
    count or at keys or beyond (`keys`, (b,) ints), as `plan_gather`'s
    lists hold them."""
    b, h, nqb = counts.shape
    walks = {}
    for bi in range(b):
        for hi in range(h):
            for mb in range(nqb):
                n = int(counts[bi, hi, mb])
                steps = -(-n // SM90_COLS)
                pos = torch.arange(steps * SM90_COLS)
                c = torch.where(pos < n, cols[bi, hi, mb, :steps * SM90_COLS]
                                .long().cpu(), -1)
                c = torch.where(c >= int(keys[bi]), -1, c)
                walks[bi, hi, mb] = c.reshape(steps, SM90_COLS)
    return walks


def gather_walk_fwd(q, k, v, counts, cols, *, softmax_scale=None,
                    causal=False, softcap=0.0, alibi_slopes=None,
                    seqlens_q=None, seqlens_k=None):
    """The Hopper kernel's walk in plain torch (fp32): each block's steps
    in order, the scores of its 64 gathered columns, the mask only on
    steps that are not full (the last column visible to the block's first
    row, every row in range), and the online softmax (base 2) across
    steps. Returns (out, lse) as the kernel does, rows past seqlens_q zero
    and -inf."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    scale = _scale(d, softmax_scale)
    uq = [sq if seqlens_q is None else int(seqlens_q[i]) for i in range(b)]
    uk = [sk if seqlens_k is None else int(seqlens_k[i]) for i in range(b)]
    keys = [max(min(u, sk), 0) for u in uk]
    slopes = _slopes(alibi_slopes, q.device)
    walks = gather_walks(counts, cols, keys)
    out = torch.zeros(b, h, sq, v.shape[-1])
    lse = torch.full((b, h, sq), float("-inf"))
    log2e = 1.0 / math.log(2.0)
    for (bi, hi, mb), steps in walks.items():
        rows = max(min(uq[bi], sq), 0)
        r0 = mb * SM90_ROWS
        if r0 >= rows:
            continue
        r = torch.arange(r0, min(r0 + SM90_ROWS, sq))
        diag = r + uk[bi] - uq[bi]
        qb = q[bi, hi, r0:r0 + SM90_ROWS].float()
        m = torch.full((len(r),), float("-inf"))
        l = torch.zeros(len(r))
        acc = torch.zeros(len(r), v.shape[-1])
        n = int(counts[bi, hi, mb])
        for x, c in enumerate(steps):
            last = int(c[-1])
            full = ((x + 1) * SM90_COLS <= n and r0 + SM90_ROWS <= rows
                    and last >= 0 and (not causal or last <= r0 + uk[bi]
                                       - uq[bi]))
            kk = k[bi, hi // group, c.clamp_min(0)].float() * (c >= 0)[:, None]
            vv = v[bi, hi // group, c.clamp_min(0)].float() * (c >= 0)[:, None]
            s = qb @ kk.T
            s = (torch.tanh(s * scale / softcap) * softcap if softcap > 0
                 else s * scale) * log2e
            if slopes is not None:
                slope = slopes[bi if slopes.shape[0] > 1 else 0, hi].float()
                s = s - slope * log2e * (c[None] - diag[:, None]).abs()
            if not full:
                ok = (c[None] >= 0) & (r[:, None] < rows)
                if causal:
                    ok &= c[None] <= diag[:, None]
                s = s.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            alpha = torch.exp2(m - safe)
            p = torch.exp2(s - safe[:, None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p @ vv
            m = m_new
        keep = r < rows
        seen = keep & (l > 0)
        out[bi, hi, r[keep]] = torch.where(
            seen[keep, None], acc[keep] / l[keep].clamp_min(1e-37)[:, None],
            0.0)
        lse[bi, hi, r[keep]] = torch.where(
            seen[keep], (m[keep] + torch.log2(l[keep].clamp_min(1e-37)))
            * math.log(2.0), float("-inf"))
    return out.to(q.dtype), lse


# (lengths, seqused_q or None, head dim): lengths 0 and 1, vLLM's mixed
# step (a 2041-token chunk and seven decode rows), seqused_q below and
# above the lengths, a sequence longer than one block.
SCHEDULES = {
    "zero-one-d64": ((0, 1, 0, 5, 0), None, 64),
    "mixed-step-d128": ((2041,) + (1,) * 7, None, 128),
    "seqused-lt-gt-d128": ((300, 7, 129, 0, 64), (120, 9, 129, 3, 0), 128),
    "long-d64": ((1000, 193, 192, 191), None, 64),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_flat_schedule_visits_each_row_tile_once(case):
    lens, used, d = SCHEDULES[case]
    cu = np.concatenate([[0], np.cumsum(lens)])
    total = int(cu[-1]) + 3  # rows past cu_seqlens_q[-1] are inert
    grid, blocks = varlen_sm90_tiles(
        torch.tensor(cu, dtype=torch.int32),
        None if used is None else torch.tensor(used, dtype=torch.int32),
        total, d)
    bm = fv.sm90_block_m(d)
    assert grid == fv.sm90_grid_tiles(total, len(lens), d) == len(blocks)
    rows = [min(u, n) for u, n in zip(used or lens, lens)]
    want = {(j, r0) for j, r in enumerate(rows) for r0 in range(0, r, bm)}
    live = [blk for blk in blocks if blk is not None]
    assert sorted(live) == sorted(want)  # each (sequence, tile) once
    # Blocks that exit come last; every live block has a visible row, and
    # a sequence's last row tile comes first.
    assert blocks[:len(live)] == live
    assert all(r0 < rows[j] for j, r0 in live)
    for j in range(len(lens)):
        mine = [r0 for s, r0 in live if s == j]
        assert mine == sorted(mine, reverse=True)


def test_grid_bound_never_short_and_tight_on_the_mixed_step():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 12))
        lens = rng.integers(0, 700, n)
        used = np.where(rng.random(n) < 0.3, rng.integers(0, 800, n), lens)
        cu = np.concatenate([[0], np.cumsum(lens)])
        for d in (64, 128):
            bm = fv.sm90_block_m(d)
            tiles = sum(-(-int(min(u, x)) // bm) for u, x in zip(used, lens))
            assert fv.sm90_grid_tiles(int(cu[-1]), n, d) >= tiles
            varlen_sm90_tiles(cu, used, int(cu[-1]), d)  # raises if short
    # vLLM's mixed step launches no block without a visible row: 16 row
    # tiles of the chunk and one for each decode row.
    assert fv.sm90_grid_tiles(2048, 8, 128) == 16 + 7


@pytest.mark.parametrize("page", [8, 16, 48, 512])
def test_page_boxes_cover_each_key_once_inside_a_page(page):
    rng = np.random.default_rng(page)
    npages, hk, d = 40, 2, 8
    # A partial last page.
    keys = 3 * page + page // 2 + 3 if page < 128 else page + 77
    width = -(-keys // page) + 2
    table = rng.permutation(npages)[:width].astype(np.int32)
    table[1] = npages + 5  # an id past the pool
    table[2 % (-(-keys // page))] = -3  # a negative id
    pool = torch.from_numpy(rng.standard_normal((npages, hk, page, d))
                            .astype(np.float32))
    # The boxes of every tile, gathered as TMA would: an id outside the
    # pool, or a piece past the keys, fills zeros.
    got = []
    for tile in range(-(-keys // fv.SM90_BLOCK_N)):
        seen = []
        for row, pid, slot in page_boxes(page, tile, keys, table):
            piece = fv.piece_rows(page)
            assert row % 8 == 0 and slot % piece == 0 and slot + piece <= page
            key = tile * fv.SM90_BLOCK_N + row
            assert pid == (table[key // page] if key < keys else -1)
            seen += range(key, key + piece)
            ok = 0 <= pid < npages
            got.append(pool[pid, :, slot:slot + piece] if ok
                       else torch.zeros(hk, piece, d))
        assert seen == list(range(tile * fv.SM90_BLOCK_N,
                                  (tile + 1) * fv.SM90_BLOCK_N))
    got = torch.cat(got, dim=1)[:, :keys]
    # The plain version's gather of the same pages, zeros outside the pool.
    kp, _, _ = fv._gather_pages((pool, pool), torch.from_numpy(table[None]),
                                torch.tensor([keys]), d, d)
    assert torch.equal(got.transpose(0, 1), kp[:keys])


def test_odd_page_sizes_take_the_sm80_route():
    src = _src("flash_varlen_fwd_sm90.cuh")
    assert "return page % 8 == 0;" in src
    for page in range(1, 600):
        gcd = int(np.gcd(page, 128))
        assert fv.pages_on_tma(page) == (gcd >= 8)
        if fv.pages_on_tma(page):
            assert fv.piece_rows(page) == gcd and 128 % gcd == 0


def test_tma_rule_takes_vllm_pool_views():
    npages, page, hk, d = 6, 16, 2, 128
    phd = torch.zeros(npages, page, hk, d, dtype=torch.bfloat16)
    fused = torch.zeros(npages, hk, page, 2 * d, dtype=torch.bfloat16)
    k_view, v_view, _ = _fused_split(fused, d, d)
    views = {"phd": phd.transpose(1, 2), "split": phd.permute(0, 2, 1, 3)
             .contiguous(), "fused-k": k_view, "fused-v": v_view}
    for name, x in views.items():
        assert tma_addressable(x), name
    # A pool broadcast over its heads (stride 0) is copied first, and a
    # packed thd view off 16 bytes is too.
    assert not tma_addressable(phd[:, :, :1].expand(npages, page, hk, d)
                               .transpose(1, 2))
    packed = torch.zeros(64 * 4 * d + 8, dtype=torch.bfloat16)
    assert not tma_addressable(packed[4:-4].view(64, 4, d))
    assert tma_addressable(packed[:-8].view(64, 4, d).transpose(0, 1))


def _meta(seed, b, h, sq, sk, nnz_s, nnz_v, variant=None):
    """Seeded vertical-slash metadata: unaligned and negative slash offsets
    that overlap or repeat, repeated vertical columns, columns inside slash
    runs and past the keys, garbage past the counts; "empty": every third
    block's counts 0."""
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
    return tuple(torch.from_numpy(x) for x in (bc, bo, cc, ci))


# (b, h, hk, sq, sk, causal, softcap, alibi, seqlens (q, k) or None,
# variant, seed): chip_smoke.py's overlap-dup-garbage, empty-blocks and
# padded-varlen cases at a small size.
GATHER_CASES = {
    "overlap-dup-garbage": (1, 4, 2, 260, 260, True, 0.0, False, None, None, 1),
    "empty-blocks": (1, 4, 2, 200, 300, False, 0.0, False, None, "empty", 2),
    "padded-varlen-alibi-softcap": (2, 2, 1, 256, 256, True, 30.0, True,
                                    ((256, 150), (256, 201)), None, 3),
}


def _gather_case(case):
    b, h, hk, sq, sk, causal, softcap, alibi, lens, variant, seed = \
        GATHER_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, h, sq, 32), (b, hk, sk, 32), (b, hk, sk, 32)))
    meta = _meta(seed, b, h, sq, sk, 4, 6, variant)
    lens_q = lens_k = None
    if lens:
        lens_q, lens_k = (torch.tensor(x, dtype=torch.int32) for x in lens)
    slopes = (torch.from_numpy(rng.uniform(0.01, 0.3, (b, h)).astype(
        np.float32)) if alibi else None)
    kw = dict(causal=causal, softcap=softcap, alibi_slopes=slopes,
              seqlens_q=lens_q, seqlens_k=lens_k)
    plan = fsg.plan_gather(*meta, seqlen_q=sq, seqlen_k=sk, causal=causal,
                           seqlens_q=lens_q, seqlens_k=lens_k)
    return q, k, v, meta, kw, plan


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_walk_reaches_each_listed_column_once_and_is_the_plain_fwd(
        case):
    q, k, v, meta, kw, (counts, cols) = _gather_case(case)
    b, sk = q.shape[0], k.shape[2]
    lens_k = kw["seqlens_k"]
    keys = [sk if lens_k is None else min(int(lens_k[i]), sk) for i in range(b)]
    walks = gather_walks(counts, cols, keys)
    assert set(walks) == {(bi, hi, mb) for bi in range(counts.shape[0])
                          for hi in range(counts.shape[1])
                          for mb in range(counts.shape[2])}
    for (bi, hi, mb), steps in walks.items():
        n = int(counts[bi, hi, mb])
        listed = [int(c) for c in cols[bi, hi, mb, :n]]
        assert listed == sorted(set(listed))
        flat = steps.reshape(-1)
        assert len(flat) == -(-n // SM90_COLS) * SM90_COLS
        want = [c if c < keys[bi] else -1 for c in listed]
        assert flat[:n].tolist() == want  # each column once, in its place
        assert (flat[n:] == -1).all()
    # The walk, run in torch with the kernel's full-step rule and online
    # softmax, is the plain forward.
    out, lse = gather_walk_fwd(q, k, v, counts, cols, **kw)
    ref_out, ref_lse = flash_attention_sparse_fwd_ref(q, k, v, *meta, **kw)
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert (out[~finite] == 0).all()
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)


def test_swizzled_cp_async_address_is_tma_128b_swizzle():
    src = _src("flash_sparse_gather_sm90.cuh")
    assert ("return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);"
            in src)
    for rows in (64, 128):
        for r in range(rows):
            for c in range(16):
                plain = (c >> 3) * rows * 128 + r * 128 + (c & 7) * 16
                # TMA's 128-byte swizzle of a 1024-aligned tile: address
                # bits 4-6 XOR bits 7-9.
                tma = plain ^ (((plain >> 7) & 7) << 4)
                assert swizzled(r, c, rows) == tma


def test_mirror_constants_are_the_headers():
    v90 = _src("flash_varlen_fwd_sm90.cuh")
    assert int(re.search(r"constexpr int kBlockN = (\d+);", v90).group(1)) \
        == fv.SM90_BLOCK_N
    m = re.search(r"block_m\(int d\) \{ return d == 64 \? (\d+) : (\d+); \}",
                  v90)
    assert (int(m.group(1)), int(m.group(2))) == (fv.sm90_block_m(64),
                                                  fv.sm90_block_m(128))
    assert "(total_q + static_cast<long long>(nseq) * (bm - 1)) / bm" in v90
    g90 = _src("flash_sparse_gather_sm90.cuh")
    assert int(re.search(r"constexpr int kRows = (\d+);", g90).group(1)) \
        == SM90_ROWS
    assert int(re.search(r"constexpr int kCols = (\d+);", g90).group(1)) \
        == SM90_COLS
    # Two blocks an SM at d 128: three stages of K and V with Q fit the
    # SM's 228 KB less 1 KB a block.
    stages = int(re.search(r"kStages = D == 128 \? (\d+) :", g90).group(1))
    smem = 64 * 128 * 2 + 2 * stages * 64 * 128 * 2 + 4 * stages * 64 \
        + 8 * (1 + 2 * stages)
    assert 2 * (smem + 1024) <= 228 * 1024
