"""The Hopper dQ kernels of the varlen backward (kernel 8,
csrc/flash_varlen_bwd_sm90.cuh) and the block-sparse backward (kernel 11,
csrc/block_sparse_bwd_sm90.cuh), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions and reads kernel 8's schedule from the kernel itself
(`flash_varlen.trace_schedule(..., kernel="dq")`). Here plain mirrors of
their walks, kept in this file: kernel 8's flat tile schedule
(`dq_tiles`) visits every (sequence, 128-row tile) with a row exactly once,
each sequence's last tile first, and its grid bound is never short; each
block's key tiles (`dq_walk`) cover every visible (row, key) pair of its
rows once per pass; run in torch over the packed inputs (`varlen_dq_run`),
with its masks, rows at lse +inf and guarded stores, the walk computes
`_varlen_dq_ref`'s dq and delta. Kernel 11's two passes over
`bs_fwd_walks` (`bs_dq_run`) compute each kept element once per pass, by
its owning warpgroup with its own mode and word, and give
`_blocksparse_dq_ref`'s dq and delta. The mirrors' constants are the
headers'. tests/test_torch_varlen.py and tests/test_torch_block_sparsity.py
hold the plain versions against the JAX package; this file makes no JAX
call.
"""

import os
import re

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.kernels import block_sparsity as bs
from flash_attn_tpu_torch.kernels import flash_varlen as fv
from flash_attn_tpu_torch.kernels.flash_bwd import walk_tile
from flash_attn_tpu_torch.kernels.flash_fwd import _scale

CSRC = os.path.join(os.path.dirname(fv.__file__), os.pardir, "csrc")
BLOCK_ROWS = 128  # kernel 8's query rows a block (kBlockRows)
BIT = np.arange(64, dtype=np.uint64)


def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def doc_lengths(total, max_len, seed):
    """Seeded document lengths in [1, max_len] that pack `total` tokens
    (chip_smoke.py's GPT2M_DOCS rule)."""
    rng = np.random.RandomState(seed)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.randint(1, max_len + 1)))
    lens[-1] -= sum(lens) - total
    return lens


GPT2M_DOCS = doc_lengths(8 * 2048, 2048, 30)


# -- plain mirrors of kernel 8's schedule and walk ---------------------------

def _rows(lens, used):
    used = lens if used is None else np.asarray(used)
    return np.maximum(np.minimum(used, lens), 0)


def dq_tiles(lens, used_q=None):
    """Kernel 8's flat schedule: (grid.x, [(sequence, first row) of block x
    for x in range(grid.x)], None past the last tile), as find_tile and
    the kernel's row0: every sequence's 128-row tiles in order, each
    sequence's last (longest causal rows) first."""
    lens = np.asarray(lens)
    rows = _rows(lens, used_q)
    grid = (int(lens.sum()) + len(lens) * (BLOCK_ROWS - 1)) // BLOCK_ROWS
    blocks = [(j, (n - 1 - m) * BLOCK_ROWS) for j, r in enumerate(rows)
              for n in [-(-int(r) // BLOCK_ROWS)] for m in range(n)]
    if len(blocks) > grid:
        raise AssertionError(f"grid {grid} short of {len(blocks)} tiles")
    return grid, blocks + [None] * (grid - len(blocks))


def dq_walk(row0, rows, keys, off, left, right, tile):
    """The key tiles of one block's pass, as the kernel's col_lo/col_hi:
    (tile_lo, n_tiles), tiles of `tile` keys."""
    row_last = min(row0 + BLOCK_ROWS, rows) - 1
    col_lo = max(row0 + off - left, 0) if left >= 0 else 0
    col_hi = min(row_last + off + right, keys - 1) if right >= 0 else keys - 1
    tile_lo = col_lo // tile
    return tile_lo, (col_hi // tile - tile_lo + 1 if col_hi >= col_lo else 0)


def _in_window(col, diag, left, right):
    return (left < 0 or col >= diag - left) & (right < 0 or col <= diag + right)


def varlen_dq_run(q, k, v, do, lse, cu_q, cu_k, used_q, used_k, *, causal,
                  window, softcap, layout):
    """Kernel 8 run in torch (fp32) over packed inputs: every block of the
    flat schedule and every head; Q/dO rows row0.. of the packed tensors
    (the next sequence's rows past this one's, zeros past the tensor's end
    as TMA fills them), K/V tiles at the sequence's offset, lse +inf on
    rows past `rows`, the mask on a warpgroup's tile unless every row sees
    every key (tile_full), delta in pass 1, dq in pass 2, and rows below
    `rows` stored. Returns (dq in q's layout, delta (h, total_q))."""
    qt, kt, vt, dot = (fv._thd(x, layout).float() for x in (q, k, v, do))
    total_q, h, d = qt.shape
    total_k, hk = kt.shape[:2]
    group, scale = h // hk, _scale(d, None)
    tile = walk_tile(d, softcap > 0)
    left, right = fv.varlen_window(window, causal)
    lens_q, lens_k = np.diff(cu_q), np.diff(cu_k)
    rows_of, keys_of = _rows(lens_q, used_q), _rows(lens_k, used_k)
    uq = lens_q if used_q is None else np.asarray(used_q)
    uk = lens_k if used_k is None else np.asarray(used_k)
    pad = lambda x, a, n: torch.cat([x, x.new_zeros((n,) + x.shape[1:])])[a:a + n]  # noqa: E731
    dq = torch.zeros_like(qt)
    delta = torch.zeros(h, total_q)
    _, blocks = dq_tiles(lens_q, used_q)
    for blk in blocks:
        if blk is None:
            continue
        seq, row0 = blk
        q0, k0 = int(cu_q[seq]), int(cu_k[seq])
        rows, keys, off = int(rows_of[seq]), int(keys_of[seq]), int(uk[seq] - uq[seq])
        tile_lo, n_tiles = dq_walk(row0, rows, keys, off, left, right, tile)
        r = row0 + torch.arange(BLOCK_ROWS)
        for head in range(h):
            g = head // group
            qb = pad(qt[:, head], q0 + row0, BLOCK_ROWS)
            dob = pad(dot[:, head], q0 + row0, BLOCK_ROWS)
            lrow = pad(lse[head], q0 + row0, BLOCK_ROWS)
            lse_r = torch.where((r < rows) & (lrow > -np.inf), lrow,
                                torch.tensor(np.inf))
            dsum = torch.zeros(BLOCK_ROWS)
            acc = torch.zeros(BLOCK_ROWS, d)
            for pas in range(2):
                for it in range(n_tiles):
                    col0 = (tile_lo + it) * tile
                    kb = pad(kt[:, g], k0 + col0, tile)
                    vb = pad(vt[:, g], k0 + col0, tile)
                    s = qb @ kb.T
                    if softcap > 0:
                        t = torch.tanh(s * (scale / softcap))
                        x, dmul = t * softcap, (1 - t * t) * scale
                    else:
                        x, dmul = s * scale, torch.full_like(s, scale)
                    p = torch.exp(x - lse_r[:, None])
                    col = col0 + torch.arange(tile)
                    vis = (col[None] < keys) & _in_window(
                        col[None], (r + off)[:, None], left, right)
                    for w0 in (0, 64):  # each warpgroup's tile_full
                        wr = row0 + w0
                        full = (wr + 64 <= rows and col0 + tile <= keys
                                and _in_window(col0, wr + 63 + off, left, -1)
                                and _in_window(col0 + tile - 1, wr + off, -1,
                                               right))
                        if not full:
                            p[w0:w0 + 64] = torch.where(
                                vis[w0:w0 + 64], p[w0:w0 + 64],
                                torch.zeros(()))
                    dp = dob @ vb.T
                    if pas == 0:
                        dsum += (p * dp).sum(1)
                    else:
                        acc += (p * (dp - dsum[:, None]) * dmul) @ kb
            keep = r < rows  # guarded per-row stores
            dq[q0 + r[keep], head] = acc[keep]
            delta[head, q0 + r[keep]] = dsum[keep]
    return (dq if layout == "thd" else dq.transpose(0, 1)), delta


# (lens, used_q): GPT2M_DOCS, lengths 0 and 1 among long ones, seqused_q
# below and above the lengths.
SCHEDULE_CASES = {
    "gpt2m-docs": (GPT2M_DOCS, None),
    "short-lengths": ((0, 1, 128, 129, 0, 1, 255, 300, 1), None),
    "seqused": ((200, 5, 129, 400, 64, 0), (130, 9, 129, 0, 200, 3)),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_dq_schedule_visits_each_row_tile_once_last_first(case):
    lens, used = SCHEDULE_CASES[case]
    grid, blocks = dq_tiles(lens, used)
    assert grid == fv.sm90_grid_tiles(sum(lens), len(lens), 128) or \
        grid == (sum(lens) + len(lens) * 127) // 128
    rows = _rows(np.asarray(lens), used)
    live = [b for b in blocks if b is not None]
    assert blocks[:len(live)] == live  # blocks past the last tile exit
    want = sorted((j, m * BLOCK_ROWS) for j, r in enumerate(rows)
                  for m in range(-(-int(r) // BLOCK_ROWS)))
    assert sorted(live) == want and len(set(live)) == len(live)
    for j in range(len(lens)):
        mine = [r0 for s, r0 in live if s == j]
        assert mine == sorted(mine, reverse=True)  # last tile first
        assert all(r0 < rows[j] for r0 in mine)
    if case == "gpt2m-docs":
        # 143 blocks per head at gpt2m-packed, 139 with rows: 2288 in all,
        # against 7424 of a max_seqlen_q x nseq grid of 64-row tiles.
        assert (grid, len(live), len(lens)) == (143, 139, 16)
        assert -(-max(lens) // 64) * len(lens) * 16 == 7424


def test_dq_grid_bound_is_never_short():
    rng = np.random.RandomState(7)
    for _ in range(300):
        n = int(rng.randint(1, 40))
        lens = rng.randint(0, 700, size=n)
        used = rng.randint(0, 800, size=n) if rng.rand() < 0.5 else None
        grid, blocks = dq_tiles(lens, used)
        assert sum(b is not None for b in blocks) <= grid


# (lens_q, lens_k, used_q, used_k, d, causal, window, softcap)
WALK_CASES = {
    "d64-causal": ((300, 1, 129, 700), (300, 1, 129, 700), None, None, 64,
                   True, (-1, -1), 0.0),
    "d128-window-seqused": ((12, 0, 1, 20, 9, 700), (15, 4, 1, 6, 9, 700),
                            (12, 0, 1, 14, 9, 700), (15, 4, 1, 5, 0, 700),
                            128, True, (63, -1), 0.0),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_dq_walk_covers_each_visible_pair_once(case):
    lens_q, lens_k, used_q, used_k, d, causal, window, softcap = \
        WALK_CASES[case]
    left, right = fv.varlen_window(window, causal)
    tile = walk_tile(d, softcap > 0)
    rows_of = _rows(np.asarray(lens_q), used_q)
    keys_of = _rows(np.asarray(lens_k), used_k)
    uq = lens_q if used_q is None else used_q
    uk = lens_k if used_k is None else used_k
    _, blocks = dq_tiles(lens_q, used_q)
    for j in range(len(lens_q)):
        rows, keys, off = int(rows_of[j]), int(keys_of[j]), uk[j] - uq[j]
        count = np.zeros((max(rows, 1), max(keys, 1)), np.int64)
        for seq, row0 in (b for b in blocks if b is not None and b[0] == j):
            tile_lo, n = dq_walk(row0, rows, keys, off, left, right, tile)
            r1 = min(row0 + BLOCK_ROWS, rows)
            for it in range(n):
                c0 = (tile_lo + it) * tile
                count[row0:r1, c0:min(c0 + tile, keys)] += 1
        i = np.arange(rows)[:, None]
        c = np.arange(keys)[None]
        vis = _in_window(c, i + off, left, right)
        if rows and keys:
            assert (count[vis] == 1).all()  # walked once per pass
            assert count.max() <= 1


# Packed metadata: (lens_q, lens_k, used_q, used_k, h, hk, d, causal,
# window, softcap, layout).
RUN_CASES = {
    # chip_smoke.py's edge-hsd-d128 metadata at small width: lengths 0 and
    # 1, seqused_q > seqused_k, seqused_k 0, a window, head-major.
    "edge-hsd-d128": ((12, 0, 1, 20, 9, 200), (15, 4, 1, 6, 9, 200),
                      (12, 0, 1, 14, 9, 200), (15, 4, 1, 5, 0, 200), 4, 2,
                      128, True, (63, -1), 0.0, "hsd"),
    # Packed documents across tile edges, softcap, GQA, d 64.
    "packed-softcap-d64": ((150, 3, 260, 90), (150, 3, 260, 90), None, None,
                           4, 1, 64, True, (-1, -1), 30.0, "thd"),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_dq_walk_in_torch_is_the_plain_dq(case):
    (lens_q, lens_k, used_q, used_k, h, hk, d, causal, window, softcap,
     layout) = RUN_CASES[case]
    rng = np.random.RandomState(3)
    tq, tk = sum(lens_q), sum(lens_k)

    def rand(total, heads):
        shape = (total, heads, d) if layout == "thd" else (heads, total, d)
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, do, k, v = rand(tq, h), rand(tq, h), rand(tk, hk), rand(tk, hk)
    cu_q = torch.tensor(np.concatenate([[0], np.cumsum(lens_q)]), dtype=torch.int32)
    cu_k = torch.tensor(np.concatenate([[0], np.cumsum(lens_k)]), dtype=torch.int32)
    ints = lambda x: None if x is None else torch.tensor(x, dtype=torch.int32)  # noqa: E731
    kw = dict(seqused_q=ints(used_q), seqused_k=ints(used_k), causal=causal,
              window_size=window, softcap=softcap, layout=layout)
    _, lse = fv.flash_attention_varlen_fwd_ref(q, k, v, cu_q, cu_k, **kw)
    ref_dq, ref_delta = fv._varlen_dq_ref(q, k, v, do, lse, cu_q, cu_k, **kw)
    dq, delta = varlen_dq_run(q, k, v, do, lse, cu_q.numpy(), cu_k.numpy(),
                              used_q, used_k, causal=causal, window=window,
                              softcap=softcap, layout=layout)
    if case == "edge-hsd-d128":
        assert (~torch.isfinite(lse)).any()  # rows that see no key: dq 0
    torch.testing.assert_close(dq, ref_dq, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(delta, ref_delta, rtol=1e-4, atol=1e-4)


# -- plain mirror of kernel 11's passes ---------------------------------------

def bs_dq_run(q, k, v, do, lse, lists, softcap):
    """Kernel 11 run in torch (fp32) over `bs_fwd_walks`: per block (two
    64-row blocks of one head and batch row) the merged walk twice, pass 1
    summing delta, pass 2 dq, each warpgroup on its own row block with its
    own mode (0: no mask, 1: the bounds, 2: its rows' words) and keys past
    sk read as zeros; every row below sq stored. Returns (dq, delta, how
    often each (b, head, row, key) was computed per pass)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    group, scale = h // k.shape[1], _scale(d, None)
    words = lists.words.numpy().view(np.uint64)
    kz = torch.cat([k.float(), k.new_zeros(b, k.shape[1], 64, d).float()], 2)
    vz = torch.cat([v.float(), v.new_zeros(b, v.shape[1], 64, d).float()], 2)
    dq = torch.zeros(b, h, sq, d)
    delta = torch.zeros(b, h, sq)
    count = np.zeros((2, b, h, sq + 64, sk + 64), np.int64)
    for (bi, hi, pair), steps in bs.bs_fwd_walks(lists).items():
        g = hi // group
        for wg in range(2):
            m = 2 * pair + wg
            rows = 64 * m + torch.arange(64)
            ok = rows < sq
            rr = rows.clamp(max=sq - 1)
            qb, dob = q[bi, hi, rr].float(), do[bi, hi, rr].float()
            lr = lse[bi, hi, rr]
            lse_r = torch.where(ok & (lr > -np.inf), lr, torch.tensor(np.inf))
            dsum, acc = torch.zeros(64), torch.zeros(64, d)
            for pas in range(2):
                for t, *sides in steps:
                    if sides[wg] is None:
                        continue
                    mode, wofs = sides[wg]
                    kb, vb = kz[bi, g, 64 * t:64 * t + 64], vz[bi, g, 64 * t:64 * t + 64]
                    s = qb @ kb.T
                    if softcap > 0:
                        tt = torch.tanh(s * (scale / softcap))
                        x, dmul = tt * softcap, (1 - tt * tt) * scale
                    else:
                        x, dmul = s * scale, torch.full_like(s, scale)
                    p = torch.exp(x - lse_r[:, None])
                    if mode == 0:
                        kept = np.ones((64, 64), bool)
                    elif mode == 1:
                        kept = (ok.numpy()[:, None]
                                & (64 * t + np.arange(64) < sk)[None])
                    else:
                        kept = ((words[wofs][:, None] >> BIT) & np.uint64(1)) > 0
                    p = torch.where(torch.from_numpy(kept), p, torch.zeros(()))
                    count[pas, bi, hi, 64 * m:64 * m + 64,
                          64 * t:64 * t + 64] += kept
                    dp = dob @ vb.T
                    if pas == 0:
                        dsum += (p * dp).sum(1)
                    else:
                        acc += (p * (dp - dsum[:, None]) * dmul) @ kb
            dq[bi, hi, rows[ok]] = acc[ok]
            delta[bi, hi, rows[ok]] = dsum[ok]
    return dq, delta, count


def _prefix_causal(prefix):
    def mod(b, h, q_idx, kv_idx):
        return (kv_idx <= q_idx) | (kv_idx < prefix)
    return mod


def _docs_causal(s, bounds):
    ids = torch.zeros(s, dtype=torch.int32)
    for i, (a, z) in enumerate(zip(bounds[:-1], bounds[1:])):
        ids[a:z] = i

    def mod(b, h, q_idx, kv_idx):
        doc = lambda i: ids[i.clamp(0, s - 1)]  # noqa: E731
        return (doc(q_idx) == doc(kv_idx)) & (kv_idx <= q_idx)
    return mod


def _gap_causal(b, h, q_idx, kv_idx):
    # Rows 128-319 keep nothing: whole row blocks with empty lists.
    return (kv_idx <= q_idx) & ((q_idx < 128) | (q_idx >= 320))


# name: (call batch, heads, kv heads, seqlen, mod, plan (batch, heads),
# tile, softcap). 520 rows: 9 row blocks (odd: the last pair's second list
# is empty); 454 rows: a partial last block; the gap leaves empty lists.
BS_CASES = {
    "doc-odd-blocks": (1, 2, 1, 520, _docs_causal(520, [0, 100, 230, 300, 520]),
                       (1, 2), 128, 0.0),
    "prefix-softcap": (1, 2, 2, 454, _prefix_causal(150), (1, 2), 128, 30.0),
    "broadcast-empty-lists": (2, 2, 1, 454, _gap_causal, (1, 1), 64, 0.0),
}


@pytest.mark.parametrize("case", list(BS_CASES))
def test_bs_dq_passes_are_the_plain_dq(case):
    b, h, hk, s, mod, (pb, ph), tile, softcap = BS_CASES[case]
    d = 64
    plan = bs.compute_block_sparsity(
        mod, batch_size=pb, num_heads=ph, seqlen_q=s, seqlen_k=s,
        tile_m=tile, tile_n=tile, device="cpu")
    lists = bs.build_execution_lists(plan, mod, None, b, h, s, s, "cpu")
    rng = np.random.RandomState(5)
    q, do = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hk, s, d))
                             .astype(np.float32)) for _ in range(2))
    kw = dict(mask_mod=mod, softcap=softcap)
    _, lse = bs.flash_attention_blocksparse_fwd_ref(q, k, v, plan, **kw)
    ref_dq, ref_delta = bs._blocksparse_dq_ref(q, k, v, do, lse, plan, **kw)
    dq, delta, count = bs_dq_run(q, k, v, do, lse, lists, softcap)
    keep = bs.block_sparse_keep_mask(plan, b, h, s, s, mask_mod=mod,
                                     device="cpu").numpy().astype(np.int64)
    for pas in range(2):  # each kept element once per pass, nothing else
        assert not count[pas, :, :, s:].any() and not count[pas, ..., s:].any()
        np.testing.assert_array_equal(count[pas, :, :, :s, :s], keep)
    torch.testing.assert_close(dq, ref_dq, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(delta, ref_delta, rtol=1e-4, atol=1e-4)
    nqb = -(-s // 64)
    empty = lists.counts.reshape(-1, nqb) == 0
    if case == "broadcast-empty-lists":
        assert empty[:, 2:5].all()  # row blocks 2-4 list nothing
        assert (dq[:, :, 128:320] == 0).all() and (delta[:, :, 128:320] == 0).all()
    if case == "doc-odd-blocks":
        assert nqb % 2 == 1


def test_mirror_constants_are_the_headers():
    dense = _src("flash_bwd_sm90.cuh")
    assert int(re.search(r"constexpr int kWarpgroups = (\d+);",
                         dense).group(1)) * 64 == BLOCK_ROWS
    assert "return d == 64 && !softcap ? 128 : 64;" in dense
    sched = _src("varlen_schedule.cuh")
    assert ("(total_q + static_cast<long long>(nseq) * (block_m - 1)) / "
            "block_m") in sched
    v8 = _src("flash_varlen_bwd_sm90.cuh")
    assert "vsched::grid_tiles(p.total_q, p.nseq, kBlockRows)" in v8
    assert "vsched::find_tile<kThreads, kBlockRows>(" in v8
    assert "(found[2] - 1 - found[1]) * kBlockRows" in v8  # last tile first
    assert "using fa::bwd90::walk_tile;" in v8
    b11 = _src("block_sparse_bwd_sm90.cuh")
    assert "using fa::bs90::kTile;" in b11 and "using fa::bs90::Merge;" in b11
    assert "const dim3 grid(p.h, (p.nqb + 1) / 2, batch);" in b11
    assert "gridDim.y - 1 - blockIdx.y" in b11  # last row blocks first
    assert "constexpr int kTile = bs::kSub;" in _src("block_sparse_fwd_sm90.cuh")
    assert bs.SUB == 64
