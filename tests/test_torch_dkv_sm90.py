"""The Hopper dK/dV kernels of the varlen backward (kernel 7,
csrc/flash_varlen_bwd_sm90.cuh) and the block-sparse backward (kernel 10,
csrc/block_sparse_bwd_sm90.cuh), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions and reads kernel 7's schedule from the kernel itself
(`flash_varlen.trace_schedule(..., kernel="dkv")`). Here plain mirrors of
their walks, kept in this file: kernel 7's flat schedule of key tiles
(`dkv_tiles`) visits every (sequence, 128-key tile) with a key exactly
once, each sequence's first tile first, and its grid bound is never short;
each block's query tiles (`dkv_walk`) cover every visible (row, key) pair
of its keys once for each query head; run in torch over the packed inputs
(`varlen_dkv_run`), with its masks, rows at lse +inf and guarded stores,
the walk computes `_varlen_dkv_ref`'s dk and dv. Kernel 10's walk
(`bs_dkv_walks`: per query head of the group, the merge of two 64-key
blocks' inverse lists) run in torch (`bs_dkv_run`) computes each kept
element once, by its owning warpgroup with its own mode and the transposed
bit test, and gives `_blocksparse_dkv_ref`'s dk and dv. The mirrors'
constants are the headers'. tests/test_torch_varlen.py and
tests/test_torch_block_sparsity.py hold the plain versions against the JAX
package; this file makes no JAX call.
"""

import os

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.kernels import block_sparsity as bs
from flash_attn_tpu_torch.kernels import flash_varlen as fv
from flash_attn_tpu_torch.kernels.common import cdiv
from flash_attn_tpu_torch.kernels.flash_bwd import walk_tile
from flash_attn_tpu_torch.kernels.flash_fwd import _scale

CSRC = os.path.join(os.path.dirname(fv.__file__), os.pardir, "csrc")
BLOCK_KEYS = 128  # kernel 7's keys a block (kBlockRows)
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


# -- plain mirrors of kernel 7's schedule and walk ---------------------------

def _used(lens, used):
    used = lens if used is None else np.asarray(used)
    return np.maximum(np.minimum(used, lens), 0)


def dkv_tiles(lens_k, used_k=None):
    """Kernel 7's flat schedule: (grid.x, [(sequence, first key) of block x
    for x in range(grid.x)], None past the last tile), as find_tile on
    cu_k / used_k and the kernel's key0: every sequence's 128-key tiles in
    order, its first (the longest causal walk) first."""
    lens_k = np.asarray(lens_k)
    keys = _used(lens_k, used_k)
    grid = (int(lens_k.sum()) + len(lens_k) * (BLOCK_KEYS - 1)) // BLOCK_KEYS
    blocks = [(j, m * BLOCK_KEYS) for j, n in enumerate(keys)
              for m in range(cdiv(int(n), BLOCK_KEYS))]
    if len(blocks) > grid:
        raise AssertionError(f"grid {grid} short of {len(blocks)} tiles")
    return grid, blocks + [None] * (grid - len(blocks))


def dkv_walk(key0, rows, keys, off, left, right, bq):
    """The query tiles of one block's walk for each query head, as the
    kernel's q_lo/q_hi: (qt_lo, n_qt), tiles of `bq` rows."""
    key_last = min(key0 + BLOCK_KEYS, keys) - 1
    q_lo = max(key0 - off - right, 0) if right >= 0 else 0
    q_hi = min(key_last - off + left, rows - 1) if left >= 0 else rows - 1
    qt_lo = q_lo // bq
    return qt_lo, (q_hi // bq - qt_lo + 1 if q_hi >= q_lo else 0)


def _in_window(col, diag, left, right):
    return (left < 0 or col >= diag - left) & (right < 0 or col <= diag + right)


def _pad(x, at, n):
    """Rows at..at + n of x, zeros past its end (TMA's fill)."""
    return torch.cat([x, x.new_zeros((n,) + x.shape[1:])])[at:at + n]


def _p_ds(q, k, do, v, lse_r, delta_r, scale, softcap):
    """P^T and dS^T (keys x rows) of one step, fp32."""
    s = k @ q.T
    if softcap > 0:
        t = torch.tanh(s * (scale / softcap))
        x, dmul = t * softcap, (1 - t * t) * scale
    else:
        x, dmul = s * scale, torch.full_like(s, scale)
    p = torch.exp(x - lse_r[None])
    dp = v @ do.T
    return p, p * (dp - delta_r[None]) * dmul


def varlen_dkv_run(q, k, v, do, lse, delta, cu_q, cu_k, used_q, used_k, *,
                   causal, window, softcap, layout):
    """Kernel 7 run in torch (fp32) over packed inputs: every block of the
    flat schedule and every kv head; K/V keys key0.. of the sequence (the
    next sequence's keys past its own, zeros past the tensor's end), for
    each query head of the group the query tiles of the walk, Q/dO rows at
    the sequence's offset, the LSE and delta read as one (h, total_q) row
    (zeros past its end) with lse +inf on rows past `rows`, the mask on a
    warpgroup's tile unless every row sees every key (full_tile), and keys
    below `keys` stored. Returns (dk, dv) in k's layout."""
    qt, kt, vt, dot = (fv._thd(x, layout).float() for x in (q, k, v, do))
    total_q, h, d = qt.shape
    hk = kt.shape[1]
    group, scale = h // hk, _scale(d, None)
    bq = walk_tile(d, softcap > 0)
    left, right = fv.varlen_window(window, causal)
    lens_q, lens_k = np.diff(cu_q), np.diff(cu_k)
    rows_of, keys_of = _used(lens_q, used_q), _used(lens_k, used_k)
    uq = lens_q if used_q is None else np.asarray(used_q)
    uk = lens_k if used_k is None else np.asarray(used_k)
    lse_flat, delta_flat = lse.reshape(-1), delta.reshape(-1)
    dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
    _, blocks = dkv_tiles(lens_k, used_k)
    for blk in blocks:
        if blk is None:
            continue
        seq, key0 = blk
        q0, k0 = int(cu_q[seq]), int(cu_k[seq])
        rows, keys = int(rows_of[seq]), int(keys_of[seq])
        off = int(uk[seq] - uq[seq])
        qt_lo, n_qt = dkv_walk(key0, rows, keys, off, left, right, bq)
        if n_qt == 0:  # no row sees these keys: nothing stored
            continue
        kk = key0 + torch.arange(BLOCK_KEYS)
        for g in range(hk):
            kb = _pad(kt[:, g], k0 + key0, BLOCK_KEYS)
            vb = _pad(vt[:, g], k0 + key0, BLOCK_KEYS)
            acc_k = torch.zeros(BLOCK_KEYS, d)
            acc_v = torch.zeros(BLOCK_KEYS, d)
            for it in range(n_qt * group):
                head = g * group + it // n_qt
                rb = (qt_lo + it % n_qt) * bq
                r = rb + torch.arange(bq)
                qb = _pad(qt[:, head], q0 + rb, bq)
                dob = _pad(dot[:, head], q0 + rb, bq)
                at = head * total_q + q0 + rb
                lrow = _pad(lse_flat, at, bq)
                drow = _pad(delta_flat, at, bq)
                lse_r = torch.where((r < rows) & (lrow > -np.inf), lrow,
                                    torch.tensor(np.inf))
                p, ds = _p_ds(qb, kb, dob, vb, lse_r, drow, scale, softcap)
                vis = (kk[:, None] < keys) & _in_window(
                    kk[:, None], (r + off)[None], left, right)
                for w0 in (0, 64):  # each warpgroup's full_tile
                    wk = key0 + w0
                    full = (rb + bq <= rows and wk + 64 <= keys
                            and _in_window(wk, rb + bq - 1 + off, left, -1)
                            and _in_window(wk + 63, rb + off, -1, right))
                    if not full:
                        sl = slice(w0, w0 + 64)
                        p[sl] = torch.where(vis[sl], p[sl], torch.zeros(()))
                        ds[sl] = torch.where(vis[sl], ds[sl], torch.zeros(()))
                acc_v += p @ dob
                acc_k += ds @ qb
            keep = kk < keys  # guarded per-row stores
            dk[k0 + kk[keep], g] = acc_k[keep]
            dv[k0 + kk[keep], g] = acc_v[keep]
    if layout == "hsd":
        return dk.transpose(0, 1), dv.transpose(0, 1)
    return dk, dv


# (lens_k, used_k): GPT2M_DOCS, lengths 0 and 1 among long ones, seqused_k
# below and above the lengths and 0.
SCHEDULE_CASES = {
    "gpt2m-docs": (GPT2M_DOCS, None),
    "short-lengths": ((0, 1, 128, 129, 0, 1, 255, 300, 1), None),
    "seqused": ((200, 5, 129, 400, 64, 0), (130, 9, 0, 0, 200, 3)),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_dkv_schedule_visits_each_key_tile_once_first_first(case):
    lens, used = SCHEDULE_CASES[case]
    grid, blocks = dkv_tiles(lens, used)
    assert grid == (sum(lens) + len(lens) * 127) // 128
    keys = _used(np.asarray(lens), used)
    live = [b for b in blocks if b is not None]
    assert blocks[:len(live)] == live  # blocks past the last tile exit
    want = sorted((j, m * BLOCK_KEYS) for j, n in enumerate(keys)
                  for m in range(cdiv(int(n), BLOCK_KEYS)))
    assert sorted(live) == want and len(set(live)) == len(live)
    for j in range(len(lens)):
        mine = [k0 for s, k0 in live if s == j]
        assert mine == sorted(mine)  # first tile first
        assert all(k0 < keys[j] for k0 in mine)
        if keys[j] == 0:
            assert not mine  # seqused_k 0 or length 0: no block
    if case == "gpt2m-docs":
        # 143 blocks per kv head at gpt2m-packed, 139 with keys, as kernel
        # 8's row tiles (the same documents).
        assert (grid, len(live), len(lens)) == (143, 139, 16)


def test_dkv_grid_bound_is_never_short():
    rng = np.random.RandomState(11)
    for _ in range(300):
        n = int(rng.randint(1, 40))
        lens = rng.randint(0, 700, size=n)
        used = rng.randint(0, 800, size=n) if rng.rand() < 0.5 else None
        grid, blocks = dkv_tiles(lens, used)
        assert sum(b is not None for b in blocks) <= grid


# (lens_q, lens_k, used_q, used_k, h, hk, d, causal, window, softcap)
WALK_CASES = {
    "d64-causal": ((300, 1, 129, 700), (300, 1, 129, 700), None, None, 4, 4,
                   64, True, (-1, -1), 0.0),
    "d128-window-seqused": ((12, 0, 1, 20, 9, 700), (15, 4, 1, 6, 9, 700),
                            (12, 0, 1, 14, 9, 700), (15, 4, 1, 5, 0, 700),
                            8, 2, 128, True, (63, -1), 0.0),
    "gqa-sq-ne-sk-window": ((100, 40, 300), (260, 700, 90), None, None, 6, 2,
                            64, False, (200, 30), 30.0),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_dkv_walk_covers_each_visible_pair_once(case):
    (lens_q, lens_k, used_q, used_k, h, hk, d, causal, window,
     softcap) = WALK_CASES[case]
    left, right = fv.varlen_window(window, causal)
    bq = walk_tile(d, softcap > 0)
    group = h // hk
    rows_of = _used(np.asarray(lens_q), used_q)
    keys_of = _used(np.asarray(lens_k), used_k)
    uq = lens_q if used_q is None else used_q
    uk = lens_k if used_k is None else used_k
    _, blocks = dkv_tiles(lens_k, used_k)
    for j in range(len(lens_q)):
        rows, keys, off = int(rows_of[j]), int(keys_of[j]), uk[j] - uq[j]
        count = np.zeros((h, max(rows, 1), max(keys, 1)), np.int64)
        for seq, key0 in (b for b in blocks if b is not None and b[0] == j):
            qt_lo, n_qt = dkv_walk(key0, rows, keys, off, left, right, bq)
            k1 = min(key0 + BLOCK_KEYS, keys)
            for g in range(hk):
                for it in range(n_qt * group):
                    head = g * group + it // n_qt
                    rb = (qt_lo + it % n_qt) * bq
                    count[head, rb:min(rb + bq, rows), key0:k1] += 1
        i = np.arange(rows)[:, None]
        c = np.arange(keys)[None]
        vis = _in_window(c, i + off, left, right)
        if rows and keys:
            for head in range(h):
                assert (count[head][vis] == 1).all()  # walked once per head
            assert count.max() <= 1


# Packed metadata: (lens_q, lens_k, used_q, used_k, h, hk, d, causal,
# window, softcap, layout).
RUN_CASES = {
    # chip_smoke.py's edge-hsd-d128 metadata at small width: lengths 0 and
    # 1, seqused_q > seqused_k, seqused_k 0, a window, head-major, GQA.
    "edge-hsd-d128": ((12, 0, 1, 20, 9, 200), (15, 4, 1, 6, 9, 200),
                      (12, 0, 1, 14, 9, 200), (15, 4, 1, 5, 0, 200), 4, 2,
                      128, True, (63, -1), 0.0, "hsd"),
    # Packed documents across tile edges, softcap, GQA, d 64.
    "packed-softcap-d64": ((150, 3, 260, 90), (150, 3, 260, 90), None, None,
                           4, 2, 64, True, (-1, -1), 30.0, "thd"),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_dkv_walk_in_torch_is_the_plain_dkv(case):
    (lens_q, lens_k, used_q, used_k, h, hk, d, causal, window, softcap,
     layout) = RUN_CASES[case]
    rng = np.random.RandomState(4)
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
    _, delta = fv._varlen_dq_ref(q, k, v, do, lse, cu_q, cu_k, **kw)
    ref_dk, ref_dv = fv._varlen_dkv_ref(q, k, v, do, lse, delta, cu_q, cu_k,
                                        **kw)
    dk, dv = varlen_dkv_run(q, k, v, do, lse, delta, cu_q.numpy(),
                            cu_k.numpy(), used_q, used_k, causal=causal,
                            window=window, softcap=softcap, layout=layout)
    if case == "edge-hsd-d128":
        assert (~torch.isfinite(lse)).any()  # rows that see no key
    torch.testing.assert_close(dk, ref_dk, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dv, ref_dv, rtol=1e-4, atol=1e-4)


# -- plain mirror of kernel 10's walk -----------------------------------------

def bs_dkv_walks(lists, group):
    """Plain mirror of kernel 10's walks over one call's inverse lists: {(b,
    kv head, pair): steps}, the block of 64-key blocks 2 pair and 2 pair +
    1 walking, for each query head j of the group in turn, the ascending
    merge of that head's two inverse lists (thread 0's two-pointer merge,
    restarted per head), each step (j, 64-row block, (mode, word group) of
    key block 2 pair or None, the same of key block 2 pair + 1 or None);
    warpgroup i owns key block 2 pair + i. The second list of a last pair
    with an odd number of key blocks is empty: the kernel reads no count
    past a head's row."""
    b, h, nkb = lists.inv_counts.shape
    counts = lists.inv_counts.reshape(-1).tolist()
    rows = lists.inv_rows.reshape(len(counts), -1).tolist()
    wofs = lists.inv_wofs.reshape(len(counts), -1).tolist()
    walks = {}
    for bi in range(b):
        for g in range(h // group):
            for pair in range(cdiv(nkb, 2)):
                steps = []
                for j in range(group):
                    r = (bi * h + g * group + j) * nkb
                    heads = []
                    for m in (2 * pair, 2 * pair + 1):
                        n = counts[r + m] if m < nkb else 0
                        heads.append({e >> 2: (e & 3, w) for e, w in
                                      zip(rows[r + m][:n], wofs[r + m][:n])}
                                     if n else {})
                    steps += [(j, qb, heads[0].get(qb), heads[1].get(qb))
                              for qb in sorted(set(heads[0]) | set(heads[1]))]
                walks[bi, g, pair] = steps
    return walks


def bs_dkv_run(q, k, v, do, lse, delta, lists, softcap):
    """Kernel 10 run in torch (fp32) over `bs_dkv_walks`: per block (two
    64-key blocks of one kv head and batch row) the merged walk of every
    query head of the group, each warpgroup on its own key block with its
    own mode (0: no mask, 1: keys below sk, 2: for each (key, row) the key's
    bit in the row's word), rows past sq zeros with lse +inf; every key
    below sk stored. Returns (dk, dv, how often each (b, head, row, key) was
    computed with a P that may be nonzero)."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group, scale = h // hk, _scale(d, None)
    words = lists.words.numpy().view(np.uint64)
    dk = torch.zeros(b, hk, sk, d)
    dv = torch.zeros(b, hk, sk, d)
    count = np.zeros((b, h, sq + 64, sk + 64), np.int64)
    for (bi, g, pair), steps in bs_dkv_walks(lists, group).items():
        for wg in range(2):
            m = 2 * pair + wg
            keys = 64 * m + torch.arange(64)
            kb, vb = (_pad(x[bi, g].float(), 64 * m, 64) for x in (k, v))
            acc_k, acc_v = torch.zeros(64, d), torch.zeros(64, d)
            for j, qb, *sides in steps:
                if sides[wg] is None:
                    continue
                mode, wofs = sides[wg]
                head = g * group + j
                r = 64 * qb + torch.arange(64)
                qr, dor = (_pad(x[bi, head].float(), 64 * qb, 64)
                           for x in (q, do))
                lrow = _pad(lse[bi, head], 64 * qb, 64)
                lse_r = torch.where((r < sq) & (lrow > -np.inf), lrow,
                                    torch.tensor(np.inf))
                p, ds = _p_ds(qr, kb, dor, vb, lse_r,
                              _pad(delta[bi, head], 64 * qb, 64), scale,
                              softcap)
                if mode == 0:
                    kept = np.ones((64, 64), bool)
                elif mode == 1:
                    kept = np.repeat((keys.numpy() < sk)[:, None], 64, 1)
                else:  # the transposed bit test: key c of row r's word
                    kept = (((words[wofs][None, :] >> BIT[:, None])
                             & np.uint64(1)) > 0)
                keep = torch.from_numpy(kept)
                p = torch.where(keep, p, torch.zeros(()))
                ds = torch.where(keep, ds, torch.zeros(()))
                live = kept & (r.numpy() < sq)[None]  # P of rows past sq is 0
                count[bi, head, 64 * qb:64 * qb + 64,
                      64 * m:64 * m + 64] += live.T
                acc_v += p @ dor
                acc_k += ds @ qr
            ok = keys < sk
            dk[bi, g, keys[ok]] = acc_k[ok]
            dv[bi, g, keys[ok]] = acc_v[ok]
    return dk, dv, count


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


def _key_gap_causal(b, h, q_idx, kv_idx):
    # Keys 128-319 are kept by no row: whole key blocks with empty inverse
    # lists (the block of key blocks 2 and 3 has nothing to walk).
    return (kv_idx <= q_idx) & ((kv_idx < 128) | (kv_idx >= 320))


# name: (call batch, heads, kv heads, seqlen, mod, plan (batch, heads),
# tile, softcap). 520 keys: 9 key blocks (odd: the last pair's second list
# is empty); 454: a partial last block; the gap leaves empty lists.
BS_CASES = {
    "doc-odd-blocks": (1, 2, 1, 520, _docs_causal(520, [0, 100, 230, 300, 520]),
                       (1, 2), 128, 0.0),
    "prefix-softcap": (1, 2, 2, 454, _prefix_causal(150), (1, 2), 128, 30.0),
    "broadcast-empty-lists-gqa": (2, 4, 2, 454, _key_gap_causal, (1, 1), 64,
                                  0.0),
}


@pytest.mark.parametrize("case", list(BS_CASES))
def test_bs_dkv_walk_is_the_plain_dkv(case):
    b, h, hk, s, mod, (pb, ph), tile, softcap = BS_CASES[case]
    d = 64
    plan = bs.compute_block_sparsity(
        mod, batch_size=pb, num_heads=ph, seqlen_q=s, seqlen_k=s,
        tile_m=tile, tile_n=tile, device="cpu")
    lists = bs.build_execution_lists(plan, mod, None, b, h, s, s, "cpu")
    rng = np.random.RandomState(6)
    q, do = (torch.from_numpy(rng.standard_normal((b, h, s, d))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hk, s, d))
                             .astype(np.float32)) for _ in range(2))
    kw = dict(mask_mod=mod, softcap=softcap)
    _, lse = bs.flash_attention_blocksparse_fwd_ref(q, k, v, plan, **kw)
    _, delta = bs._blocksparse_dq_ref(q, k, v, do, lse, plan, **kw)
    ref_dk, ref_dv = bs._blocksparse_dkv_ref(q, k, v, do, lse, delta, plan,
                                             **kw)
    dk, dv, count = bs_dkv_run(q, k, v, do, lse, delta, lists, softcap)
    keep = bs.block_sparse_keep_mask(plan, b, h, s, s, mask_mod=mod,
                                     device="cpu").numpy().astype(np.int64)
    # Each kept element once, by the warpgroup owning its key, nothing else.
    assert not count[:, :, s:].any() and not count[..., s:].any()
    np.testing.assert_array_equal(count[:, :, :s, :s], keep)
    torch.testing.assert_close(dk, ref_dk, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dv, ref_dv, rtol=1e-4, atol=1e-4)
    nkb = cdiv(s, 64)
    if case == "broadcast-empty-lists-gqa":
        empty = lists.inv_counts.reshape(-1, nkb) == 0
        assert empty[:, 2:5].all()  # key blocks 2-4 list nothing
        assert (dk[:, :, 128:320] == 0).all() and (dv[:, :, 128:320] == 0).all()
    if case == "doc-odd-blocks":
        assert nkb % 2 == 1


def test_mirror_constants_are_the_headers():
    dense = _src("flash_bwd_sm90.cuh")
    assert "constexpr int kWarpgroups = 2;" in dense  # 128 keys a block
    assert "return d == 64 && !softcap ? 128 : 64;" in dense
    sched = _src("varlen_schedule.cuh")
    assert ("(total_q + static_cast<long long>(nseq) * (block_m - 1)) / "
            "block_m") in sched
    v7 = _src("flash_varlen_bwd_sm90.cuh")
    assert "vsched::grid_tiles(total_k, p.nseq, kBlockRows)" in v7
    assert ("vsched::find_tile<kThreads, kBlockRows>(\n"
            "      p.cu_k, p.used_k, p.nseq, blockIdx.x, scan)") in v7
    # first tile first: key0 is the tile's index in its sequence
    assert "const int key0 = scan[kThreads / 32 + 1] * kBlockRows;" in v7
    assert "const int q_lo = p.right >= 0 ? max(key0 - off - p.right, 0) : 0;" in v7
    assert "const int head = g * p.group + it / n_qt;" in v7
    b10 = _src("block_sparse_bwd_sm90.cuh")
    assert "const dim3 grid(p.h / p.group, (p.nkb + 1) / 2, batch);" in b10
    assert "const int pair = blockIdx.y;  // 64-key blocks" in b10  # first first
    assert "st.tile = j * p.nqb + qb;" in b10
    assert "const bool second = 2 * pair + 1 < p.nkb;" in b10
    assert "m.rows[i] |= ((word >> (key[i] - wkey0)) & 1ull) << (8 * j + c);" in b10
    assert "constexpr int kTile = bs::kSub;" in _src("block_sparse_fwd_sm90.cuh")
    assert bs.SUB == 64
