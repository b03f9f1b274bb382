"""The port's block-sparse mask_mod attention against the JAX package's.

The same numpy-seeded q, k, v and output cotangent go through
flash_attn_tpu's `flash_attn_func(block_sparse_tensors=...)` (Pallas in
interpret mode on the CPU, as its own tests run it) and the port's, forward
and `torch.autograd.grad`; the planners' lists are compared entry by entry.
Each mod is written once with operators and takes `aux_take` from its own
package. On the CPU the port's kernel wrappers run their plain versions
(`flash_attention_blocksparse_fwd_ref`, `_blocksparse_dq_ref`,
`_blocksparse_dkv_ref`); chip_smoke.py holds kernels 9-11 against those on
the card. The execution lists, which only the card's kernels read, are
held here against a numpy brute force. Each JAX result is built once per
module: an interpret-mode call costs seconds.

Both sides run in fp32 and differ only in summation order and the JAX
kernels' base-2 online softmax, so RTOL is far inside the numerics contract
(2 x the bf16-eager error against an fp32 oracle).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import BlockSparseTensors as JaxBlockSparseTensors
from flash_attn_tpu import compute_block_sparsity as jax_plan
from flash_attn_tpu import flash_attn_func as jax_attn
from flash_attn_tpu.kernels.common import aux_take as jax_take
from flash_attn_tpu_torch import (
    BlockSparseTensors,
    compute_block_sparsity,
    flash_attn_func,
)
from flash_attn_tpu_torch.kernels import block_sparsity as bs
from flash_attn_tpu_torch.kernels.common import aux_take as torch_take
from flash_attn_tpu_torch.utils.testing import masked_attention_ref

RTOL = 1e-4
B, H, S, D, TILE = 2, 4, 512, 64, 128


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL,
                               atol=RTOL * np.abs(want[finite]).max())


def _doc_ids(s):
    # Uneven documents, boundaries off the tiles (the JAX tests' own).
    bounds = [0, 100, 230, 300, s]
    ids = np.zeros(s, np.int32)
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        ids[a:b] = i
    return ids


def doc_mod(take):
    def mask_mod(b, h, q_idx, kv_idx, aux):
        d = aux.tensors[0]
        return (kv_idx <= q_idx) & (take(d, q_idx) == take(d, kv_idx))

    return mask_mod


def causal(b, h, q_idx, kv_idx):
    return kv_idx <= q_idx


def prefix_lm(b, h, q_idx, kv_idx):
    return (kv_idx < 130) | (kv_idx <= q_idx)


def sliding(b, h, q_idx, kv_idx):
    return (kv_idx <= q_idx) & (q_idx - kv_idx < 150)


def head_alternating(b, h, q_idx, kv_idx):
    return (h % 2 == 1) | (kv_idx <= q_idx)


def one_hole_per_tile(b, h, q_idx, kv_idx):
    # Masks row 5, column 7 of every 128-tile: no corner and no center
    # sample hits it, so fast sampling calls every tile FULL.
    return (q_idx % TILE != 5) | (kv_idx % TILE != 7)


# name -> (mod of a take function, aux (numpy), seqlen, heads, kv heads,
# softcap, plan heads)
CASES = {
    "doc_aux": (doc_mod, (_doc_ids(S),), S, H, H, 0.0, H),
    "gqa_window": (lambda t: sliding, (), S, 4, 2, 0.0, 4),
    "softcap": (lambda t: prefix_lm, (), S, H, H, 5.0, H),
    "single_head_plan": (lambda t: head_alternating, (), S, H, H, 0.0, 1),
    "unaligned": (lambda t: causal, (), 384 + 70, H, H, 0.0, H),
    "gqa_softcap_unaligned": (lambda t: sliding, (), 454, 4, 2, 5.0, 4),
}


def _inputs(seed, s, h, hk):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in (
        (B, s, h, D), (B, s, hk, D), (B, s, hk, D), (B, s, h, D)))


@functools.lru_cache(maxsize=None)
def _jax_plan(name, **kw):
    mod, aux, s, _, _, _, plan_h = CASES[name]
    return jax_plan(mod(jax_take), batch_size=B if plan_h > 1 else 1,
                    num_heads=plan_h, seqlen_q=s, seqlen_k=s, tile_m=TILE,
                    tile_n=TILE,
                    aux_tensors=tuple(jnp.asarray(a) for a in aux), **kw)


def _port_plan(name, **kw):
    mod, aux, s, _, _, _, plan_h = CASES[name]
    return compute_block_sparsity(
        mod(torch_take), batch_size=B if plan_h > 1 else 1, num_heads=plan_h,
        seqlen_q=s, seqlen_k=s, tile_m=TILE, tile_n=TILE,
        aux_tensors=tuple(torch.as_tensor(a) for a in aux), device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax_result(name, grads=False, **kw):
    """out (and lse) of the JAX package, or its gradients of sum(out * do)."""
    mod, aux, s, h, hk, softcap, _ = CASES[name]
    q, k, v, do = _inputs(1, s, h, hk)
    plan = _jax_plan(name, **kw)
    call = functools.partial(
        jax_attn, mask_mod=mod(jax_take), softcap=softcap,
        aux_tensors=tuple(jnp.asarray(a) for a in aux),
        block_sparse_tensors=plan)
    if grads:
        loss = lambda q_, k_, v_: jnp.sum(call(q_, k_, v_) * do)  # noqa: E731
        return tuple(np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(q, k, v))
    out, lse, _ = call(q, k, v, return_attn_probs=True)
    return np.asarray(out), np.asarray(lse)


def _port_call(name, plan, *, requires_grad=False):
    mod, aux, s, h, hk, softcap, _ = CASES[name]
    q, k, v, do = (torch.tensor(x, requires_grad=requires_grad)
                   for x in _inputs(1, s, h, hk))
    out, lse, _ = flash_attn_func(
        q, k, v, mask_mod=mod(torch_take), softcap=softcap,
        aux_tensors=tuple(torch.as_tensor(a) for a in aux),
        block_sparse_tensors=plan, return_attn_probs=True)
    return out, lse, (q, k, v, do)


@pytest.mark.parametrize("name, fast", [("doc_aux", False),
                                        ("softcap", False),
                                        ("doc_aux", True)])
def test_planner_matches_jax(name, fast):
    """Exact classification (doc mask through an aux table; prefix-LM) and
    5-point sampling give the JAX planner's lists, entry by entry; the
    port's plan also records its grid."""
    mine = _port_plan(name, use_fast_sampling=fast)
    ref = _jax_plan(name, use_fast_sampling=fast)
    for field in ("mask_block_cnt", "mask_block_idx", "full_block_cnt",
                  "full_block_idx"):
        np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    assert (mine.seqlen_q, mine.seqlen_k, mine.num_m, mine.num_n) == (
        S, S, S // TILE, S // TILE)
    assert mine.block_size == (TILE, TILE)
    if fast:  # the mod's own flag picks sampling, as in the JAX planner
        mod = doc_mod(torch_take)
        mod.use_fast_sampling = True
        flagged = compute_block_sparsity(
            mod, batch_size=B, num_heads=H, seqlen_q=S, seqlen_k=S,
            tile_m=TILE, tile_n=TILE, aux_tensors=(torch.as_tensor(
                _doc_ids(S)),), device="cpu")
        assert torch.equal(flagged.full_block_cnt, mine.full_block_cnt)


@pytest.mark.parametrize("name", ["doc_aux", "gqa_window", "softcap",
                                  "single_head_plan", "unaligned"])
def test_forward_matches_jax(name):
    """Forward parity: doc mask with aux, GQA, softcap, a single-head plan
    broadcast to every (b, h) with a head-dependent mod (evaluated at each
    real head in partial tiles), and a seqlen off the tiles."""
    out, lse, _ = _port_call(name, _port_plan(name))
    ref_out, ref_lse = _jax_result(name)
    _close(out.numpy(), ref_out)
    _close(lse.numpy(), ref_lse)


@pytest.mark.parametrize("name", ["doc_aux", "gqa_softcap_unaligned"])
def test_backward_matches_jax(name):
    """torch.autograd.grad of sum(out * do) against jax.grad: dQ, and dK/dV
    summed over each GQA group."""
    out, _, (q, k, v, do) = _port_call(name, _port_plan(name),
                                       requires_grad=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    for got, want in zip(grads, _jax_result(name, grads=True)):
        _close(got.numpy(), want)


def test_full_blocks_off_matches_jax():
    """compute_full_blocks=False: no full lists, every live tile in the mask
    lists (and through the mod), as in JAX."""
    plan = _port_plan("doc_aux", compute_full_blocks=False)
    assert plan.full_block_cnt is None and plan.full_block_idx is None
    np.testing.assert_array_equal(
        plan.mask_block_cnt.numpy(),
        np.asarray(_jax_plan("doc_aux", compute_full_blocks=False)
                   .mask_block_cnt))
    out, lse, _ = _port_call("doc_aux", plan)
    ref_out, ref_lse = _jax_result("doc_aux", compute_full_blocks=False)
    _close(out.numpy(), ref_out)
    _close(lse.numpy(), ref_lse)


def test_plan_without_mod_is_a_blockmask():
    """With no mask_mod a PARTIAL tile gets the bounds only (JAX test
    test_blocksparse_without_mod_is_blockmask): diagonal tiles listed as
    partial, the lower ones as full, attend whole tiles."""
    nm = S // TILE
    eye = np.broadcast_to(np.eye(nm, dtype=bool), (B, H, nm, nm))
    low = np.broadcast_to(np.tril(np.ones((nm, nm), bool), -1), (B, H, nm, nm))

    def pack(flags):
        return (flags.sum(-1).astype(np.int32),
                np.argsort(~flags, axis=-1, kind="stable").astype(np.int32))

    fields = (*pack(eye), *pack(low), (TILE, TILE))
    q, k, v, _ = _inputs(2, S, H, H)
    want = np.asarray(jax_attn(
        q, k, v, block_sparse_tensors=JaxBlockSparseTensors(*fields)))
    got = flash_attn_func(*(torch.tensor(x) for x in (q, k, v)),
                          block_sparse_tensors=BlockSparseTensors(*fields))
    _close(got.numpy(), want)
    keep = torch.tensor(np.kron(np.tril(np.ones((nm, nm), bool)),
                                np.ones((TILE, TILE), bool)))
    oracle, _ = masked_attention_ref(*(torch.tensor(x) for x in (q, k, v)),
                                     keep[None, None])
    _close(got.numpy(), oracle.numpy())


def test_fast_sampling_misclassified_tile_runs_unmasked():
    """A fast-sampling plan that calls tiles FULL which the mod masks in
    part: those tiles run unmasked, as in JAX, so the result is plain
    causal-free attention, not the mod's."""
    q, k, v, _ = _inputs(3, S, H, H)
    kw = dict(batch_size=B, num_heads=H, seqlen_q=S, seqlen_k=S, tile_m=TILE,
              tile_n=TILE, use_fast_sampling=True)
    plan = compute_block_sparsity(one_hole_per_tile, device="cpu", **kw)
    assert int(plan.mask_block_cnt.sum()) == 0  # every tile called FULL
    got = flash_attn_func(*(torch.tensor(x) for x in (q, k, v)),
                          mask_mod=one_hole_per_tile, block_sparse_tensors=plan)
    want = np.asarray(jax_attn(q, k, v, mask_mod=one_hole_per_tile,
                               block_sparse_tensors=jax_plan(
                                   one_hole_per_tile, **kw)))
    _close(got.numpy(), want)
    unmasked, _ = masked_attention_ref(*(torch.tensor(x) for x in (q, k, v)),
                                       torch.ones(1, 1, S, S, dtype=torch.bool))
    _close(got.numpy(), unmasked.numpy())


def test_jax_plan_drives_the_port():
    """The JAX planner's numpy plan (five fields, no recorded grid) runs the
    port unchanged and gives exactly what the port's own plan gives."""
    ref = _jax_plan("doc_aux")
    assert isinstance(ref.mask_block_cnt, np.ndarray)
    from_jax, lse_jax, _ = _port_call("doc_aux", ref)
    own, lse_own, _ = _port_call("doc_aux", _port_plan("doc_aux"))
    assert torch.equal(from_jax, own) and torch.equal(lse_jax, lse_own)


def _brute_keep(plan, b, h, sq, sk, mod, aux):
    """The kept elements straight from the plan and the mod, in numpy."""
    tm, tn = plan.block_size
    partial = np.zeros((b, h, -(-sq // tm), -(-sk // tn)), bool)
    full = np.zeros_like(partial)
    for flags, cnt, idx in ((partial, plan.mask_block_cnt, plan.mask_block_idx),
                            (full, plan.full_block_cnt, plan.full_block_idx)):
        cnt, idx = np.asarray(cnt), np.asarray(idx)
        for bi in range(b):
            for hi in range(h):
                pb, ph = bi % cnt.shape[0], hi % cnt.shape[1]
                for m in range(cnt.shape[2]):
                    flags[bi, hi, m, idx[pb, ph, m, :cnt[pb, ph, m]]] = True
    keep = np.zeros((b, h, sq, sk), bool)
    rows, cols = np.arange(sq)[:, None], np.arange(sk)[None]
    for bi in range(b):
        for hi in range(h):
            p = partial[bi, hi][rows // tm, cols // tn]
            f = full[bi, hi][rows // tm, cols // tn]
            m = np.broadcast_to(mod(bi, hi, rows, cols, *aux), (sq, sk))
            keep[bi, hi] = np.where(p, m, f)
    return keep


def test_execution_lists_match_brute_force():
    """The kernels' lists (modes, per-row words, inverse lists) decode to
    exactly the kept elements: a single-head plan broadcast to GQA heads,
    a head-dependent mod, a seqlen off the tiles."""
    s, h = 454, 4

    def mod(b, h_, q_idx, kv_idx):
        return ((h_ % 2 == 1) & (q_idx - kv_idx < 70)) | (kv_idx <= q_idx // 2)

    plan = compute_block_sparsity(mod, batch_size=1, num_heads=1, seqlen_q=s,
                                  seqlen_k=s, tile_m=TILE, tile_n=TILE,
                                  device="cpu")
    lists = bs.build_execution_lists(plan, mod, None, B, h, s, s, "cpu")
    keep = _brute_keep(plan, B, h, s, s, mod, ())
    words = lists.words.numpy().view(np.uint64)
    bit = np.arange(64, dtype=np.uint64)
    span = 64 * (-(-s // 64))

    def row_words(mode, wofs, m0, n0):
        rows = 64 * m0 + np.arange(64)
        if mode == 2:
            return words[wofs]
        cols = 64 if mode == 0 else min(max(s - 64 * n0, 0), 64)
        w = np.uint64((1 << cols) - 1)
        return np.where(rows < s, w, np.uint64(0)) if mode == 1 else np.full(
            64, w)

    def decode(counts, entries, wofs, transposed):
        got = np.zeros((B, h, span, span), bool)
        for bi, hi, blk in np.ndindex(*counts.shape):
            for x in range(counts[bi, hi, blk]):
                idx, mode = entries[bi, hi, blk, x] >> 2, entries[bi, hi, blk, x] & 3
                m0, n0 = (idx, blk) if transposed else (blk, idx)
                w = row_words(mode, wofs[bi, hi, blk, x], m0, n0)
                got[bi, hi, 64 * m0:64 * m0 + 64, 64 * n0:64 * n0 + 64] = (
                    (w[:, None] >> bit) & np.uint64(1)).astype(bool)
        assert not got[:, :, s:].any() and not got[..., s:].any()
        return got[:, :, :s, :s]

    fwd = decode(lists.counts.numpy(), lists.tiles.numpy(), lists.wofs.numpy(),
                 False)
    inv = decode(lists.inv_counts.numpy(), lists.inv_rows.numpy(),
                 lists.inv_wofs.numpy(), True)
    assert (fwd == keep).all() and (inv == keep).all()
    # Every listed sub-tile keeps something, and lists ascend.
    for counts, entries in ((lists.counts, lists.tiles),
                            (lists.inv_counts, lists.inv_rows)):
        for bi, hi, blk in np.ndindex(*counts.shape):
            ids = entries[bi, hi, blk, :counts[bi, hi, blk]].numpy() >> 2
            assert (np.diff(ids) > 0).all()
    assert int(lists.words.shape[0]) < B * h * (s // 64 + 1) ** 2


def test_plain_versions_match_masked_oracle():
    """Kernels 9-11's plain versions against the fp32 keep-mask oracle and
    its autograd: out, lse, dQ (with delta = sum_j P dP), dK, dV, on GQA
    with a softcap and rows that keep nothing."""
    s, h, hk, softcap = 454, 4, 2, 5.0

    def mod(b, h_, q_idx, kv_idx):  # rows 200-263 keep nothing
        return (kv_idx <= q_idx) & ((q_idx < 200) | (q_idx >= 264))

    plan = compute_block_sparsity(mod, batch_size=B, num_heads=h, seqlen_q=s,
                                  seqlen_k=s, tile_m=TILE, tile_n=TILE,
                                  device="cpu")
    q, k, v, do = (torch.tensor(x).transpose(1, 2).contiguous()
                   for x in _inputs(4, s, h, hk))
    kw = dict(mask_mod=mod, softcap=softcap)
    out, lse = bs.flash_attention_blocksparse_fwd_ref(q, k, v, plan, **kw)
    dq, delta = bs._blocksparse_dq_ref(q, k, v, do, lse, plan, **kw)
    dk, dv = bs._blocksparse_dkv_ref(q, k, v, do, lse, delta, plan, **kw)
    keep = torch.tensor(_brute_keep(plan, B, h, s, s, mod, ()))
    leaves = [x.transpose(1, 2).clone().requires_grad_() for x in (q, k, v)]
    ref_out, ref_lse = masked_attention_ref(*leaves, keep, softcap=softcap)
    ref_grads = torch.autograd.grad(ref_out, leaves, do.transpose(1, 2))
    assert torch.isneginf(lse[:, :, 200:264]).all()
    assert (out[:, :, 200:264] == 0).all()
    _close(out.transpose(1, 2).numpy(), ref_out.detach().numpy())
    _close(lse.numpy(), ref_lse.detach().numpy())
    for got, want in zip((dq, dk, dv), ref_grads):
        _close(got.transpose(1, 2).numpy(), want.numpy())
    p = torch.softmax(torch.where(keep, torch.tanh(
        torch.einsum("bhtd,bhsd->bhts", q, k.repeat_interleave(h // hk, 1))
        * D ** -0.5 / softcap) * softcap, float("-inf")), -1).nan_to_num()
    dp = torch.einsum("bhtd,bhsd->bhts", do, v.repeat_interleave(h // hk, 1))
    _close(delta.numpy(), (p * dp).sum(-1).numpy())
