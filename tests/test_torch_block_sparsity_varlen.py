"""The port's varlen block-sparse route and its refusals, against the JAX
package's.

The same numpy-seeded packed q, k, v go through flash_attn_tpu's
`flash_attn_varlen_func(block_sparse_tensors=...)` (Pallas in interpret
mode on the CPU) and the port's, forward and `torch.autograd.grad`, with
`compute_block_sparsity_varlen` plans compared entry by entry. Then the
calls both packages refuse (feature combinations with a plan), the one the
port refuses on its own (`score_mod` with a plan, which no CUDA kernel can
call), and the held difference of ROADMAP §3: a plan built for a shorter
seqlen_k, which the JAX package accepts and the port refuses.

Both sides run in fp32, so RTOL is far inside the numerics contract (2 x
the bf16-eager error against an fp32 oracle).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu import compute_block_sparsity as jax_plan
from flash_attn_tpu import compute_block_sparsity_varlen as jax_plan_varlen
from flash_attn_tpu import flash_attn_func as jax_attn
from flash_attn_tpu import flash_attn_varlen_func as jax_varlen
from flash_attn_tpu_torch import (
    compute_block_sparsity,
    compute_block_sparsity_varlen,
    flash_attn_func,
    flash_attn_varlen_func,
)

RTOL = 1e-4
H, D, TILE = 4, 64, 128
LENS = [200, 380, 120]
USED_Q = [150, 380, 96]  # seqused_q trims rows of sequences 0 and 2
CU = np.concatenate([[0], np.cumsum(LENS)]).astype(np.int32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    finite = np.isfinite(want)
    assert (np.isfinite(got) == finite).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL,
                               atol=RTOL * np.abs(want[finite]).max())


def window_mod(b, h, q_idx, kv_idx):
    return (kv_idx <= q_idx) & (q_idx - kv_idx < 100)


def causal(b, h, q_idx, kv_idx):
    return kv_idx <= q_idx


def _packed(seed):
    rng = np.random.default_rng(seed)
    total = int(CU[-1])
    return tuple(rng.standard_normal((total, H, D)).astype(np.float32)
                 for _ in range(4))


@functools.lru_cache(maxsize=None)
def _jax_varlen():
    """(plan, out, lse, (dq, dk, dv)) of the JAX package."""
    plan, _, _ = jax_plan_varlen(window_mod, cu_seqlens_q=jnp.asarray(CU),
                                 cu_seqlens_k=jnp.asarray(CU), num_heads=H,
                                 tile_m=TILE, tile_n=TILE)
    q, k, v, do = _packed(5)
    call = functools.partial(
        jax_varlen, cu_seqlens_q=jnp.asarray(CU), cu_seqlens_k=jnp.asarray(CU),
        mask_mod=window_mod, block_sparse_tensors=plan,
        seqused_q=jnp.asarray(USED_Q, jnp.int32))
    out, lse, _ = call(q, k, v, return_attn_probs=True)
    loss = lambda q_, k_, v_: jnp.sum(call(q_, k_, v_) * do)  # noqa: E731
    grads = jax.grad(loss, (0, 1, 2))(q, k, v)
    return plan, np.asarray(out), np.asarray(lse), tuple(
        np.asarray(g) for g in grads)


def _port_plan():
    cu = torch.tensor(CU)
    return compute_block_sparsity_varlen(
        window_mod, cu_seqlens_q=cu, cu_seqlens_k=cu, num_heads=H,
        tile_m=TILE, tile_n=TILE, device="cpu")


def test_varlen_planner_matches_jax():
    """compute_block_sparsity_varlen gives the JAX lists entry by entry,
    and its wrapped mod and length tables as the JAX planner returns them."""
    plan, wrapped, aux = _port_plan()
    ref = _jax_varlen()[0]
    for field in ("mask_block_cnt", "mask_block_idx", "full_block_cnt",
                  "full_block_idx"):
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    assert (plan.seqlen_q, plan.seqlen_k) == (max(LENS), max(LENS))
    assert [a.tolist() for a in aux] == [LENS, LENS]
    # Tiles past a sequence's end are skipped: fewer live tiles than the grid.
    live = int(plan.mask_block_cnt.sum() + plan.full_block_cnt.sum())
    assert live < 0.5 * len(LENS) * H * plan.num_m * plan.num_n
    assert callable(wrapped)


def test_varlen_matches_jax_forward_and_backward():
    """Packed forward and backward with seqused_q: out, lse (h, total_q) and
    dq/dk/dv equal the JAX route's; rows trimmed by seqused_q read out 0
    and lse -inf."""
    plan, _, _ = _port_plan()
    _, ref_out, ref_lse, ref_grads = _jax_varlen()
    cu = torch.tensor(CU)
    q, k, v, do = (torch.tensor(x) for x in _packed(5))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    out, lse, _ = flash_attn_varlen_func(
        q, k, v, cu, cu, mask_mod=window_mod, block_sparse_tensors=plan,
        seqused_q=torch.tensor(USED_Q, dtype=torch.int32),
        return_attn_probs=True)
    _close(out.detach().numpy(), ref_out)
    _close(lse.numpy(), ref_lse)
    for i, (lo, hi) in enumerate(zip(CU[:-1], CU[1:])):
        trimmed = slice(lo + USED_Q[i], hi)
        assert torch.isneginf(lse[:, trimmed]).all()
        assert (out[trimmed] == 0).all()
        assert torch.isfinite(lse[:, lo:lo + USED_Q[i]]).all()
    grads = torch.autograd.grad(out, (q, k, v), do)
    for got, want in zip(grads, ref_grads):
        _close(got.numpy(), want)


def _dense_plan():
    return compute_block_sparsity(causal, batch_size=1, num_heads=H,
                                  seqlen_q=256, seqlen_k=256, tile_m=TILE,
                                  tile_n=TILE, device="cpu")


@pytest.mark.parametrize("extra", [
    dict(causal=True), dict(window_size=(64, -1)), dict(dropout_p=0.1),
    dict(alibi_slopes=np.ones(H, np.float32)), dict(attention_chunk=64)])
def test_feature_combinations_raise_value_error(extra):
    """A plan composes with mask_mod and softcap only: both packages raise
    ValueError on causal, a window, dropout, ALiBi or a chunk with one, on
    flash_attn_func; and on causal or layout "hsd" on the varlen route."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 256, H, D)).astype(np.float32)
               for _ in range(3))
    jax_bst = jax_plan(causal, batch_size=1, num_heads=H, seqlen_q=256,
                       seqlen_k=256, tile_m=TILE, tile_n=TILE)
    jax_extra = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                 for n, x in extra.items()}
    with pytest.raises(ValueError, match="block_sparse_tensors"):
        jax_attn(q, k, v, mask_mod=causal, block_sparse_tensors=jax_bst,
                 **jax_extra)
    torch_extra = {n: torch.tensor(x) if isinstance(x, np.ndarray) else x
                   for n, x in extra.items()}
    with pytest.raises(ValueError, match="block_sparse_tensors"):
        flash_attn_func(*(torch.tensor(x) for x in (q, k, v)), mask_mod=causal,
                        block_sparse_tensors=_dense_plan(), **torch_extra)
    plan, _, _ = _port_plan()
    cu = torch.tensor(CU)
    packed = [torch.tensor(x) for x in _packed(7)[:3]]
    with pytest.raises(ValueError, match="block_sparse_tensors"):
        flash_attn_varlen_func(*packed, cu, cu, causal=True,
                               mask_mod=window_mod, block_sparse_tensors=plan)
    with pytest.raises(ValueError, match="hsd"):
        flash_attn_varlen_func(*(x.transpose(0, 1) for x in packed), cu, cu,
                               mask_mod=window_mod, block_sparse_tensors=plan,
                               layout="hsd")


def test_score_mod_with_plan_raises_not_implemented():
    """No CUDA kernel can call a Python score_mod: with a plan it raises
    NotImplementedError naming its ROADMAP entry, on every device; and the
    planners run on the card unless the caller asks for the CPU."""
    q = torch.zeros(1, 256, H, D)
    with pytest.raises(NotImplementedError, match="score_mod catalog"):
        flash_attn_func(q, q, q, mask_mod=causal,
                        score_mod=lambda s, b, h, qi, ki: s,
                        block_sparse_tensors=_dense_plan())
    plan, _, _ = _port_plan()
    cu = torch.tensor(CU)
    packed = torch.zeros(int(CU[-1]), H, D)
    with pytest.raises(NotImplementedError, match="score_mod catalog"):
        flash_attn_varlen_func(packed, packed, packed, cu, cu,
                               mask_mod=window_mod,
                               score_mod=lambda s, b, h, qi, ki: s,
                               block_sparse_tensors=plan)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compute_block_sparsity(causal, batch_size=1, num_heads=H,
                                   seqlen_q=256, seqlen_k=256)


def test_plan_for_shorter_seqlen_k_refused():
    """Held difference (ROADMAP §3): a plan built for seqlen_k 512 runs in
    the JAX package on a call with seqlen_k 640 (its indices fit the larger
    grid), and the port, whose planner records the grid, refuses it; a
    plan with no recorded grid gets the JAX checks in the port."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 512, H, D)).astype(np.float32)
    kv = rng.standard_normal((1, 640, H, D)).astype(np.float32)
    kw = dict(batch_size=1, num_heads=H, seqlen_q=512, seqlen_k=512,
              tile_m=TILE, tile_n=TILE)
    out = jax_attn(q, kv, kv, mask_mod=causal,
                   block_sparse_tensors=jax_plan(causal, **kw))
    assert np.isfinite(np.asarray(out)).all()
    plan = compute_block_sparsity(causal, device="cpu", **kw)
    tq, tkv = torch.tensor(q), torch.tensor(kv)
    with pytest.raises(ValueError, match="different grid"):
        flash_attn_func(tq, tkv, tkv, mask_mod=causal, block_sparse_tensors=plan)
    # The JAX five-field form of the same plan: the JAX checks only.
    out = flash_attn_func(tq, tkv, tkv, mask_mod=causal,
                          block_sparse_tensors=plan[:5])
    assert torch.isfinite(out).all()
    short = torch.tensor(q[:, :384])
    with pytest.raises(ValueError, match="different seqlen_q"):
        flash_attn_func(short, tkv, tkv, mask_mod=causal,
                        block_sparse_tensors=plan[:5])
