"""The port's paged decode and KV-pool append against the JAX package.

The same numpy-seeded inputs go through flash_attn_tpu (Pallas in interpret
mode on the CPU) and flash_attn_tpu_torch (its plain PyTorch version, which
is what the wrapper runs for CPU tensors). The CUDA kernel itself is held
against that plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage as jax_decode_multipage,
)
from flash_attn_tpu.runtime import kv_cache as jax_kv
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage,
)
from flash_attn_tpu_torch.runtime import kv_cache as torch_kv

B, H, HK, D = 2, 4, 2, 64
FUSED_WIDTH = 256  # K and V sections each padded to 128

# (fused, sq, window_left, softcap, permuted table, page, seqlens)
CASES = {
    "fused-decode": (True, 1, -1, 0.0, False, 8, (37, 21)),
    "split-decode-permuted-window": (False, 1, 9, 0.0, True, 16, (40, 17)),
    "fused-chunk-window-permuted": (True, 8, 5, 0.0, True, 8, (30, 12)),
    "split-chunk-softcap": (False, 8, -1, 30.0, False, 16, (44, 8)),
    "fused-softcap-window": (True, 1, 12, 5.0, True, 16, (29, 33)),
    "split-chunk-zero-length-row": (False, 8, -1, 0.0, True, 8, (19, 0)),
}


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


@pytest.mark.parametrize("case", list(CASES))
def test_paged_decode_matches_jax(case):
    fused, sq, window, softcap, permuted, page, seqlens = CASES[case]
    rng = np.random.default_rng(len(case))
    k, v, table = _pools(rng, fused, page, seqlens, permuted)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    lens = np.asarray(seqlens, np.int32)
    kw = dict(fused_kv_dim=D if fused else 0, window_left=window,
              softcap=softcap)

    out_j, lse_j = jax_decode_multipage(
        jnp.asarray(q), jnp.asarray(k), None if v is None else jnp.asarray(v),
        jnp.asarray(lens), jnp.asarray(table), **kw,
    )
    out_t, lse_t = flash_attention_decode_multipage(
        torch.from_numpy(q), torch.from_numpy(k),
        None if v is None else torch.from_numpy(v),
        torch.from_numpy(lens), torch.from_numpy(table), **kw,
    )
    # Both compute in fp32; they differ only in summation order and exp
    # base (the JAX kernel's online softmax runs in base 2).
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    lse_j = np.asarray(lse_j)
    np.testing.assert_array_equal(np.isfinite(lse_t.numpy()), np.isfinite(lse_j))
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=1e-5, atol=1e-5)
    if 0 in seqlens:
        row = seqlens.index(0)
        assert not out_t[row].any() and torch.isinf(lse_t[row]).all()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_paged_append_matches_jax(fused):
    """Same pages written, bit for bit, on every page but the trash page:
    padded rows write duplicate indices there, and neither framework fixes
    the order of those writes."""
    rng = np.random.default_rng(7)
    page, npages, max_pages, snew = 8, 13, 4, 5
    trash = npages - 1
    # Row 2 is a padded batch row: its whole table is the trash page.
    table = np.full((3, max_pages), trash, np.int32)
    table[:2] = rng.permutation(trash)[: 2 * max_pages].reshape(2, max_pages)
    offsets = np.array([3, 14, 0], np.int32)
    k_new = rng.standard_normal((3, snew, HK, D)).astype(np.float32)
    v_new = rng.standard_normal((3, snew, HK, D)).astype(np.float32)
    t = torch.from_numpy
    if fused:
        pool = rng.standard_normal((npages, HK, page, FUSED_WIDTH)).astype(np.float32)
        want = np.asarray(jax_kv.update_fused_paged_kv_cache(
            jnp.asarray(pool), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(offsets), jnp.asarray(table)))
        got = torch_kv.update_fused_paged_kv_cache(
            t(pool.copy()), t(k_new), t(v_new), t(offsets), t(table)).numpy()
        pairs = [(got, want)]
    else:
        kp = rng.standard_normal((npages, HK, page, D)).astype(np.float32)
        vp = rng.standard_normal((npages, HK, page, D)).astype(np.float32)
        want = jax_kv.update_paged_kv_cache(
            jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_new),
            jnp.asarray(v_new), jnp.asarray(offsets), jnp.asarray(table))
        got = torch_kv.update_paged_kv_cache(
            t(kp.copy()), t(vp.copy()), t(k_new), t(v_new), t(offsets), t(table))
        pairs = [(g.numpy(), np.asarray(w)) for g, w in zip(got, want)]
    for got_pool, want_pool in pairs:
        np.testing.assert_array_equal(got_pool[:trash], want_pool[:trash])


def test_contiguous_append_matches_jax():
    """Contiguous (b, hk, smax, d) caches, rows picked by cache_batch_idx:
    bit for bit."""
    rng = np.random.default_rng(8)
    k_cache, v_cache = (rng.standard_normal((4, HK, 24, D)).astype(np.float32)
                        for _ in range(2))
    k_new, v_new = (rng.standard_normal((2, 5, HK, D)).astype(np.float32)
                    for _ in range(2))
    lens = np.array([3, 19], np.int32)
    rows = np.array([2, 0], np.int32)
    want = jax_kv.update_kv_cache(
        jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(lens),
        cache_batch_idx=jnp.asarray(rows))
    t = torch.from_numpy
    got = torch_kv.update_kv_cache(
        t(k_cache.copy()), t(v_cache.copy()), t(k_new), t(v_new), t(lens),
        cache_batch_idx=t(rows))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
