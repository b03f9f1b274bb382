"""The port's general decode (kernel 5's plain version) and
`flash_attn_with_kvcache` against the JAX package.

The same numpy-seeded fp32 inputs go through flash_attn_tpu (its
`_decode_kernel` in interpret mode on the CPU) and flash_attn_tpu_torch (the
plain PyTorch version, which is what the wrapper runs for CPU tensors). The
CUDA kernel itself is held against that plain version on the card by
chip_smoke.py. Each JAX result is built once, in module-scoped fixtures."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.flash_attn_interface import (
    flash_attn_combine as jax_flash_attn_combine,
)
from flash_attn_tpu.flash_attn_interface import (
    flash_attn_with_kvcache as jax_flash_attn_with_kvcache,
)
from flash_attn_tpu.kernels.flash_decode import (
    combine_partials as jax_combine_partials,
)
from flash_attn_tpu.kernels.flash_decode import (
    flash_attention_decode as jax_decode,
)
from flash_attn_tpu_torch.flash_attn_interface import (
    flash_attn_combine,
    flash_attn_with_kvcache,
)
from flash_attn_tpu_torch.kernels.flash_decode import (
    combine_partials,
    flash_attention_decode,
)
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage_ref,
)
from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding
from flash_attn_tpu_torch.utils.testing import attention_ref

B, H, HK, D, SMAX = 2, 4, 2, 64, 96
# Both sides compute in fp32; they differ in summation order and in the exp
# base (the JAX kernel's online softmax runs in base 2).
ATOL = 1e-4

# name: (sq, seqlens, extra arguments). Array extras are built by _inputs.
CASES = {
    "contig-gqa-sq1": (1, (37, 90), {}),
    "contig-gqa-sq4-window-softcap": (4, (40, 77),
                                      dict(window_left=9, softcap=5.0)),
    "cache-batch-idx": (1, (30, 85), dict(cache_batch_idx=True)),
    "leftpad": (2, (40, 77), dict(cache_leftpad=(5, 17), window_left=20)),
    "alibi-batched": (3, (50, 64), dict(alibi_slopes=True)),
    "sink": (1, (45, 70), dict(sink=True, window_left=20)),
    "chunk-leftpad": (4, (50, 90), dict(cache_leftpad=(3, 10),
                                        attention_chunk=16)),
    "sink-tokens-window": (2, (60, 45), dict(sink_token_length=4,
                                             window_left=10)),
    "noncausal": (4, (33, 80), dict(causal=False)),
    "paged-sink": (2, (40, 61), dict(paged=16, sink=True, window_left=30)),
}


def _inputs(name):
    sq, seqlens, extra = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    extra = dict(extra)
    rows = B + 1 if extra.get("cache_batch_idx") else B
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    kw = {}
    page = extra.pop("paged", 0)
    if page:
        max_pages = -(-SMAX // page)
        npages = B * max_pages + 1
        k, v = (rng.standard_normal((npages, HK, page, D)).astype(np.float32)
                for _ in range(2))
        kw["block_table"] = rng.permutation(npages - 1)[: B * max_pages].reshape(
            B, max_pages).astype(np.int32)
    else:
        k, v = (rng.standard_normal((rows, HK, SMAX, D)).astype(np.float32)
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


def _jax(q, k, v, lens, kw):
    """The JAX decode, jitted (a third of the eager call's cost in interpret
    mode): array arguments traced, the rest static."""
    arrays = {n: jnp.asarray(x) for n, x in kw.items()
              if isinstance(x, np.ndarray)}
    static = {n: x for n, x in kw.items() if n not in arrays}
    fn = jax.jit(functools.partial(jax_decode, **static))
    out, lse = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lens), **arrays)
    return np.asarray(out), np.asarray(lse)


def _port(q, k, v, lens, kw):
    t = torch.from_numpy
    kw = {n: t(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    out, lse = flash_attention_decode(t(q), t(k), t(v), t(lens), **kw)
    return out.numpy(), lse.numpy()


def _assert_matches(got, want):
    (out, lse), (out_j, lse_j) = got, want
    np.testing.assert_allclose(out, out_j, rtol=0, atol=ATOL)
    finite = np.isfinite(lse_j)
    np.testing.assert_array_equal(np.isfinite(lse), finite)
    np.testing.assert_allclose(lse[finite], lse_j[finite], rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def jax_results():
    return {name: _jax(*_inputs(name)) for name in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_jax(case, jax_results):
    _assert_matches(_port(*_inputs(case)), jax_results[case])


def test_leftpad_window_matches_oracle_not_reference_skip():
    """leftpad 50 and window 25 at length 250 of a 256-slot cache: the row
    sees columns 224-249. The JAX kernel starts its walk at block
    (250 - 1 - 25 + 50) // 256 = 1, past the last block holding keys, and
    returns lse -inf; the port sees the 26 keys, as the oracle does."""
    rng = np.random.default_rng(11)
    smax, seqlen, leftpad, window = 256, 250, 50, 25
    q = rng.standard_normal((1, 1, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, HK, smax, D)).astype(np.float32)
            for _ in range(2))
    lens, lp = np.array([seqlen], np.int32), np.array([leftpad], np.int32)
    kw = dict(cache_leftpad=lp, window_left=window)
    out, lse = _port(q, k, v, lens, kw)
    cols = torch.arange(smax)[None]
    ref_out, _ = attention_ref(
        torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), causal=True,
        window_size=(window, -1), key_leftpad=torch.from_numpy(lp),
        key_padding_mask=(cols < seqlen) & (cols >= leftpad))
    np.testing.assert_allclose(out, ref_out.numpy(), rtol=0, atol=ATOL)
    qs = torch.from_numpy(q)[0, 0].reshape(HK, H // HK, D) * D**-0.5
    s = torch.einsum("kgd,kcd->kgc", qs, torch.from_numpy(k)[0, :, 224:250])
    np.testing.assert_allclose(lse[0, :, 0],
                               torch.logsumexp(s, -1).reshape(H).numpy(),
                               rtol=0, atol=ATOL)
    _, lse_j = _jax(q, k, v, lens, kw)
    assert np.isneginf(lse_j).all()


def test_kvcache_append_rotary_matches_jax():
    """flash_attn_with_kvcache on a contiguous bshd cache: rotary on q and
    the new k, the new k/v written at each row's length into the rows
    cache_batch_idx picks, with leftpad; out, lse and the caches."""
    rng = np.random.default_rng(5)
    snew, rows = 3, 3
    q = rng.standard_normal((B, snew, H, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, snew, HK, D)).astype(np.float32)
              for _ in range(2))
    kc, vc = (rng.standard_normal((rows, SMAX, HK, D)).astype(np.float32)
              for _ in range(2))
    cos, sin = RotaryEmbedding(D, base=1000.0).cos_sin(SMAX)
    lens = np.array([20, 51], np.int32)
    bidx = np.array([2, 0], np.int32)
    lp = np.array([4, 0], np.int32)
    kw = dict(causal=True, window_size=(30, -1), return_softmax_lse=True)
    out_j, lse_j, (kc_j, vc_j) = jax.jit(functools.partial(
        jax_flash_attn_with_kvcache, **kw))(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
        jnp.asarray(lens), jnp.asarray(bidx), jnp.asarray(lp))
    t = torch.from_numpy
    k_cache, v_cache = t(kc.copy()), t(vc.copy())
    out, lse, (k_ret, v_ret) = flash_attn_with_kvcache(
        t(q), k_cache, v_cache, t(kn), t(vn), cos, sin, t(lens), t(bidx),
        t(lp), **kw)
    assert k_ret is k_cache and v_ret is v_cache
    _assert_matches((out.numpy(), lse.numpy()),
                    (np.asarray(out_j), np.asarray(lse_j)))
    np.testing.assert_allclose(k_cache.numpy(), np.asarray(kc_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(v_cache.numpy(), np.asarray(vc_j))


def test_combine_matches_jax():
    """combine_partials and flash_attn_combine, with empty partials (lse
    -inf) and a position whose every partial is empty."""
    rng = np.random.default_rng(3)
    o = rng.standard_normal((3, 2, 5, H, 8)).astype(np.float32)
    lse = rng.standard_normal((3, 2, 5, H)).astype(np.float32)
    lse[1, 0, 2] = -np.inf
    lse[:, 1, 4, 0] = -np.inf
    want_o, want_lse = jax_combine_partials(jnp.asarray(o), jnp.asarray(lse))
    got_o, got_lse = combine_partials(torch.from_numpy(o), torch.from_numpy(lse))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-6,
                               atol=1e-6)
    want_lse = np.asarray(want_lse)
    np.testing.assert_array_equal(np.isneginf(got_lse.numpy()),
                                  np.isneginf(want_lse))
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-6, atol=1e-6)
    assert np.isneginf(got_lse.numpy()[1, 4, 0]) and not got_o[1, 4, 0].any()
    want = jax_flash_attn_combine(jnp.asarray(o), jnp.asarray(lse),
                                  out_dtype=jnp.bfloat16, return_lse=False)
    got = flash_attn_combine(torch.from_numpy(o), torch.from_numpy(lse),
                             out_dtype=torch.bfloat16, return_lse=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_routes_and_unported_arguments():
    """Paged causal calls without extras go to kernel 4 (its plain version,
    bit for bit); a fused pool with an extra, and a batch index on a paged
    cache, are refused; qv with a window, 1-byte queries and head dims
    other than 64/128 raise NotImplementedError naming the ROADMAP item
    (qv alone answers). Descales and 1-byte
    caches are taken (kernel 5 here): unit descales change no bit, and an
    int8 cache gives the answer of its values in q's dtype."""
    q, k, v, lens, kw = _inputs("paged-sink")
    t = torch.from_numpy
    table = t(kw["block_table"])
    got = flash_attention_decode(t(q), t(k), t(v), t(lens), block_table=table,
                                 window_left=7)
    want = flash_attention_decode_multipage_ref(t(q), t(k), t(v), t(lens),
                                                table, window_left=7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fused = torch.zeros(k.shape[:3] + (256,))
    with pytest.raises(ValueError, match="fused"):
        flash_attention_decode(t(q), fused, None, t(lens), block_table=table,
                               fused_kv_dim=D, sink=torch.zeros(H))
    with pytest.raises(ValueError, match="cache_batch_idx"):
        flash_attention_decode(t(q), t(k), t(v), t(lens), block_table=table,
                               causal=False, cache_batch_idx=t(lens))
    qc, kc, vc, lens_c, _ = _inputs("contig-gqa-sq1")
    args = (t(qc), t(kc), t(vc), t(lens_c))
    # qv (MLA) is ported: a zero qv adds nothing to the scores; qv with a
    # window still raises.
    for g, w in zip(flash_attention_decode(*args, qv=torch.zeros_like(t(qc)),
                                           softmax_scale=0.1),
                    flash_attention_decode(*args, softmax_scale=0.1)):
        assert torch.equal(g, w)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention_decode(*args, qv=t(qc), window_left=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention_decode(args[0].to(torch.float8_e4m3fn), *args[1:])
    plain = flash_attention_decode(*args)
    for g, w in zip(flash_attention_decode(*args, k_scale=torch.ones(HK),
                                           v_scale=torch.ones(B, HK)), plain):
        assert torch.equal(g, w)
    k8, v8 = (x.mul(20).round().clamp(-127, 127) for x in args[1:3])
    for g, w in zip(flash_attention_decode(args[0], k8.to(torch.int8),
                                           v8.to(torch.int8), args[3]),
                    flash_attention_decode(args[0], k8, v8, args[3])):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError, match="head dim"):
        flash_attention_decode(args[0][..., :32], args[1][..., :32],
                               args[2][..., :32], args[3])
