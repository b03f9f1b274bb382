"""MLA serving in the port against the JAX package: the `MLA` module (no
cache, prefill + decode on contiguous latent caches, fused and split paged
pools), the plain versions of kernels 1, 4 and 5 with `qv` against the JAX
kernels (interpret mode), the default scale with `qv`, `LLMEngine` and
`generate` on an MLA model against the JAX model's `generate` on the same
weights, and what still raises. Inputs are numpy draws from fixed seeds; the
small MLA config is the JAX tests' (tests/test_gpt.py:210-217)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.flash_attn_interface import flash_attn_func as jax_fa_func
from flash_attn_tpu.kernels.flash_decode import (
    flash_attention_decode as jax_decode,
)
from flash_attn_tpu.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage as jax_multipage,
)
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.modules.mha import InferenceParams as JaxInferenceParams
from flash_attn_tpu.modules.mla import MLA as JaxMLA
from flash_attn_tpu_torch.flash_attn_interface import flash_attn_func
from flash_attn_tpu_torch.kernels import mla_attn
from flash_attn_tpu_torch.kernels.flash_decode import (
    flash_attention_decode,
    flash_attention_decode_ref,
)
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage,
    flash_attention_decode_multipage_ref,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.modules.mha import InferenceParams
from flash_attn_tpu_torch.modules.mla import MLA
from flash_attn_tpu_torch.runtime.engine import EngineConfig, LLMEngine
from flash_attn_tpu_torch.utils.convert import state_dict_from_flax

# The JAX tests' small MLA model (tests/test_gpt.py:210-217).
FIELDS = dict(
    vocab_size=61, n_positions=0, n_embd=64, n_layer=2, n_head=4,
    attn_type="mla", kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, rms_norm=True,
    activation_function="swiglu", qkv_proj_bias=False, out_proj_bias=False,
    mlp_fc1_bias=False, mlp_fc2_bias=False, tie_word_embeddings=True,
)
MLA_DIMS = dict(embed_dim=64, num_heads=4, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
DR, DC = 8, 32  # the kernels' d (rope) and dv (latent) at these widths
# The module's scale, (dn + dr)^-0.5. The kernel tests below take it and
# the module tests' shapes, so that each JAX kernel compiles once.
SCALE = (16 + DR) ** -0.5
ENGINE = dict(max_batch_size=4, page_size=16, num_pages=64,
              max_pages_per_seq=8, prefill_chunk=16, max_seqlen=128)
MAX_NEW = 4
# fp32 on both sides, the same arithmetic in other orders.
TOL = dict(atol=2e-5, rtol=2e-5)


def _draw(tree, seed):
    """numpy normal(0, 1/sqrt(fan_in)) draws shaped like a params tree."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        fan_in = int(np.prod(x.shape[:-1])) if len(x.shape) > 1 else 1
        return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def mla_pair():
    """(JAX MLA, its params, the port's MLA with the same weights)."""
    jmla = JaxMLA(**MLA_DIMS, dtype=jnp.float32, layer_idx=0)
    shapes = jax.eval_shape(jmla.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 64), jnp.float32))
    params = _draw(shapes, 1)
    mla = MLA(**MLA_DIMS, layer_idx=0, device="cpu", dtype=torch.float32)
    p = params["params"]
    sd = {f"{n}.weight": torch.from_numpy(np.asarray(p[n]["kernel"]).T.copy())
          for n in ("W_q", "W_dkv", "out_proj")}
    sd.update(W_uk=torch.from_numpy(np.asarray(p["W_uk"])),
              W_uv=torch.from_numpy(np.asarray(p["W_uv"])))
    mla.load_state_dict(sd)
    return jmla, params, mla


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(
        np.float32)


def _caches(route, b, smax, seed, page=4):
    """(JAX cache entry, port cache entry, JAX table, port table) of one
    layer, filled with the same random rope keys and latents: contiguous
    (rope, latent), or paged pools (fused or split) under a permuted block
    table."""
    rng = np.random.default_rng(seed)
    if route == "contiguous":
        rows = (b, 1, smax)
        table = None
    else:
        max_pages = smax // page
        rows = (b * max_pages + 1, 1, page)
        table = rng.permutation(rows[0] - 1)[:b * max_pages].reshape(
            b, max_pages).astype(np.int32)
    rope = rng.standard_normal(rows + (DR,)).astype(np.float32)
    lat = rng.standard_normal(rows + (DC,)).astype(np.float32)
    if route == "fused":
        pool = np.zeros(rows + (256,), np.float32)
        pool[..., :DR], pool[..., 128:128 + DC] = rope, lat
        jc, pc = jnp.asarray(pool), torch.from_numpy(pool)
    else:
        jc = (jnp.asarray(rope), jnp.asarray(lat))
        pc = (torch.from_numpy(rope), torch.from_numpy(lat))
    if table is None:
        return jc, pc, None, None
    return jc, pc, jnp.asarray(table), torch.from_numpy(table)


def _jax_cached_apply(jmla, smax, params, x, entry, offsets, table):
    """The JAX MLA's cached forward: (output, the written cache entry)."""
    ip = JaxInferenceParams(max_seqlen=smax, max_batch_size=x.shape[0],
                            seqlen_offset=offsets,
                            key_value_memory_dict={0: entry},
                            block_table=table)
    out = jmla.apply(params, x, inference_params=ip)
    return out, ip.key_value_memory_dict[0]


# Per route: (new tokens per call, the rows' cache lengths before it).
ROUTE_CALLS = {"contiguous": (1, (7, 12)), "fused": (3, (0, 9)),
               "split": (3, (5, 2))}


@pytest.mark.parametrize("route", ["no-cache", "contiguous", "fused", "split"])
def test_mla_module_matches_jax(mla_pair, route):
    """The module's output against the JAX MLA's, fp32: the whole sequence
    without a cache; a decode step on contiguous latent caches; a 3-token
    prefill chunk into fused or split page pools; over caches filled with
    the same random rows, at per-row offsets. The port writes the cache in
    place, and it must then hold what the JAX module returns."""
    jmla, params, mla = mla_pair
    b = 2
    if route == "no-cache":
        x = _x(b, 7, 11)
        want = jax.jit(jmla.apply)(params, jnp.asarray(x))
        got = mla(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        return
    smax = 9 + MAX_NEW if route == "contiguous" else 16
    s, offsets = ROUTE_CALLS[route]
    jc, pc, jt, pt = _caches(route, b, smax, seed=12)
    pip = InferenceParams(
        max_seqlen=smax, max_batch_size=b, key_value_memory_dict={0: pc},
        seqlen_offset=torch.tensor(offsets, dtype=torch.int32),
        block_table=pt)
    x = _x(b, s, 20)
    want, cache = jax.jit(_jax_cached_apply, static_argnums=(0, 1))(
        jmla, smax, params, jnp.asarray(x), jc,
        jnp.asarray(offsets, jnp.int32), jt)
    with torch.no_grad():
        got = mla(torch.from_numpy(x), inference_params=pip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    written = jax.tree.leaves(cache)
    for j, p in zip(written, jax.tree.leaves(pc)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


def _pool_inputs(fused, b=2, sq=3, h=4, page=4, max_pages=4, seed=30):
    rng = np.random.default_rng(seed)
    npages = b * max_pages + 1
    q = rng.standard_normal((b, sq, h, DR)).astype(np.float32)
    qv = rng.standard_normal((b, sq, h, DC)).astype(np.float32)
    rope = rng.standard_normal((npages, 1, page, DR)).astype(np.float32)
    lat = rng.standard_normal((npages, 1, page, DC)).astype(np.float32)
    table = rng.permutation(npages)[:b * max_pages].reshape(
        b, max_pages).astype(np.int32)
    lens = np.array([12, 9], np.int32)
    if fused:
        pool = np.zeros((npages, 1, page, 256), np.float32)
        pool[..., :DR], pool[..., 128:128 + DC] = rope, lat
        pools = (pool, None)
    else:
        pools = (rope, lat)
    return q, qv, pools, lens, table


def test_multipage_qv_matches_jax_kernel():
    """Kernel 4's plain version with qv against the JAX multipage kernel
    in interpret mode on the fused layout (rope at 0, latent at 128): a
    3-token chunk over a permuted table; split pools of unequal widths
    holding the same rows give the same bits."""
    q, qv, (k, _), lens, table = _pool_inputs(True)
    kw = dict(fused_kv_dim=DR, fused_kv_dim_v=DC, softmax_scale=SCALE)
    jo, jl = jax_multipage(jnp.asarray(q), jnp.asarray(k), None,
                           jnp.asarray(lens), jnp.asarray(table),
                           qv=jnp.asarray(qv), **kw)
    t = torch.from_numpy
    po, pl = flash_attention_decode_multipage(
        t(q), t(k), None, t(lens), t(table), qv=t(qv), **kw)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    so, sl = flash_attention_decode_multipage(
        t(q), t(k[..., :DR]).contiguous(), t(k[..., 128:128 + DC]).contiguous(),
        t(lens), t(table), qv=t(qv), softmax_scale=SCALE)
    assert torch.equal(so, po) and torch.equal(sl, pl)


def test_decode_qv_matches_jax_kernel():
    """Kernel 5's plain version with qv on contiguous (b, 1, smax, d) and
    (b, 1, smax, dv) latent caches against the JAX decode kernel in
    interpret mode: a decode step, causal."""
    rng = np.random.default_rng(40)
    b, sq, h, smax = 2, 1, 4, 9 + MAX_NEW
    q = rng.standard_normal((b, sq, h, DR)).astype(np.float32)
    qv = rng.standard_normal((b, sq, h, DC)).astype(np.float32)
    kc = rng.standard_normal((b, 1, smax, DR)).astype(np.float32)
    vc = rng.standard_normal((b, 1, smax, DC)).astype(np.float32)
    lens = np.array([13, 6], np.int32)
    jo, jl = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(lens), qv=jnp.asarray(qv),
                        softmax_scale=SCALE)
    t = torch.from_numpy
    po, pl = flash_attention_decode(t(q), t(kc), t(vc), t(lens), qv=t(qv),
                                    softmax_scale=SCALE)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


def test_fwd_qv_matches_jax():
    """Kernel 1's plain qv forward through flash_attn_func(qv=) against
    the JAX flash_attn_func(qv=): causal, one KV head under four query
    heads, sq < sk (bottom-right aligned), the default scale; the LSE
    too."""
    rng = np.random.default_rng(50)
    b, sq, sk, h = 2, 6, 9, 4
    q = rng.standard_normal((b, sq, h, DR)).astype(np.float32)
    qv = rng.standard_normal((b, sq, h, DC)).astype(np.float32)
    k = rng.standard_normal((b, sk, 1, DR)).astype(np.float32)
    v = rng.standard_normal((b, sk, 1, DC)).astype(np.float32)
    jo, jl, _ = jax_fa_func(*(jnp.asarray(x) for x in (q, k, v)),
                            qv=jnp.asarray(qv), causal=True,
                            return_attn_probs=True)
    t = torch.from_numpy
    po, pl, _ = flash_attn_func(t(q), t(k), t(v), qv=t(qv), causal=True,
                                return_attn_probs=True)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


def test_qv_default_scale():
    """With qv and no softmax_scale, kernels 1, 4 and 5's plain versions
    take (d + dv)^-0.5, as the JAX kernels do; without qv d^-0.5."""
    q, qv, (k, v), lens, table = _pool_inputs(False, seed=60)
    t = torch.from_numpy
    q, qv, k, v, lens, table = t(q), t(qv), t(k), t(v), t(lens), t(table)
    scale = (DR + DC) ** -0.5
    for fn, args in (
            (flash_attention_decode_multipage_ref, (q, k, v, lens, table)),
            (flash_attention_decode_ref, (q, k, v, lens))):
        kw = dict(block_table=table) if fn is flash_attention_decode_ref else {}
        a = fn(*args, qv=qv, **kw)
        b = fn(*args, qv=qv, softmax_scale=scale, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    qd, kd, vd = (torch.randn(1, 4, 5, DR), torch.randn(1, 1, 5, DR),
                  torch.randn(1, 1, 5, DC))
    qvd = torch.randn(1, 4, 5, DC)
    a = flash_attention_fwd_ref(qd, kd, vd, qv=qvd, causal=True)
    b = flash_attention_fwd_ref(qd, kd, vd, qv=qvd, causal=True,
                                softmax_scale=scale)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a = flash_attention_fwd_ref(qd, kd, vd, causal=True)
    b = flash_attention_fwd_ref(qd, kd, vd, causal=True,
                                softmax_scale=DR ** -0.5)
    assert torch.equal(a[0], b[0])



@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX MLA model's params and its greedy `generate` of two
    9-token prompts, 4 new tokens each."""
    model = JaxGPTLMHeadModel(JaxGPTConfig(**FIELDS, dtype=jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    params = _draw(shapes, 2)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 61, (2, 9)).astype(np.int32)
    seqs = model.generate(params, jnp.asarray(prompts), 9 + MAX_NEW)
    return params, prompts, np.asarray(seqs)[:, 9:].tolist()


def _port_model(params):
    config = GPTConfig(**FIELDS, dtype=torch.float32)
    model = GPTLMHeadModel(config, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, config))
    return model


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "split"])
def test_engine_matches_jax_generate(jax_tokens, fused):
    """LLMEngine on latent pools (fused by default, split under
    fused_kv_pages=False) gives the JAX model's greedy tokens, and so does
    the port's generate() over contiguous latent caches, eager and with
    cg=True (run eagerly on the CPU); speculative decoding with the
    target as its own draft too (fused)."""
    params, prompts, want = jax_tokens
    model = _port_model(params)
    engine = LLMEngine(model, EngineConfig(**ENGINE, fused_kv_pages=fused),
                       device="cpu")
    pools = engine.caches[0]
    assert torch.is_tensor(pools) == (fused is None)
    assert engine.generate(prompts.tolist(), MAX_NEW) == want
    if fused is None:
        spec = LLMEngine(model, EngineConfig(**ENGINE, speculative_k=3),
                         device="cpu", draft_model=model)
        assert spec.generate(prompts.tolist(), MAX_NEW) == want
        assert spec.spec_drafted == 3 * len(prompts) * spec.spec_rounds
        return
    ids = torch.from_numpy(prompts).long()
    for cg in (False, True):
        seqs = model.generate(ids, 9 + MAX_NEW, cg=cg)
        assert seqs[:, 9:].tolist() == want


def test_mla_raises_what_is_not_ported():
    """1-byte latent pools (ValueError, as both packages), qv (or a dv != d
    forward) with a window, and (d, dv) pairs the MLA kernels do not take
    (on the card) or a dv != d without qv (kernel 5) raise; the backward
    through qv, once among them, now gives the gradients of the plain
    expanded attention (tests/test_torch_mla_train.py holds it to the JAX
    kernels)."""
    model = GPTLMHeadModel(GPTConfig(**FIELDS, dtype=torch.float32),
                           device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        LLMEngine(model, EngineConfig(**ENGINE, kv_cache_dtype="int8"),
                  device="cpu")
    q = torch.randn(1, 1, 4, DR)
    pool = torch.zeros(3, 1, 4, 256, dtype=torch.int8)
    with pytest.raises(ValueError, match="1-byte"):
        flash_attention_decode_multipage(
            q, pool, None, torch.tensor([3], dtype=torch.int32),
            torch.tensor([[0]], dtype=torch.int32), qv=torch.randn(1, 1, 4, DC),
            fused_kv_dim=DR, fused_kv_dim_v=DC)
    qs = torch.randn(1, 5, 4, DR, requires_grad=True)
    ks, cs = torch.randn(1, 5, 1, DR), torch.randn(1, 5, 1, DC)
    qvs = torch.randn(1, 5, 4, DC, requires_grad=True)
    out = flash_attn_func(qs, ks, cs, qv=qvs, causal=True)
    grads = torch.autograd.grad(out.sum(), (qs, qvs))
    s = (torch.einsum("bqhd,bkd->bhqk", qs, ks[:, :, 0])
         + torch.einsum("bqhe,bke->bhqk", qvs, cs[:, :, 0])) * (DR + DC) ** -0.5
    s = s.masked_fill(torch.ones(5, 5, dtype=torch.bool).triu(1), float("-inf"))
    ref = torch.einsum("bhqk,bke->bqhe", s.softmax(-1), cs[:, :, 0])
    for got, want in zip(grads, torch.autograd.grad(ref.sum(), (qs, qvs))):
        torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(NotImplementedError, match="queue 2"):
        flash_attn_func(qs.detach(), torch.randn(1, 5, 1, DR),
                        torch.randn(1, 5, 1, DC), qv=torch.randn(1, 5, 4, DC),
                        causal=True, window_size=(2, 0))
    with pytest.raises(NotImplementedError, match="queue 2"):
        flash_attention_fwd(torch.randn(1, 4, 5, DR), torch.randn(1, 1, 5, DR),
                            torch.randn(1, 1, 5, DC), causal=True,
                            window_size=(2, 0))
    mla_attn.check_pair(64, 512, "qv decode")
    for d, dv in ((128, 512), (64, 256), (DR, DC)):
        with pytest.raises(NotImplementedError, match="queue 2"):
            mla_attn.check_pair(d, dv, "qv decode")
    with pytest.raises(NotImplementedError, match="queue 2"):
        flash_attention_decode(torch.randn(1, 1, 4, 64),
                               torch.randn(1, 1, 8, 64),
                               torch.randn(1, 1, 8, 512),
                               torch.tensor([4], dtype=torch.int32))
