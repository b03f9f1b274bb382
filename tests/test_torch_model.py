"""The port's model stack against the JAX package's, at a tiny float32
configuration: JAX params carried across with `state_dict_from_flax`, the
same numpy-seeded tokens through chunked prefill and decode over a fused
paged pool, logits compared step by step."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.adapters import (
    llama_config_to_gpt_config as jax_llama_config,
)
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.modules.mha import InferenceParams as JaxInferenceParams
from flash_attn_tpu.modules.mlp import GatedMlp as JaxGatedMlp
from flash_attn_tpu.ops.rotary import apply_rotary_emb as jax_apply_rotary
from flash_attn_tpu.runtime.generation import sample_tokens as jax_sample_tokens
from flash_attn_tpu.runtime.kv_cache import (
    allocate_fused_paged_kv_cache as jax_alloc_fused,
)
from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding
from flash_attn_tpu_torch.models.adapters import llama_config_to_gpt_config
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.modules.mha import InferenceParams
from flash_attn_tpu_torch.modules.mlp import GatedMlp
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb
from flash_attn_tpu_torch.runtime.generation import sample_tokens
from flash_attn_tpu_torch.runtime.kv_cache import allocate_fused_paged_kv_cache
from flash_attn_tpu_torch.utils.convert import state_dict_from_flax
from flash_attn_tpu_torch.utils.testing import gpt_forward_ref

FIELDS = dict(
    vocab_size=97, n_positions=0, n_embd=64, n_layer=2, n_head=4, n_head_kv=2,
    rotary_emb_fraction=1.0, rms_norm=True, activation_function="swiglu",
    qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
    mlp_fc2_bias=False, tie_word_embeddings=False, window_size=(11, -1),
)
PAGE, MAX_PAGES, NPAGES, MAX_SEQLEN = 8, 4, 9, 64
# Float32 on both sides: the two differ only in summation order.
TOL = dict(rtol=1e-4, atol=1e-4)


def _draw_params(model, seed):
    """Params of the JAX model's tree drawn with numpy: kernels and
    embedding rows at 1/sqrt(fan-in), norm scales 1 + 0.1 N(0, 1). The
    tree comes from `jax.eval_shape`, which runs no kernel (`model.init`
    runs the Pallas kernels in interpret mode, seconds of compile)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        kind = path[-1].key
        if kind == "scale":
            return 1.0 + 0.1 * x
        fan_in = leaf.shape[-1] if kind == "embedding" else leaf.shape[0]
        return x / np.float32(np.sqrt(fan_in))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models():
    jax_model = JaxGPTLMHeadModel(JaxGPTConfig(**FIELDS, dtype=jnp.float32))
    params = _draw_params(jax_model, 0)
    config = GPTConfig(**FIELDS, dtype=torch.float32)
    model = GPTLMHeadModel(config, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, config))
    return jax_model, params, model


def _steps(rng):
    """(tokens (2, s), offsets (2,)) of two prefill chunks, then three
    decode steps. Row 1's first chunk ends in 3 padding tokens that its
    second chunk (offset 5) overwrites."""
    chunk = lambda: rng.integers(0, 97, (2, 8)).astype(np.int32)  # noqa: E731
    steps = [(chunk(), np.array([0, 0], np.int32)),
             (chunk(), np.array([8, 5], np.int32))]
    for i in range(3):
        tok = rng.integers(0, 97, (2, 1)).astype(np.int32)
        steps.append((tok, np.array([16 + i, 13 + i], np.int32)))
    return steps


def test_cached_forward_matches_jax_and_plain_forward(models):
    jax_model, params, model = models
    rng = np.random.default_rng(0)
    steps = _steps(rng)
    table = rng.permutation(NPAGES - 1)[: 2 * MAX_PAGES].reshape(2, MAX_PAGES)
    table = table.astype(np.int32)
    jax_caches = {i: jax_alloc_fused(NPAGES, PAGE, 2, 16, dtype=jnp.float32)
                  for i in range(2)}
    caches = {i: allocate_fused_paged_kv_cache(NPAGES, PAGE, 2, 16,
                                               dtype=torch.float32,
                                               device="cpu")
              for i in range(2)}

    @jax.jit
    def jax_step(caches, tokens, offsets):
        jip = JaxInferenceParams(
            max_seqlen=MAX_SEQLEN, max_batch_size=2, seqlen_offset=offsets,
            key_value_memory_dict=dict(caches), block_table=jnp.asarray(table))
        out = jax_model.apply(params, tokens, inference_params=jip)
        return out, jip.key_value_memory_dict

    logits = []
    for tokens, offsets in steps:
        want, jax_caches = jax_step(jax_caches, jnp.asarray(tokens),
                                    jnp.asarray(offsets))
        want = np.asarray(want)
        ip = InferenceParams(
            max_seqlen=MAX_SEQLEN, max_batch_size=2,
            seqlen_offset=torch.from_numpy(offsets),
            key_value_memory_dict=caches, block_table=torch.from_numpy(table))
        with torch.no_grad():
            got = model(torch.from_numpy(tokens), inference_params=ip).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        logits.append(got)
    for i in range(2):
        np.testing.assert_allclose(caches[i].numpy(),
                                   np.asarray(jax_caches[i]), **TOL)

    # The cached path against a plain forward over each row's true tokens.
    (c0, _), (c1, _) = steps[0], steps[1]
    dec = np.concatenate([t for t, _ in steps[2:]], axis=1)
    rows = [
        (np.concatenate([c0[0], c1[0], dec[0]]),
         np.concatenate([logits[0][0], logits[1][0]]
                        + [lg[0] for lg in logits[2:]])),
        (np.concatenate([c0[1, :5], c1[1], dec[1]]),
         np.concatenate([logits[0][1, :5], logits[1][1]]
                        + [lg[1] for lg in logits[2:]])),
    ]
    for ids, cached in rows:
        ref = gpt_forward_ref(model, torch.from_numpy(ids)[None].long())[0]
        np.testing.assert_allclose(cached, ref.numpy(), **TOL)


@pytest.mark.parametrize("interleaved", [False, True])
def test_rotary_matches_jax(interleaved):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    offsets = np.array([0, 7], np.int32)
    cos, sin = RotaryEmbedding(12, base=500.0).cos_sin(32)  # partial rotary
    want = jax_apply_rotary(jnp.asarray(x), jnp.asarray(cos.numpy()),
                            jnp.asarray(sin.numpy()), interleaved=interleaved,
                            seqlen_offsets=jnp.asarray(offsets))
    got = apply_rotary_emb(torch.from_numpy(x), cos, sin,
                           interleaved=interleaved,
                           seqlen_offsets=torch.from_numpy(offsets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_gated_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    jax_mlp = JaxGatedMlp(in_features=32, hidden_features=48, dtype=jnp.float32)
    params = jax_mlp.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    mlp = GatedMlp(32, hidden_features=48, dtype=torch.float32)
    mlp.load_state_dict({f"{name}.weight": torch.from_numpy(
        np.asarray(node["kernel"]).T.copy()) for name, node in params.items()})
    want = jax_mlp.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mistral_config_matches_jax_adapter():
    """The Mistral-7B-v0.1 config.json maps to the same GPTConfig fields."""
    hf = dict(hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
              num_key_value_heads=8, intermediate_size=14336,
              vocab_size=32000, rope_theta=10000.0, rms_norm_eps=1e-5,
              sliding_window=4096, tie_word_embeddings=False)
    want = jax_llama_config(types.SimpleNamespace(**hf))
    got = llama_config_to_gpt_config(hf)
    for field in dataclasses.fields(got):
        if field.name != "dtype":
            assert getattr(got, field.name) == getattr(want, field.name), field
    assert got.window_size == (4095, -1)


def test_greedy_sampling_matches_jax():
    """Greedy takes the first maximum on ties, as jnp.argmax does."""
    logits = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                       [-2.0, -1.0, -3.0, -1.0]], np.float32)
    want = np.asarray(jax_sample_tokens(jnp.asarray(logits),
                                        jax.random.PRNGKey(0)))
    got = sample_tokens(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
