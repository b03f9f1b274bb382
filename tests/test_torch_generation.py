"""The port's generation runtime against the JAX package's, at a tiny fp32
Llama-style configuration: JAX params (numpy draws on `jax.eval_shape`'s
tree) carried across with `state_dict_from_flax`, the same numpy-seeded
prompts through `generate` over contiguous caches (kernel 5's plain version
on the CPU, the JAX `_decode_kernel` in interpret mode), speculative
decoding, sampling, and ALiBi decode through MHA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu.modules.mha import InferenceParams as JaxInferenceParams
from flash_attn_tpu.runtime import generation as jax_gen
from flash_attn_tpu.runtime.kv_cache import allocate_kv_cache as jax_alloc
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.modules.mha import MHA, InferenceParams
from flash_attn_tpu_torch.runtime.generation import (
    decode_speculative,
    make_apply_fn,
    sample_speculative,
)
from flash_attn_tpu_torch.runtime.kv_cache import allocate_kv_cache
from flash_attn_tpu_torch.utils.convert import state_dict_from_flax
from flash_attn_tpu_torch.utils.testing import gpt_forward_ref

FIELDS = dict(
    vocab_size=97, n_positions=0, n_embd=128, n_layer=2, n_head=2,
    n_head_kv=1, rotary_emb_fraction=1.0, rms_norm=True,
    activation_function="swiglu", qkv_proj_bias=False, out_proj_bias=False,
    mlp_fc1_bias=False, mlp_fc2_bias=False, tie_word_embeddings=False,
    window_size=(11, -1),
)
PROMPT, NEW, GAMMA = 7, 6, 3
# Float32 on both sides: the two differ only in summation order.
TOL = dict(rtol=1e-4, atol=1e-4)


def _params(module, seed, *args):
    """Params for `module` from numpy draws on its eval_shape tree (init
    would run the Pallas kernels): kernels at 1/sqrt(fan_in), embeddings at
    unit scale, norm scales near 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        std = 1.0 if "embedding" in name else s.shape[0] ** -0.5
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(seed, **fields):
    """(JAX model, its params, the port's model with the same weights)."""
    cfg = dict(FIELDS, **fields)
    jax_model = JaxGPTLMHeadModel(JaxGPTConfig(**cfg, dtype=jnp.float32))
    params = _params(jax_model, seed, jnp.zeros((1, 8), jnp.int32))
    config = GPTConfig(**cfg, dtype=torch.float32)
    model = GPTLMHeadModel(config, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, config))
    return jax_model, params, model


@pytest.fixture(scope="module")
def target():
    return _pair(0)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(1).integers(0, 97, (2, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def greedy(target, prompts):
    """(JAX output, port output) of greedy generate with scores."""
    jax_model, params, model = target
    want = jax_model.generate(params, jnp.asarray(prompts), PROMPT + NEW,
                              return_dict_in_generate=True,
                              output_scores=True)
    got = model.generate(torch.from_numpy(prompts), PROMPT + NEW,
                         return_dict_in_generate=True, output_scores=True)
    return want, got


def test_generate_greedy_matches_jax(greedy):
    want, got = greedy
    np.testing.assert_array_equal(got.sequences.numpy(),
                                  np.asarray(want.sequences))
    assert got.scores.shape == (2, NEW - 1, 97)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **TOL)


def test_generate_matches_plain_forward(target, greedy):
    """Each generated token is the argmax of a plain full-sequence forward
    at the position before it, and the scores are that forward's logits."""
    model = target[2]
    seqs = greedy[1].sequences
    ref = gpt_forward_ref(model, seqs.long())  # (2, PROMPT + NEW, vocab)
    pred = ref[:, PROMPT - 1:-1].argmax(-1)
    np.testing.assert_array_equal(pred.numpy(), seqs[:, PROMPT:].numpy())
    np.testing.assert_allclose(greedy[1].scores.numpy(),
                               ref[:, PROMPT:-1].numpy(), **TOL)


def test_eos_stops_a_row(target, prompts, greedy):
    """With eos the third new token of row 0, row 0 keeps its tokens up to
    it and repeats eos after; row 1 runs as before up to its own first eos
    (if any), then repeats eos."""
    model = target[2]
    base = greedy[1].sequences[:, PROMPT:]
    eos = int(base[0, 2])
    got = model.generate(torch.from_numpy(prompts), PROMPT + NEW,
                         eos_token_id=eos)[:, PROMPT:]
    for row in range(2):
        hits = (base[row] == eos).nonzero()
        stop = int(hits[0]) if len(hits) else NEW
        assert torch.equal(got[row, :stop + 1], base[row, :stop + 1])
        assert (got[row, stop:] == eos).all() or stop == NEW
    assert (got[0, 2:] == eos).all()


def test_graphed_decode_matches_eager(target, prompts):
    """`generate(cg=True)`'s step over static buffers (on the CPU run
    eagerly, the code a CUDA graph captures) gives cg=False's sequences and
    scores exactly: greedy with an eos, and top-k sampling from a seeded
    generator."""
    model = target[2]
    ids = torch.from_numpy(prompts)
    base = model.generate(ids, PROMPT + NEW)[:, PROMPT:]
    for kw in (dict(eos_token_id=int(base[0, 2])),
               dict(top_k=5, temperature=0.8)):
        runs = [model.generate(ids, PROMPT + NEW, cg=cg,
                               generator=torch.Generator().manual_seed(3),
                               return_dict_in_generate=True,
                               output_scores=True, **kw)
                for cg in (True, False)]
        assert torch.equal(runs[0].sequences, runs[1].sequences)
        assert torch.equal(runs[0].scores, runs[1].scores)


def test_seeded_generator_reproducible(target, prompts):
    """top-k sampling from a seeded torch.Generator: the same seed gives the
    same tokens, and each token after the first lies in the top k of the
    step's scores."""
    model = target[2]
    kw = dict(top_k=5, temperature=0.8, return_dict_in_generate=True,
              output_scores=True)
    runs = [model.generate(torch.from_numpy(prompts), PROMPT + NEW,
                           generator=torch.Generator().manual_seed(3), **kw)
            for _ in range(2)]
    assert torch.equal(runs[0].sequences, runs[1].sequences)
    top = runs[0].scores.topk(5, dim=-1).indices  # (2, NEW - 1, 5)
    nxt = runs[0].sequences[:, PROMPT + 1:].long()
    assert (top == nxt[..., None]).any(-1).all()


def test_decode_speculative_matches_generate_and_jax(target, prompts):
    """Greedy speculative decoding (a one-layer draft, gamma 3, batch 1)
    gives the target's own greedy tokens, as the JAX function does."""
    jax_target, jparams, model = target
    jax_draft, dparams, draft = _pair(7, n_layer=1)
    ids = prompts[:1]
    slots = PROMPT + NEW + GAMMA + 1

    def jax_caches(m):
        return {i: jax_alloc(1, slots, 1, 64, jnp.float32)
                for i in range(m.config.n_layer)}

    want = jax_gen.decode_speculative(
        jnp.asarray(ids), jax_gen.make_apply_fn(jax_target, jparams, slots, 1),
        jax_caches(jax_target),
        jax_gen.make_apply_fn(jax_draft, dparams, slots, 1),
        jax_caches(jax_draft), NEW, gamma=GAMMA)

    def caches(m):
        return {i: allocate_kv_cache(1, slots, 1, 64, torch.float32,
                                    device="cpu")
                for i in range(m.config.n_layer)}

    got = decode_speculative(
        torch.from_numpy(ids), make_apply_fn(model, slots, 1), caches(model),
        make_apply_fn(draft, slots, 1), caches(draft), NEW, gamma=GAMMA)
    np.testing.assert_array_equal(got.sequences.numpy(),
                                  np.asarray(want.sequences))
    assert int(got.lengths[0]) == int(want.lengths[0])
    plain = model.generate(torch.from_numpy(ids), PROMPT + NEW)
    assert torch.equal(got.sequences, plain)


def test_sample_speculative_identical_models_accept_all():
    """Draft and target distributions equal: every draft token is accepted,
    and the bonus token comes from the target's last distribution."""
    rng = np.random.default_rng(4)
    b, g, vocab = 3, 4, 11
    probs = torch.softmax(torch.from_numpy(
        rng.standard_normal((b, g + 1, vocab)).astype(np.float32)), -1)
    drafted = torch.from_numpy(rng.integers(0, vocab, (b, g)).astype(np.int32))
    tokens, accepted = sample_speculative(probs, probs[:, :g], drafted,
                                          torch.Generator().manual_seed(0))
    assert (accepted == g).all()
    assert torch.equal(tokens[:, :g], drafted)
    assert ((tokens[:, g] >= 0) & (tokens[:, g] < vocab)).all()


def test_alibi_decode_matches_jax_mha():
    """MHA with ALiBi over contiguous caches (kernel 5's ALiBi route): a
    5-token prefill and one decode step, per-row offsets, against the JAX
    MHA with the same weights."""
    rng = np.random.default_rng(9)
    b, embed, h, hk, smax = 2, 256, 4, 2, 16
    kw = dict(num_heads=h, num_heads_kv=hk, qkv_proj_bias=False,
              out_proj_bias=False, use_alibi=True, window_size=(3, -1))
    jax_mha = JaxMHA(embed_dim=embed, causal=True, dtype=jnp.float32,
                     layer_idx=0, **kw)
    x0 = jnp.zeros((b, 5, embed), jnp.float32)
    params = _params(jax_mha, 9, x0)
    mha = MHA(embed, dtype=torch.float32, layer_idx=0, **kw)
    mha.load_state_dict({f"{name}.weight": torch.from_numpy(
        np.asarray(node["kernel"]).T.copy())
        for name, node in params["params"].items()})
    @jax.jit
    def jax_step(caches, x, offsets):
        jip = JaxInferenceParams(max_seqlen=smax, max_batch_size=b,
                                 seqlen_offset=offsets,
                                 key_value_memory_dict=dict(caches))
        out = jax_mha.apply(params, x, inference_params=jip)
        return out, jip.key_value_memory_dict

    jcache = {0: jax_alloc(b, smax, hk, 64, jnp.float32)}
    cache = {0: allocate_kv_cache(b, smax, hk, 64, torch.float32,
                                   device="cpu")}
    offsets = np.array([0, 3], np.int32)
    for s in (5, 1):
        x = rng.standard_normal((b, s, embed)).astype(np.float32)
        want, jcache = jax_step(jcache, jnp.asarray(x), jnp.asarray(offsets))
        ip = InferenceParams(max_seqlen=smax, max_batch_size=b,
                             seqlen_offset=torch.from_numpy(offsets),
                             key_value_memory_dict=cache)
        with torch.no_grad():
            got = mha(torch.from_numpy(x), inference_params=ip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        offsets = offsets + s
    assert mha.alibi_slopes is not None and "alibi_slopes" not in mha.state_dict()
    # Without a cache ALiBi now runs in kernel 1's feature instance (its
    # plain version here), as the JAX MHA's full-sequence call.
    x = rng.standard_normal((b, 6, embed)).astype(np.float32)
    np.testing.assert_allclose(
        mha(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jax_mha.apply(params, jnp.asarray(x))), **TOL)
