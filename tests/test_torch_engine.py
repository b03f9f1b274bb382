"""The port's serving engine against the JAX package's: the same weights
(carried across with `state_dict_from_flax`) and prompts must give the same
greedy tokens, plain and speculative (the JAX rule: speculative equals
plain). Also the step programs' static tensors, the port's native-vs-Python
scheduler differential, and its import hygiene and device rules."""

import dataclasses
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from flash_attn_tpu.runtime.engine import LLMEngine as JaxLLMEngine
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.runtime.engine import EngineConfig, LLMEngine
from flash_attn_tpu_torch.runtime.scheduler import (
    NativeScheduler,
    PyScheduler,
    _lib,
)
from flash_attn_tpu_torch.utils.convert import state_dict_from_flax

FIELDS = dict(
    vocab_size=97, n_positions=0, n_embd=64, n_layer=2, n_head=4, n_head_kv=2,
    rotary_emb_fraction=1.0, rms_norm=True, activation_function="swiglu",
    qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
    mlp_fc2_bias=False, tie_word_embeddings=False, window_size=(11, -1),
)
ENGINE = dict(max_batch_size=2, page_size=8, num_pages=16, max_pages_per_seq=8,
              prefill_chunk=8, max_seqlen=64)
MAX_NEW = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def jax_run():
    """The JAX engine's greedy tokens, run once, and its params."""
    model = JaxGPTLMHeadModel(JaxGPTConfig(**FIELDS, dtype=jnp.float32))
    params = _draw_params(model, 0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, n).tolist() for n in (21, 5)]
    engine = JaxLLMEngine(model, params, JaxEngineConfig(**ENGINE))
    tokens = engine.generate(prompts, MAX_NEW)
    return jax.tree.map(np.asarray, params), prompts, tokens


def _port_model(params):
    config = GPTConfig(**FIELDS, dtype=torch.float32)
    model = GPTLMHeadModel(config, device="cpu")
    model.load_state_dict(state_dict_from_flax(params, config))
    return model


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "split"])
def test_engine_matches_jax_engine(jax_run, fused):
    params, prompts, want = jax_run
    engine = LLMEngine(_port_model(params),
                       EngineConfig(**ENGINE, fused_kv_pages=fused),
                       device="cpu")
    got = engine.generate(prompts, MAX_NEW)
    assert got == want
    assert all(len(t) == MAX_NEW for t in got)
    # 20 + 4 prefill tokens in chunks of 8 batched two rows at a time.
    assert engine.prefill_steps == 3 and engine.decode_steps == MAX_NEW


OPTIONS = {
    "decode-depth-3": dict(decode_depth=3),
    "kv-window-16": dict(kv_window_tokens=16),  # >= the 12-token window
    "prefix-caching": dict(enable_prefix_caching=True),
    "python-scheduler": dict(prefer_native_scheduler=False),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_engine_options_keep_jax_tokens(jax_run, option):
    """Engine options change the schedule, never the greedy tokens."""
    params, prompts, want = jax_run
    engine = LLMEngine(_port_model(params),
                       EngineConfig(**ENGINE, **OPTIONS[option]), device="cpu")
    assert engine.generate(prompts, MAX_NEW) == want
    if option == "decode-depth-3":
        # Two dispatches of three forwards; the last two overshoot.
        assert engine.decode_steps == 6
    if option == "prefix-caching":
        # The second round reuses the first prompt's two full pages.
        assert engine.generate(prompts, MAX_NEW) == want
        assert engine.prefix_cache.hits >= 1


SPEC_K = 3


@pytest.fixture(scope="module")
def jax_draft():
    """An independent draft's JAX params: the engine's model at another
    seed."""
    model = JaxGPTLMHeadModel(JaxGPTConfig(**FIELDS, dtype=jnp.float32))
    return _draw_params(model, 7)


@pytest.mark.parametrize("draft", ["draft", "target-as-draft"])
@pytest.mark.parametrize("fused", [None, False], ids=["fused", "split"])
def test_speculative_engine_matches_jax_engine(jax_run, jax_draft, fused,
                                               draft):
    """speculative_k 3 gives the JAX engine's plain greedy tokens; the
    target as its own draft has every draft accepted."""
    params, prompts, want = jax_run
    target = _port_model(params)
    draft_model = target if draft == "target-as-draft" else _port_model(
        jax_draft)
    engine = LLMEngine(target, EngineConfig(**ENGINE, fused_kv_pages=fused,
                                            speculative_k=SPEC_K),
                       device="cpu", draft_model=draft_model)
    assert engine.generate(prompts, MAX_NEW) == want
    assert engine.prefill_steps == 3 and engine.decode_steps == 0
    assert engine.spec_rounds >= 1
    assert engine.spec_drafted == SPEC_K * len(prompts) * engine.spec_rounds
    if draft == "target-as-draft":
        assert engine.spec_accepted == engine.spec_drafted


def test_speculative_config_errors():
    """The JAX engine's ValueErrors: speculative_k without a draft, with
    top_k != 1, with decode_depth > 1. speculative_k serves; device_put_fn
    still raises, naming its ROADMAP item."""
    model = GPTLMHeadModel(GPTConfig(**FIELDS, dtype=torch.float32),
                           device="cpu")
    spec = EngineConfig(**ENGINE, speculative_k=SPEC_K)
    with pytest.raises(ValueError, match="draft_model"):
        LLMEngine(model, spec, device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        LLMEngine(model, dataclasses.replace(spec, top_k=5), device="cpu",
                  draft_model=model)
    with pytest.raises(ValueError, match="exclusive"):
        LLMEngine(model, dataclasses.replace(spec, decode_depth=2),
                  device="cpu", draft_model=model)
    assert "round" in LLMEngine(model, spec, device="cpu",
                                draft_model=model).graphs
    with pytest.raises(NotImplementedError, match="item 12"):
        LLMEngine(model, EngineConfig(**ENGINE, device_put_fn=lambda x: x),
                  device="cpu")


STATIC = ("_inputs", "_staging", "_prefill_tokens", "_decode_tokens",
          "_offsets", "_tables", "_sampled", "_read_back", "last_logits")


@pytest.mark.parametrize("program", ["decode", "round"])
def test_step_programs_keep_their_static_tensors(jax_run, program):
    """Every step program reads and writes the same tensors at every step
    (what a captured CUDA graph replays over): the inputs are views of one
    buffer, written in place; the tokens stay the JAX engine's. The rotary
    table the steps read outlives a longer request's rebuild, and dropping
    the engine frees it at once (its graphs hold it in no cycle)."""
    params, prompts, want = jax_run
    model = _port_model(params)
    extra = (dict(speculative_k=SPEC_K) if program == "round"
             else dict(decode_depth=2))
    engine = LLMEngine(model, EngineConfig(**ENGINE, **extra), device="cpu",
                       draft_model=model if program == "round" else None)
    ptrs = {name: getattr(engine, name).data_ptr() for name in STATIC}
    lo = ptrs["_inputs"]
    hi = lo + engine._inputs.numel() * 4
    assert all(lo <= ptrs[name] < hi for name in STATIC[2:6])
    for i, p in enumerate(prompts):
        engine.add_request(i, p, MAX_NEW)
    steps = 0
    while engine.sched.num_active() > 0 or any(
            engine.sched.request_state(r) in (0, 1) for r in engine.outputs):
        engine.step()
        steps += 1
        assert {name: getattr(engine, name).data_ptr()
                for name in STATIC} == ptrs
    assert [engine.outputs[i].tokens for i in range(len(prompts))] == want
    assert steps > engine.prefill_steps
    assert (engine.spec_rounds if program == "round" else engine.decode_steps)
    rotary = model.transformer.layers[0].mixer.rotary
    table = weakref.ref(rotary._cached[torch.device("cpu")][1])
    rotary.cos_sin(2 * ENGINE["max_seqlen"] + 1)
    assert table() is not None
    gone = weakref.ref(engine)
    del engine
    assert gone() is None


def _drive(sched, workload, max_steps=500):
    """Run a synthetic workload, recording every scheduling decision."""
    trace = []
    added = 0
    for _ in range(max_steps):
        while added < len(workload) and workload[added][0] <= len(trace):
            _, rid, plen, mnew = workload[added]
            sched.add_request(rid, plen, mnew)
            added += 1
        b = sched.next_batch()
        trace.append((b.kind, b.request_ids.tolist(), b.positions.tolist(),
                      b.chunk_lens.tolist(), b.block_tables.tolist()))
        if b.kind == 0:
            if added == len(workload) and sched.num_active() == 0:
                break
            continue
        ids = b.request_ids.tolist()
        if b.kind == 1:
            sched.report(ids, [0] * len(ids), [0] * len(ids))
        else:
            done = [1 if (rid + len(trace)) % 7 == 0 else 0 for rid in ids]
            sched.report(ids, [1] * len(ids), done)
    trace.append(("free", sched.num_free_pages()))
    return trace


def test_scheduler_native_matches_python():
    """The port's C++ and Python schedulers take identical decisions."""
    assert _lib() is not None, "the native scheduler did not build"
    rng = np.random.RandomState(0)
    workload = sorted(
        (int(rng.randint(0, 20)), i, int(rng.randint(1, 600)),
         int(rng.randint(1, 30)))
        for i in range(12)
    )
    args = dict(num_pages=64, page_size=64, max_batch=4,
                max_pages_per_seq=16, chunk_size=128)
    assert _drive(NativeScheduler(**args), workload) == _drive(
        PyScheduler(**args), workload)


def test_port_imports_no_jax():
    """Importing every module of the port loads nothing of JAX or of the
    JAX package."""
    code = (
        "import pkgutil, sys, flash_attn_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'flash_attn_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'flash_attn_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('flash_attn_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 20


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    """Without a card, an entry point given no device raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = GPTConfig(**FIELDS, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTLMHeadModel(config)
    model = GPTLMHeadModel(config, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(model, EngineConfig(**ENGINE))
