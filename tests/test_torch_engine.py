"""The port's serving engine against the JAX package's: the same weights
(carried across with `state_dict_from_flax`) and prompts must give the same
greedy tokens. Also the port's native-vs-Python scheduler differential, and
its import hygiene and device rules."""

import os
import subprocess
import sys

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


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine's greedy tokens, run once, and its params."""
    model = JaxGPTLMHeadModel(JaxGPTConfig(**FIELDS, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
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
