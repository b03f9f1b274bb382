"""The port's training path against the JAX package's, in float32 at a tiny
size: one step's loss and every parameter's gradient for a GPT-2-style and
a Llama-style model (JAX params carried across with `state_dict_from_flax`,
JAX gradients likewise), a 3-step `Trainer.fit` against the JAX `Trainer`
on the same `LMDataModule`, and the optimizer's pieces (decay mask,
schedules) against optax's. On the CPU the attention runs the flash
kernels' plain versions; the JAX side runs its Pallas kernels in interpret
mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.losses.cross_entropy import (
    cross_entropy_loss as jax_cross_entropy,
)
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.training import data as jax_data
from flash_attn_tpu.training.optim import decay_mask as jax_decay_mask
from flash_attn_tpu.training.optim import make_schedule as jax_make_schedule
from flash_attn_tpu.training.trainer import TrainConfig as JaxTrainConfig
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu_torch.losses.cross_entropy import cross_entropy_loss
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.training import data
from flash_attn_tpu_torch.training import run
from flash_attn_tpu_torch.training.optim import (
    decay_mask,
    flax_path,
    make_schedule,
)
from flash_attn_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    gpt_flops_per_token,
)
from flash_attn_tpu_torch.utils.convert import state_dict_from_flax

GPT2_STYLE = dict(vocab_size=97, n_positions=64, n_embd=64, n_layer=2,
                  n_head=4, remat="dots")
LLAMA_STYLE = dict(
    vocab_size=97, n_positions=0, n_embd=64, n_layer=2, n_head=4, n_head_kv=2,
    rotary_emb_fraction=1.0, rms_norm=True, activation_function="swiglu",
    qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
    mlp_fc2_bias=False, tie_word_embeddings=False, window_size=(11, -1),
    remat="full",
)
STYLES = {"gpt2": GPT2_STYLE, "llama": LLAMA_STYLE}
# float32 on both sides: the two differ only in summation order. Errors are
# measured against the largest value of the whole set compared, since some
# gradients are exactly 0 in exact arithmetic (a k-projection bias shifts a
# softmax row uniformly) and hold only rounding noise.
TOL = 1e-4


def _close_all(got: dict, want: dict):
    assert got.keys() == want.keys()
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]),
                                   rtol=TOL, atol=TOL * scale, err_msg=name)


def _random_params(jax_model, seed):
    """Params of the JAX model's tree, drawn with numpy: kernels and
    embedding rows at 1/sqrt(fan-in), norm scales 1 + 0.1 N(0, 1), biases
    0.1 N(0, 1). (The tree comes from `jax.eval_shape`, which traces the
    model without running its kernels.)"""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        kind = path[-1].key
        if kind == "scale":
            return 1.0 + 0.1 * x
        if kind == "bias":
            return 0.1 * x
        fan_in = leaf.shape[-1] if kind == "embedding" else leaf.shape[0]
        return x / np.float32(np.sqrt(fan_in))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(fields, seed=0):
    # remat changes memory and time, never the numbers: the JAX side runs
    # without it (it compiles faster), the port with the style's policy.
    jax_fields = dict(fields, remat="none")
    jax_model = JaxGPTLMHeadModel(JaxGPTConfig(**jax_fields, dtype=jnp.float32))
    params = _random_params(jax_model, seed)
    config = GPTConfig(**fields, dtype=torch.float32)
    model = GPTLMHeadModel(config, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params, config))
    return jax_model, params, model


@pytest.mark.parametrize("style", list(STYLES))
def test_step_gradients_match_jax(style):
    fields = STYLES[style]
    jax_model, params, model = _models(fields)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 97, (2, 33)).astype(np.int32)
    ids, labels = tokens[:, :-1], tokens[:, 1:]

    def jax_loss(p):
        logits = jax_model.apply(p, jnp.asarray(ids))
        return jax_cross_entropy(logits.astype(jnp.float32), jnp.asarray(labels))

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(params)
    loss = cross_entropy_loss(model(torch.from_numpy(ids).long()).float(),
                              torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=TOL)
    want = {n: g.numpy() for n, g in state_dict_from_flax(
        grads_j, model.config).items()}
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    _close_all(got, want)


def _datamodules(batch=2, seqlen=32):
    toks = data.synthetic_tokens(97, 4000, seed=0)
    np.testing.assert_array_equal(toks, jax_data.synthetic_tokens(97, 4000, seed=0))
    return (jax_data.LMDataModule(jax_data.TokenDataset(toks, seqlen), batch),
            data.LMDataModule(data.TokenDataset(toks, seqlen), batch))


def test_trainer_fit_matches_jax():
    """Three AdamW steps (warmup 1, cosine, clip 1.0): per-step loss and
    grad norm, and the final parameters."""
    jax_model, params, model = _models(GPT2_STYLE)
    train = dict(lr=3e-3, weight_decay=0.1, grad_clip=1.0, warmup_steps=1,
                 total_steps=3, schedule="cosine", log_every=1)
    jax_dm, dm = _datamodules()
    jax_trainer = JaxTrainer(jax_model, params, JaxTrainConfig(**train))
    want = jax_trainer.fit(jax_dm)
    trainer = Trainer(model, TrainConfig(**train), device="cpu")
    got = trainer.fit(dm)
    assert [h["step"] for h in got] == [1, 2, 3]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=TOL)
    assert got[0]["grad_norm"] > 1.0  # the clip was active
    assert [s["lr"] for s in trainer.steps][0] == 0.0  # optax counts from 0
    # The k-projection biases are left out: their exact gradient is 0 (they
    # shift a softmax row uniformly), and Adam's normalisation turns the
    # rounding noise left in it into steps of about lr, different in the
    # two frameworks.
    final = {n: p.detach().numpy() for n, p in model.named_parameters()
             if not n.endswith("mixer.Wk.bias")}
    want = {n: t.numpy() for n, t in state_dict_from_flax(
        jax.tree.map(np.asarray, jax_trainer.params), model.config).items()
        if not n.endswith("mixer.Wk.bias")}
    _close_all(final, want)


def test_data_batches_match_jax():
    jax_dm, dm = _datamodules(batch=3, seqlen=16)
    for (xj, yj), (x, y) in zip(jax_dm.batches(5), dm.batches(5)):
        np.testing.assert_array_equal(x, xj)
        np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("style", list(STYLES))
def test_decay_mask_matches_jax(style):
    _, params, model = _models(STYLES[style])
    flat = jax.tree_util.tree_flatten_with_path(jax_decay_mask(params))[0]
    want = {"/".join(k.key for k in path): bool(v) for path, v in flat}
    modules = dict(model.named_modules())
    got = {}
    for name, decay in decay_mask(model).items():
        mname, pname = name.rsplit(".", 1)
        got[flax_path(mname, modules[mname], pname)] = decay
    assert got == want
    assert not any(got[p] for p in got if "embedding" in p or "bias" in p)


@pytest.mark.parametrize("kind,warmup", [("cosine", 3), ("linear", 2),
                                         ("constant", 2), ("cosine", 0)])
def test_schedule_matches_optax(kind, warmup):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=12, schedule=kind)
    want = jax_make_schedule(**kw)
    got = make_schedule(**kw)
    for step in range(15):
        expect = float(want(step)) if callable(want) else float(want)
        np.testing.assert_allclose(got(step), expect, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("style", list(STYLES))
def test_flops_per_token_counts_each_weight_matrix_once(style):
    """MFU's 6 N: N read off the model itself, every weight matrix of the
    layers plus the head's (vocab x n_embd, tied or not)."""
    config = GPTConfig(**STYLES[style], dtype=torch.float32)
    model = GPTLMHeadModel(config, device="cpu")
    n = sum(p.numel() for name, p in model.named_parameters()
            if name.startswith("transformer.layers.") and p.dim() == 2)
    n += model.transformer.embeddings.word_embeddings.weight.numel()
    assert gpt_flops_per_token(config) == 6 * n


def test_run_main_trains_on_cpu(tmp_path):
    """The entry point on a tiny config file: the YAML, presets, --set
    overrides and the report."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "model: {vocab_size: 97, n_positions: 32, n_embd: 32, n_layer: 1,\n"
        "        n_head: 2, remat: dots, dtype: float32}\n"
        "train: {lr: 1.0e-3, warmup_steps: 1, total_steps: 4, log_every: 2}\n"
        "data: {kind: synthetic, num_tokens: 3000, seqlen: 16, batch_size: 2}\n")
    report = run.main(["--config", str(cfg), "--device", "cpu",
                       "--set", "train.total_steps=3"])
    assert report["final"]["step"] == 3
    assert [s["step"] for s in report["steps"]] == [1, 2, 3]
    assert all(np.isfinite(s["loss"]) for s in report["steps"])
    assert report["tokens_per_s"] > 0


def test_training_entry_points_do_not_fall_back_to_cpu(monkeypatch, tmp_path):
    """Without a card, the trainer and the training entry point given no
    device raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPTLMHeadModel(GPTConfig(**GPT2_STYLE, dtype=torch.float32),
                           device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, TrainConfig())
    cfg = tmp_path / "c.yaml"
    cfg.write_text("model: {preset: gpt2s}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--config", str(cfg)])
