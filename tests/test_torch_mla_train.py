"""MLA training in the port against the JAX package: the absorbed-qv
backward (dq, dk, dv with dS^T Qv, dqv) of kernels 2-3's plain versions
against the JAX `flash_attention_bwd(qv=)` in interpret mode, the dv != d
backward without qv, the `MLA` module's and an MLA GPT's gradients of every
parameter against `jax.grad` on carried weights, three trainer steps against
the JAX trainer, and the MLA model's decay mask and flops count. Inputs are
numpy draws from fixed seeds; the JAX calls are jitted. The small MLA widths
are the JAX tests' (tests/test_gpt.py:210-217)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.flash_attn_interface import flash_attn_func as jax_fa_func
from flash_attn_tpu.kernels.flash_bwd import (
    flash_attention_bwd as jax_flash_bwd,
)
from flash_attn_tpu.kernels.flash_fwd import (
    flash_attention_fwd as jax_flash_fwd,
)
from flash_attn_tpu.losses.cross_entropy import (
    cross_entropy_loss as jax_cross_entropy,
)
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.modules.mla import MLA as JaxMLA
from flash_attn_tpu.training import data as jax_data
from flash_attn_tpu.training.optim import decay_mask as jax_decay_mask
from flash_attn_tpu.training.trainer import TrainConfig as JaxTrainConfig
from flash_attn_tpu.training.trainer import Trainer as JaxTrainer
from flash_attn_tpu_torch.flash_attn_interface import flash_attn_func
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.losses.cross_entropy import cross_entropy_loss
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.modules.mla import MLA
from flash_attn_tpu_torch.training import data
from flash_attn_tpu_torch.training.optim import decay_mask, flax_path
from flash_attn_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    gpt_flops_per_token,
)
from flash_attn_tpu_torch.utils.convert import state_dict_from_flax

# The JAX tests' small MLA model (tests/test_gpt.py:210-217); the port's
# model checkpoints every block (the JAX side runs without remat, which
# changes memory and time, never the numbers).
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
# float32 on both sides, the same arithmetic in other orders (the JAX
# kernels take delta = rowsum(dO * O), the port sum_j P dP: equal in exact
# arithmetic). Errors are measured against the largest value of the set
# compared.
TOL = 1e-4


def _close_all(got: dict, want: dict):
    assert got.keys() == want.keys()
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]),
                                   rtol=TOL, atol=TOL * scale, err_msg=name)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# name: (b, h, hk, sq, sk, causal)
QV_CASES = {
    "causal-mqa-sq-below-sk": (2, 4, 1, 6, 9, True),
    "noncausal-group2-sq-above-sk": (1, 4, 2, 9, 6, False),
}


@pytest.mark.parametrize("name", list(QV_CASES))
def test_qv_bwd_matches_jax_kernel(name):
    """flash_attention_bwd(qv=) (kernels 3 and 2's plain versions) against
    the JAX kernels in interpret mode on the JAX forward's out and lse: dq,
    dk, dv (P^T dO + dS^T Qv, the group summed) and dqv, at the default
    scale (d + dv)^-0.5; MQA and a group of 2, bottom-right aligned."""
    b, h, hk, sq, sk, causal = QV_CASES[name]
    rng = np.random.default_rng(len(name))
    q, do = _normal(rng, b, h, sq, DR), _normal(rng, b, h, sq, DC)
    qv = _normal(rng, b, h, sq, DC, scale=0.3)
    k, v = _normal(rng, b, hk, sk, DR), _normal(rng, b, hk, sk, DC, scale=0.3)

    @jax.jit
    def jax_grads(q, k, v, qv, do):
        out, lse = jax_flash_fwd(q, k, v, qv=qv, causal=causal)
        return (lse,) + tuple(jax_flash_bwd(q, k, v, out, lse, do, qv=qv,
                                            causal=causal))

    lse, *want = jax_grads(*(jnp.asarray(x) for x in (q, k, v, qv, do)))
    t = torch.from_numpy
    got = flash_attention_bwd(t(q), t(k), t(v), t(np.array(lse)), t(do),
                              qv=t(qv), causal=causal)
    names = ("dq", "dk", "dv", "dqv")
    _close_all({n: g.numpy() for n, g in zip(names, got)},
               dict(zip(names, want)))


def test_dv_wider_than_d_bwd_matches_jax():
    """A v wider than q and k without qv (MLA's dv-512 shape, the kernels'
    kHasQv=false instances on the card): flash_attn_func's q, k and v
    gradients against jax.vjp of the JAX flash_attn_func, causal, GQA."""
    rng = np.random.default_rng(7)
    b, sq, sk, h, hk = 1, 7, 10, 4, 2
    q, k = _normal(rng, b, sq, h, DR), _normal(rng, b, sk, hk, DR)
    v, do = _normal(rng, b, sk, hk, DC), _normal(rng, b, sq, h, DC)

    @jax.jit
    def jax_fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(functools.partial(jax_fa_func, causal=True),
                           q, k, v)
        return (out,) + vjp(do)

    want = jax_fwd_bwd(*(jnp.asarray(x) for x in (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attn_func(tq, tk, tv, causal=True)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    names = ("out", "dq", "dk", "dv")
    _close_all({n: x.detach().numpy() for n, x in
                zip(names, (out,) + grads)}, dict(zip(names, want)))


def _module_sd(tree):
    """The port MLA's parameter names for a JAX MLA params (or grads)
    tree."""
    p = tree["params"]
    sd = {f"{n}.weight": np.asarray(p[n]["kernel"]).T
          for n in ("W_q", "W_dkv", "out_proj")}
    sd.update(W_uk=np.asarray(p["W_uk"]), W_uv=np.asarray(p["W_uv"]))
    return sd


def test_mla_module_grads_match_jax():
    """The MLA module's gradients of every parameter (W_q, W_dkv, W_uk,
    W_uv, out_proj) and of its input against jax.grad of the JAX MLA on the
    same weights: training through the fp32 absorb and un-absorb and the
    qv attention's backward."""
    jmla = JaxMLA(**MLA_DIMS, dtype=jnp.float32, layer_idx=0)
    x = np.random.default_rng(3).standard_normal((2, 9, 64)).astype(np.float32)
    shapes = jax.eval_shape(jmla.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda s: _normal(rng, *s.shape, scale=1 / np.sqrt(
            np.prod(s.shape[:-1]))), shapes)
    cot = _normal(np.random.default_rng(5), 2, 9, 64)

    @jax.jit
    def jax_grads(params, x):
        return jax.grad(lambda p, x: (jmla.apply(p, x) * cot).sum(),
                        argnums=(0, 1))(params, x)

    gp, gx = jax_grads(params, jnp.asarray(x))
    mla = MLA(**MLA_DIMS, layer_idx=0, device="cpu", dtype=torch.float32)
    mla.load_state_dict({n: torch.from_numpy(w.copy())
                         for n, w in _module_sd(params).items()})
    tx = torch.from_numpy(x).requires_grad_()
    (mla(tx) * torch.from_numpy(cot)).sum().backward()
    got = {n: p.grad.numpy() for n, p in mla.named_parameters()}
    got["x"] = tx.grad.numpy()
    _close_all(got, dict(_module_sd(gp), x=np.asarray(gx)))


def _random_params(jax_model, seed):
    """Params of the JAX model's tree drawn with numpy (kernels and
    embedding rows at 1/sqrt(fan-in), W_uk / W_uv at flax lecun_normal's
    1/sqrt(h x middle axis), norm scales 1 + 0.1 N); the tree comes from
    `jax.eval_shape`, which runs no kernel."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        kind = path[-1].key
        if kind == "scale":
            return 1.0 + 0.1 * x
        fan_in = (leaf.shape[-1] if kind == "embedding"
                  else np.prod(leaf.shape[:-1]))
        return x / np.float32(np.sqrt(fan_in))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(remat="full", seed=0):
    jax_model = JaxGPTLMHeadModel(JaxGPTConfig(**FIELDS, dtype=jnp.float32))
    params = _random_params(jax_model, seed)
    config = GPTConfig(**FIELDS, remat=remat, dtype=torch.float32)
    model = GPTLMHeadModel(config, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params, config))
    return jax_model, params, model


def test_mla_gpt_grads_match_jax():
    """An MLA GPT's loss and every parameter's gradient against the JAX
    model's jax.value_and_grad on the same weights, the port checkpointing
    every MLA block (remat "full": the blocks run again in the backward,
    kernel 1's qv forward among them)."""
    jax_model, params, model = _models()
    tokens = np.random.default_rng(1).integers(0, 61, (2, 17)).astype(np.int32)
    ids, labels = tokens[:, :-1], tokens[:, 1:]

    @jax.jit
    def jax_loss_grads(p):
        def loss(p):
            logits = jax_model.apply(p, jnp.asarray(ids))
            return jax_cross_entropy(logits.astype(jnp.float32),
                                     jnp.asarray(labels))
        return jax.value_and_grad(loss)(p)

    loss_j, grads_j = jax_loss_grads(params)
    loss = cross_entropy_loss(model(torch.from_numpy(ids).long()).float(),
                              torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=TOL)
    want = {n: g.numpy() for n, g in state_dict_from_flax(
        grads_j, model.config).items()}
    _close_all({n: p.grad.numpy() for n, p in model.named_parameters()}, want)


def test_mla_trainer_fit_matches_jax():
    """Three AdamW steps of the MLA GPT (warmup 1, cosine, clip 1.0) on the
    same weights and batches as the JAX Trainer: per-step loss and grad
    norm, and the final parameters, W_uk and W_uv decayed."""
    jax_model, params, model = _models(remat="dots")
    train = dict(lr=3e-3, weight_decay=0.1, grad_clip=1.0, warmup_steps=1,
                 total_steps=3, schedule="cosine", log_every=1)
    toks = data.synthetic_tokens(61, 2000, seed=0)
    jax_dm = jax_data.LMDataModule(jax_data.TokenDataset(toks, 16), 2)
    dm = data.LMDataModule(data.TokenDataset(toks, 16), 2)
    jax_trainer = JaxTrainer(jax_model, params, JaxTrainConfig(**train))
    want = jax_trainer.fit(jax_dm)
    trainer = Trainer(model, TrainConfig(**train), device="cpu")
    got = trainer.fit(dm)
    assert [h["step"] for h in got] == [1, 2, 3]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=TOL)
    final = {n: p.detach().numpy() for n, p in model.named_parameters()}
    _close_all(final, {n: t.numpy() for n, t in state_dict_from_flax(
        jax.tree.map(np.asarray, jax_trainer.params), model.config).items()})


def test_mla_decay_mask_matches_jax():
    """decay_mask of an MLA GPT equals the JAX mask: W_uk and W_uv (3-D
    tensors of the MLA module) decay like every projection; norms and the
    embedding do not."""
    _, params, model = _models()
    flat = jax.tree_util.tree_flatten_with_path(jax_decay_mask(params))[0]
    want = {"/".join(k.key for k in path): bool(v) for path, v in flat}
    modules = dict(model.named_modules())
    got = {}
    for name, decay in decay_mask(model).items():
        mname, pname = name.rsplit(".", 1)
        got[flax_path(mname, modules[mname], pname)] = decay
    assert got == want
    assert got["params/transformer/layers_0/mixer/W_uk"]
    assert got["params/transformer/layers_1/mixer/W_uv"]


def test_mla_flops_per_token_counts_mla_matrices():
    """MFU's 6 N for an MLA model, with W_q and with a query LoRA: N read
    off the model itself, every weight tensor of the layers (W_q, or W_dq
    and W_uq; W_dkv, W_uk, W_uv, out_proj; the MLP) plus the head's, none
    of MHA's q/k/v projections (the JAX count treats an MLA model as
    MHA)."""
    for q_lora_rank in (None, 24):
        config = GPTConfig(**FIELDS, q_lora_rank=q_lora_rank,
                           dtype=torch.float32)
        model = GPTLMHeadModel(config, device="cpu")
        n = sum(p.numel() for name, p in model.named_parameters()
                if name.startswith("transformer.layers.") and p.dim() >= 2)
        n += model.transformer.embeddings.word_embeddings.weight.numel()
        assert gpt_flops_per_token(config) == 6 * n
