"""The dense attention features of the port (ALiBi, segment ids,
attention_chunk, sink tokens, the learnable sink, murmur3 dropout,
gather_kv_indices) against the JAX package's, on the same numpy-seeded
inputs in float32.

On the CPU the port's `flash_attn_func` runs kernels 1-3's plain versions
(`flash_attention_fwd_ref`, `_bwd_dq_ref`, `_bwd_dkv_ref`) with the
features; the JAX side runs its Pallas kernels in interpret mode (two
cases) or its oracle `attention_ref` with the JAX keep mask. The keep mask
itself must match the JAX `_dropout_keep_mask` in bits. The CUDA kernels are
held against the plain versions on the card by chip_smoke.py's
attn_features phase."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.flash_attn_interface import flash_attn_func as jax_flash_attn
from flash_attn_tpu.flash_attn_interface import (
    flash_attn_varlen_func as jax_varlen_func,
)
from flash_attn_tpu.kernels.flash_fwd import _dropout_keep_mask
from flash_attn_tpu.losses.cross_entropy import (
    cross_entropy_loss as jax_cross_entropy,
)
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.modules.mha import MHA as JaxMHA
from flash_attn_tpu.utils.testing import attention_ref as jax_attention_ref
from flash_attn_tpu_torch.flash_attn_interface import (
    flash_attn_func,
    flash_attn_varlen_func,
)
from flash_attn_tpu_torch.kernels.common import (
    default_alibi_slopes,
    dropout_keep_mask,
    fold_seed,
)
from flash_attn_tpu_torch.losses.cross_entropy import cross_entropy_loss
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.modules.mha import MHA
from flash_attn_tpu_torch.training.trainer import TrainConfig, Trainer
from flash_attn_tpu_torch.utils.convert import state_dict_from_flax

B, H, HK, D = 2, 4, 2, 64
# float32 on both sides: the two differ only in summation order (and the
# JAX side's base-2 ALiBi term), measured against the largest value of each
# tensor compared.
RTOL = 1e-4


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _jax_keep(seed, b, h, sq, sk, p):
    """The JAX kernel's keep mask over the whole (b, h, sq, sk) grid,
    jitted (its hash op by op costs seconds)."""
    seed_ref = jnp.asarray(seed, jnp.int32).reshape(1, 1)
    return jnp.stack([jnp.stack([
        _dropout_keep_mask(seed_ref, bi, hi, 0, 0, (sq, sk), 1.0 - p)
        for hi in range(h)]) for bi in range(b)])


def test_keep_mask_matches_jax_bits():
    """dropout_keep_mask against the JAX hash, bit for bit, at nonzero
    batch rows and heads, row/column offsets, negative and large seeds."""
    for seed, b, h, row0, col0, p in [
            (0, 0, 0, 0, 0, 0.1), (1234, 1, 3, 128, 64, 0.17),
            (-7, 5, 63, 4095, 3, 0.5), (2**31 - 1, 7, 39, 65536, 8191, 0.9),
            (-2**31, 2, 1, 1, 16383, 0.01)]:
        want = np.asarray(_dropout_keep_mask(
            jnp.asarray([[seed]], jnp.int32), b, h, row0, col0, (48, 80),
            1.0 - p))
        got = dropout_keep_mask(seed, b, h, row0, col0, (48, 80),
                                1.0 - p).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(seed))
    # Broadcast over (b, 1, 1, 1) and (1, h, 1, 1), as the plain versions
    # draw it.
    grid = dropout_keep_mask(-3, torch.arange(B).reshape(-1, 1, 1, 1),
                             torch.arange(H).reshape(1, -1, 1, 1), 0, 0,
                             (40, 56), 0.8).numpy()
    np.testing.assert_array_equal(grid, np.asarray(_jax_keep(-3, B, H, 40, 56,
                                                             0.2)))


def _inputs(seed, sq, sk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, sk, HK, D)).astype(np.float32)
    v = rng.standard_normal((B, sk, HK, D)).astype(np.float32)
    do = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    return q, k, v, do, rng


def _segments(rng, s, pad):
    """Packed documents as sorted ids per batch row, the last `pad`
    positions padding."""
    ids = np.sort(rng.integers(0, 3, (B, s)), axis=1).astype(np.int32)
    ids[:, s - pad:] = -1
    return ids


# name: (sq, sk, causal, window, extras); extras name the features.
ORACLE_CASES = {
    "dropout": (96, 96, True, (-1, -1), dict(dropout_p=0.17, seed=1234)),
    "alibi-bh": (80, 112, True, (-1, -1), dict(alibi="bh")),
    "segments": (96, 96, False, (-1, -1), dict(segments=8)),
    "chunk": (128, 128, True, (-1, -1), dict(attention_chunk=32)),
    "sink-tokens": (128, 128, True, (16, -1), dict(sink_token_length=4)),
    "learnable-sink": (96, 64, True, (24, -1), dict(sink=True)),
}


def _features(case, sq, sk, rng):
    """(port kwargs, oracle kwargs, oracle bias or None, sink array or
    None) of one case's features."""
    port, oracle, bias, sink = {}, {}, None, None
    if "dropout_p" in case:
        p, seed = case["dropout_p"], case["seed"]
        port.update(dropout_p=p, dropout_seed=seed)
        oracle.update(dropout_p=p,
                      dropout_mask=_jax_keep(seed, B, H, sq, sk, p))
    if "alibi" in case:
        slopes = (default_alibi_slopes(H).numpy()[None]
                  * rng.uniform(0.5, 2.0, (B, 1))).astype(np.float32)
        port["alibi_slopes"] = torch.from_numpy(slopes)
        rel = np.abs(np.arange(sk)[None] - np.arange(sq)[:, None] - (sk - sq))
        bias = -slopes[:, :, None, None] * rel[None, None]
    if "segments" in case:
        qs = _segments(rng, sq, case["segments"])
        ks = qs.copy()
        ks[ks < 0] = -2
        port.update(q_segment_ids=torch.from_numpy(qs),
                    kv_segment_ids=torch.from_numpy(ks))
        seg = np.where(qs[:, :, None] == ks[:, None, :], 0.0, -np.inf)
        bias = seg[:, None].astype(np.float32)
    for name in ("attention_chunk", "sink_token_length"):
        if name in case:
            port[name] = oracle[name] = case[name]
    if "sink" in case:
        sink = rng.standard_normal(H).astype(np.float32)
    return port, oracle, bias, sink


def _port_run(q, k, v, do, sink, causal, window, port):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    inputs = [tq, tk, tv]
    ts = None
    if sink is not None:
        ts = torch.from_numpy(sink).requires_grad_()
        inputs.append(ts)
    out, lse, _ = flash_attn_func(tq, tk, tv, causal=causal,
                                  window_size=window, sink=ts,
                                  return_attn_probs=True, **port)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(do))
    return out.detach().numpy(), lse.numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", list(ORACLE_CASES))
def test_feature_matches_oracle(name):
    """Forward and q/k/v (and sink) gradients of each feature against the
    JAX oracle `attention_ref`, which takes dropout as the JAX keep mask,
    ALiBi and segment ids as an additive bias."""
    sq, sk, causal, window, case = ORACLE_CASES[name]
    q, k, v, do, rng = _inputs(len(name), sq, sk)
    port, oracle, bias, sink = _features(case, sq, sk, rng)
    left = window[0] if window[0] >= 0 else None

    def ref(q, k, v, s=None):
        out, _ = jax_attention_ref(
            q, k, v, attn_bias=None if bias is None else jnp.asarray(bias),
            causal=causal, window_size=(left, None), learnable_sink=s,
            **oracle)
        return out

    @jax.jit
    def jax_fwd_bwd(args, do):
        out, vjp = jax.vjp(ref, *args)
        return out, vjp(do)

    args = [jnp.asarray(x) for x in (q, k, v)]
    if sink is not None:
        args.append(jnp.asarray(sink))
    out_j, grads_j = jax_fwd_bwd(args, jnp.asarray(do))
    out, _, grads = _port_run(q, k, v, do, sink, causal, window, port)
    _close(out, out_j, "out")
    for got, want, what in zip(grads, grads_j, ("dq", "dk", "dv", "dsink")):
        _close(got, want, what)


# name: (sq, sk, causal, window, extras), through the JAX kernels.
KERNEL_CASES = {
    "dropout-alibi-segments": (128, 128, True, (-1, -1),
                               dict(dropout_p=0.1, seed=-5, alibi="bh",
                                    segments=16)),
    "chunk-sinktokens-sink": (128, 96, True, (24, -1),
                              dict(attention_chunk=64, sink_token_length=4,
                                   sink=True)),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_features_match_jax_kernels(name):
    """Forward, LSE and gradients (q, k, v, sink) against the JAX package's
    flash_attn_func, its Pallas kernels in interpret mode, with the same
    dropout seed. Held difference: a row that sees no key has lse = sink
    in the port (the oracle's log-sum-exp) where the JAX kernel gives
    +inf."""
    sq, sk, causal, window, case = KERNEL_CASES[name]
    q, k, v, do, rng = _inputs(len(name), sq, sk)
    port, _, _, sink = _features(case, sq, sk, rng)
    jkw = {key: (jnp.asarray(val.numpy()) if isinstance(val, torch.Tensor)
                 else val) for key, val in port.items()}
    if "dropout_seed" in jkw:
        jkw["dropout_seed"] = jnp.int32(jkw["dropout_seed"])
    args = [jnp.asarray(x) for x in (q, k, v)]
    if sink is not None:
        args.append(jnp.asarray(sink))

    @jax.jit
    def jax_fwd_bwd(*args):
        def f(*a):
            s = a[3] if len(a) > 3 else None
            out, lse, _ = jax_flash_attn(*a[:3], causal=causal,
                                         window_size=window, sink=s,
                                         return_attn_probs=True, **jkw)
            return out, lse

        (out, lse), vjp = jax.vjp(f, *args)
        return out, lse, vjp((jnp.asarray(do), jnp.zeros_like(lse)))

    out_j, lse_j, grads_j = jax_fwd_bwd(*args)
    out, lse, grads = _port_run(q, k, v, do, sink, causal, window, port)
    _close(out, out_j, "out")
    lse_j = np.asarray(lse_j)
    seen = np.isfinite(lse_j)
    _close(lse[seen], lse_j[seen], "lse")
    if sink is not None and not seen.all():
        # The held difference, row by row.
        assert np.all(lse_j[~seen] == np.inf)
        np.testing.assert_allclose(
            lse[~seen], np.broadcast_to(sink[None, :, None], lse.shape)[~seen],
            rtol=1e-6)
    for got, want, what in zip(grads, grads_j, ("dq", "dk", "dv", "dsink")):
        _close(got, want, what)


def test_gather_kv_indices_matches_jax():
    """Top-k gathered attention, dense (causal, softcap) and varlen
    (causal), forward and q/k/v gradients, against the JAX package's XLA
    versions; negative and out-of-range indices are masked."""
    rng = np.random.default_rng(11)
    sq, sk, topk = 24, 40, 8
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, sq, H, D), (B, sk, HK, D), (B, sk, HK, D), (B, sq, H, D)))
    idx = rng.integers(-4, sk + 4, (B, sq, topk)).astype(np.int32)

    def both(jax_fn, port_fn, arrays, cot):
        @jax.jit
        def jax_fwd_bwd(arrays, cot):
            out, vjp = jax.vjp(jax_fn, *arrays)
            return out, vjp(cot)

        out_j, grads_j = jax_fwd_bwd([jnp.asarray(x) for x in arrays],
                                     jnp.asarray(cot))
        ts = [torch.from_numpy(x).requires_grad_() for x in arrays]
        out = port_fn(*ts)
        grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
        _close(out.detach().numpy(), out_j, "out")
        for got, want in zip(grads, grads_j):
            _close(got.numpy(), want, "grad")

    kw = dict(causal=True, softcap=5.0)
    both(lambda q, k, v: jax_flash_attn(q, k, v, gather_kv_indices=jnp.asarray(
        idx), **kw),
         lambda q, k, v: flash_attn_func(q, k, v, gather_kv_indices=torch.from_numpy(
             idx), **kw), (q, k, v), do)
    cu_q = np.array([0, 10, 24], np.int32)
    cu_k = np.array([0, 16, 40], np.int32)
    vidx = rng.integers(-2, 18, (sq, topk)).astype(np.int32)
    both(lambda q, k, v: jax_varlen_func(
        q, k, v, jnp.asarray(cu_q), jnp.asarray(cu_k), causal=True,
        gather_kv_indices=jnp.asarray(vidx)),
         lambda q, k, v: flash_attn_varlen_func(
             q, k, v, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
             causal=True, gather_kv_indices=torch.from_numpy(vidx)),
         (q[0], k[0], v[0]), do[0])


def _random_params(jax_model, seed, *args, **kwargs):
    """Params of the JAX module's tree drawn with numpy (kernels and
    embedding rows at 1/sqrt(fan-in), norm scales 1 + 0.1 N, biases
    0.1 N); the tree comes from `jax.eval_shape`, which runs no kernel."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
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


GPT = dict(vocab_size=97, n_positions=64, n_embd=128, n_layer=2, n_head=2)


@pytest.mark.parametrize("fields", [
    dict(GPT, attn_pdrop=0.1, remat="dots"),
    dict(GPT, n_positions=0, use_alibi=True),
], ids=["attn-dropout-seed0", "alibi"])
def test_gpt_matches_jax(fields):
    """A 2-layer GPT's loss and every parameter's gradient against the JAX
    model on weights carried across by state_dict_from_flax: with
    attn_pdrop 0.1 the JAX model (deterministic=False) drops with seed 0 in
    every layer, which the port is handed as one seed per layer; with
    use_alibi both take the geometric slopes."""
    jax_fields = dict(fields, remat="none")
    jax_model = JaxGPTLMHeadModel(JaxGPTConfig(**jax_fields,
                                               dtype=jnp.float32))
    params = _random_params(jax_model, 0, jnp.zeros((1, 8), jnp.int32))
    config = GPTConfig(**fields, dtype=torch.float32)
    model = GPTLMHeadModel(config, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_flax(params, config))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 97, (2, 33)).astype(np.int32)
    ids, labels = tokens[:, :-1], tokens[:, 1:]

    def jax_loss(p):
        logits = jax_model.apply(p, jnp.asarray(ids), deterministic=False)
        return jax_cross_entropy(logits.astype(jnp.float32),
                                 jnp.asarray(labels))

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss))(params)
    loss = cross_entropy_loss(
        model(torch.from_numpy(ids).long(),
              dropout_seed=[0] * config.n_layer).float(),
        torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=RTOL)
    want = {n: g.numpy() for n, g in state_dict_from_flax(
        grads_j, config).items()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=RTOL,
                                   atol=RTOL * scale, err_msg=name)


def _mha_pair(dropout=0.0):
    jax_mha = JaxMHA(embed_dim=128, num_heads=4, num_heads_kv=2,
                     causal=True, dropout=dropout, dtype=jnp.float32)
    x = np.random.default_rng(5).standard_normal((B, 48, 128)).astype(
        np.float32)
    params = _random_params(jax_mha, 3, jnp.asarray(x))
    mha = MHA(128, 4, num_heads_kv=2, dropout=dropout, device="cpu",
              dtype=torch.float32)
    sd = {}
    for name, node in params["params"].items():
        sd[f"{name}.weight"] = torch.from_numpy(
            np.asarray(node["kernel"]).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(node["bias"]))
    mha.load_state_dict(sd)
    return jax_mha, params, mha, x


def test_mha_key_padding_mask_matches_jax():
    """MHA with a key_padding_mask (the last positions of each row padding)
    against the JAX MHA, which turns it into segment ids the same way."""
    jax_mha, params, mha, x = _mha_pair()
    kpm = np.ones((B, 48), bool)
    kpm[0, 40:] = False
    kpm[1, 29:] = False
    want = jax.jit(jax_mha.apply)(params, jnp.asarray(x),
                                  key_padding_mask=jnp.asarray(kpm))
    got = mha(torch.from_numpy(x), key_padding_mask=torch.from_numpy(kpm))
    _close(got.detach().numpy(), want)


def test_dropout_seeds_per_step_and_layer():
    """Held difference: the JAX MHA drops with seed 0 at every call, so two
    training calls repeat one mask (equal outputs); the port's trainer
    seeds each step (fold_seed of TrainConfig.seed and the step) and the
    model each layer, so two steps differ while one seed repeats its bits.
    At seed 0 the port's MHA equals the JAX MHA."""
    jax_mha, params, mha, x = _mha_pair(dropout=0.3)
    mha.train()
    run_j = jax.jit(lambda x: jax_mha.apply(params, x, deterministic=False))
    a, b = run_j(jnp.asarray(x)), run_j(jnp.asarray(x) + 0.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tx = torch.from_numpy(x)
    _close(mha(tx, dropout_seed=0).detach().numpy(), a)
    trainer = Trainer(GPTLMHeadModel(
        GPTConfig(**GPT, attn_pdrop=0.1, dtype=torch.float32), device="cpu",
        param_dtype=torch.float32), TrainConfig(seed=7), device="cpu")
    seeds = [trainer.step_seed()]
    trainer.step_idx += 1
    seeds.append(trainer.step_seed())
    assert seeds[0] != seeds[1]
    assert fold_seed(seeds[0], 0) != fold_seed(seeds[0], 1)
    first = mha(tx, dropout_seed=seeds[0])
    torch.testing.assert_close(mha(tx, dropout_seed=seeds[0]), first,
                               rtol=0, atol=0)
    assert not torch.equal(mha(tx, dropout_seed=seeds[1]), first)
