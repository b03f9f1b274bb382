"""Quantized KV caches in the port against the JAX package: 1-byte (int8 and
fp8 e4m3) pools with per-kv-head dequant scales.

The quantizers write the JAX package's bytes; the plain e4m3 upcast is its
bit build; kernel 4's and kernel 5's plain versions (what the wrappers run
on CPU tensors, and what the CUDA kernels are held to on the card by
chip_smoke.py's `quant_kernels`) equal the JAX kernels run in interpret
mode; the engine with `kv_cache_dtype` gives the JAX engine's greedy tokens;
vLLM's entry on 1-byte pools equals the JAX module's. Inputs come from
numpy with a seed; pools are quantized once, in numpy bytes both sides
share."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.common import upcast_e4m3_bits as jax_upcast_e4m3
from flash_attn_tpu.kernels.flash_decode import (
    flash_attention_decode as jax_decode,
)
from flash_attn_tpu.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage as jax_multipage,
)
from flash_attn_tpu.models.gpt import GPTConfig as JaxGPTConfig
from flash_attn_tpu.models.gpt import GPTLMHeadModel as JaxGPTLMHeadModel
from flash_attn_tpu.runtime.engine import EngineConfig as JaxEngineConfig
from flash_attn_tpu.runtime.engine import LLMEngine as JaxLLMEngine
from flash_attn_tpu.runtime.kv_cache import quantize_kv as jax_quantize_kv
from flash_attn_tpu.runtime.kv_cache import (
    quantize_to_cache_dtype as jax_quantize,
)
from flash_attn_tpu.vllm_compat import flash_attn_varlen_func as jax_vllm
from flash_attn_tpu_torch.kernels.common import (
    upcast_e4m3_bits,
    upcast_quant_tile,
)
from flash_attn_tpu_torch.kernels.flash_decode import flash_attention_decode
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage,
)
from flash_attn_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from flash_attn_tpu_torch.runtime.engine import EngineConfig, LLMEngine
from flash_attn_tpu_torch.runtime.kv_cache import (
    QuantPagedKV,
    allocate_fused_paged_kv_cache,
    allocate_kv_cache,
    allocate_paged_kv_cache,
    quantize_kv,
    quantize_to_cache_dtype,
)
from flash_attn_tpu_torch.utils.convert import state_dict_from_flax
from flash_attn_tpu_torch.utils.fa_logging import dispatch_counts
from flash_attn_tpu_torch.utils.testing import attention_ref
from flash_attn_tpu_torch.vllm_compat import flash_attn_varlen_func

B, H, HK, D, PAGE = 2, 4, 2, 64, 8
DTYPES = {"int8": (jnp.int8, torch.int8, np.int8),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn, np.uint8)}
SCALES = np.array([0.05, 0.5], np.float32)  # (hk,) dequant scales
# The JAX kernels round P to bf16 against their bf16-upcast V tiles; the
# port's plain versions keep P in fp32. Outputs agree to 2^-8 of the
# largest output, LSEs (fp32 on both sides) to 1e-4.
OUT_TOL, LSE_TOL = 2.0**-8, 1e-4


def _close(got, want, lse, lse_want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=OUT_TOL * np.abs(want).max())
    lse_want = np.asarray(lse_want)
    finite = np.isfinite(lse_want)
    np.testing.assert_array_equal(np.isfinite(lse), finite)
    np.testing.assert_allclose(np.asarray(lse)[finite], lse_want[finite],
                               rtol=0, atol=LSE_TOL)


def _quant(x, name, scales=SCALES):
    """x (..., hk, d) fp32 quantized by the JAX package, as numpy bytes (a
    uint8 view for e4m3), and the torch tensor of the same bytes."""
    jdt, tdt, _ = DTYPES[name]
    q = np.asarray(jax_quantize(jnp.asarray(x), jnp.asarray(scales), jdt))
    raw = q.view(np.uint8)
    return q, torch.from_numpy(raw.copy()).view(tdt)


def _values(name, shape, seed):
    """fp32 K/V values that stress the quantizer: a spread over the range,
    values past it (clipped), values below e4m3's smallest normal
    (flushed), and int8 ties (x / scale = k + 0.5, rounded half to even)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 20 * SCALES[:, None]
    flat = x.reshape(-1, HK, x.shape[-1])
    flat[0, :, :4] = [1e4, -1e4, 3e2, -3e2]
    flat[1, :, :4] = SCALES[:, None] * np.array([1e-3, -3e-3, 2.0**-8, 2.0**-7])
    flat[2, :, :4] = SCALES[:, None] * np.array([0.5, 1.5, 2.5, -2.5])
    return x


@pytest.mark.parametrize("name", list(DTYPES))
def test_quantize_and_upcast_match_jax(name):
    """quantize_to_cache_dtype and quantize_kv write the JAX bytes (and
    scales) for out-of-range values, subnormals and ties; the plain upcast
    is exact: every int8 value as itself, and for e4m3 the JAX bit build
    (upcast_e4m3_bits) equals torch's conversion on every byte pattern but
    the two NaNs, 0x7F and 0xFF, which the bit build decodes to 480 and
    which a quantizer never writes."""
    jdt, tdt, _ = DTYPES[name]
    x = _values(name, (3, 5, HK, D), seed=1)
    want, got = _quant(x, name)
    t = quantize_to_cache_dtype(torch.from_numpy(x), torch.from_numpy(SCALES),
                                tdt)
    assert torch.equal(t.view(torch.uint8), got.view(torch.uint8))
    k_layout = x.transpose(0, 2, 1, 3)  # (b, hk, s, d): the head on axis 1
    jq = jax_quantize_kv(jnp.asarray(k_layout), jnp.asarray(2 * k_layout),
                         dtype=jdt, head_axis=1)
    tq = quantize_kv(torch.from_numpy(k_layout), torch.from_numpy(2 * k_layout),
                     dtype=tdt, head_axis=1)
    for j, p in zip(jq, tq):
        j = np.asarray(j)
        if j.dtype.itemsize == 1:
            assert np.array_equal(j.view(np.uint8), p.view(torch.uint8).numpy())
        else:
            assert np.array_equal(j, p.numpy())
    if name == "int8":
        vals = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
        assert torch.equal(upcast_quant_tile(vals).float(), vals.float())
        return
    bits = np.array([b for b in range(256) if b & 0x7F != 0x7F], np.uint8)
    jax_bf16 = np.asarray(jax_upcast_e4m3(jnp.asarray(bits).view(jdt))
                          .astype(jnp.float32))
    e4m3 = torch.from_numpy(bits).view(torch.float8_e4m3fn)
    np.testing.assert_array_equal(upcast_e4m3_bits(e4m3).float().numpy(),
                                  jax_bf16)
    np.testing.assert_array_equal(upcast_quant_tile(e4m3).float().numpy(),
                                  jax_bf16)


def _paged(name, sq, lens, seed, fused):
    """Seeded paged inputs on a 1-byte pool: (q, pools (torch), pools
    (numpy bytes in the JAX dtype), table, lens)."""
    rng = np.random.default_rng(seed)
    max_pages = -(-max(lens) // PAGE)
    npages = B * max_pages + 1
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    table = rng.permutation(npages - 1)[: B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    k = _values(name, (npages, PAGE, HK, D), seed + 1)
    v = _values(name, (npages, PAGE, HK, D), seed + 2)[..., ::-1].copy()
    (kj, kt), (vj, vt) = _quant(k, name), _quant(v, name)
    kj, vj = (a.transpose(0, 2, 1, 3) for a in (kj, vj))  # (np, hk, page, d)
    kt, vt = (a.transpose(1, 2) for a in (kt, vt))
    if fused:  # K at [:D], V at [128:128 + D]
        pad = ((0, 0),) * 3 + ((0, 128 - D),)
        kj = np.concatenate([np.pad(kj, pad), np.pad(vj, pad)], axis=-1)
        kt = torch.from_numpy(kj.view(np.uint8).copy()).view(kt.dtype)
        vj = vt = None
    return q, (kt, vt), (kj, vj), table, np.asarray(lens, np.int32)


MULTIPAGE = {"int8-fused": ("int8", True, 1, -1),
             "int8-split": ("int8", False, 3, 10),
             "fp8-fused": ("fp8", True, 3, -1),
             "fp8-split": ("fp8", False, 1, 10)}


@pytest.mark.parametrize("case", list(MULTIPAGE))
def test_multipage_quant_matches_jax(case):
    """Kernel 4's plain version on 1-byte fused and split pools with (hk,)
    descales equals the JAX multipage kernel (interpret mode), decode steps
    (sq 1) and chunks (sq 3), with and without a window."""
    name, fused, sq, window = MULTIPAGE[case]
    q, (kt, vt), (kj, vj), table, lens = _paged(name, sq, (29, 13 + sq), 5,
                                                fused)
    kw = dict(window_left=window, fused_kv_dim=D if fused else 0)
    out_j, lse_j = jax_multipage(
        jnp.asarray(q), jnp.asarray(kj), None if fused else jnp.asarray(vj),
        jnp.asarray(lens), jnp.asarray(table), k_scale=jnp.asarray(SCALES),
        v_scale=jnp.asarray(SCALES[::-1].copy()), **kw)
    out, lse = flash_attention_decode_multipage(
        torch.from_numpy(q), kt, vt, torch.from_numpy(lens),
        torch.from_numpy(table), k_scale=torch.from_numpy(SCALES),
        v_scale=torch.from_numpy(SCALES[::-1].copy()), **kw)
    _close(out.numpy(), out_j, lse.numpy(), lse_j)


def _dequant_rows(pool, table, lens, scale):
    """(b, smax, hk, d) fp32: each batch row's pages upcast and times its
    (b, hk) descale, zero past its length."""
    x = upcast_quant_tile(pool[table.long()]).float()  # (b, mp, hk, page, d)
    x = x.permute(0, 1, 3, 2, 4).reshape(B, -1, HK, D)
    keep = torch.arange(x.shape[1])[None] < lens[:, None]
    return x * keep[..., None, None] * scale[:, None, :, None]


def test_batched_descales_match_oracle():
    """(b, hk) descales, vLLM's layout (the JAX multipage wrapper takes
    (hk,) only and fails on them: a held difference, ROADMAP §3): kernel 4's
    plain version against attention_ref on the dequantized cache, and
    kernel 5's plain version on the same paged pool, which routing sends
    there with a sink, at the same values."""
    q, (kt, vt), _, table, lens = _paged("fp8", 2, (27, 19), 9, False)
    kd = torch.tensor([[0.5, 2.0], [1.5, 0.25]])
    vd = torch.tensor([[3.0, 0.5], [0.75, 1.25]])
    t_lens, t_table, tq = (torch.from_numpy(x) for x in (lens, table, q))
    out, lse = flash_attention_decode_multipage(tq, kt, vt, t_lens, t_table,
                                                k_scale=kd, v_scale=vd)
    k = _dequant_rows(kt, t_table, t_lens, torch.ones(B, HK))
    v = _dequant_rows(vt, t_table, t_lens, torch.ones(B, HK))
    mask = torch.arange(k.shape[1])[None] < t_lens[:, None]
    want, _ = attention_ref(tq, k, v, key_padding_mask=mask, causal=True,
                            k_descale=kd, v_descale=vd)
    # fp32 on both sides, the descales applied at other points (on the
    # scores and the output here, on K and V there): 1e-5 of the largest
    # output.
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(out, want, rtol=0, atol=tol)
    out5, lse5 = flash_attention_decode(
        tq, kt, vt, t_lens, block_table=t_table, k_scale=kd, v_scale=vd,
        sink=torch.full((H,), -1e4))
    torch.testing.assert_close(out5, out, rtol=0, atol=tol)
    torch.testing.assert_close(lse5, lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(DTYPES))
def test_general_decode_quant_matches_jax(name):
    """Kernel 5's plain version on a 1-byte contiguous (b, hk, smax, d)
    cache with (b, hk) descales, sq 2 and a window, equals the JAX general
    decode (interpret mode; it upcasts a contiguous fp8 cache in one pass
    before its kernel, the port in-kernel)."""
    rng = np.random.default_rng(12)
    smax, sq, lens = 48, 2, np.array([41, 30], np.int32)
    q = rng.standard_normal((B, sq, H, D)).astype(np.float32)
    (kj, kt), (vj, vt) = (
        _quant(_values(name, (B, smax, HK, D), s), name) for s in (13, 14))
    kj, vj = (a.transpose(0, 2, 1, 3) for a in (kj, vj))
    kt, vt = (a.transpose(1, 2) for a in (kt, vt))
    kd = rng.uniform(0.5, 2.0, (B, HK)).astype(np.float32)
    vd = rng.uniform(0.5, 2.0, (B, HK)).astype(np.float32)
    out_j, lse_j = jax_decode(
        jnp.asarray(q), jnp.asarray(kj), jnp.asarray(vj), jnp.asarray(lens),
        k_scale=jnp.asarray(kd), v_scale=jnp.asarray(vd), window_left=20)
    t = torch.from_numpy
    out, lse = flash_attention_decode(t(q), kt, vt, t(lens), k_scale=t(kd),
                                      v_scale=t(vd), window_left=20)
    _close(out.numpy(), out_j, lse.numpy(), lse_j)


FIELDS = dict(
    vocab_size=97, n_positions=0, n_embd=64, n_layer=2, n_head=4, n_head_kv=2,
    rotary_emb_fraction=1.0, rms_norm=True, activation_function="swiglu",
    qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
    mlp_fc2_bias=False, tie_word_embeddings=False, window_size=(11, -1),
)
ENGINE = dict(max_batch_size=2, page_size=8, num_pages=16, max_pages_per_seq=8,
              prefill_chunk=8, max_seqlen=64)
# int8 at a calibrated scale (about amax / 127 of this model's K/V), fp8
# at 1.0, as the JAX engine's notes recommend; fused pools (the default)
# for int8, split ones for fp8.
ENGINE_QUANT = {"int8": dict(kv_cache_dtype="int8", kv_cache_scale=0.05),
                "fp8": dict(kv_cache_dtype="fp8", kv_cache_scale=1.0,
                            fused_kv_pages=False)}


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
def jax_model():
    model = JaxGPTLMHeadModel(JaxGPTConfig(**FIELDS, dtype=jnp.float32))
    params = _draw_params(model, 0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, n).tolist() for n in (21, 5)]
    return model, params, prompts


@pytest.mark.parametrize("name", list(ENGINE_QUANT))
def test_engine_quant_matches_jax_engine(jax_model, name):
    """LLMEngine on 1-byte pools gives the JAX engine's greedy tokens (2
    layers, width 64, 4 new tokens), and its pools are 1-byte with (hk,)
    scales."""
    model, params, prompts = jax_model
    want = JaxLLMEngine(model, params, JaxEngineConfig(
        **ENGINE, **ENGINE_QUANT[name])).generate(prompts, 4)
    config = GPTConfig(**FIELDS, dtype=torch.float32)
    port = GPTLMHeadModel(config, device="cpu")
    port.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, params), config))
    engine = LLMEngine(port, EngineConfig(**ENGINE, **ENGINE_QUANT[name]),
                       device="cpu")
    assert engine.generate(prompts, 4) == want
    entry = engine.caches[0]
    assert isinstance(entry, QuantPagedKV)
    assert entry.k.dtype == DTYPES[name][1] and entry.fused == (name == "int8")
    assert entry.k_scale.shape == (2,)


def test_engine_quant_refuses_mla_alibi():
    """The JAX engine's eligibility errors, ValueErrors raised before any
    pool is allocated: MLA, ALiBi, a V head dim other than the head dim,
    and an unknown kv_cache_dtype."""
    cfg = EngineConfig(**ENGINE, kv_cache_dtype="int8")

    def model(**fields):
        mc = dict(attn_type="mha", use_alibi=False, resolved_head_dim=64)
        return types.SimpleNamespace(
            config=types.SimpleNamespace(**dict(mc, **fields)))

    for fields, match in ((dict(attn_type="mla"), "MLA"),
                          (dict(use_alibi=True), "ALiBi"),
                          (dict(v_head_dim=32), "v_head_dim")):
        with pytest.raises(ValueError, match=match):
            LLMEngine(model(**fields), cfg, device="cpu")
    with pytest.raises(ValueError, match="int4"):
        LLMEngine(model(), EngineConfig(**ENGINE, kv_cache_dtype="int4"),
                  device="cpu")


VLLM = {
    # (dtype, q lengths, contexts, window, descales): decode-only steps go
    # to kernel 4; the mixed step to the dequant pass and kernel 6.
    "decode-fp8": ("fp8", (1, 1), (20, 35), (-1, -1), "hk"),
    "mixed-int8": ("int8", (1, 30, 1, 12), (50, 100, 7, 40), (24, 0), "nseq"),
    "qdescale-fp8": ("fp8", (1, 1), (26, 17), (-1, -1), "q"),
}


@pytest.mark.parametrize("case", list(VLLM))
def test_vllm_quant_routes_match_jax(case):
    """vllm_compat.flash_attn_varlen_func on 1-byte "phd" pools equals the
    JAX module's: decode-only steps (kernel 4, (hk,) descales, and
    (nseq, hk) ones expanded from them giving the same bits), the mixed
    step with (nseq, hk) descales (the dequant pass into a bf16 scratch
    pool, then kernel 6), and q_descale folded into the K descale."""
    name, qlens, used, window, how = VLLM[case]
    rng = np.random.default_rng(len(case))
    nseq = len(qlens)
    max_pages = -(-max(used) // 16)
    npages = nseq * max_pages + 1
    table = rng.permutation(npages)[: nseq * max_pages].reshape(
        nseq, max_pages).astype(np.int32)
    cu_q = np.concatenate([[0], np.cumsum(qlens)]).astype(np.int32)
    q = rng.standard_normal((int(cu_q[-1]), H, D)).astype(np.float32)
    (kj, kt), (vj, vt) = (
        _quant(_values(name, (npages, 16, HK, D), s), name) for s in (21, 22))
    desc = {"k_descale": SCALES, "v_descale": SCALES[::-1].copy()}
    if how == "nseq":
        desc = {n: rng.uniform(0.5, 2.0, (nseq, HK)).astype(np.float32)
                for n in desc}
    if how == "q":
        desc["q_descale"] = np.array([2.0, 0.5], np.float32)
    args = dict(max_seqlen_q=max(qlens), cu_seqlens_q=cu_q,
                max_seqlen_k=max(used), seqused_k=np.asarray(used, np.int32),
                causal=True, window_size=window, block_table=table,
                return_softmax_lse=True)
    out_j, lse_j = jax_vllm(jnp.asarray(q), jnp.asarray(kj), jnp.asarray(vj),
                            **args, **{n: jnp.asarray(x)
                                       for n, x in desc.items()})
    t = torch.from_numpy
    targs = {n: t(x) if isinstance(x, np.ndarray) else x
             for n, x in args.items()}
    dispatch_counts.clear()
    out, lse = flash_attn_varlen_func(t(q), kt, vt, **targs,
                                      **{n: t(x) for n, x in desc.items()})
    _close(out.numpy(), out_j, lse.numpy(), lse_j)
    route = ("paged-prefill-dequant" if max(qlens) > 4 else "paged-decode")
    assert dict(dispatch_counts) == {("varlen", route): 1}
    if how == "hk":  # vLLM's (nseq, hk) layout of one per-layer scale
        wide = {n: t(x).expand(nseq, HK) for n, x in desc.items()}
        out2, lse2 = flash_attn_varlen_func(t(q), kt, vt, **targs, **wide)
        assert torch.equal(out2, out) and torch.equal(lse2, lse)


def test_allocators_default_to_the_card():
    """The cache allocators resolve their device as every entry point does:
    the card unless device names another, and without one they raise rather
    than allocate on the CPU. device="cpu" allocates there, in any dtype,
    1-byte ones included."""
    shapes = ((allocate_kv_cache, (1, 8, HK, D)),
              (allocate_paged_kv_cache, (4, PAGE, HK, D)),
              (allocate_fused_paged_kv_cache, (4, PAGE, HK, D)))
    for alloc, args in shapes:
        if torch.cuda.is_available():
            got = alloc(*args)
            got = got[0] if isinstance(got, tuple) else got
            assert got.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                alloc(*args)
        got = alloc(*args, dtype=torch.float8_e4m3fn, device="cpu")
        got = got[0] if isinstance(got, tuple) else got
        assert got.device.type == "cpu" and got.dtype == torch.float8_e4m3fn
    fused = allocate_fused_paged_kv_cache(4, PAGE, HK, D, dtype=torch.int8,
                                          device="cpu")
    assert fused.shape == (4, HK, PAGE, 256)
    assert QuantPagedKV(fused, None, torch.ones(HK), torch.ones(HK)).fused
