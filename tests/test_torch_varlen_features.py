"""The varlen attention features of the port (ALiBi, attention_chunk,
murmur3 dropout on kernels 6-8) against the JAX package's, on the same
numpy-seeded packed inputs in float32.

On the CPU the port's `flash_attn_varlen_func` runs kernels 6-8's plain
versions with the features; the JAX side runs its varlen Pallas kernels in
interpret mode. Both draw dropout's keep mask in packed coordinates (batch
row 0, the packed query row and key column), which must match in bits.
vLLM's entry takes ALiBi on its packed, paged-prefill and decode routes,
held against the JAX entry. The CUDA kernels are held against the plain
versions on the card by chip_smoke.py's varlen_features phases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.flash_attn_interface import (
    flash_attn_varlen_func as jax_varlen,
)
from flash_attn_tpu.kernels.flash_fwd import _dropout_keep_mask
from flash_attn_tpu.kernels.flash_varlen import (
    make_varlen_metadata as jax_metadata,
)
from flash_attn_tpu.vllm_compat import flash_attn_varlen_func as jax_vllm
from flash_attn_tpu_torch import vllm_compat
from flash_attn_tpu_torch.flash_attn_interface import (
    compile_flash_attn_varlen_func_from_specs,
    flash_attn_varlen_func,
)
from flash_attn_tpu_torch.kernels.common import (
    default_alibi_slopes,
    dropout_keep_mask,
)
from flash_attn_tpu_torch.kernels.flash_varlen import (
    flash_attention_varlen_fwd,
    make_varlen_metadata,
    make_varlen_plan,
)
from flash_attn_tpu_torch.utils.fa_logging import dispatch_counts

H, HK, D = 4, 2, 64
LENS = (37, 64, 91)
# float32 on both sides: they differ in summation order and in the JAX
# kernels' base-2 online softmax and ALiBi term (as tests/test_torch_varlen.py).
RTOL = 1e-4


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


def _inputs(seed, lens_q, lens_k, layout="thd"):
    rng = np.random.default_rng(seed)
    tq, tk = sum(lens_q), sum(lens_k)

    def draw(total, heads):
        x = rng.standard_normal((total, heads, D)).astype(np.float32)
        return x if layout == "thd" else np.ascontiguousarray(
            x.transpose(1, 0, 2))

    return draw(tq, H), draw(tk, HK), draw(tk, HK), draw(tq, H)


# name: (causal, window, layout, seqused_k, features). Each runs the JAX
# forward and its vjp once (interpret mode).
CASES = {
    # Baichuan-style ALiBi, one sequence's used keys below its length.
    "alibi-seqused": (True, (-1, -1), "thd", (37, 60, 91),
                      dict(alibi=True)),
    # Llama-4-style chunked local attention.
    "chunk": (True, (-1, -1), "thd", None, dict(attention_chunk=32)),
    "dropout": (True, (-1, -1), "thd", None,
                dict(dropout_p=0.17, dropout_seed=1234)),
    # Every feature at once with a softcap, head-major.
    "all-softcap-hsd": (True, (40, 0), "hsd", None,
                        dict(alibi=True, attention_chunk=48, dropout_p=0.1,
                             dropout_seed=-7, softcap=30.0)),
}


def _features(spec):
    port = {key: spec[key] for key in ("attention_chunk", "dropout_p",
                                       "dropout_seed", "softcap")
            if key in spec}
    if spec.get("alibi"):
        port["alibi_slopes"] = default_alibi_slopes(H)
    jkw = {key: (jnp.asarray(val.numpy()) if isinstance(val, torch.Tensor)
                 else val) for key, val in port.items()}
    if "dropout_seed" in jkw:
        jkw["dropout_seed"] = jnp.int32(jkw["dropout_seed"])
    return port, jkw


@pytest.mark.parametrize("name", list(CASES))
def test_features_match_jax(name):
    """Forward, LSE and q/k/v gradients through `flash_attn_varlen_func`
    (its autograd core: the backward draws the forward's keep mask from
    the saved seed) against the JAX package's forward and `jax.vjp`."""
    causal, window, layout, used, spec = CASES[name]
    q, k, v, do = _inputs(len(name), LENS, LENS, layout)
    cu = _cu(LENS)
    port, jkw = _features(spec)
    kw = dict(causal=causal, window_size=window, layout=layout)
    used_k = None if used is None else np.asarray(used, np.int32)

    def fwd(q, k, v):
        return jax_varlen(q, k, v, cu, cu, seqused_k=used_k,
                          return_attn_probs=True, **kw, **jkw)[:2]

    @jax.jit
    def fwd_bwd(q, k, v, do):
        (out, lse), vjp = jax.vjp(fwd, q, k, v)
        return out, lse, vjp((do, jnp.zeros_like(lse)))

    out_j, lse_j, grads_j = fwd_bwd(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse, _ = flash_attn_varlen_func(
        tq, tk, tv, torch.from_numpy(cu), torch.from_numpy(cu),
        seqused_k=None if used_k is None else torch.from_numpy(used_k),
        return_attn_probs=True, **kw, **port)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _close(out.detach().numpy(), out_j, "out")
    finite = np.isfinite(np.asarray(lse_j))
    np.testing.assert_array_equal(np.isfinite(lse.numpy()), finite)
    _close(lse.numpy()[finite], np.asarray(lse_j)[finite], "lse")
    for got, want, what in zip(grads, grads_j, ("dq", "dk", "dv")):
        _close(got.numpy(), want, what)


def test_keep_mask_matches_jax_kernel_bits():
    """The keep mask in bits, read back through V = I: three sequences of
    64 keys (= d) each, no causality, so out[r, c] = P Z / (1 - p) / l and
    out's zeros are exactly the dropped entries, in packed rows and keys.
    The JAX varlen kernel's zeros, the port's plain forward's and
    `dropout_keep_mask` at batch row 0 are the same bits, at a negative
    seed."""
    seed, p = -31337, 0.25
    lens_k = (64, 64, 64)
    q, k, _, _ = _inputs(3, LENS, lens_k)
    q, k = 0.1 * q, 0.1 * k
    v = np.tile(np.eye(D, dtype=np.float32)[:, None], (3, HK, 1))
    cu_q, cu_k = _cu(LENS), _cu(lens_k)
    out_j = np.asarray(jax_varlen(*map(jnp.asarray, (q, k, v)), cu_q, cu_k,
                                  dropout_p=p, dropout_seed=jnp.int32(seed)))
    out = flash_attn_varlen_func(*map(torch.from_numpy, (q, k, v, cu_q, cu_k)),
                                 dropout_p=p, dropout_seed=seed).numpy()
    want = np.zeros(out.shape, bool)
    for j in range(3):
        rows = slice(cu_q[j], cu_q[j + 1])
        for h in range(H):
            want[rows, h] = dropout_keep_mask(
                seed, 0, h, int(cu_q[j]), int(cu_k[j]), (LENS[j], D),
                1.0 - p).numpy()
            jax_bits = np.asarray(_dropout_keep_mask(
                jnp.asarray([[seed]], jnp.int32), 0, h, int(cu_q[j]),
                int(cu_k[j]), (LENS[j], D), 1.0 - p))
            np.testing.assert_array_equal(want[rows, h], jax_bits)
    np.testing.assert_array_equal(out_j != 0, want)
    np.testing.assert_array_equal(out != 0, want)
    assert abs(1.0 - want.mean() - p) < 0.02


def test_metadata_chunk_intervals_match_jax():
    """`make_varlen_metadata`'s visible intervals with attention_chunk
    against the JAX planner's, with seqused_q/k (a negative qpos_adj, whose
    chunk start is taken towards -inf), causal, windows and none."""
    lens_q, lens_k = (37, 64, 5, 90), (50, 64, 9, 100)
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    for used_q, used_k, causal, window, chunk in (
            (None, None, True, (-1, -1), 16),
            (None, (41, 64, 3, 77), True, (20, -1), 24),
            ((30, 64, 5, 90), (41, 10, 9, 100), False, (-1, -1), 7),
            (None, None, False, (5, 3), 128)):
        kw = dict(causal=causal, window=window, attention_chunk=chunk)
        uq = None if used_q is None else np.asarray(used_q, np.int32)
        uk = None if used_k is None else np.asarray(used_k, np.int32)
        jm = jax_metadata(cu_q, cu_k, sum(lens_q), sum(lens_k), seqused_q=uq,
                          seqused_k=uk, block_q=8, block_kv=8, xp=np, **kw)
        pm = make_varlen_metadata(
            torch.from_numpy(cu_q), torch.from_numpy(cu_k), sum(lens_q),
            seqused_q=None if uq is None else torch.from_numpy(uq),
            seqused_k=None if uk is None else torch.from_numpy(uk), **kw)
        jlo, jhi = (np.asarray(x)[:sum(lens_q), 0] for x in jm[3:5])
        valid = np.asarray(jm[0])[:sum(lens_q), 0] >= 0
        np.testing.assert_array_equal(pm.qseg.numpy() >= 0, valid)
        np.testing.assert_array_equal(pm.lo.numpy()[valid], jlo[valid])
        np.testing.assert_array_equal(pm.hi.numpy()[valid], jhi[valid])


PAGE = 16


def _vllm_step(seed, qlens, used):
    rng = np.random.default_rng(seed)
    max_pages = -(-max(used) // PAGE)
    npages = len(used) * max_pages + 1
    table = rng.permutation(npages)[: len(used) * max_pages].reshape(
        len(used), max_pages).astype(np.int32)
    return dict(
        q=rng.standard_normal((sum(qlens), H, D)).astype(np.float32),
        k=rng.standard_normal((npages, PAGE, HK, D)).astype(np.float32),
        v=rng.standard_normal((npages, PAGE, HK, D)).astype(np.float32),
        table=table, cu_q=_cu(qlens), used=np.asarray(used, np.int32),
        max_q=max(qlens), max_k=max(used))


# route: (query rows per sequence, keys per sequence, window).
VLLM_ROUTES = {
    "packed": ((37, 64, 91), (37, 64, 91), (-1, -1)),
    "paged-prefill-inkernel": ((1, 30, 1, 12), (50, 100, 7, 40), (24, 0)),
    "paged-decode-alibi": ((1, 1, 1), (20, 35, 70), (-1, -1)),
}


@pytest.mark.parametrize("route", list(VLLM_ROUTES))
def test_vllm_alibi_routes_match_jax(route):
    """vLLM's entry with ALiBi slopes (h,) against the JAX entry on each
    route: packed (kernel 6), a paged prefill step over "phd" pools (kernel
    6 reading the pages; the JAX entry gathers them first) and decode rows
    (kernel 5)."""
    qlens, used, window = VLLM_ROUTES[route]
    slopes = default_alibi_slopes(H)
    dispatch_counts.clear()
    if route == "packed":
        q, k, v, _ = _inputs(11, qlens, used)
        cu = _cu(qlens)
        args = dict(max_seqlen_q=max(qlens), max_seqlen_k=max(used),
                    causal=True, return_softmax_lse=True)
        out_j, lse_j = jax_vllm(*map(jnp.asarray, (q, k, v)),
                                cu_seqlens_q=cu, cu_seqlens_k=cu,
                                alibi_slopes=jnp.asarray(slopes.numpy()),
                                **args)
        out, lse = vllm_compat.flash_attn_varlen_func(
            *map(torch.from_numpy, (q, k, v)), cu_seqlens_q=torch.from_numpy(cu),
            cu_seqlens_k=torch.from_numpy(cu), alibi_slopes=slopes, **args)
        want = "packed"
    else:
        s = _vllm_step(len(route), qlens, used)
        args = dict(max_seqlen_q=s["max_q"], max_seqlen_k=s["max_k"],
                    causal=True, window_size=window, return_softmax_lse=True)
        out_j, lse_j = jax_vllm(
            *map(jnp.asarray, (s["q"], s["k"], s["v"])),
            cu_seqlens_q=s["cu_q"], seqused_k=s["used"],
            block_table=s["table"], alibi_slopes=jnp.asarray(slopes.numpy()),
            **args)
        out, lse = vllm_compat.flash_attn_varlen_func(
            *map(torch.from_numpy, (s["q"], s["k"], s["v"])),
            cu_seqlens_q=torch.from_numpy(s["cu_q"]),
            seqused_k=torch.from_numpy(s["used"]),
            block_table=torch.from_numpy(s["table"]), alibi_slopes=slopes,
            **args)
        want = route
    assert dict(dispatch_counts) == {("varlen", want): 1}
    _close(out.numpy(), out_j, "out")
    _close(lse.numpy(), lse_j, "lse")


def test_compiled_specs_callable_equals_varlen_func():
    """`compile_flash_attn_varlen_func_from_specs`'s callable gives
    `flash_attn_varlen_func`'s answer in bits, refuses tensors of other
    shapes, and refuses has_qv as `qv` is refused."""
    q, k, v, _ = _inputs(5, LENS, LENS)
    cu = torch.from_numpy(_cu(LENS))
    q, k, v = map(torch.from_numpy, (q, k, v))
    specs = dict(total_q=sum(LENS), total_k=sum(LENS), nseq=len(LENS),
                 num_heads=H, num_heads_kv=HK, head_dim=D,
                 dtype=torch.float32, causal=True, window_size=(40, 0),
                 softcap=20.0, device="cpu")
    fn = compile_flash_attn_varlen_func_from_specs(**specs)
    want = flash_attn_varlen_func(q, k, v, cu, cu, causal=True,
                                  window_size=(40, 0), softcap=20.0)
    assert torch.equal(fn(q, k, v, cu, cu), want)
    with pytest.raises(ValueError, match="compiled for"):
        fn(q[:-1], k, v, cu, cu)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compile_flash_attn_varlen_func_from_specs(**dict(specs, has_qv=True))


def test_refused_feature_arguments():
    """What the varlen features refuse: (nseq, h) ALiBi slopes (the JAX
    varlen kernel asserts per-head slopes), dropout on page pools and
    features on the sm80 route of odd page sizes (NotImplementedError,
    naming ROADMAP entries), a plan built for another attention_chunk."""
    q = torch.zeros(8, H, D)
    cu = torch.tensor([0, 8], dtype=torch.int32)
    k = torch.zeros(8, HK, D)
    with pytest.raises(ValueError, match="per-head slopes"):
        flash_attention_varlen_fwd(q, k, k, cu, cu,
                                   alibi_slopes=torch.ones(1, H))
    for page, extra in ((16, dict(dropout_p=0.1)),
                        (12, dict(alibi_slopes=torch.ones(H)))):
        pool = torch.zeros(2, HK, page, D)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            flash_attention_varlen_fwd(
                q, None, None, cu, None, seqused_k=torch.tensor([8]),
                kv_pools=(pool, pool),
                block_table=torch.zeros(1, 1, dtype=torch.int32), **extra)
    plan = make_varlen_plan(cu, cu, causal=True, attention_chunk=4)
    assert plan.attention_chunk == 4
    with pytest.raises(ValueError, match="stale VarlenPlan"):
        flash_attention_varlen_fwd(q, k, k, cu, cu, causal=True, plan=plan,
                                   attention_chunk=8)
