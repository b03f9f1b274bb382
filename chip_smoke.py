"""Smoke run of flash_attn_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (into build/kernels/), then:

  1. env      torch/CUDA versions, the card's name and power limit, build time;
  2. kernel   the paged-decode kernel against its plain PyTorch version at the
              serving path's shapes (Mistral-7B widths), with CUDA-event times
              of the kernel, the plain version, a PyTorch library yardstick,
              and the card's bound for the same work;
  3. attn_kernels  the flash forward, dK/dV and dQ kernels likewise, at the
              GPT-2-medium training shape, the Mistral-7B shape (GQA, window
              4095), a short window (127), a softcap, and rows that see
              nothing; the backward twice for equal bits; then attn_fault:
              the window cases with the kernels handed a window one column
              wider, which every kernel's check must catch;
     varlen_kernels, varlen_fault, varlen_train, vllm: kernels 6-8 and
              vLLM's per-layer calls (see each function);
     decode_kernels  the general decode kernel (kernel 5) against its plain
              version at Mistral-7B widths: decode, generate's 4500-token
              prefill, batch index, leftpad with a window, ALiBi, sinks,
              chunks, sink tokens, softcap, non-causal, paged "phd" views,
              TinyLlama's d 64, and a vLLM step with s_aux sinks at
              gpt-oss-20b widths; then decode_fault: a window, leftpad or
              chunk off by one, which every check must catch;
  4. logits   a Mistral-7B-v0.1-width model (random seeded weights, bf16, all
              32 layers): chunked prefill of a ~4500-token prompt and 8 decode
              steps through the engine's own forward, logits held against a
              plain fp32 forward under the 2x-bf16-eager contract;
  5. serve    LLMEngine.generate on 8 requests, tokens/s, peak memory, and
              proof that every attention call went through the kernel;
  6. profile  torch.profiler device time by kernel over the prefill and the
              decode steps of 8 more requests, beside the host wall time;
     generate the same model's generate() over contiguous caches (kernel 5):
              batch 4, 4500-token prompts, 32 new tokens, scores held against
              an fp32 forward, launches counted, tokens/s;
     speculative  decode_speculative with a TinyLlama-1.1B-width draft,
              tokens equal to greedy generate's;
  7. train_grad  one loss and gradient of GPT-2-medium (configs/gpt2m-synth.yaml,
              full depth, fp32 weights, bf16 compute) through the kernels,
              held against the plain model in fp32 under the 2x-bf16-eager
              contract;
  8. train    training.run.main on configs/gpt2m-synth.yaml for 20 steps:
              falling loss, tokens/s, MFU, peak memory, and the kernels'
              launches = layers x steps (x 2 for the forward under remat);
  9. profile  device time by kernel over one training step.

One JSON line per phase; then the {"kernels": [...]} line, the card's name
and power limit, and {"ok": true, "device": {...}} as the last line. Any
failed check raises, so the exit code is non-zero and no result is printed.
It needs a CUDA device and the rest of this repository beside it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flash_attn_tpu_torch.flash_attn_interface import (  # noqa: E402
    flash_attn_varlen_func,
)
from flash_attn_tpu_torch.kernels import _build  # noqa: E402
from flash_attn_tpu_torch.kernels.flash_bwd import (  # noqa: E402
    _bwd_dkv_ref,
    _bwd_dq_ref,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from flash_attn_tpu_torch.kernels.common import (  # noqa: E402
    default_alibi_slopes,
    normalize_window,
    visible_mask,
)
from flash_attn_tpu_torch.kernels.flash_decode import (  # noqa: E402
    flash_attention_decode_general,
    flash_attention_decode_ref,
    visible_columns,
)
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (  # noqa: E402
    flash_attention_decode_multipage,
    flash_attention_decode_multipage_ref,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (  # noqa: E402
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from flash_attn_tpu_torch.kernels.flash_varlen import (  # noqa: E402
    _varlen_dkv_ref,
    _varlen_dq_ref,
    flash_attention_varlen_bwd_dkv,
    flash_attention_varlen_bwd_dq,
    flash_attention_varlen_fwd,
    flash_attention_varlen_fwd_ref,
    plan_mismatch,
    varlen_window,
)
from flash_attn_tpu_torch.losses.cross_entropy import (  # noqa: E402
    cross_entropy_loss,
)
from flash_attn_tpu_torch.models.adapters import (  # noqa: E402
    llama_config_to_gpt_config,
)
from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel  # noqa: E402
from flash_attn_tpu_torch.runtime.engine import (  # noqa: E402
    EngineConfig,
    LLMEngine,
)
from flash_attn_tpu_torch.runtime.generation import (  # noqa: E402
    decode,
    decode_speculative,
    make_apply_fn,
)
from flash_attn_tpu_torch.runtime.kv_cache import (  # noqa: E402
    allocate_fused_paged_kv_cache,
    allocate_paged_kv_cache,
)
from flash_attn_tpu_torch.training import run as train_run  # noqa: E402
from flash_attn_tpu_torch.training.run import load_config  # noqa: E402
from flash_attn_tpu_torch.training.trainer import Trainer  # noqa: E402
from flash_attn_tpu_torch.utils.fa_logging import dispatch_counts  # noqa: E402
from flash_attn_tpu_torch.utils.testing import (  # noqa: E402
    gpt_forward_ref,
    gpt_loss_ref,
)
from flash_attn_tpu_torch.vllm_compat import (  # noqa: E402
    flash_attn_varlen_func as vllm_flash_attn_varlen_func,
)
from flash_attn_tpu_torch.vllm_compat import (  # noqa: E402
    get_scheduler_metadata,
)

# Mistral-7B-v0.1, https://huggingface.co/mistralai/Mistral-7B-v0.1 config.json
MISTRAL_7B = dict(
    hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, intermediate_size=14336, vocab_size=32000,
    rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=4096,
    tie_word_embeddings=False,
)
# TinyLlama-1.1B, https://huggingface.co/TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T
# config.json: the speculative phase's draft model.
TINYLLAMA_1B = dict(
    hidden_size=2048, num_hidden_layers=22, num_attention_heads=32,
    num_key_value_heads=4, intermediate_size=5632, vocab_size=32000,
    rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
)
ENGINE = EngineConfig(max_batch_size=8, page_size=16, num_pages=4096,
                      max_pages_per_seq=384, prefill_chunk=256, max_seqlen=8192)
WINDOW = MISTRAL_7B["sliding_window"] - 1  # window_size (4095, -1)

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Kernel vs plain fp32: the kernel rounds P to bf16/fp16 for the PV product
# and its output to bf16 (2^-9 relative); the LSE stays fp32.
OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3
# Logits: port error vs fp32 <= 2 x (bf16 eager error vs fp32) + a floor of
# 1% of the largest fp32 logit, for the bf16 rounding of the logits.
LOGIT_FLOOR_FRACTION = 1e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event times of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


# -- phase 2: kernel vs plain ------------------------------------------------

# (name, sq, fused, page, window_left, softcap, permuted table, phd): phd
# pools are vLLM's (npages, page, hk, d), handed to the kernel as head-major
# views (the vllm_compat decode route), not copied.
CASES = [
    ("decode", 1, True, 16, WINDOW, 0.0, True, False),    # the engine's decode
    ("decode-split", 1, False, 16, -1, 0.0, True, False),
    ("decode-page128-contiguous", 1, True, 128, -1, 0.0, False, False),
    ("decode-softcap30", 1, True, 16, -1, 30.0, True, False),
    ("prefill", 256, True, 16, WINDOW, 0.0, True, False),  # an engine prefill chunk
    ("prefill-split-page128", 256, False, 128, -1, 0.0, True, False),
    ("decode-phd-view", 1, False, 16, WINDOW, 0.0, True, True),
]
B, H, HK, D = 8, 32, 8, 128
MAX_CTX = 6000


def bound(seqlens, sq, window, table_shape):
    """Least time (ms) the card needs for one call, and what bounds it:
    visible K/V rows read once, q/out/lse/table moved once, and 4*d flops
    per visible (query head, query token, column)."""
    tokens, pairs = 0, 0
    for L in seqlens:
        pos = L - sq + np.arange(sq)
        lo = np.maximum(pos - window, 0) if window >= 0 else np.zeros(sq, int)
        pairs += int(np.maximum(np.minimum(pos + 1, L) - lo, 0).sum())
        tokens += max(0, L - int(lo[0]))
    nbytes = (tokens * HK * 2 * D * 2 + 2 * B * sq * H * D * 2 + B * H * sq * 4
              + 4 * table_shape[0] * table_shape[1] + 4 * B)
    flops = 4 * D * H * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_case(name, sq, fused, page, window, softcap, permuted, phd, seed):
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    seqlens = rng.randint(max(sq, 1), MAX_CTX + 1, B)
    seqlens[0] = max(seqlens[0], 4500)  # one context past the 4096 window
    max_pages = -(-MAX_CTX // page)
    npages = B * max_pages + 1
    ids = rng.permutation(npages - 1) if permuted else np.arange(npages - 1)
    table = torch.from_numpy(ids[: B * max_pages].reshape(B, max_pages)
                             .astype(np.int32)).to(dev)
    lens = torch.from_numpy(seqlens.astype(np.int32)).to(dev)
    if fused:
        k_pages = allocate_fused_paged_kv_cache(npages, page, HK, D, device=dev)
        v_pages = None
    elif phd:
        k_pages, v_pages = (
            torch.empty(npages, page, HK, D, device=dev, dtype=torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
        v_pages.normal_(generator=gen)
    else:
        k_pages, v_pages = allocate_paged_kv_cache(npages, page, HK, D, device=dev)
        v_pages.normal_(generator=gen)
    k_pages.normal_(generator=gen)
    q = torch.randn(B, sq, H, D, generator=gen, device=dev, dtype=torch.bfloat16)
    kw = dict(fused_kv_dim=D if fused else 0, window_left=window, softcap=softcap)
    args = (q, k_pages, v_pages, lens, table)

    out, lse = flash_attention_decode_multipage(*args, **kw)
    torch.cuda.synchronize()
    up = [None if a is None else a.float() if a.is_floating_point() else a
          for a in args]
    ref_out, ref_lse = flash_attention_decode_multipage_ref(*up, **kw)
    err = (out.float() - ref_out).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = bool((err <= OUT_ATOL + OUT_RTOL * ref_out.abs()).all()
              and lse_err <= LSE_ATOL and torch.isfinite(out).all())
    del up, ref_out, ref_lse

    ms = cuda_ms(lambda: flash_attention_decode_multipage(*args, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_decode_multipage_ref(*args, **kw),
                       reps=20, warmup=1)
    library_ms = None
    if softcap == 0.0:
        # Yardstick: one PyTorch call on K/V already gathered contiguous (no
        # PyTorch call reads a paged pool); the port never calls it.
        if fused:
            kc, vc = k_pages[..., :D], k_pages[..., 128:128 + D]
        else:
            kc, vc = k_pages, v_pages
        tl = table.long()
        kg = kc[tl].permute(0, 2, 1, 3, 4).reshape(B, HK, -1, D).contiguous()
        vg = vc[tl].permute(0, 2, 1, 3, 4).reshape(B, HK, -1, D).contiguous()
        cols = torch.arange(kg.shape[2], device=dev)[None, None]
        pos = (lens.long()[:, None, None] - sq
               + torch.arange(sq, device=dev)[None, :, None])
        mask = (cols < lens.long()[:, None, None]) & (cols <= pos)
        if window >= 0:
            mask &= cols >= pos - window
        mask = mask[:, None]
        qt = q.transpose(1, 2)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True))
        del kg, vg, mask
    bound_ms, bound_by = bound(seqlens.tolist(), sq, window, tuple(table.shape))
    result = dict(
        phase="kernel", kernel="paged_decode", case=name, b=B, sq=sq, h=H,
        hk=HK, d=D, page=page, fused=fused, phd_view=phd, window_left=window,
        softcap=softcap, permuted=permuted, max_ctx=int(seqlens.max()),
        max_abs_err=float(err.max()), lse_max_abs_err=lse_err,
        tolerance=f"|out-ref| <= {OUT_ATOL} + {OUT_RTOL}|ref|, |lse-ref| <= {LSE_ATOL}",
        ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by,
    )
    emit(result)
    check(ok, f"paged_decode case {name} disagrees with its plain version")
    return result


# -- phase: attn_kernels (flash fwd, dK/dV and dQ vs plain) ----------------

# (name, b, h, hk, sq, sk, d, causal, window_size, softcap, dtype)
ATTN_CASES = [
    ("gpt2m", 8, 16, 16, 2048, 2048, 64, True, (-1, -1), 0.0, torch.bfloat16),
    ("mistral-window", 1, 32, 8, 8192, 8192, 128, True, (WINDOW, -1), 0.0,
     torch.bfloat16),
    # A short window, so the edge columns carry weight (P ~ 1/128).
    ("window127-gqa", 2, 16, 4, 2048, 2048, 64, True, (127, -1), 0.0,
     torch.bfloat16),
    ("softcap30-fp16", 2, 8, 2, 1000, 1000, 64, True, (-1, -1), 30.0,
     torch.float16),
    ("noncausal-sq1000-sk3000", 2, 8, 8, 1000, 3000, 128, False, (-1, -1),
     0.0, torch.bfloat16),
    ("causal-sq3000-sk1000", 1, 4, 2, 3000, 1000, 64, True, (-1, -1), 0.0,
     torch.bfloat16),
]
# Kernel vs plain fp32 on the same bf16/fp16 inputs, element by element:
#   |x - ref| <= RTOL |ref| + ROW_ATOL rms(ref's row) + FLOOR max|ref|,
# a row being the d values of one query row (out, dQ) or one key row (dK,
# dV); for delta (b, h, sq), one head's sequence. RTOL covers the 16-bit
# rounding of the result itself (at most 2^-8 for bf16). ROW_ATOL covers
# the 16-bit rounding of P (forward) and of P and dS (backward) before
# their products: a sum of such terms is off by about 2^-9 x the root sum of
# squares of its terms, i.e. a few thousandths of the row's rms, and about
# 5 sigma of that at the largest of 16 M elements. FLOOR lets a row whose
# exact value is 0 (a row that sees nothing, the first causal row's dQ)
# pass rounding noise. The LSE stays fp32: |lse - ref| <= LSE_TOL.
ATTN_RTOL, ATTN_ROW_ATOL, ATTN_FLOOR, ATTN_LSE_TOL = 1e-2, 3e-2, 1e-5, 1e-3
ATTN_TOLERANCE = (f"|x-ref| <= {ATTN_RTOL}|ref| + {ATTN_ROW_ATOL} rms(ref "
                  f"row over d) + {ATTN_FLOOR} max|ref|; |lse-ref| <= "
                  f"{ATTN_LSE_TOL}")


def visible_pairs(sq, sk, causal, window_size):
    """Visible (query row, key column) pairs of one head."""
    left, right = normalize_window(window_size, causal)
    diag = np.arange(sq) + sk - sq
    lo = np.maximum(diag - left, 0) if left >= 0 else np.zeros(sq, np.int64)
    hi = np.minimum(diag + right, sk - 1) if right >= 0 else np.full(sq, sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attn_bound(flops_per_pair_per_d, nbytes, b, h, d, pairs):
    flops = flops_per_pair_per_d * d * b * h * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def held(got, ref):
    """How `got` stands against `ref` under the tolerance above: the worst
    ratio of error to limit (<= 1 passes), the max abs error, and the
    median |ref| beside the median limit."""
    got, ref = got.float(), ref.float()
    mag = ref.abs()
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    limit = (ATTN_RTOL * mag + ATTN_ROW_ATOL * rms
             + ATTN_FLOOR * mag.max()).clamp_min(1e-30)
    err = (got - ref).abs()
    return dict(err_over_limit=float((err / limit).max()),
                max_abs_err=float(err.max()), median_abs_ref=float(mag.median()),
                median_limit=float(limit.median()))


def attn_compare(b, h, hk, sq, sk, d, causal, window, softcap, dtype, seed,
                 kernel_window=None):
    """Runs the three kernels and their plain versions on the same seeded
    inputs; returns (result, kernel kwargs, the inputs). `kernel_window`
    hands the kernels another window than the plain versions (a planted
    fault)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=dev, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    kw = dict(causal=causal, window_size=window, softcap=softcap)
    kkw = dict(kw, window_size=kernel_window or window)

    out, lse = flash_attention_fwd(q, k, v, **kkw)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                               **kw)
    finite = torch.isfinite(ref_lse)
    empty_rows = int((~finite).sum())
    lse_err = float((lse - ref_lse)[finite].abs().max()) if finite.any() else 0.0
    result = dict(empty_rows=empty_rows, out=held(out, ref_out),
                  lse_max_abs_err=lse_err)
    fwd_ok = bool(result["out"]["err_over_limit"] <= 1
                  and torch.equal(finite, torch.isfinite(lse))
                  and lse_err <= ATTN_LSE_TOL and torch.isfinite(out).all()
                  and (out.float()[~finite] == 0).all())
    del ref_out
    # The backward kernels and their plain versions on the same inputs: the
    # plain forward's LSE and, for dK/dV, the plain dQ's delta.
    dq, delta = flash_attention_bwd_dq(q, k, v, do, ref_lse, **kkw)
    dq2, delta2 = flash_attention_bwd_dq(q, k, v, do, ref_lse, **kkw)
    up = tuple(x.float() for x in (q, k, v, do)) + (ref_lse,)
    ref_dq, ref_delta = _bwd_dq_ref(*up, **kw)
    args = (q, k, v, do, ref_lse, ref_delta)
    dk, dv = flash_attention_bwd_dkv(*args, **kkw)
    dk2, dv2 = flash_attention_bwd_dkv(*args, **kkw)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(x, y) for x, y in
                        ((dk, dk2), (dv, dv2), (dq, dq2), (delta, delta2)))
    del dk2, dv2, dq2, delta2
    result.update(dq=held(dq, ref_dq), delta=held(delta, ref_delta))
    del ref_dq
    ref_dk, ref_dv = _bwd_dkv_ref(*up, ref_delta, **kw)
    result.update(dk=held(dk, ref_dk), dv=held(dv, ref_dv))
    del ref_dk, ref_dv, up
    grads_finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    result.update(
        fwd_ok=fwd_ok,
        dq_ok=result["dq"]["err_over_limit"] <= 1
        and result["delta"]["err_over_limit"] <= 1,
        dkv_ok=max(result["dk"]["err_over_limit"],
                   result["dv"]["err_over_limit"]) <= 1,
        bwd_bitwise_deterministic=deterministic, grads_finite=grads_finite)
    return result, kw, args


def attn_case(name, b, h, hk, sq, sk, d, causal, window, softcap, dtype,
              seed):
    checked, kw, args = attn_compare(b, h, hk, sq, sk, d, causal, window,
                                     softcap, dtype, seed)
    q, k, v = args[:3]
    result = dict(
        phase="attn_kernels", case=name, b=b, h=h, hk=hk, sq=sq, sk=sk, d=d,
        causal=causal, window_size=list(window), softcap=softcap,
        dtype=str(dtype).split(".")[-1], **checked, tolerance=ATTN_TOLERANCE,
        ok=(checked["fwd_ok"] and checked["dq_ok"] and checked["dkv_ok"]
            and checked["bwd_bitwise_deterministic"]
            and checked["grads_finite"]),
    )
    pairs = visible_pairs(sq, sk, causal, window)
    el = q.element_size()
    qb, kvb, stats = b * h * sq * d * el, b * hk * sk * d * el, b * h * sq * 4
    result.update(
        fwd_ms=cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
        dkv_ms=cuda_ms(lambda: flash_attention_bwd_dkv(*args, **kw)),
        dq_ms=cuda_ms(lambda: flash_attention_bwd_dq(*args[:5], **kw)),
        fwd_plain_ms=cuda_ms(lambda: flash_attention_fwd_ref(q, k, v, **kw),
                             reps=20, warmup=1),
        dkv_plain_ms=cuda_ms(lambda: _bwd_dkv_ref(*args, **kw), reps=20,
                             warmup=1),
        dq_plain_ms=cuda_ms(lambda: _bwd_dq_ref(*args[:5], **kw), reps=20,
                            warmup=1),
        visible_pairs_per_head=pairs,
    )
    # Least time: fwd 4d flops per visible pair (S, PV); dK/dV 8d (S, dP,
    # dV, dK); dQ 6d (S, dP, dQ; delta rides on P and dP); each input
    # read once, each output written once.
    for key, per_d, nbytes in (
            ("fwd", 4, 2 * qb + 2 * kvb + stats),
            ("dkv", 8, 2 * qb + 4 * kvb + 2 * stats),
            ("dq", 6, 3 * qb + 2 * kvb + 2 * stats)):
        result[f"{key}_bound_ms"], result[f"{key}_bound_by"] = attn_bound(
            per_d, nbytes, b, h, d, pairs)
    if name == "gpt2m":
        # Yardstick only: SDPA has no sliding window, and the port never
        # calls it.
        qt, kt, vt = (x.detach().clone().requires_grad_() for x in (q, k, v))
        result["library_fwd_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            torch.autograd.grad(o, (qt, kt, vt), args[3])

        result["library_fwd_bwd_ms"] = cuda_ms(sdpa_fwd_bwd)
        result["library"] = ("scaled_dot_product_attention(is_causal=True):"
                             " a yardstick only; the port never calls it")
        del qt, kt, vt
    if name == "mistral-window":
        # Yardstick: SDPA with the window as a boolean mask and enable_gqa,
        # the same function in one call; the port never calls it.
        mask = visible_mask(sq, sk, normalize_window(window, causal),
                            device=q.device)
        result["library_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), reps=10)
        result["library"] = ("scaled_dot_product_attention(attn_mask=window "
                             "mask, enable_gqa=True): a yardstick only")
        del mask
    emit(result)
    check(result["ok"], f"attn_kernels case {name} disagrees with its plain "
                        "version or is not deterministic")
    return result


def attn_fault_phase():
    """The tolerance's power, shown: each window case again with the kernels
    handed a window one column wider on the left than the plain versions
    (an off-by-one at the window edge). Every kernel must fail its check."""
    for i, case in enumerate(ATTN_CASES):
        name, b, h, hk, sq, sk, d, causal, window, softcap, dtype = case
        if window[0] < 0:
            continue
        planted = (window[0] + 1, window[1])
        checked, _, _ = attn_compare(b, h, hk, sq, sk, d, causal, window,
                                     softcap, dtype, seed=20 + i,
                                     kernel_window=planted)
        caught = {key: not checked[f"{key}_ok"] for key in ("fwd", "dq", "dkv")}
        emit(dict(phase="attn_fault", case=name, window_size=list(window),
                  kernel_window_size=list(planted),
                  err_over_limit={key: checked[key]["err_over_limit"]
                                  for key in ("out", "dq", "delta", "dk",
                                              "dv")},
                  lse_max_abs_err=checked["lse_max_abs_err"], caught=caught,
                  ok=all(caught.values())))
        check(all(caught.values()), f"attn_fault: a window off by one in "
                                    f"case {name} passes the tolerance")


# -- phases: varlen_kernels, varlen_fault (kernels 6-8 vs plain) --------------

def doc_lengths(total, max_len, seed):
    """Seeded document lengths in [1, max_len] that pack `total` tokens."""
    rng = np.random.RandomState(seed)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.randint(1, max_len + 1)))
    lens[-1] -= sum(lens) - total
    return lens


GPT2M_DOCS = doc_lengths(8 * 2048, 2048, 30)
# Packed cases: (lens_q, lens_k, seqused_q, seqused_k, h, hk, d, causal,
# window_size, layout, the cu_seqlens_k boundary the fault moves).
VARLEN_CASES = {
    # GPT-2-medium attention over 8 x 2048 tokens packed as documents.
    "gpt2m-packed": (GPT2M_DOCS, GPT2M_DOCS, None, None, 16, 16, 64, True,
                     (-1, -1), "thd", 1),
    # Lengths 0 and 1, seqused_q > seqused_k, seqused_k 0, head-major
    # layout, d 128, a window.
    "edge-hsd-d128": ((12, 0, 1, 20, 9, 700), (15, 4, 1, 6, 9, 700),
                      (12, 0, 1, 14, 9, 700), (15, 4, 1, 5, 0, 700), 8, 2,
                      128, True, (63, -1), "hsd", 5),
}
# Paged (Mistral-7B widths, vLLM "phd" pools): a chunked-prefill step of
# four 512-token chunks at contexts past the 4096 window.
PAGED_QLENS, PAGED_CONTEXTS = (512, 512, 512, 512), (2831, 3862, 4144, 6000)


def varlen_pairs(rows, keys, off, left, right):
    """Visible (row, key) pairs of one sequence and how many of its keys
    any row sees, under the varlen rule (csrc/flash_fwd.cu)."""
    if rows <= 0 or keys <= 0:
        return 0, 0
    diag = np.arange(rows) + off
    lo = np.maximum(diag - left, 0) if left >= 0 else np.zeros(rows, np.int64)
    hi = np.minimum(diag + right, keys - 1) if right >= 0 else np.full(rows, keys - 1)
    span = np.maximum(hi - lo + 1, 0)
    seen = span > 0
    needed = int(hi[seen].max() - lo[seen].min() + 1) if seen.any() else 0
    return int(span.sum()), needed


def varlen_work(lens_q, lens_k, used_q, used_k, causal, window):
    """(visible pairs per head, keys that must be read) of a packed call."""
    left, right = varlen_window(window, causal)
    pairs = needed = 0
    for j, (lq, lk) in enumerate(zip(lens_q, lens_k)):
        uq = lq if used_q is None else used_q[j]
        uk = lk if used_k is None else used_k[j]
        p, n = varlen_pairs(min(uq, lq), min(uk, lk), uk - uq, left, right)
        pairs, needed = pairs + p, needed + n
    return pairs, needed


def _dev_int(x, dev="cuda"):
    return None if x is None else torch.tensor(np.asarray(x), dtype=torch.int32,
                                               device=dev)


def _cu_of(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def library_packed(q, k, v, cu, causal):
    """The yardstick of a packed call: SDPA on jagged torch.nested tensors
    (the port never calls it). Returns (ms, what ran) or (None, why not)."""
    try:
        offs = cu.long()
        qn, kn, vn = (torch.nested.nested_tensor_from_jagged(x, offs)
                      .transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qn, kn, vn, is_causal=causal))
        return ms, f"SDPA on jagged torch.nested tensors, is_causal={causal}"
    except Exception as exc:  # a yardstick: report why it did not run
        return None, f"not run: {type(exc).__name__}: {str(exc)[:160]}"


def varlen_compare(name, seed, fault=False):
    """Kernels 6-8 and their plain versions on one packed case's seeded
    inputs (the plain forward's LSE and the plain dQ's delta feed the
    backward kernels). With fault=True the kernels get cu_seqlens_k with
    one boundary moved by a token. Returns (result, tensors)."""
    (lens_q, lens_k, used_q, used_k, h, hk, d, causal, window, layout,
     boundary) = VARLEN_CASES[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tq, tk = sum(lens_q), sum(lens_k)

    def rand(total, heads):
        shape = (total, heads, d) if layout == "thd" else (heads, total, d)
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    q, do = rand(tq, h), rand(tq, h)
    k, v = rand(tk, hk), rand(tk, hk)
    cu_q, cu_k = _dev_int(_cu_of(lens_q)), _dev_int(_cu_of(lens_k))
    kcu_k = cu_k.clone()
    if fault:
        kcu_k[boundary] += 1
    kw = dict(seqused_q=_dev_int(used_q), seqused_k=_dev_int(used_k),
              causal=causal, window_size=window, layout=layout)
    maxes = dict(max_seqlen_q=max(lens_q))
    out, lse = flash_attention_varlen_fwd(q, k, v, cu_q, kcu_k, **kw, **maxes)
    torch.cuda.synchronize()
    up = tuple(x.float() for x in (q, k, v, do))
    ref_out, ref_lse = flash_attention_varlen_fwd_ref(*up[:3], cu_q, cu_k, **kw)
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[finite].abs().max()) if finite.any() else 0.0
    out_rows = out.float() if layout == "thd" else out.float().transpose(0, 1)
    result = dict(empty_rows=int((~finite).sum()),
                  out=held(out_rows, ref_out if layout == "thd"
                           else ref_out.transpose(0, 1)),
                  lse_max_abs_err=lse_err)
    fwd_ok = bool(result["out"]["err_over_limit"] <= 1
                  and torch.equal(finite, torch.isfinite(lse))
                  and lse_err <= ATTN_LSE_TOL and torch.isfinite(out).all())
    del ref_out
    args = (q, k, v, do, ref_lse)
    dq, delta = flash_attention_varlen_bwd_dq(*args, cu_q, kcu_k, **kw, **maxes)
    dq2, delta2 = flash_attention_varlen_bwd_dq(*args, cu_q, kcu_k, **kw, **maxes)
    ref_dq, ref_delta = _varlen_dq_ref(*up, ref_lse, cu_q, cu_k, **kw)
    kmax = dict(max_seqlen_k=max(lens_k))
    dk, dv = flash_attention_varlen_bwd_dkv(*args, ref_delta, cu_q, kcu_k, **kw,
                                            **kmax)
    dk2, dv2 = flash_attention_varlen_bwd_dkv(*args, ref_delta, cu_q, kcu_k,
                                              **kw, **kmax)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(x, y) for x, y in
                        ((dk, dk2), (dv, dv2), (dq, dq2), (delta, delta2)))
    ref_dk, ref_dv = _varlen_dkv_ref(*up, ref_lse, ref_delta, cu_q, cu_k, **kw)

    def rows(x):  # the d values of one token and head last, for `held`
        return x.float() if layout == "thd" else x.float().transpose(0, 1)

    result.update(dq=held(rows(dq), rows(ref_dq)), delta=held(delta, ref_delta),
                  dk=held(rows(dk), rows(ref_dk)), dv=held(rows(dv), rows(ref_dv)))
    grads_finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    # A grid sized for 64-row sequences loops over the longer ones' tiles:
    # the same tiles, the same bits.
    short = dict(max_seqlen_q=64)
    out_s, _ = flash_attention_varlen_fwd(q, k, v, cu_q, kcu_k, **kw, **short)
    dq_s, _ = flash_attention_varlen_bwd_dq(*args, cu_q, kcu_k, **kw, **short)
    dk_s, dv_s = flash_attention_varlen_bwd_dkv(*args, ref_delta, cu_q, kcu_k,
                                                **kw, max_seqlen_k=64)
    short_grid_equal = all(torch.equal(x, y) for x, y in (
        (out_s, out), (dq_s, dq), (dk_s, dk), (dv_s, dv)))
    result.update(
        short_grid_equal=short_grid_equal,
        fwd_ok=fwd_ok,
        dq_ok=result["dq"]["err_over_limit"] <= 1
        and result["delta"]["err_over_limit"] <= 1,
        dkv_ok=max(result["dk"]["err_over_limit"],
                   result["dv"]["err_over_limit"]) <= 1,
        bwd_bitwise_deterministic=deterministic, grads_finite=grads_finite)
    tensors = dict(args=args, delta=ref_delta, cu=(cu_q, cu_k), kw=kw,
                   maxes=dict(maxes, **kmax))
    return result, tensors


def varlen_case(name, seed):
    checked, t = varlen_compare(name, seed)
    (lens_q, lens_k, used_q, used_k, h, hk, d, causal, window, layout,
     _) = VARLEN_CASES[name]
    q, k, v, do, lse = t["args"]
    cu_q, cu_k = t["cu"]
    kw, maxes = t["kw"], t["maxes"]
    fwd_kw = dict(kw, max_seqlen_q=maxes["max_seqlen_q"])
    dq_kw = dict(kw, max_seqlen_q=maxes["max_seqlen_q"])
    dkv_kw = dict(kw, max_seqlen_k=maxes["max_seqlen_k"])
    result = dict(
        phase="varlen_kernels", case=name, nseq=len(lens_q), total_q=sum(lens_q),
        total_k=sum(lens_k), max_seqlen_q=max(lens_q), h=h, hk=hk, d=d,
        causal=causal, window_size=list(window), layout=layout,
        seqused=used_q is not None, dtype="bfloat16", **checked,
        tolerance=ATTN_TOLERANCE,
        ok=(checked["fwd_ok"] and checked["dq_ok"] and checked["dkv_ok"]
            and checked["bwd_bitwise_deterministic"] and checked["grads_finite"]
            and checked["short_grid_equal"]))
    pairs, needed = varlen_work(lens_q, lens_k, used_q, used_k, causal, window)
    el = 2
    qb, kvb, stats = sum(lens_q) * h * d * el, needed * hk * d * el, sum(lens_q) * h * 4
    result.update(
        fwd_ms=cuda_ms(lambda: flash_attention_varlen_fwd(q, k, v, cu_q, cu_k,
                                                          **fwd_kw)),
        dq_ms=cuda_ms(lambda: flash_attention_varlen_bwd_dq(
            q, k, v, do, lse, cu_q, cu_k, **dq_kw)),
        dkv_ms=cuda_ms(lambda: flash_attention_varlen_bwd_dkv(
            q, k, v, do, lse, t["delta"], cu_q, cu_k, **dkv_kw)),
        fwd_plain_ms=cuda_ms(lambda: flash_attention_varlen_fwd_ref(
            q, k, v, cu_q, cu_k, **kw), reps=5, warmup=1),
        dq_plain_ms=cuda_ms(lambda: _varlen_dq_ref(
            q, k, v, do, lse, cu_q, cu_k, **kw), reps=5, warmup=1),
        dkv_plain_ms=cuda_ms(lambda: _varlen_dkv_ref(
            q, k, v, do, lse, t["delta"], cu_q, cu_k, **kw), reps=5, warmup=1),
        visible_pairs_per_head=pairs)
    for key, per_d, nbytes in (
            ("fwd", 4, 2 * qb + 2 * kvb + stats),
            ("dkv", 8, 2 * qb + 4 * kvb + 2 * stats),
            ("dq", 6, 3 * qb + 2 * kvb + 2 * stats)):
        result[f"{key}_bound_ms"], result[f"{key}_bound_by"] = attn_bound(
            per_d, nbytes, 1, h, d, pairs)
    if layout == "thd" and used_q is None and used_k is None:
        result["library_fwd_ms"], result["library"] = library_packed(
            q, k, v, cu_q, causal)
    emit(result)
    check(result["ok"], f"varlen_kernels case {name} disagrees with its plain "
                        "version or is not deterministic")
    return result


def paged_step(qlens, contexts, page, seed, h=H, hk=HK, d=D):
    """A chunked-prefill step over vLLM "phd" pools, at Mistral-7B widths
    unless others are given: q, the pools, their head-major views, the
    block table, cu_seqlens_q and seqused_k."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    pages = [-(-c // page) for c in contexts]
    width = max(pages)
    npages = sum(pages) + 1
    ids = rng.permutation(npages)
    table = np.zeros((len(contexts), width), np.int32)
    start = 0
    for j, n in enumerate(pages):
        table[j, :n] = ids[start:start + n]
        start += n
    k_phd, v_phd = (torch.randn(npages, page, hk, d, generator=gen, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
    return dict(
        q=torch.randn(sum(qlens), h, d, generator=gen, device=dev,
                      dtype=torch.bfloat16),
        k_phd=k_phd, v_phd=v_phd,
        pools=(k_phd.transpose(1, 2), v_phd.transpose(1, 2)),
        table=_dev_int(table), cu_q=_dev_int(_cu_of(qlens)),
        used=_dev_int(contexts), max_q=max(qlens), page=page,
        pages_in_order=torch.from_numpy(np.concatenate(
            [table[j, :n] for j, n in enumerate(pages)]).astype(np.int64)).to(dev),
        cu_k_pad=_dev_int(_cu_of([n * page for n in pages])))


PAGED_KW = dict(causal=True, window_size=(WINDOW, -1))


def paged_fwd(st, used=None):
    return flash_attention_varlen_fwd(
        st["q"], None, None, st["cu_q"], None,
        seqused_k=st["used"] if used is None else used, kv_pools=st["pools"],
        block_table=st["table"], max_seqlen_q=st["max_q"], **PAGED_KW)


def gather_then_packed(st):
    """The reference's gather route: copy every sequence's used pages into
    packed K/V (vllm_compat.py:339-402), then the packed kernel."""
    kp = st["k_phd"][st["pages_in_order"]].reshape(-1, HK, D)
    vp = st["v_phd"][st["pages_in_order"]].reshape(-1, HK, D)
    return flash_attention_varlen_fwd(
        st["q"], kp, vp, st["cu_q"], st["cu_k_pad"], seqused_k=st["used"],
        max_seqlen_q=st["max_q"], **PAGED_KW)


def paged_compare(st, fault=False):
    """Kernel 6 reading pages against its plain version (which gathers the
    pages first); with fault=True the kernel gets the first sequence's
    seqused_k one token longer."""
    used = st["used"].clone()
    if fault:
        used[0] += 1
    out, lse = paged_fwd(st, used)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_varlen_fwd_ref(
        st["q"].float(), None, None, st["cu_q"], None, seqused_k=st["used"],
        kv_pools=st["pools"], block_table=st["table"], **PAGED_KW)
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[finite].abs().max())
    res = dict(out=held(out, ref_out), lse_max_abs_err=lse_err)
    res["fwd_ok"] = bool(res["out"]["err_over_limit"] <= 1
                         and torch.equal(finite, torch.isfinite(lse))
                         and lse_err <= ATTN_LSE_TOL)
    return res


def paged_cases(seed=40):
    """Kernel 6 on vLLM pools: held against its plain version at page 16
    and 512, timed against its bound, and against the gather route; then
    the cost of a step that mixes a 2041-token chunk with seven 1-token
    decode rows, whose grid (cdiv(2041, 64) x h x 8 blocks) is mostly
    empty."""
    results = {}
    pairs, needed = varlen_work(PAGED_QLENS, PAGED_CONTEXTS, None, None, True,
                                (WINDOW, -1))
    tq = sum(PAGED_QLENS)
    nbytes = 2 * tq * H * D * 2 + 2 * needed * HK * D * 2 + tq * H * 4
    for page in (16, 512):
        st = paged_step(PAGED_QLENS, PAGED_CONTEXTS, page, seed)
        checked = paged_compare(st)
        bound_ms, bound_by = attn_bound(4, nbytes, 1, H, D, pairs)
        r = dict(phase="varlen_kernels", case=f"mistral-paged-prefill-page{page}",
                 qlens=list(PAGED_QLENS), contexts=list(PAGED_CONTEXTS), h=H,
                 hk=HK, d=D, page=page, pools="phd (views)",
                 window_size=[WINDOW, -1], **checked, tolerance=ATTN_TOLERANCE,
                 ok=checked["fwd_ok"])
        torch.cuda.synchronize()
        # Route measurement, in turns (in-kernel, gather, gather, in-kernel)
        # three times: times vary between calls, so only these pairs count.
        inkernel, gather = [], []
        for _ in range(3):
            inkernel.append(cuda_ms(lambda: paged_fwd(st)))
            gather.append(cuda_ms(lambda: gather_then_packed(st)))
            gather.append(cuda_ms(lambda: gather_then_packed(st)))
            inkernel.append(cuda_ms(lambda: paged_fwd(st)))
        r.update(fwd_ms=float(np.median(inkernel)), inkernel_ms=inkernel,
                 gather_route_ms=gather,
                 gather_over_inkernel=float(np.median(gather) / np.median(inkernel)),
                 fwd_plain_ms=cuda_ms(lambda: flash_attention_varlen_fwd_ref(
                     st["q"], None, None, st["cu_q"], None, seqused_k=st["used"],
                     kv_pools=st["pools"], block_table=st["table"], **PAGED_KW),
                     reps=5, warmup=1),
                 fwd_bound_ms=bound_ms, fwd_bound_by=bound_by,
                 visible_pairs_per_head=pairs,
                 library_fwd_ms=None,
                 library="none: no PyTorch call attends over a page table with "
                         "a per-sequence sliding window")
        emit(r)
        check(r["ok"], f"varlen_kernels paged case page {page} disagrees with "
                       "its plain version")
        results[page] = r
        del st
    # A mixed step: one long chunk and seven decode rows, against each part
    # alone; the difference is what the empty blocks of the mixed grid cost.
    ctx = (4144, 2831, 3862, 2770, 1355, 3591, 689, 2891)
    parts = {"mixed": ((2041,) + (1,) * 7, ctx), "chunk": ((2041,), ctx[:1]),
             "decode_rows": ((1,) * 7, ctx[1:])}
    ms = {}
    for key, (ql, cx) in parts.items():
        st = paged_step(ql, cx, 16, seed + 1)
        ms[key] = cuda_ms(lambda: paged_fwd(st))
        if key == "mixed":  # the gather route on a step of the vLLM loop
            ms["mixed_gather_route"] = cuda_ms(lambda: gather_then_packed(st))
            ms["mixed_again"] = cuda_ms(lambda: paged_fwd(st))
        del st
    grid = -(-2041 // 64) * 8
    emit(dict(phase="varlen_kernels", case="mixed-step-grid", qlens=[2041] + [1] * 7,
              contexts=list(ctx), ms=ms,
              empty_blocks_share=1 - (-(-2041 // 64) + 7) / grid,
              # What the seven decode rows and the empty blocks add to the
              # chunk's launch, together: an upper bound on the empty
              # blocks' cost (the rows alone, in a launch of their own,
              # pay that launch's fixed cost too).
              mixed_minus_chunk_ms=ms["mixed"] - ms["chunk"]))
    return results


def varlen_fault_phase():
    """The tolerance's power on varlen inputs: each packed case with one
    cu_seqlens_k boundary moved by a token, and the paged case with one
    seqused_k a token longer, handed to the kernels only. Every kernel's
    check must fail."""
    for i, name in enumerate(VARLEN_CASES):
        checked, _ = varlen_compare(name, seed=60 + i, fault=True)
        caught = {key: not checked[f"{key}_ok"] for key in ("fwd", "dq", "dkv")}
        emit(dict(phase="varlen_fault", case=name,
                  moved=f"cu_seqlens_k[{VARLEN_CASES[name][-1]}] + 1",
                  err_over_limit={key: checked[key]["err_over_limit"]
                                  for key in ("out", "dq", "delta", "dk", "dv")},
                  caught=caught, ok=all(caught.values())))
        check(all(caught.values()), f"varlen_fault: a moved boundary in case "
                                    f"{name} passes the tolerance")
    st = paged_step(PAGED_QLENS, PAGED_CONTEXTS, 16, 70)
    checked = paged_compare(st, fault=True)
    emit(dict(phase="varlen_fault", case="mistral-paged-prefill-page16",
              moved="seqused_k[0] + 1",
              err_over_limit={"out": checked["out"]["err_over_limit"]},
              caught={"fwd": not checked["fwd_ok"]}, ok=not checked["fwd_ok"]))
    check(not checked["fwd_ok"], "varlen_fault: a seqused_k one token longer "
                                 "passes the tolerance")


# -- phase: varlen_train (packed training attention through autograd) --------

def varlen_train_phase(layers=24, seed=50):
    """GPT-2-medium's 24 attention layers over 8 x 2048 tokens packed as
    documents, forward and backward through `flash_attn_varlen_func` and
    autograd, as a training step runs them; launches counted over this
    phase only."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cu = _dev_int(_cu_of(GPT2M_DOCS))
    tq, h, d = sum(GPT2M_DOCS), 16, 64
    qkv = [torch.randn(3, tq, h, d, generator=gen, device=dev,
                       dtype=torch.bfloat16).requires_grad_()
           for _ in range(layers)]
    do = torch.randn(tq, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
    maxlen = max(GPT2M_DOCS)

    def step():
        outs = [flash_attn_varlen_func(x[0], x[1], x[2], cu, cu, maxlen, maxlen,
                                       causal=True) for x in qkv]
        torch.autograd.backward(outs, [do] * layers)

    step()  # warm-up
    torch.cuda.synchronize()
    _zero_varlen_counts()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _varlen_counts()
    want = dict(flash_varlen_fwd=layers, flash_varlen_bwd_dkv=layers,
                flash_varlen_bwd_dq=layers)
    grads_finite = all(bool(torch.isfinite(x.grad).all()) for x in qkv)
    ok = counts == want and grads_finite
    result = dict(phase="varlen_train", layers=layers, docs=len(GPT2M_DOCS),
                  tokens=tq, h=h, d=d, causal=True, step_wall_ms=wall_ms,
                  step_ms_by_events=cuda_ms(step, reps=5, warmup=1),
                  launches=counts, launches_expected=want,
                  grads_finite=grads_finite, ok=ok)
    emit(result)
    check(ok, "varlen_train: launches off the count or non-finite gradients")
    return result


def _varlen_counts():
    return dict(flash_varlen_fwd=flash_attention_varlen_fwd.launches,
                flash_varlen_bwd_dkv=flash_attention_varlen_bwd_dkv.launches,
                flash_varlen_bwd_dq=flash_attention_varlen_bwd_dq.launches)


def _zero_varlen_counts():
    flash_attention_varlen_fwd.launches = 0
    flash_attention_varlen_bwd_dkv.launches = 0
    flash_attention_varlen_bwd_dq.launches = 0


# -- phase: vllm (vLLM's per-layer calls, Mistral-7B widths) ------------------

VLLM_BUDGET, VLLM_DECODE_STEPS, VLLM_PAGE = 2048, 32, 16


def vllm_schedule(lens, budget, decode_steps):
    """A chunked-prefill schedule in vLLM's manner: each step first gives
    every request past its prompt one decode row (until it has
    `decode_steps`), then fills the rest of the query-token budget with
    prompt chunks in arrival order. Returns per step [(request, query
    tokens, context after the step)]."""
    n = len(lens)
    done, dec = [0] * n, [0] * n
    steps = []
    while True:
        rows, left = [], budget
        for i in range(n):
            if done[i] == lens[i] and dec[i] < decode_steps:
                dec[i] += 1
                left -= 1
                rows.append((i, 1, lens[i] + dec[i]))
        for i in range(n):
            if done[i] < lens[i] and left > 0:
                c = min(lens[i] - done[i], left)
                done[i] += c
                left -= c
                rows.append((i, c, done[i]))
        if not rows:
            return steps
        steps.append(rows)


class _SyncsRaise:
    """torch.cuda.set_sync_debug_mode("error") inside the block: any host
    sync raises."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


def vllm_phase(seed=2, layers=32):
    """One scheduler loop in vLLM's calling convention at Mistral-7B
    widths: 32 layers, each with its own (num_blocks, 16, 8, 128) bf16 K
    and V pools; the 8 prompts of the serve phase under a 2048-token budget,
    32 decode steps each. Per step: new K/V rows written into every layer's
    pools by plain indexing (vLLM's reshape_and_cache), one
    get_scheduler_metadata, then one vllm_compat.flash_attn_varlen_func per
    layer with host syncs made errors."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    lens = serve_prompt_lens(np.random.RandomState(seed)).tolist()
    steps = vllm_schedule(lens, VLLM_BUDGET, VLLM_DECODE_STEPS)
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pages = [-(-(n + VLLM_DECODE_STEPS) // VLLM_PAGE) for n in lens]
    num_blocks = sum(pages) + 1
    ids = rng.permutation(num_blocks)
    req_table = np.zeros((len(lens), max(pages)), np.int32)
    start = 0
    for i, n in enumerate(pages):
        req_table[i, :n] = ids[start:start + n]
        start += n
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pools = [(torch.zeros(num_blocks, VLLM_PAGE, HK, D, device=dev,
                          dtype=torch.bfloat16),
              torch.zeros(num_blocks, VLLM_PAGE, HK, D, device=dev,
                          dtype=torch.bfloat16)) for _ in range(layers)]
    pool_gb = 2 * layers * pools[0][0].numel() * 2 / 1e9
    _zero_varlen_counts()
    flash_attention_decode_multipage.launches = 0
    dispatch_counts.clear()
    kinds, attn_ms, checks = [], [], []
    q_tokens = plan_reused = 0
    profiles = {}
    for si, rows in enumerate(steps):
        reqs = [r[0] for r in rows]
        qlens = [r[1] for r in rows]
        ctx = [r[2] for r in rows]
        tq = sum(qlens)
        pos = np.concatenate([np.arange(c - n, c) for _, n, c in rows])
        owner = np.repeat(reqs, qlens)
        page_ids = torch.from_numpy(req_table[owner, pos // VLLM_PAGE].astype(
            np.int64)).to(dev)
        slots = torch.from_numpy((pos % VLLM_PAGE).astype(np.int64)).to(dev)
        new_kv = torch.randn(layers, 2, tq, HK, D, generator=gen, device=dev,
                             dtype=torch.bfloat16)
        for layer, (kp, vp) in enumerate(pools):  # vLLM's reshape_and_cache
            kp[page_ids, slots] = new_kv[layer, 0]
            vp[page_ids, slots] = new_kv[layer, 1]
        q = torch.randn(layers, tq, H, D, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        cu_q = _dev_int(_cu_of(qlens))
        used = _dev_int(ctx)
        table = _dev_int(req_table[reqs])
        max_q, max_k = max(qlens), max(ctx)
        kind = "mixed" if max_q > 4 else "decode"
        meta = get_scheduler_metadata(
            len(rows), max_q, max_k, H, HK, D, cache_seqlens=used,
            cu_seqlens_q=cu_q, causal=True, window_size=(WINDOW, -1),
            page_size=VLLM_PAGE)
        # The layers' calls reuse the step's plan without a host read.
        plan_reused += plan_mismatch(
            meta.plan, cu_seqlens_q=cu_q, seqused_k=used, causal=True,
            window_size=(WINDOW, -1), host_read=False) is None

        def calls(keep=()):
            kept = {}
            for layer, (kp, vp) in enumerate(pools):
                o = vllm_flash_attn_varlen_func(
                    q[layer], kp, vp, max_q, cu_q, max_k, seqused_k=used,
                    causal=True, window_size=(WINDOW, -1), block_table=table,
                    scheduler_metadata=meta)
                if layer in keep:
                    kept[layer] = o
            return kept

        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        with _SyncsRaise():
            kept = calls(keep=(0, layers - 1) if si % 8 == 0 else ())
        end.record()
        end.synchronize()
        kinds.append(kind)
        attn_ms.append(start.elapsed_time(end))
        q_tokens += tq
        for layer, o in kept.items():
            kp, vp = pools[layer]
            ref, _ = flash_attention_varlen_fwd_ref(
                q[layer].float(), None, None, cu_q, None, seqused_k=used,
                kv_pools=(kp.transpose(1, 2), vp.transpose(1, 2)),
                block_table=table, causal=True, window_size=(WINDOW, -1))
            checks.append(dict(step=si, layer=layer, kind=kind, **held(o, ref)))
        if kind not in profiles and (kind == "decode" or si >= 2):
            counts_before = (flash_attention_varlen_fwd.launches,
                             flash_attention_decode_multipage.launches,
                             dict(dispatch_counts))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            # The profiled replay is not part of the scheduler loop's count.
            flash_attention_varlen_fwd.launches = counts_before[0]
            flash_attention_decode_multipage.launches = counts_before[1]
            dispatch_counts.clear()
            dispatch_counts.update(counts_before[2])
            by_kernel = _device_ms_by_kernel(prof)
            busy = sum(by_kernel.values())
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
            profiles[kind] = dict(step=si, wall_ms=wall,
                                  device_busy_ms=busy if busy > 0 else None,
                                  idle_share=1 - busy / wall if busy > 0 else None,
                                  top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
        del q, new_kv
    n_mixed, n_decode = kinds.count("mixed"), kinds.count("decode")
    launches = dict(flash_varlen_fwd=flash_attention_varlen_fwd.launches,
                    paged_decode=flash_attention_decode_multipage.launches,
                    flash_varlen_bwd_dkv=flash_attention_varlen_bwd_dkv.launches,
                    flash_varlen_bwd_dq=flash_attention_varlen_bwd_dq.launches)
    want = dict(flash_varlen_fwd=layers * n_mixed, paged_decode=layers * n_decode,
                flash_varlen_bwd_dkv=0, flash_varlen_bwd_dq=0)
    routes = {f"{k}/{r}": n for (k, r), n in dispatch_counts.items()}
    want_routes = {"varlen/paged-prefill-inkernel": layers * n_mixed,
                   "varlen/paged-decode": layers * n_decode}
    worst = max(c["err_over_limit"] for c in checks)
    mixed_ms = [t for t, k in zip(attn_ms, kinds) if k == "mixed"]
    decode_ms = [t for t, k in zip(attn_ms, kinds) if k == "decode"]
    ok = (launches == want and routes == want_routes and worst <= 1
          and n_mixed > 0 and n_decode > 0 and plan_reused == len(steps))
    result = dict(
        phase="vllm", model="Mistral-7B-v0.1 attention widths", layers=layers,
        pool_layout="phd (num_blocks, 16, 8, 128) bf16 per layer, K and V",
        num_blocks=num_blocks, pools_gb=pool_gb, prompt_lens=lens,
        budget=VLLM_BUDGET, decode_steps_per_request=VLLM_DECODE_STEPS,
        steps=len(steps), mixed_steps=n_mixed, decode_steps=n_decode,
        query_tokens=q_tokens,
        attention_ms_per_mixed_step=float(np.mean(mixed_ms)),
        attention_ms_per_decode_step=float(np.mean(decode_ms)),
        query_tokens_per_s=q_tokens / (sum(attn_ms) / 1e3),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        host_syncs_in_layer_calls="none (set_sync_debug_mode error)",
        steps_reusing_plan=plan_reused,
        launches=launches, launches_expected=want, routes=routes,
        checked=len(checks), worst_err_over_limit=worst,
        tolerance=ATTN_TOLERANCE, profile=profiles, ok=ok)
    emit(result)
    check(ok, "vllm: launches or routes off the count, or a layer's output "
              "outside the tolerance")
    del pools
    return result


# -- phases: decode_kernels, decode_fault (kernel 5 vs plain) -----------------

# Decode contexts between 2831 and 4144 tokens (seeded, as the serve
# phase's), eight batch rows.
DECODE_LENS = (2831, 4144, 3862, 3591, 2891, 3377, 4012, 3105)
# The generate and speculative phases' shapes: generate at batch 4 on
# 4500-token prompts with 32 new tokens; decode_speculative at gamma 4 on a
# 1024-token prompt with 64 new tokens, its caches gamma + 1 slots longer.
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 4500, 32
SPEC_PROMPT, SPEC_NEW, SPEC_GAMMA = 1024, 64, 4
SPEC_SLOTS = SPEC_PROMPT + SPEC_NEW + SPEC_GAMMA + 1
DECODE_DEFAULTS = dict(b=8, sq=1, h=H, hk=HK, d=D, smax=4608, lens=DECODE_LENS,
                       dtype=torch.bfloat16, page=0, causal=True,
                       window_left=-1, chunk=0, sink_tokens=0, softcap=0.0,
                       batch_idx=None, leftpad=None, alibi=False, sink=False)
# Kernel 5 at Mistral-7B widths (h 32, hk 8, d 128) unless a case says
# otherwise; contiguous (b, hk, smax, d) caches unless `page` is set.
DECODE_CASES = {
    "decode": dict(window_left=WINDOW),
    # generate()'s prefill and a late decode step, at its batch and cache
    # length: the whole prompt through the decode kernel, 282 blocks of 64
    # rows per (batch row, kv head).
    "prefill": dict(b=GEN_BATCH, sq=GEN_PROMPT, smax=GEN_PROMPT + GEN_NEW,
                    lens=(GEN_PROMPT,) * GEN_BATCH, window_left=WINDOW),
    "generate-decode": dict(b=GEN_BATCH, smax=GEN_PROMPT + GEN_NEW,
                            lens=(4501, 4511, 4521, 4531), window_left=WINDOW),
    # decode_speculative's target verify (gamma + 1 = 5 tokens, 20 packed
    # rows) and its TinyLlama-width draft's prefill of prompt[:-1].
    "spec-verify-sq5": dict(b=1, sq=SPEC_GAMMA + 1, smax=SPEC_SLOTS,
                            lens=(SPEC_SLOTS,), window_left=WINDOW),
    "spec-draft-prefill": dict(b=1, sq=SPEC_PROMPT - 1, hk=4, d=64,
                               smax=SPEC_SLOTS, lens=(SPEC_PROMPT - 1,)),
    "batch-idx-permuted": dict(window_left=WINDOW,
                               batch_idx=(5, 2, 7, 0, 3, 6, 1, 4)),
    # The reference's fault (flash_decode.py:122) scaled up: its walk would
    # start 2000 columns past the first visible one in row 0.
    "leftpad-window": dict(b=4, smax=8192, lens=(8000, 7000, 6500, 5000),
                           leftpad=(2000, 1000, 3000, 500),
                           window_left=WINDOW),
    "alibi-batched": dict(alibi=True),
    "sink": dict(window_left=WINDOW, sink=True),
    # Llama-4-Scout's attention_chunk_size; row 1's four rows straddle its
    # chunk boundary at leftpad + 8192.
    "chunk8192-leftpad": dict(b=4, sq=4, smax=12288,
                              lens=(8000, 8294, 10500, 12000),
                              leftpad=(0, 100, 500, 1000), chunk=8192),
    "sinktok4-window": dict(smax=8192, lens=(4500, 5200, 6100, 7000, 7900,
                                             4800, 6600, 8000),
                            window_left=WINDOW, sink_tokens=4),
    "softcap50-fp16": dict(window_left=WINDOW, softcap=50.0,
                           dtype=torch.float16),
    "noncausal-sq4": dict(sq=4, causal=False),
    "paged-phd-sinks": dict(page=16, window_left=WINDOW, sink=True),
    # TinyLlama-1.1B widths: 32 query heads over 4 kv heads of 64.
    "tinyllama-d64-g8": dict(hk=4, d=64),
}
# The planted faults: (case, what the kernel is handed instead).
DECODE_FAULTS = (("prefill", "window_left + 1"),
                 ("chunk8192-leftpad", "cache_leftpad + 1"),
                 ("chunk8192-leftpad", "attention_chunk + 1"))


def decode_inputs(name, seed):
    """A case's seeded inputs: (config, q, k_cache, v_cache, lengths, the
    kernel's keyword arguments)."""
    c = dict(DECODE_DEFAULTS, **DECODE_CASES[name])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    b, h, hk, d, dt = c["b"], c["h"], c["hk"], c["d"], c["dtype"]
    q = torch.randn(b, c["sq"], h, d, generator=gen, device=dev, dtype=dt)
    kw = dict(causal=c["causal"], window_left=c["window_left"],
              attention_chunk=c["chunk"], sink_token_length=c["sink_tokens"],
              softcap=c["softcap"])
    if c["page"]:
        page = c["page"]
        max_pages = -(-max(c["lens"]) // page)
        npages = b * max_pages + 1
        k, v = (torch.randn(npages, page, hk, d, generator=gen, device=dev,
                            dtype=dt).transpose(1, 2) for _ in range(2))
        kw["block_table"] = _dev_int(rng.permutation(npages)[: b * max_pages]
                                     .reshape(b, max_pages))
    else:
        rows = len(c["batch_idx"]) if c["batch_idx"] else b
        k, v = (torch.randn(rows, hk, c["smax"], d, generator=gen, device=dev,
                            dtype=dt) for _ in range(2))
    if c["batch_idx"]:
        kw["cache_batch_idx"] = _dev_int(c["batch_idx"])
    if c["leftpad"]:
        kw["cache_leftpad"] = _dev_int(c["leftpad"])
    if c["alibi"]:
        kw["alibi_slopes"] = (default_alibi_slopes(h).to(dev)[None]
                              * torch.from_numpy(rng.uniform(0.5, 1.5, (b, h))
                                                 .astype(np.float32)).to(dev))
    if c["sink"]:
        kw["sink"] = torch.randn(h, generator=gen, device=dev)
    return c, q, k, v, _dev_int(c["lens"]), kw


def decode_masks(c, lens, kw, ncols):
    """(b, 1, sq, ncols) bool: the columns each query row sees, by the
    function's own rule (`visible_columns`)."""
    dev = lens.device
    lp = kw.get("cache_leftpad")
    masks = []
    for i, length in enumerate(lens.tolist()):
        pos = torch.arange(length - c["sq"], length, device=dev).reshape(1, -1, 1)
        masks.append(visible_columns(
            length, pos, ncols, leftpad=0 if lp is None else lp[i],
            causal=kw["causal"], window_left=kw["window_left"],
            attention_chunk=kw["attention_chunk"],
            sink_token_length=kw["sink_token_length"]).expand(1, c["sq"], ncols))
    return torch.stack(masks)


def decode_bound(c, pairs, kv_rows):
    """Least time: each visible K/V row read once, q/out/lse moved once; 4d
    flops per visible pair (`pairs` over all heads, `kv_rows` over all kv
    heads)."""
    el = 2
    q_rows = c["b"] * c["sq"] * c["h"]
    nbytes = kv_rows * 2 * c["d"] * el + 2 * q_rows * c["d"] * el + q_rows * 4
    return attn_bound(4, nbytes, 1, 1, c["d"], pairs)


def decode_library(c, q, k, v, lens, kw):
    """The yardstick: SDPA with enable_gqa on the same cache rows cut to the
    longest length, with a boolean mask (a float bias with ALiBi). Returns
    (ms, what ran) or (None, why not)."""
    if c["page"] or c["sink"] or c["softcap"]:
        return None, ("none: no PyTorch attention call takes a "
                      + ("page table" if c["page"] else
                         "learnable sink" if c["sink"] else "softcap"))
    dev = q.device
    longest = int(lens.max())
    rows = kw.get("cache_batch_idx")
    rows = rows.long() if rows is not None else torch.arange(c["b"], device=dev)
    ks, vs = k[rows, :, :longest], v[rows, :, :longest]
    mask = decode_masks(c, lens, kw, longest)
    what = "SDPA enable_gqa, boolean mask"
    if c["alibi"]:
        cols = torch.arange(longest, device=dev)
        pos = (lens.long()[:, None] - c["sq"]
               + torch.arange(c["sq"], device=dev)[None])  # (b, sq)
        dist = (cols[None, None] - pos[..., None]).abs().float()
        bias = -kw["alibi_slopes"][:, :, None, None] * dist[:, None]
        mask = bias.masked_fill(~mask, float("-inf")).to(q.dtype)
        what = "SDPA enable_gqa, float ALiBi bias"
    qt = q.transpose(1, 2)
    ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, ks, vs, attn_mask=mask, enable_gqa=True), reps=10)
    return ms, what


def decode_compare(name, seed, fault=None):
    """Kernel 5 and its plain version on one case's inputs, held per
    element; with `fault` the kernel alone gets the planted argument."""
    c, q, k, v, lens, kw = decode_inputs(name, seed)
    kkw = dict(kw)
    if fault == "window_left + 1":
        kkw["window_left"] += 1
    elif fault == "cache_leftpad + 1":
        kkw["cache_leftpad"] = kw["cache_leftpad"] + 1
    elif fault == "attention_chunk + 1":
        kkw["attention_chunk"] += 1
    out, lse = flash_attention_decode_general(q, k, v, lens, **kkw)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_decode_ref(q.float(), k, v, lens, **kw)
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[finite].abs().max()) if finite.any() else 0.0
    res = dict(out=held(out, ref_out), lse_max_abs_err=lse_err,
               empty_rows=int((~finite).sum()))
    res["ok"] = bool(res["out"]["err_over_limit"] <= 1
                     and torch.equal(finite, torch.isfinite(lse))
                     and lse_err <= ATTN_LSE_TOL and torch.isfinite(out).all())
    del ref_out, ref_lse
    return res, (c, q, k, v, lens, kw)


def decode_case(name, seed):
    checked, (c, q, k, v, lens, kw) = decode_compare(name, seed)
    mask = decode_masks(c, lens, kw, int(lens.max()))
    pairs = int(mask.sum()) * c["h"]
    kv_rows = int(mask.any(dim=2).sum()) * c["hk"]
    del mask
    bound_ms, bound_by = decode_bound(c, pairs, kv_rows)
    library_ms, library = decode_library(c, q, k, v, lens, kw)
    result = dict(
        phase="decode_kernels", kernel="general_decode", case=name,
        **{key: (str(val).split(".")[-1] if key == "dtype" else val)
           for key, val in c.items() if key != "lens"},
        lens=list(c["lens"]), **checked, tolerance=ATTN_TOLERANCE,
        ms=cuda_ms(lambda: flash_attention_decode_general(q, k, v, lens, **kw)),
        plain_ms=cuda_ms(lambda: flash_attention_decode_ref(q, k, v, lens, **kw),
                         reps=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, visible_pairs=pairs,
        kv_rows_read=kv_rows, library_ms=library_ms, library=library)
    emit(result)
    check(result["ok"], f"decode_kernels case {name} disagrees with its plain "
                        "version")
    return result


# gpt-oss-20b attention widths (https://huggingface.co/openai/gpt-oss-20b
# config.json: 64 query heads, 8 kv heads of 64, sliding_window 128 on
# alternate layers, learnable sinks), vLLM "phd" pools at page 16.
GPT_OSS = dict(h=64, hk=8, d=64, window=127)
SINKS_QLENS = (2048,) + (1,) * 7
SINKS_CONTEXTS = (4096, 2831, 3862, 2770, 1355, 3591, 689, 2891)


def vllm_sinks_case(seed=90):
    """One vLLM step with s_aux sinks: a 2048-token chunk (at context 4096)
    and seven decode rows through vllm_compat.flash_attn_varlen_func
    (kernel 5's paged route), held per element against kernel 5's plain
    version run on each sequence's own rows."""
    h, hk, d, window = (GPT_OSS[key] for key in ("h", "hk", "d", "window"))
    qlens, contexts = SINKS_QLENS, SINKS_CONTEXTS
    st = paged_step(qlens, contexts, VLLM_PAGE, seed, h=h, hk=hk, d=d)
    sinks = torch.randn(h, generator=torch.Generator(device="cuda")
                        .manual_seed(seed), device="cuda")
    kw = dict(causal=True, window_size=(window, -1), block_table=st["table"],
              s_aux=sinks, return_softmax_lse=True)

    def call():
        return vllm_flash_attn_varlen_func(
            st["q"], st["k_phd"], st["v_phd"], st["max_q"], st["cu_q"],
            max(contexts), seqused_k=st["used"], **kw)

    def plain():
        outs, lses = [], []
        cu = _cu_of(qlens)
        for j in range(len(qlens)):
            o, lse_j = flash_attention_decode_ref(
                st["q"][cu[j]:cu[j + 1]].float()[None], *st["pools"],
                st["used"][j:j + 1], block_table=st["table"][j:j + 1],
                sink=sinks, window_left=window)
            outs.append(o[0])
            lses.append(lse_j[0])
        return torch.cat(outs), torch.cat(lses, dim=1)

    launches0 = flash_attention_decode_general.launches
    out, lse = call()
    torch.cuda.synchronize()
    launches = flash_attention_decode_general.launches - launches0
    ref_out, ref_lse = plain()
    lse_err = float((lse - ref_lse).abs().max())
    res = dict(out=held(out, ref_out), lse_max_abs_err=lse_err)
    del ref_out, ref_lse
    pairs = kv_rows = 0
    for ql, ctx in zip(qlens, contexts):
        p, n = varlen_pairs(ql, ctx, ctx - ql, window, 0)
        pairs, kv_rows = pairs + p * h, kv_rows + n * hk
    cfg = dict(b=1, sq=sum(qlens), h=h, d=d)
    bound_ms, bound_by = decode_bound(cfg, pairs, kv_rows)
    result = dict(
        phase="decode_kernels", kernel="general_decode",
        case="vllm-gpt-oss-sinks-mixed", model="gpt-oss-20b attention widths",
        qlens=list(qlens), contexts=list(contexts), h=h, hk=hk, d=d,
        window_size=[window, -1], page=VLLM_PAGE, pools="phd",
        kernel5_launches=launches, **res, tolerance=ATTN_TOLERANCE,
        ok=bool(res["out"]["err_over_limit"] <= 1 and lse_err <= ATTN_LSE_TOL
                and launches == 1 and torch.isfinite(out).all()),
        ms=cuda_ms(call), plain_ms=cuda_ms(plain, reps=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, visible_pairs=pairs,
        library_ms=None,
        library="none: no PyTorch call attends through a page table with "
                "sinks")
    emit(result)
    check(result["ok"], "decode_kernels: the vLLM step with sinks disagrees "
                        "with the plain version")
    return result


def decode_fault_phase():
    """The tolerance's power on kernel 5: the kernel handed a window one
    column wider, a leftpad one larger, or a chunk one longer (its
    boundaries moved) than the plain version. Every check must fail."""
    for i, (name, fault) in enumerate(DECODE_FAULTS):
        checked, _ = decode_compare(name, seed=80 + i, fault=fault)
        emit(dict(phase="decode_fault", case=name, kernel_given=fault,
                  err_over_limit=checked["out"]["err_over_limit"],
                  lse_max_abs_err=checked["lse_max_abs_err"],
                  caught=not checked["ok"], ok=not checked["ok"]))
        check(not checked["ok"], f"decode_fault: {fault} in case {name} "
                                 "passes the tolerance")


# -- phases 3 and 4: the model and the engine ---------------------------------

class TimedEngine(LLMEngine):
    """LLMEngine whose steps are timed (host clock around a synchronised
    step) by kind."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.seconds = {"prefill": 0.0, "decode": 0.0}

    def step(self):
        p0 = self.prefill_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().step()
        torch.cuda.synchronize()
        kind = "prefill" if self.prefill_steps > p0 else "decode"
        self.seconds[kind] += time.perf_counter() - t0
        return out


def logits_phase(engine, model, prompt_len=4500, decode_steps=8, seed=1):
    cfg = engine.config
    c = model.config
    dev = engine.device
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, c.vocab_size, prompt_len).tolist()
    needed = -(-(prompt_len + decode_steps) // cfg.page_size)
    table = np.full((1, cfg.max_pages_per_seq), cfg.num_pages, np.int32)  # trash
    table[0, :needed] = rng.permutation(cfg.num_pages)[:needed]
    table_t = torch.from_numpy(table).to(dev)
    rows, positions = [], []
    chunk = cfg.prefill_chunk
    for start in range(0, prompt_len, chunk):
        ids = prompt[start:start + chunk]
        tokens = np.zeros((1, chunk), np.int64)
        tokens[0, :len(ids)] = ids
        logits = engine._apply(
            torch.from_numpy(tokens).to(dev),
            torch.tensor([start], dtype=torch.int32, device=dev), table_t,
            num_last_tokens=chunk)
        rows.append(logits[0, len(ids) - 1])
        positions.append(start + len(ids) - 1)
    seq = list(prompt)
    for i in range(decode_steps):
        nxt = int(rows[-1].argmax())
        seq.append(nxt)
        logits = engine._apply(
            torch.tensor([[nxt]], device=dev),
            torch.tensor([prompt_len + i], dtype=torch.int32, device=dev),
            table_t)
        rows.append(logits[0, -1])
        positions.append(prompt_len + i)
    port = torch.stack(rows)
    ids = torch.tensor([seq], device=dev)
    # fp32 reference in true fp32 (no TF32), then the same plain forward in
    # bf16 eager.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pos_t = torch.tensor(positions, device=dev)
    ref32 = gpt_forward_ref(model, ids, dtype=torch.float32)[0, pos_t]
    ref16 = gpt_forward_ref(model, ids, dtype=torch.bfloat16)[0, pos_t].float()
    err_port = (port - ref32).abs().max().item()
    err_bf16 = (ref16 - ref32).abs().max().item()
    floor = LOGIT_FLOOR_FRACTION * ref32.abs().max().item()
    ok = bool(torch.isfinite(port).all()) and err_port <= 2 * err_bf16 + floor
    result = dict(
        phase="logits", model="Mistral-7B-v0.1 widths, random weights (seed 0)",
        layers=c.n_layer, dtype="bfloat16", prompt_len=prompt_len,
        prefill_chunks=len(range(0, prompt_len, chunk)),
        decode_steps=decode_steps, rows_compared=len(positions),
        max_abs_err_port=err_port, max_abs_err_bf16_eager=err_bf16,
        floor=floor, limit=2 * err_bf16 + floor, ok=ok,
        argmax_agreement=float((port.argmax(-1) == ref32.argmax(-1))
                               .float().mean()),
    )
    emit(result)
    check(ok, "model logits outside the 2x bf16-eager contract")
    return result


def serve_prompt_lens(rng):
    """The 8 prompt lengths of the serve phase (2831, 3862, 2770, 1355,
    3591, 689, 2891, 4144 from seed 2), one of them past the window."""
    lens = rng.randint(256, 5001, 8)
    lens[int(rng.randint(8))] = int(rng.randint(4097, 5001))
    return lens


def serve_phase(engine, model, seed=2):
    c = model.config
    rng = np.random.RandomState(seed)
    lens = serve_prompt_lens(rng)
    prompts = [rng.randint(0, c.vocab_size, int(n)).tolist() for n in lens]
    max_new = 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p0, d0 = engine.prefill_steps, engine.decode_steps
    flash_attention_decode_multipage.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_decode_multipage.launches
    steps = (engine.prefill_steps - p0) + (engine.decode_steps - d0)
    prefill_tokens = int(sum(n - 1 for n in lens))
    decode_tokens = sum(len(o) for o in outs)
    ok = (launches > 0 and launches == c.n_layer * steps
          and all(len(o) == max_new for o in outs)
          and all(0 <= t < c.vocab_size for o in outs for t in o))
    result = dict(
        phase="serve", requests=len(prompts), prompt_lens=lens.tolist(),
        max_new_tokens=max_new, engine=vars(ENGINE) | {"device_put_fn": None},
        prefill_steps=engine.prefill_steps - p0,
        decode_steps=engine.decode_steps - d0,
        prefill_tokens=prefill_tokens, decode_tokens=decode_tokens,
        prefill_s=engine.seconds["prefill"], decode_s=engine.seconds["decode"],
        prefill_tokens_per_s=prefill_tokens / engine.seconds["prefill"],
        decode_tokens_per_s=decode_tokens / engine.seconds["decode"],
        wall_s=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        kernel_launches=launches, layers_x_steps=c.n_layer * steps, ok=ok,
    )
    emit(result)
    check(ok, "serve: launches != layers x steps, or malformed outputs")
    return result


def _zero_all_counts():
    _zero_attn_counts()
    _zero_varlen_counts()
    flash_attention_decode_multipage.launches = 0
    flash_attention_decode_general.launches = 0


def _all_counts():
    return dict(general_decode=flash_attention_decode_general.launches,
                paged_decode=flash_attention_decode_multipage.launches,
                **_attn_counts(), **_varlen_counts())


def _timed(apply_fn, seconds):
    """apply_fn, each call's host-clock time (synchronised) appended to
    `seconds`."""
    def fn(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply_fn(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return fn


def generate_phase(model, logits_limit, seed=6):
    """`model.generate` (contiguous caches, kernel 5 for every attention
    call) at batch 4 on 4500-token prompts, 32 new tokens, greedy, with
    scores: the scores of every batch row at every step against an fp32
    plain forward (one row at a time) under the 2x bf16-eager contract,
    every token the argmax of its step's scores, launches = layers x
    forward calls with no other attention kernel, peak memory; then the
    same decode timed call by call for prefill and decode tokens/s."""
    c = model.config
    dev = model.device
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, c.vocab_size, (GEN_BATCH, GEN_PROMPT))
                           ).to(dev)
    length = GEN_PROMPT + GEN_NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_all_counts()
    t0 = time.perf_counter()
    out = model.generate(ids, length, return_dict_in_generate=True,
                         output_scores=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    seqs, scores = out.sequences, out.scores
    want = {k: 0 for k in counts}
    want["general_decode"] = c.n_layer * GEN_NEW  # 1 prefill + 31 steps
    argmax_ok = bool(torch.equal(scores.argmax(-1), seqs[:, GEN_PROMPT + 1:]))
    # Every row's scores against a plain forward over its own tokens.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err_port = err_bf16 = ref_max = 0.0
    for i in range(GEN_BATCH):
        row = seqs[i:i + 1, :GEN_PROMPT + GEN_NEW - 1]
        ref32 = gpt_forward_ref(model, row, dtype=torch.float32)[0, GEN_PROMPT:]
        ref16 = gpt_forward_ref(model, row, dtype=torch.bfloat16)[
            0, GEN_PROMPT:].float()
        err_port = max(err_port, (scores[i] - ref32).abs().max().item())
        err_bf16 = max(err_bf16, (ref16 - ref32).abs().max().item())
        ref_max = max(ref_max, ref32.abs().max().item())
        del ref32, ref16
    floor = LOGIT_FLOOR_FRACTION * ref_max
    scores_ok = (bool(torch.isfinite(scores).all())
                 and err_port <= 2 * err_bf16 + floor)
    # The same decode again, each forward timed, under torch.profiler
    # (device activity only).
    from torch.profiler import ProfilerActivity, profile

    seconds = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(ids, _timed(make_apply_fn(model, length, GEN_BATCH), seconds),
               model.allocate_inference_cache(GEN_BATCH, length)
               .key_value_memory_dict, GEN_NEW)
    prefill_s, decode_s = seconds[0], sum(seconds[1:])
    by_kernel = _device_ms_by_kernel(prof)
    busy = sum(by_kernel.values())
    k5 = sum(v for k, v in by_kernel.items() if "decode_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    profiled = dict(
        forwards_wall_ms=1e3 * sum(seconds),
        device_busy_ms=busy if busy > 0 else None,
        idle_share=1 - busy / (1e3 * sum(seconds)) if busy > 0 else None,
        general_decode_ms=k5 if busy > 0 else None,
        general_decode_share=k5 / busy if busy > 0 else None,
        top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
    ok = argmax_ok and scores_ok and counts == want
    result = dict(
        phase="generate", model="Mistral-7B-v0.1 widths, random weights (seed 0)",
        layers=c.n_layer, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
        new_tokens=GEN_NEW, cache=f"contiguous (b, hk, {length}, d) bf16 per layer",
        scores_checked=f"all {GEN_BATCH} rows x {GEN_NEW - 1} steps",
        max_abs_err_port=err_port,
        max_abs_err_bf16_eager=err_bf16, floor=floor,
        limit=2 * err_bf16 + floor, scores_ok=scores_ok,
        tokens_are_argmax_of_scores=argmax_ok, launches=counts,
        launches_expected=want, wall_s=wall, peak_memory_gb=peak,
        prefill_s=prefill_s,
        prefill_tokens_per_s=GEN_BATCH * GEN_PROMPT / prefill_s,
        decode_steps=len(seconds) - 1, decode_s=decode_s,
        decode_tokens_per_s=GEN_BATCH * (len(seconds) - 1) / decode_s,
        profile=profiled, logits_limit_of_logits_phase=logits_limit, ok=ok)
    emit(result)
    check(ok, "generate: scores outside the 2x bf16-eager contract, a token "
              "not the argmax of its step, or launches off the count")
    return result


def _speculative(model, draft, ids, new_tokens):
    """decode_speculative of `new_tokens` (gamma SPEC_GAMMA, greedy) with
    fresh caches, launch counts zeroed before it: (output, verify rounds,
    launch counts, seconds, launches expected)."""
    slots = ids.shape[1] + new_tokens + SPEC_GAMMA + 1
    target_calls = [0]
    target_apply = make_apply_fn(model, slots, 1)

    def counted(*args):
        target_calls[0] += 1
        return target_apply(*args)

    target_caches = model.allocate_inference_cache(1, slots).key_value_memory_dict
    draft_caches = draft.allocate_inference_cache(1, slots).key_value_memory_dict
    torch.cuda.synchronize()
    _zero_all_counts()
    t0 = time.perf_counter()
    out = decode_speculative(ids, counted, target_caches,
                             make_apply_fn(draft, slots, 1), draft_caches,
                             new_tokens, gamma=SPEC_GAMMA)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _all_counts()
    rounds = target_calls[0] - 1
    want = dict({k: 0 for k in counts},
                general_decode=(model.config.n_layer * (1 + rounds)
                                + draft.config.n_layer
                                * (1 + SPEC_GAMMA * rounds)))
    return out, rounds, counts, seconds, want


def _tokens_held(model, seq, prompt_len, logits_limit):
    """Each new token of `seq` (1, prompt + new) against one fp32 plain
    forward over the sequence: the token's logit must lie within twice the
    logits tolerance of the step's largest (a token that is the argmax of
    logits within L of the reference's lies within 2L of its maximum).
    Returns (ok, worst margin, tokens that are not the reference's
    argmax)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = gpt_forward_ref(model, seq[:, :-1], dtype=torch.float32)[
        0, prompt_len - 1:]
    tokens = seq[0, prompt_len:].long()
    margin = ref.max(dim=-1).values - ref.gather(1, tokens[:, None])[:, 0]
    worst = float(margin.max())
    return (worst <= 2 * logits_limit, worst,
            int((ref.argmax(dim=-1) != tokens).sum()))


SPEC_SELF_NEW = 16


def speculative_phase(model, logits_limit, seed=7):
    """decode_speculative (gamma 4, batch 1, a 1024-token prompt, 64 new
    tokens): the Mistral-width target with a TinyLlama-1.1B-width draft
    (random weights, seed 1). Every new token is held against one fp32
    plain forward of the target over the speculative sequence
    (`_tokens_held`); the tokens must equal the target's greedy generate,
    except past a step whose top-2 logit margin is within the logits
    tolerance (printed). Then a short run with the target as its own draft,
    so that drafts are accepted: at least half of them must be, and its
    tokens are held the same way. Rounds, accepted drafts per round,
    tokens/s beside plain greedy generate's, kernel-5 launches per run."""
    dev = model.device
    draft_cfg = llama_config_to_gpt_config(TINYLLAMA_1B)
    draft = GPTLMHeadModel(draft_cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, model.config.vocab_size,
                                       (1, SPEC_PROMPT))).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = model.generate(ids, SPEC_PROMPT + SPEC_NEW,
                           return_dict_in_generate=True, output_scores=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    out, rounds, counts, spec_s, launches_want = _speculative(
        model, draft, ids, SPEC_NEW)
    del draft
    committed = int(out.lengths[0])
    got = out.sequences[0, SPEC_PROMPT:]
    want = plain.sequences[0, SPEC_PROMPT:]
    differ = (got != want).nonzero()
    divergence = None
    if len(differ):
        j = int(differ[0])
        if j == 0:
            with torch.no_grad():
                logits = model(ids, num_last_tokens=1)[0, -1].float()
        else:
            logits = plain.scores[0, j - 1]
        top2 = logits.topk(2).values
        divergence = dict(step=j, target_top2_margin=float(top2[0] - top2[1]),
                          logits_limit=logits_limit)
    held_ok, worst, not_argmax = _tokens_held(model, out.sequences,
                                              SPEC_PROMPT, logits_limit)
    # The target as its own draft: the accept path.
    self_out, self_rounds, self_counts, self_s, self_want = _speculative(
        model, model, ids, SPEC_SELF_NEW)
    self_accepted = int(self_out.lengths[0]) - self_rounds
    self_ok, self_worst, self_not_argmax = _tokens_held(
        model, self_out.sequences, SPEC_PROMPT, logits_limit)
    self_run = dict(
        new_tokens=SPEC_SELF_NEW, rounds=self_rounds,
        accepted=self_accepted,
        accepted_per_round=self_accepted / max(self_rounds, 1),
        tokens_held=self_ok, worst_margin=self_worst,
        tokens_not_ref_argmax=self_not_argmax, spec_s=self_s,
        launches=self_counts, launches_expected=self_want,
        ok=bool(self_ok and self_counts == self_want
                and 2 * self_accepted >= SPEC_GAMMA * self_rounds))
    ok = (got.shape == want.shape and counts == launches_want and held_ok
          and self_run["ok"]
          and (divergence is None
               or divergence["target_top2_margin"] <= logits_limit))
    result = dict(
        phase="speculative", target="Mistral-7B-v0.1 widths (seed 0)",
        draft="TinyLlama-1.1B widths, random weights (seed 1)",
        gamma=SPEC_GAMMA, prompt_len=SPEC_PROMPT, new_tokens=SPEC_NEW,
        rounds=rounds, committed=committed,
        accepted_per_round=(committed - rounds) / max(rounds, 1),
        tokens_held=held_ok, worst_margin=worst,
        margin_limit=2 * logits_limit, tokens_not_ref_argmax=not_argmax,
        equal_to_greedy=divergence is None, divergence=divergence,
        spec_s=spec_s, spec_tokens_per_s=SPEC_NEW / spec_s,
        greedy_generate_s=plain_s, greedy_tokens_per_s=SPEC_NEW / plain_s,
        launches=counts, launches_expected=launches_want,
        self_draft=self_run, ok=ok)
    emit(result)
    check(ok, "speculative: a token off the plain forward, tokens differ from "
              "greedy generate away from a near-tie, too few drafts accepted "
              "with the target as its own draft, or launches off the count")
    return result


def _device_ms_by_kernel(prof):
    """{kernel name: device ms} from a torch.profiler run."""
    from torch.autograd import DeviceType

    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def profile_phase(engine, model, n_requests=8, prompt_len=2048, max_new=8,
                  seed=3):
    """Where a step's time goes: torch.profiler (device activity only, to
    keep its cost on the host small) over all prefill steps and then all
    decode steps of a small batch, device time by kernel beside the
    host-clock wall time. Reports, checks nothing."""
    from torch.profiler import ProfilerActivity, profile

    c = model.config
    rng = np.random.RandomState(seed)
    base = max(engine.outputs.keys(), default=-1) + 1
    ids = range(base, base + n_requests)
    for rid in ids:
        engine.add_request(rid,
                           rng.randint(0, c.vocab_size, prompt_len).tolist(),
                           max_new)
    result = dict(phase="profile", requests=n_requests, prompt_len=prompt_len,
                  max_new_tokens=max_new)
    acts = [ProfilerActivity.CUDA]
    more = {
        # waiting or prefilling (scheduler states 0 and 1)
        "prefill": lambda: any(engine.sched.request_state(r) in (0, 1)
                               for r in ids),
        "decode": lambda: engine.sched.num_active() > 0,
    }
    for kind in ("prefill", "decode"):
        steps = 0
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while more[kind]():
                engine.step()
                steps += 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = _device_ms_by_kernel(prof)
        busy = sum(by_kernel.values())
        attn = sum(v for k, v in by_kernel.items() if "paged_decode" in k)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        result[kind] = dict(
            steps=steps, wall_ms=wall_ms,
            device_busy_ms=busy if busy > 0 else None,
            idle_share=1 - busy / wall_ms if busy > 0 else None,
            paged_decode_ms=attn if busy > 0 else None,
            paged_decode_share=attn / busy if busy > 0 else None,
            top_kernels=[dict(name=k[:80], ms=v) for k, v in top],
        )
    emit(result)
    return result


# -- phases: train_grad, train, train profile (GPT-2-medium) -----------------

GPT2M_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "gpt2m-synth.yaml")
TRAIN_STEPS, TRAIN_WARMUP = 20, 5
# Training gradient contract: for the loss and for the worst per-tensor
# relative gradient error (max |g - g32| / max |g32|), the port's error
# against the fp32 plain model is at most 2x that of the same plain model
# run in bf16 eager, plus a floor for the bf16 rounding both pay: 1e-3 of
# the loss, 1e-2 relative for a gradient (bf16 keeps 8 bits: 2^-8 = 0.4%).
# The k-projection biases are left out: their exact gradient is 0 (they
# shift a softmax row uniformly), so their relative error is of noise.
LOSS_FLOOR_FRACTION, GRAD_FLOOR = 1e-3, 1e-2


def _max_rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def _attn_counts():
    return dict(flash_fwd=flash_attention_fwd.launches,
                flash_bwd_dkv=flash_attention_bwd_dkv.launches,
                flash_bwd_dq=flash_attention_bwd_dq.launches)


def _zero_attn_counts():
    flash_attention_fwd.launches = 0
    flash_attention_bwd_dkv.launches = 0
    flash_attention_bwd_dq.launches = 0


def _expected_counts(config, steps):
    """Launches of a training run: per layer and step one forward, and a
    second one when remat recomputes it in the backward; one dK/dV and one
    dQ."""
    fwd = 2 if config.remat != "none" else 1
    return dict(flash_fwd=fwd * config.n_layer * steps,
                flash_bwd_dkv=config.n_layer * steps,
                flash_bwd_dq=config.n_layer * steps)


def train_grad_phase(batch=1, seed=4):
    """One loss and gradient of the full-depth GPT-2-medium model through
    the port (kernels, bf16 compute, fp32 params) against the plain model
    in fp32 and in bf16 eager."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, _, dcfg = load_config(GPT2M_CONFIG)
    model = GPTLMHeadModel(
        config, device="cuda", param_dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(
        0, config.vocab_size, (batch, dcfg["seqlen"] + 1))).cuda()
    ids, labels = tokens[:, :-1], tokens[:, 1:]
    _zero_attn_counts()
    loss = cross_entropy_loss(model(ids).float(), labels)
    grads = torch.autograd.grad(loss, params)
    counts = _attn_counts()
    loss32 = gpt_loss_ref(model, ids, labels, dtype=torch.float32)
    grads32 = torch.autograd.grad(loss32, params)
    loss16 = gpt_loss_ref(model, ids, labels, dtype=torch.bfloat16)
    grads16 = torch.autograd.grad(loss16, params)

    def worst(gs):
        errs = {n: _max_rel(g, g32) for n, g, g32 in zip(names, gs, grads32)
                if not n.endswith("mixer.Wk.bias")}
        name = max(errs, key=errs.get)
        return errs[name], name

    port_grad, port_at = worst(grads)
    bf16_grad, bf16_at = worst(grads16)
    loss_err = abs(loss.item() - loss32.item())
    loss_err16 = abs(loss16.item() - loss32.item())
    loss_floor = LOSS_FLOOR_FRACTION * abs(loss32.item())
    ok = (all(bool(torch.isfinite(g).all()) for g in grads)
          and loss_err <= 2 * loss_err16 + loss_floor
          and port_grad <= 2 * bf16_grad + GRAD_FLOOR
          and counts == _expected_counts(config, 1))
    result = dict(
        phase="train_grad", model="gpt2m (configs/gpt2m-synth.yaml), random "
        f"fp32 weights (seed {seed})", layers=config.n_layer,
        params_m=sum(p.numel() for p in params) / 1e6, batch=batch,
        seqlen=dcfg["seqlen"], compute_dtype="bfloat16", remat=config.remat,
        loss_port=loss.item(), loss_fp32=loss32.item(),
        loss_bf16_eager=loss16.item(), loss_err_port=loss_err,
        loss_err_bf16_eager=loss_err16, loss_limit=2 * loss_err16 + loss_floor,
        grad_rel_err_port=port_grad, grad_worst_tensor_port=port_at,
        grad_rel_err_bf16_eager=bf16_grad, grad_worst_tensor_bf16=bf16_at,
        grad_limit=2 * bf16_grad + GRAD_FLOOR, launches=counts,
        contract="err <= 2 x bf16-eager err + floor (loss: 1e-3 |loss|, "
                 "gradients: 1e-2 relative)", ok=ok)
    emit(result)
    check(ok, "train_grad outside the 2x bf16-eager contract or launches "
              "off the count")
    return result


def train_phase():
    """`training.run.main` on configs/gpt2m-synth.yaml as it is, cut to
    TRAIN_STEPS steps with a short warmup; launches of the three attention
    kernels counted over this phase only."""
    argv = ["--config", GPT2M_CONFIG,
            "--set", f"train.total_steps={TRAIN_STEPS}",
            "--set", f"train.warmup_steps={TRAIN_WARMUP}"]
    config, train_config, dcfg = load_config(GPT2M_CONFIG, argv[3::2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_attn_counts()
    t0 = time.perf_counter()
    report = train_run.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _attn_counts()
    steps = report["steps"]
    losses = [s["loss"] for s in steps]
    n = len(steps)
    want = _expected_counts(config, n)
    ok = (n == TRAIN_STEPS and all(np.isfinite(losses))
          and losses[-1] < losses[0] and counts == want)
    result = dict(
        phase="train", config="configs/gpt2m-synth.yaml",
        overrides=argv[2:], layers=config.n_layer, n_embd=config.n_embd,
        heads=config.n_head, vocab=config.vocab_size, remat=config.remat,
        batch=dcfg["batch_size"], seqlen=dcfg["seqlen"],
        steps=steps, tokens_per_s=report["tokens_per_s"], mfu=report["mfu"],
        mfu_peak="989 TFLOP/s (H100 SXM bf16 dense, data sheet)",
        wall_s=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, launches_expected=want, ok=ok)
    emit(result)
    check(ok, "train: non-finite or non-falling loss, or launches off "
              "the count")
    return result


def train_profile_phase(seed=5):
    """Where one training step's time goes: torch.profiler (device activity
    only) over one step of the gpt2m trainer after a warm-up step, device
    time by kernel beside the host-clock wall time. Reports, checks
    nothing."""
    from torch.profiler import ProfilerActivity, profile

    config, train_config, dcfg = load_config(GPT2M_CONFIG)
    model = GPTLMHeadModel(
        config, device="cuda", param_dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    trainer = Trainer(model, train_config)
    rng = np.random.RandomState(seed)
    shape = (dcfg["batch_size"], dcfg["seqlen"] + 1)
    batches = [rng.randint(0, config.vocab_size, shape) for _ in range(2)]
    trainer.train_step(batches[0][:, :-1], batches[0][:, 1:])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batches[1][:, :-1], batches[1][:, 1:])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = _device_ms_by_kernel(prof)
    busy = sum(by_kernel.values())
    attn = {name: sum(v for k, v in by_kernel.items() if name in k)
            for name in ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                         "flash_bwd_dq_kernel")}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    result = dict(
        phase="profile", path="train step", config="configs/gpt2m-synth.yaml",
        batch=dcfg["batch_size"], seqlen=dcfg["seqlen"], wall_ms=wall_ms,
        device_busy_ms=busy if busy > 0 else None,
        idle_share=1 - busy / wall_ms if busy > 0 else None,
        attention_ms=attn, attention_share=(sum(attn.values()) / busy
                                            if busy > 0 else None),
        top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
    emit(result)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", nargs="+",
        choices=("kernel", "attn", "varlen", "vllm", "decode"),
        help="run only these kernel phases (kernel, attn_kernels + attn_fault, "
             "varlen_kernels + varlen_fault + varlen_train, vllm, "
             "decode_kernels + decode_fault) and stop, with no result line: "
             "for iterating on one kernel")
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = smi()
    t0 = time.perf_counter()
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    logs = _build.build_libraries(sources)
    build_s = time.perf_counter() - t0
    emit(dict(phase="env", python=sys.version.split()[0], torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              nvidia_smi=card, build_s=build_s, sources=sources,
              ptxas=[ln.strip() for log in logs.values()
                     for ln in log.splitlines() if "registers" in ln
                     or "spill" in ln or "Function properties" in ln]))

    if only:
        if "kernel" in only:
            for i, case in enumerate(CASES):
                kernel_case(*case, seed=10 + i)
        if "attn" in only:
            for i, c in enumerate(ATTN_CASES):
                attn_case(*c, seed=20 + i)
            attn_fault_phase()
        if "varlen" in only:
            for i, name in enumerate(VARLEN_CASES):
                varlen_case(name, seed=30 + i)
            paged_cases()
            varlen_fault_phase()
            varlen_train_phase()
        if "vllm" in only:
            vllm_phase()
        if "decode" in only:
            for i, name in enumerate(DECODE_CASES):
                decode_case(name, seed=70 + i)
            vllm_sinks_case()
            decode_fault_phase()
        print(smi(), flush=True)
        return 0

    cases = [kernel_case(*case, seed=10 + i) for i, case in enumerate(CASES)]
    attn = {c[0]: attn_case(*c, seed=20 + i) for i, c in enumerate(ATTN_CASES)}
    attn_fault_phase()
    varlen = {name: varlen_case(name, seed=30 + i)
              for i, name in enumerate(VARLEN_CASES)}
    paged = paged_cases()
    varlen_fault_phase()
    vtrain = varlen_train_phase()
    vllm = vllm_phase()
    gc.collect()
    torch.cuda.empty_cache()
    decodes = {name: decode_case(name, seed=70 + i)
               for i, name in enumerate(DECODE_CASES)}
    vllm_sinks = vllm_sinks_case()
    decode_fault_phase()
    gc.collect()
    torch.cuda.empty_cache()

    config = llama_config_to_gpt_config(MISTRAL_7B)
    t0 = time.perf_counter()
    model = GPTLMHeadModel(config, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    engine = TimedEngine(model, ENGINE, device="cuda")
    torch.cuda.synchronize()
    emit(dict(phase="model", layers=config.n_layer,
              params_b=sum(p.numel() for p in model.parameters()) / 1e9,
              init_s=time.perf_counter() - t0,
              memory_gb=torch.cuda.memory_allocated() / 1e9))
    logits = logits_phase(engine, model)
    serve = serve_phase(engine, model)
    profile_phase(engine, model)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    gen = generate_phase(model, logits["limit"])
    spec = speculative_phase(model, logits["limit"])
    del model
    gc.collect()
    torch.cuda.empty_cache()

    train_grad_phase()
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    train_profile_phase()

    decode, prefill, phd = cases[0], cases[4], cases[6]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict(
        name="paged_decode", route="cuda",
        source="flash_attn_tpu_torch/csrc/paged_decode.cu",
        replaces="flash_attn_tpu/kernels/flash_decode_multipage.py:65",
        launches=serve["kernel_launches"],
        launches_by_path=dict(serve=serve["kernel_launches"],
                              vllm=vllm["launches"]["paged_decode"]),
        phd_view=dict({k: phd[k] for k in keys},
                      shape="decode on vLLM phd pools as views, split, "
                            "window 4095"),
        max_abs_err=max(c["max_abs_err"] for c in cases),
        max_err=max(c["max_abs_err"] for c in cases),
        kernel_ms=decode["ms"],
        **{k: decode[k] for k in keys},
        shape="decode: b=8 sq=1 h=32 hk=8 d=128 page=16 fused, window 4095",
        prefill=dict({k: prefill[k] for k in keys},
                     shape="prefill chunk: b=8 sq=256, otherwise as decode"),
    )]
    dec, pre = decodes["decode"], decodes["prefill"]
    general_err = max([c["out"]["max_abs_err"] for c in decodes.values()]
                      + [vllm_sinks["out"]["max_abs_err"]])
    kernels.append(dict(
        name="general_decode", route="cuda",
        source="flash_attn_tpu_torch/csrc/decode.cu",
        replaces="flash_attn_tpu/kernels/flash_decode.py:56",
        launches=gen["launches"]["general_decode"],
        launches_by_path=dict(
            generate=gen["launches"]["general_decode"],
            speculative=spec["launches"]["general_decode"],
            vllm_sinks=vllm_sinks["kernel5_launches"]),
        max_abs_err=general_err, max_err=general_err,
        **{k: dec[k] for k in keys},
        shape="decode: b=8 sq=1 h=32 hk=8 d=128 contiguous smax 4608, "
              "window 4095, bf16",
        prefill=dict({k: pre[k] for k in keys},
                     shape="generate's prefill: b=4 sq=4500 smax 4532, "
                           "otherwise as decode"),
        vllm_sinks=dict({k: vllm_sinks[k] for k in keys},
                        shape="vLLM mixed step with s_aux, gpt-oss-20b "
                              "widths, phd page 16"),
    ))
    gpt2m, mistral = attn["gpt2m"], attn["mistral-window"]
    for name, key, source, replaces, tensors in (
            ("flash_fwd", "fwd", "flash_fwd.cu", "flash_fwd.py:95", ("out",)),
            ("flash_bwd_dkv", "dkv", "flash_bwd.cu", "flash_bwd.py:233",
             ("dk", "dv")),
            ("flash_bwd_dq", "dq", "flash_bwd.cu", "flash_bwd.py:449",
             ("dq", "delta"))):
        err = max(c[t]["max_abs_err"] for c in attn.values() for t in tensors)
        library = gpt2m["library_fwd_ms"] if key == "fwd" else None
        kernels.append(dict(
            name=name, route="cuda",
            source=f"flash_attn_tpu_torch/csrc/{source}",
            replaces=f"flash_attn_tpu/kernels/{replaces}",
            launches=train["launches"][name], max_abs_err=err, max_err=err,
            ms=gpt2m[f"{key}_ms"], kernel_ms=gpt2m[f"{key}_ms"],
            plain_ms=gpt2m[f"{key}_plain_ms"],
            bound_ms=gpt2m[f"{key}_bound_ms"],
            bound_by=gpt2m[f"{key}_bound_by"], library_ms=library,
            shape="gpt2m: b=8 h=hk=16 s=2048 d=64 causal bf16",
            mistral=dict(ms=mistral[f"{key}_ms"],
                         plain_ms=mistral[f"{key}_plain_ms"],
                         bound_ms=mistral[f"{key}_bound_ms"],
                         bound_by=mistral[f"{key}_bound_by"],
                         library_ms=(mistral["library_fwd_ms"]
                                     if key == "fwd" else None),
                         shape="b=1 h=32 hk=8 s=8192 d=128 causal window "
                               "4095 bf16"),
        ))
    gpt2m_v, p16 = varlen["gpt2m-packed"], paged[16]
    for name, key, source, replaces, tensors in (
            ("flash_varlen_fwd", "fwd", "flash_fwd.cu", "flash_varlen.py:542",
             ("out",)),
            ("flash_varlen_bwd_dkv", "dkv", "flash_bwd.cu",
             "flash_varlen.py:883", ("dk", "dv")),
            ("flash_varlen_bwd_dq", "dq", "flash_bwd.cu", "flash_varlen.py:1005",
             ("dq", "delta"))):
        err = max(c[t]["max_abs_err"] for c in varlen.values() for t in tensors)
        by_path = dict(varlen_train=vtrain["launches"][name],
                       vllm=vllm["launches"][name])
        entry = dict(
            name=name, route="cuda",
            source=f"flash_attn_tpu_torch/csrc/{source}",
            replaces=f"flash_attn_tpu/kernels/{replaces}",
            launches=by_path["vllm"] if key == "fwd" else by_path["varlen_train"],
            launches_by_path=by_path, max_abs_err=err,
            ms=gpt2m_v[f"{key}_ms"], plain_ms=gpt2m_v[f"{key}_plain_ms"],
            bound_ms=gpt2m_v[f"{key}_bound_ms"],
            bound_by=gpt2m_v[f"{key}_bound_by"],
            library_ms=gpt2m_v.get("library_fwd_ms") if key == "fwd" else None,
            shape=f"gpt2m packed: 16384 tokens in {len(GPT2M_DOCS)} documents, "
                  "h=hk=16 d=64 causal bf16")
        if key == "fwd":
            entry["max_abs_err"] = max(err, *(r["out"]["max_abs_err"]
                                              for r in paged.values()))
            entry["paged"] = dict(
                ms=p16["fwd_ms"], plain_ms=p16["fwd_plain_ms"],
                bound_ms=p16["fwd_bound_ms"], bound_by=p16["fwd_bound_by"],
                library_ms=None,
                shape="Mistral paged prefill: 4 x 512-token chunks at "
                      "contexts 2831-6000, h=32 hk=8 d=128, window 4095, "
                      "page 16, phd views")
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
