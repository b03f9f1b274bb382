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
     sparse_kernels, sparse_fault, sparse_autograd, sparse_crossover,
     sparse_vllm  vertical-slash sparse attention (kernels 12-15): both
              forward routes and the backward against their plain versions
              on MInference-style metadata (the 32768-token Mistral-width
              prefill, 8192 forward and backward, d 64, ALiBi + softcap
              fp16, padded lengths, overlaps and garbage, empty blocks),
              each with a slash offset moved by one column that every check
              must catch; sparse_attn_func's autograd with launches
              counted; sparse against dense over contexts, densities and
              slash shares, and the crossover fit; a 32-layer prefill step
              of two packed sequences through vllm_compat's
              sparse_attn_varlen_func, host syncs made errors;
     blocksparse_kernels, blocksparse_fault, blocksparse_train,
     blocksparse_varlen  mask_mod attention over block-sparse plans
              (kernels 9-11) against their plain versions: the doc5, doc10
              and prefix masks and an aux-table document mask of
              benchmarks/benchmark_blocksparse.py, doc10 at Mistral-7B
              widths, d 64 fp16 with a softcap and a broadcast single-head
              plan, fast sampling, no full blocks, a plan with no mod, rows
              that keep nothing; a row's word shifted and a sub-tile
              dropped, which every check must catch; GPT-2-medium's packed
              documents through 24 layers of flash_attn_func fwd+bwd with
              one plan per step, host syncs made errors, held against
              kernels 6-8; and flash_attn_varlen_func over a varlen plan;
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
import collections
import dataclasses
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
    flash_attn_func,
    flash_attn_varlen_func,
    sparse_attn_func,
)
from flash_attn_tpu_torch.kernels import _build  # noqa: E402
from flash_attn_tpu_torch.kernels.block_sparsity import (  # noqa: E402
    BlockSparseTensors,
    _blocksparse_dkv_ref,
    _blocksparse_dq_ref,
    block_sparse_keep_mask,
    build_execution_lists,
    compute_block_sparsity,
    compute_block_sparsity_varlen,
    flash_attention_blocksparse_bwd_dkv,
    flash_attention_blocksparse_bwd_dq,
    flash_attention_blocksparse_fwd,
    flash_attention_blocksparse_fwd_ref,
    prepare_lists,
)
from flash_attn_tpu_torch.kernels.flash_bwd import (  # noqa: E402
    _bwd_dkv_ref,
    _bwd_dq_ref,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from flash_attn_tpu_torch.kernels.common import (  # noqa: E402
    aux_take,
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
from flash_attn_tpu_torch.kernels.flash_sparse import (  # noqa: E402
    _sparse_dkv_ref,
    _sparse_dq_ref,
    column_limits,
    flash_attention_sparse_bwd_dkv,
    flash_attention_sparse_bwd_dq,
    flash_attention_sparse_fwd_ref,
    flash_attention_sparse_tiles_fwd,
    plan_inverse,
    plan_sparse,
    sparse_route,
    visible_chunks,
)
from flash_attn_tpu_torch.kernels.flash_sparse_gather import (  # noqa: E402
    flash_attention_sparse_gather_fwd,
    plan_gather,
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
from flash_attn_tpu_torch.utils import sparse_crossover  # noqa: E402
from flash_attn_tpu_torch.utils.fa_logging import dispatch_counts  # noqa: E402
from flash_attn_tpu_torch.utils.sparse_crossover import (  # noqa: E402
    fit_crossover,
    metadata_density,
)
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
from flash_attn_tpu_torch.vllm_compat import (  # noqa: E402
    sparse_attn_varlen_func as vllm_sparse_attn_varlen_func,
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


_START = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's line also carries t_s, the seconds
    since the script started (a phase's wall time is the step from the line
    before)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _START)
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


# -- phases: sparse_kernels, sparse_fault, sparse_autograd, sparse_crossover,
#    sparse_vllm (vertical-slash sparse attention, kernels 12-15) ------------

# Synthetic traffic. The (vertical, slash) top-k sizes are candidates of
# the search space that MInference (arXiv 2407.02490) describes for its
# vertical-slash heads, as recalled, not its per-head configuration of a
# 7-8B model, which is not in this repository; the heads here take them in
# turn. Where the slash diagonals lie has no source: MINF_LOCAL of them lie
# next to the main diagonal, the rest are drawn over the context. Every
# timing of the sparse phases holds for this traffic only (PERF.md).
MINF_HEADS = ((30, 800), (100, 750), (500, 700), (3500, 100))
MINF_LOCAL = 0.9


def vs_metadata(b, h, sq, sk, heads, causal, seed, garbage=False):
    """Seeded MInference-style metadata on the card, built as vLLM's
    convert_vertical_slash_indexes builds it: per (batch row, head) the
    `slash` diagonals, those closer than 64 merged into one range, emitted
    per 64-row block as 64-column slash blocks at unaligned offsets from the
    block's last row (clamped at 0); the `vertical` columns (the first 4
    and the rest drawn) that the block's rows can see, outside its ranges.
    Entries past the counts hold leftovers, or random values with garbage.
    `heads` is a (vertical, slash) pair per head, taken in turn."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    nqb = -(-sq // 64)
    e = torch.arange(1, nqb + 1, device=dev)[:, None] * 64 + (sk - sq)
    limit = torch.minimum(e, torch.tensor(sk, device=dev)) if causal else sk
    rows = []
    for _ in range(b):
        for hi in range(h):
            n_v, n_s = heads[hi % len(heads)]
            n_s = max(1, min(n_s, sk))
            n_loc = min(int(np.ceil(MINF_LOCAL * n_s)), sk)
            far = (rng.choice(np.arange(n_loc, sk), min(n_s - n_loc,
                                                        sk - n_loc),
                              replace=False) if sk > n_loc else [])
            deltas = np.sort(np.concatenate([np.arange(n_loc), far]))
            cut = np.nonzero(np.diff(deltas) > 64)[0] + 1
            lo = deltas[np.r_[0, cut]]
            hi_ = deltas[np.r_[cut - 1, len(deltas) - 1]]
            rel = np.sort(np.concatenate([
                -64 - top + 64 * np.arange(-(-(top - bot + 64) // 64))
                for bot, top in zip(lo, hi_)]))
            off = e + torch.from_numpy(rel).to(dev)
            ok = (off > -64) & (off < limit)
            order = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)
            off = off.clamp_min(0).gather(1, order)
            n_v = min(n_v, sk // 2)
            cols = np.unique(np.concatenate([
                np.arange(min(4, sk)),
                rng.choice(np.arange(4, sk), max(n_v - 4, 0), replace=False)]))
            c = torch.from_numpy(cols).to(dev)[None]
            x = e - c - 1  # the diagonal distance of column c from the block
            gi = torch.searchsorted(torch.from_numpy(lo).to(dev),
                                    x.contiguous(), right=True) - 1
            hi_t = torch.from_numpy(hi_).to(dev)
            inside = (gi >= 0) & (x <= hi_t[gi.clamp_min(0)] + 63)
            okv = ~inside & (c < limit)
            order = torch.argsort((~okv).to(torch.int8), dim=1, stable=True)
            rows.append((off, ok.sum(1), c.expand(nqb, -1).gather(1, order),
                         okv.sum(1)))
    ns = max(r[0].shape[1] for r in rows)
    nv = max(r[2].shape[1] for r in rows)

    def stack(i, n):
        out = torch.stack([torch.nn.functional.pad(r[i], (0, n - r[i].shape[1]),
                                                   value=-1) for r in rows])
        return out.reshape(b, h, nqb, n).int()

    bo, ci = stack(0, ns), stack(2, nv)
    bc = torch.stack([r[1] for r in rows]).reshape(b, h, nqb).int()
    cc = torch.stack([r[3] for r in rows]).reshape(b, h, nqb).int()
    if garbage:
        g = torch.Generator(device=dev).manual_seed(seed)
        for lst, cnt in ((bo, bc), (ci, cc)):
            junk = torch.randint(-256, 2 * sk, lst.shape, generator=g,
                                 device=dev, dtype=torch.int32)
            past = torch.arange(lst.shape[-1], device=dev) >= cnt[..., None]
            lst[past] = junk[past]
    return bc.contiguous(), bo.contiguous(), cc.contiguous(), ci.contiguous()


def vs_variant(meta, variant):
    """"overlap": each block's first slash range also 17 columns later and
    repeated, its first vertical column repeated and a column inside that
    range added (union semantics); "empty": every third block's counts 0."""
    bc, bo, cc, ci = (x.clone() for x in meta)
    if variant == "overlap":
        has = (bc >= 1).int()
        bo = torch.cat([bo[..., :1] + 17, bo[..., :1], bo], -1)
        bc = bc + 2 * has
        ci = torch.cat([ci[..., :1], bo[..., 1:2] + 5, ci], -1)
        cc = cc + 2 * ((cc >= 1) & (bc >= 1)).int()
    elif variant == "empty":
        bc[..., ::3] = 0
        cc[..., ::3] = 0
    return tuple(x.contiguous() for x in (bc, bo, cc, ci))


def vs_cover(meta, bi, hi, sk):
    """(nqb, sk + 64) int32: how many slash ranges and vertical entries of
    (bi, hi) cover each column, per 64-row block (for planting faults)."""
    bc, bo, cc, ci = meta
    dev = bo.device
    nqb = bo.shape[2]
    width = sk + 64
    steps = torch.zeros(nqb, width + 1, dtype=torch.int32, device=dev)
    ok = torch.arange(bo.shape[-1], device=dev)[None] < bc[bi, hi, :, None]
    lo = bo[bi, hi].long().clamp(0, width)
    hi_ = (bo[bi, hi].long() + 64).clamp(0, width)
    steps.scatter_add_(1, torch.where(ok, lo, width), ok.int())
    steps.scatter_add_(1, torch.where(ok, hi_, width), -ok.int())
    cover = steps[:, :width].cumsum(1).int()
    okv = ((torch.arange(ci.shape[-1], device=dev)[None] < cc[bi, hi, :, None])
           & (ci[bi, hi] >= 0) & (ci[bi, hi] < width))
    cover.scatter_add_(1, torch.where(okv, ci[bi, hi].long(), 0), okv.int())
    return cover


def vs_planted(meta, sq, sk, causal, lens_q=None, lens_k=None):
    """The metadata with one slash offset per 64-row block moved by one
    column: right where the column lost (the old offset) and the one
    gained (old offset + 64) are both visible to some row of the block and
    covered by nothing else, else left where the same holds for columns
    old offset + 63 and old offset - 1. Returns (planted metadata, blocks
    changed)."""
    bc, bo, cc, ci = meta
    b, h, nqb, ns = bo.shape
    lim = column_limits(b, sq, sk, causal, lens_q, lens_k, bo.device)
    bo = bo.clone()
    moved = 0
    for bi in range(b):
        for hi in range(h):
            cover = vs_cover(meta, bi, hi, sk)
            off = bo[bi, hi].long()
            listed = (torch.arange(ns, device=bo.device)[None]
                      < bc[bi, hi, :, None])
            lim_b = lim[bi, :, None]

            def alone(col, n):  # covered n times and visible to some row
                safe = col.clamp(0, sk + 63)
                return (col >= 0) & (col < lim_b) & (cover.gather(1, safe) == n)

            right = listed & alone(off, 1) & alone(off + 64, 0)
            left = listed & alone(off + 63, 1) & alone(off - 1, 0)
            pick = torch.arange(nqb, device=bo.device)
            use_right = right.any(1)
            first = torch.where(use_right, torch.argmax(right.int(), 1),
                                torch.argmax(left.int(), 1))
            shift = torch.where(use_right, 1, -left.any(1).int())
            bo[bi, hi, pick, first] += shift.int()
            moved += int((shift != 0).sum())
    return (bc, bo, cc, ci), moved


# (b, h, hk, sq, sk, d, causal, dtype, softcap, alibi, lens, variant, bwd)
SPARSE_CASES = {
    # vLLM's long-context prefill at Mistral-7B widths: forward only.
    "vllm-prefill-32k": (1, H, HK, 32768, 32768, D, True, torch.bfloat16, 0.0,
                         False, None, None, False),
    "prefill-8k": (1, H, HK, 8192, 8192, D, True, torch.bfloat16, 0.0, False,
                   None, None, True),
    "tinyllama-d64-noncausal": (2, 32, 4, 1000, 3000, 64, False,
                                torch.bfloat16, 0.0, False, None, None, True),
    "alibi-softcap-fp16": (2, 8, 2, 2048, 2048, D, True, torch.float16, 30.0,
                           True, None, None, True),
    "padded-varlen": (3, 8, 2, 2048, 2048, D, True, torch.bfloat16, 0.0, False,
                      ((2048, 1500, 700), (2048, 1500, 900)), None, True),
    "overlap-dup-garbage": (1, 8, 2, 2048, 2048, D, True, torch.bfloat16, 0.0,
                            False, None, "overlap", True),
    "empty-blocks": (1, 8, 2, 1500, 2000, D, False, torch.bfloat16, 0.0, False,
                     None, "empty", True),
}
# The largest boolean mask handed to SDPA as the library yardstick.
SDPA_MASK_BYTES = 4 << 30


def vs_visible_pairs(gplan, b, sq, sk, causal, lens_q, lens_k):
    """Exact visible (head, row, column) triples of a call, from its gather
    lists: each row counts its block's listed columns at or left of its
    diagonal (all of them without causal), on rows inside seqlens_q."""
    counts, cols = gplan
    dev = cols.device
    n = cols.shape[-1]
    uq = (torch.full((b,), sq, device=dev) if lens_q is None
          else lens_q.long())
    uk = (torch.full((b,), sk, device=dev) if lens_k is None
          else lens_k.long())
    total = 0
    for m0 in range(0, cols.shape[2], 64):
        listed = (torch.arange(n, device=dev)
                  < counts[:, :, m0:m0 + 64, None].long())
        c = torch.where(listed, cols[:, :, m0:m0 + 64].long(), 1 << 40)
        r = (torch.arange(c.shape[2], device=dev)[:, None] + m0) * 64 + \
            torch.arange(64, device=dev)[None]  # (blocks, 64) rows
        diag = r[None] + (uk - uq)[:, None, None]  # (b, blocks, 64)
        hi = diag if causal else torch.full_like(diag, 1 << 39)
        seen = torch.searchsorted(
            c.reshape(-1, n).contiguous(),
            hi[:, None].expand(-1, c.shape[1], -1, -1).reshape(-1, 64)
            .contiguous(), right=True).reshape(b, c.shape[1], -1, 64)
        seen = torch.minimum(seen, counts[:, :, m0:m0 + 64, None].long())
        seen = seen * (r < torch.minimum(uq, torch.tensor(sq, device=dev))
                       [:, None, None])[:, None]
        total += int(seen.sum())
    return total


def vs_sdpa_mask(meta, b, h, sq, sk, causal, lens_q, lens_k):
    """The call's (b, h, sq, sk) boolean visibility, for SDPA (a yardstick
    only; the port never calls it)."""
    mask = torch.zeros(b, h, sq, sk, dtype=torch.bool, device=meta[1].device)
    for bi, hi, rows, vis, _ in visible_chunks(meta, b, h, sq, sk, causal,
                                              lens_q, lens_k, None):
        mask[bi, hi, rows] = vis
    return mask


def sparse_compare(name, seed):
    """Kernels 12 and 15 (both routes) and 13-14 against their plain
    versions on one case's seeded inputs and metadata, then the same
    kernels given the metadata with a slash offset moved by one column in
    every block (`vs_planted`), which every check must catch. The backward
    kernels take the plain forward's LSE and the plain dQ's delta, as in
    `attn_compare`. Returns (result, fault result, tensors)."""
    (b, h, hk, sq, sk, d, causal, dtype, softcap, alibi, lens, variant,
     bwd) = SPARSE_CASES[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=dev, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    meta = vs_metadata(b, h, sq, sk, MINF_HEADS, causal, seed,
                       garbage=variant == "overlap")
    if variant:
        meta = vs_variant(meta, variant)
    lens_q = lens_k = None
    if lens:
        lens_q, lens_k = (_dev_int(x) for x in lens)
    slopes = None
    if alibi:  # one set of slopes per batch row
        slopes = torch.stack([default_alibi_slopes(h) * (1 + 0.25 * i)
                              for i in range(b)]).to(dev)
    kw = dict(softmax_scale=None, causal=causal, softcap=softcap,
              alibi_slopes=slopes, seqlens_q=lens_q, seqlens_k=lens_k)
    plans = dict(seqlen_q=sq, seqlen_k=sk, causal=causal, seqlens_q=lens_q,
                 seqlens_k=lens_k)
    up = tuple(x.float() for x in (q, k, v, do))
    ref_out, ref_lse = flash_attention_sparse_fwd_ref(*up[:3], *meta, **kw)
    finite = torch.isfinite(ref_lse)
    refs = dict(out=ref_out)
    if bwd:
        ref_dq, ref_delta = _sparse_dq_ref(*up, ref_lse, *meta, **kw)
        ref_dk, ref_dv = _sparse_dkv_ref(*up, ref_lse, ref_delta, *meta, **kw)
        refs.update(dq=ref_dq, delta=ref_delta, dk=ref_dk, dv=ref_dv)
    del up

    def run(m):
        """Both forward routes and the backward kernels on metadata m."""
        plan = plan_sparse(*m, keep_table=bwd, **plans)
        gplan = plan_gather(*m, **plans)
        got = {}
        for route, (out, lse) in (
                ("tiles", flash_attention_sparse_tiles_fwd(
                    q, k, v, *m, plan=plan, **kw)),
                ("gather", flash_attention_sparse_gather_fwd(
                    q, k, v, *m, plan=gplan, **kw))):
            lse_err = (float((lse - ref_lse)[finite].abs().max())
                       if finite.any() else 0.0)
            got[route] = dict(out=held(out, ref_out), lse_max_abs_err=lse_err)
            got[route]["ok"] = bool(
                got[route]["out"]["err_over_limit"] <= 1
                and lse_err <= ATTN_LSE_TOL
                and torch.equal(finite, torch.isfinite(lse))
                and bool(torch.isfinite(out).all())
                and bool((out.float()[~finite] == 0).all()))
        if bwd:
            args = (q, k, v, do, ref_lse)
            dq, delta = flash_attention_sparse_bwd_dq(*args, *m, plan=plan,
                                                      **kw)
            dq2, delta2 = flash_attention_sparse_bwd_dq(*args, *m, plan=plan,
                                                        **kw)
            inverse = plan_inverse(plan.table, hk)
            dk, dv = flash_attention_sparse_bwd_dkv(
                *args, ref_delta, *m, inverse=inverse, **kw)
            dk2, dv2 = flash_attention_sparse_bwd_dkv(
                *args, ref_delta, *m, inverse=inverse, **kw)
            torch.cuda.synchronize()
            got.update(
                dq=held(dq, ref_dq), delta=held(delta, ref_delta),
                dk=held(dk, ref_dk), dv=held(dv, ref_dv),
                bwd_bitwise_deterministic=all(
                    torch.equal(x, y) for x, y in
                    ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2))),
                grads_finite=all(bool(torch.isfinite(x).all())
                                 for x in (dq, dk, dv)))
            if lens_k is not None:  # keys past a row's length get nothing
                past = (torch.arange(sk, device=dev)[None]
                        >= lens_k[:, None])[:, None, :, None]
                got["padded_keys_zero"] = bool(
                    (dk.float() * past == 0).all()
                    and (dv.float() * past == 0).all())
            got["dq_ok"] = (got["dq"]["err_over_limit"] <= 1
                            and got["delta"]["err_over_limit"] <= 1)
            got["dkv_ok"] = max(got["dk"]["err_over_limit"],
                                got["dv"]["err_over_limit"]) <= 1
        return got, plan, gplan

    got, plan, gplan = run(meta)
    ok = got["tiles"]["ok"] and got["gather"]["ok"]
    if bwd:
        ok = ok and (got["dq_ok"] and got["dkv_ok"]
                     and got["bwd_bitwise_deterministic"]
                     and got["grads_finite"]
                     and got.get("padded_keys_zero", True))
    planted, moved = vs_planted(meta, sq, sk, causal, lens_q, lens_k)
    bad, _, _ = run(planted)
    caught = dict(fwd_tiles=not bad["tiles"]["ok"],
                  fwd_gather=not bad["gather"]["ok"])
    if bwd:
        caught.update(dq=not bad["dq_ok"], dkv=not bad["dkv_ok"])
    fault = dict(
        phase="sparse_fault", case=name, blocks_moved=moved,
        blocks=b * h * meta[0].shape[2],
        err_over_limit=dict(
            out_tiles=bad["tiles"]["out"]["err_over_limit"],
            out_gather=bad["gather"]["out"]["err_over_limit"],
            **({key: bad[key]["err_over_limit"]
                for key in ("dq", "delta", "dk", "dv")} if bwd else {})),
        lse_max_abs_err=dict(tiles=bad["tiles"]["lse_max_abs_err"],
                             gather=bad["gather"]["lse_max_abs_err"]),
        caught=caught, ok=all(caught.values()) and moved > 0)
    del refs, ref_out
    result = dict(
        phase="sparse_kernels", case=name, b=b, h=h, hk=hk, sq=sq, sk=sk,
        d=d, causal=causal, dtype=str(dtype).split(".")[-1], softcap=softcap,
        alibi=alibi, seqlens=lens, variant=variant,
        nnz_s=meta[1].shape[-1], nnz_v=meta[3].shape[-1],
        route=sparse_route(meta[1].shape[-1], meta[3].shape[-1], sk),
        density=metadata_density(meta[0], meta[2], sq, sk),
        empty_rows=int((~finite).sum()), **got, tolerance=ATTN_TOLERANCE,
        ok=ok)
    tensors = dict(q=q, k=k, v=v, do=do, meta=meta, kw=kw, plans=plans,
                   plan=plan, gplan=gplan, lse=ref_lse,
                   delta=ref_delta if bwd else None)
    return result, fault, tensors


def sparse_case(name, seed):
    """sparse_compare, then CUDA-event times of every kernel (planners
    timed apart), its bound, its plain version and, where the mask fits,
    SDPA with a boolean mask (the library yardstick)."""
    result, fault, t = sparse_compare(name, seed)
    (b, h, hk, sq, sk, d, causal, dtype, _, _, _, _, bwd) = SPARSE_CASES[name]
    q, k, v, do, meta, kw = (t[x] for x in ("q", "k", "v", "do", "meta", "kw"))
    plan, gplan, plans = t["plan"], t["gplan"], t["plans"]
    big = sq * sk >= 1 << 26
    reps = dict(reps=5, warmup=1) if big else {}
    plain = dict(reps=2, warmup=0) if big else dict(reps=3, warmup=1)
    result.update(
        tiles_ms=cuda_ms(lambda: flash_attention_sparse_tiles_fwd(
            q, k, v, *meta, plan=plan, **kw), **reps),
        gather_ms=cuda_ms(lambda: flash_attention_sparse_gather_fwd(
            q, k, v, *meta, plan=gplan, **kw), **reps),
        plan_tiles_ms=cuda_ms(lambda: plan_sparse(*meta, **plans), **reps),
        plan_gather_ms=cuda_ms(lambda: plan_gather(*meta, **plans), **reps),
        fwd_plain_ms=cuda_ms(lambda: flash_attention_sparse_fwd_ref(
            q, k, v, *meta, **kw), **plain))
    pairs = vs_visible_pairs(gplan, b, sq, sk, causal, kw["seqlens_q"],
                             kw["seqlens_k"])
    el = q.element_size()
    qb, kvb, stats = b * h * sq * d * el, b * hk * sk * d * el, b * h * sq * 4
    result["visible_pairs"] = pairs
    result["visible_share"] = pairs / (b * h * sq * sk)
    for key, per_d, nbytes in (("fwd", 4, 2 * qb + 2 * kvb + stats),
                               ("dkv", 8, 2 * qb + 4 * kvb + 2 * stats),
                               ("dq", 6, 3 * qb + 2 * kvb + 2 * stats)):
        if key != "fwd" and not bwd:
            continue
        result[f"{key}_bound_ms"], result[f"{key}_bound_by"] = attn_bound(
            per_d, nbytes, 1, 1, d, pairs)
    if bwd:
        args = (q, k, v, do, t["lse"])
        inverse = plan_inverse(plan.table, hk)
        result.update(
            dq_ms=cuda_ms(lambda: flash_attention_sparse_bwd_dq(
                *args, *meta, plan=plan, **kw), **reps),
            dkv_ms=cuda_ms(lambda: flash_attention_sparse_bwd_dkv(
                *args, t["delta"], *meta, inverse=inverse, **kw), **reps),
            plan_inverse_ms=cuda_ms(lambda: plan_inverse(plan.table, hk),
                                    **reps),
            dq_plain_ms=cuda_ms(lambda: _sparse_dq_ref(*args, *meta, **kw),
                                **plain),
            dkv_plain_ms=cuda_ms(lambda: _sparse_dkv_ref(
                *args, t["delta"], *meta, **kw), **plain))
    result["library_fwd_ms"] = None
    result["library"] = "not run: the (b, h, sq, sk) mask exceeds 4 GiB"
    if b * h * sq * sk <= SDPA_MASK_BYTES:
        mask = vs_sdpa_mask(meta, b, h, sq, sk, causal, kw["seqlens_q"],
                            kw["seqlens_k"])
        try:
            if kw["softcap"] or kw["alibi_slopes"] is not None:
                raise ValueError("SDPA has no softcap or ALiBi")
            result["library_fwd_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True), **reps)
            result["library"] = ("scaled_dot_product_attention(attn_mask="
                                 "visibility, enable_gqa=True): a yardstick")
        except Exception as exc:  # a yardstick: report why it did not run
            result["library"] = f"not run: {type(exc).__name__}: {exc}"[:200]
        del mask
    emit(result)
    emit(fault)
    check(result["ok"], f"sparse_kernels case {name} disagrees with its "
                        "plain version or is not deterministic")
    check(fault["ok"], f"sparse_fault: a slash offset moved by one column in "
                       f"case {name} passes the tolerance")
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _sparse_counts():
    return dict(flash_sparse_fwd=flash_attention_sparse_tiles_fwd.launches,
                flash_sparse_gather_fwd=flash_attention_sparse_gather_fwd.launches,
                flash_sparse_bwd_dq=flash_attention_sparse_bwd_dq.launches,
                flash_sparse_bwd_dkv=flash_attention_sparse_bwd_dkv.launches)


def _zero_sparse_counts():
    flash_attention_sparse_tiles_fwd.launches = 0
    flash_attention_sparse_gather_fwd.launches = 0
    flash_attention_sparse_bwd_dq.launches = 0
    flash_attention_sparse_bwd_dkv.launches = 0


def sparse_autograd_phase(seed=111, s=8192, heads=MINF_HEADS):
    """`sparse_attn_func`'s autograd path at the prefill-8k case (bshd
    layout, as a training step calls it): the forward on its route, then
    kernels 14 and 13 through backward(), launches counted from zero;
    gradients held against the plain versions. `heads` sets the route:
    all four MInference sizes list more than 8192 columns (kernel 12), the
    first three fewer (kernel 15, whose backward builds kernel 12's plan)."""
    b, h, hk, sq, sk, d = 1, H, HK, s, s, D
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, sq, h, d, generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, sk, hk, d, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    meta = vs_metadata(b, h, sq, sk, heads, True, seed)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    _zero_sparse_counts()
    dispatch_counts.clear()
    out = sparse_attn_func(*leaves, *meta, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = _sparse_counts()
    routes = {f"{k_}/{r}": n for (k_, r), n in dispatch_counts.items()}
    route = sparse_route(meta[1].shape[-1], meta[3].shape[-1], sk)
    fwd_name = ("flash_sparse_fwd" if route == "tiles"
                else "flash_sparse_gather_fwd")
    want = dict(flash_sparse_fwd=0, flash_sparse_gather_fwd=0,
                flash_sparse_bwd_dq=1, flash_sparse_bwd_dkv=1)
    want[fwd_name] = 1
    qh, kh, vh, doh = (x.transpose(1, 2).float() for x in (q, k, v, do))
    ref_out, ref_lse = flash_attention_sparse_fwd_ref(qh, kh, vh, *meta,
                                                      causal=True)
    ref_dq, ref_delta = _sparse_dq_ref(qh, kh, vh, doh, ref_lse, *meta,
                                       causal=True)
    ref_dk, ref_dv = _sparse_dkv_ref(qh, kh, vh, doh, ref_lse, ref_delta,
                                     *meta, causal=True)
    checks = dict(out=held(out.detach().transpose(1, 2), ref_out),
                  dq=held(grads[0].transpose(1, 2), ref_dq),
                  dk=held(grads[1].transpose(1, 2), ref_dk),
                  dv=held(grads[2].transpose(1, 2), ref_dv))
    ok = launches == want and all(c["err_over_limit"] <= 1
                                  for c in checks.values())
    result = dict(phase="sparse_autograd", b=b, h=h, hk=hk, s=sq, d=d,
                  layout="bshd", route=route, launches=launches,
                  launches_expected=want, routes=routes, **checks,
                  tolerance=ATTN_TOLERANCE, ok=ok)
    emit(result)
    check(ok, "sparse_autograd: launches off the count or a gradient outside "
              "the tolerance")
    return result


CROSSOVER_CONTEXTS = (2048, 4096, 8192, 16384, 32768)
CROSSOVER_DENSITIES = (0.02, 0.05, 0.1, 0.2)
CROSSOVER_SHARES = (0.3, 0.7)


def crossover_metadata(sk, density, share, seed):
    """Causal MInference-style metadata (b 1, H heads, s = sk) aimed at a
    metadata density (the JAX package's count, `metadata_density`) with
    `share` of it from slashes: a first guess (a causal row sees half the
    drawn vertical columns), then each size scaled once by how far its part
    of the density landed from its target."""
    n_v, n_s = (max(4, int(2 * (1 - share) * density * sk)),
                max(1, int(share * density * sk)))
    for attempt in range(2):
        meta = vs_metadata(1, H, sk, sk, ((n_v, n_s),), True, seed)
        if attempt:
            return meta
        grid = H * sk * sk
        got_s = float(meta[0].sum()) * 64 * 64 / grid
        got_v = float(meta[2].sum()) * 64 / grid
        n_s = max(1, int(n_s * share * density / max(got_s, 1e-9)))
        n_v = max(4, int(n_v * (1 - share) * density / max(got_v, 1e-9)))


def sparse_crossover_phase(seed=120):
    """Sparse (`sparse_attn_func` on its route, planner included, and each
    route alone) against the port's dense causal `flash_attn_func` (kernel
    1) at Mistral-7B widths (b 1, 32/8 heads of 128, causal, bf16), over
    contexts, densities and slash shares; then the fit of
    utils/sparse_crossover.py's constants from those cells."""
    dev = torch.device("cuda")
    cells = []
    for sk in CROSSOVER_CONTEXTS:
        gen = torch.Generator(device=dev).manual_seed(seed + sk)
        q = torch.randn(1, H, sk, D, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(1, HK, sk, D, generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        dense_ms = cuda_ms(lambda: flash_attn_func(q, k, v, causal=True,
                                                   layout="bhsd"),
                           reps=5, warmup=1)
        for share in CROSSOVER_SHARES:
            for target in CROSSOVER_DENSITIES:
                meta = crossover_metadata(sk, target, share,
                                          seed + sk + int(1000 * target))
                dens = metadata_density(meta[0], meta[2], sk, sk)
                route = sparse_route(meta[1].shape[-1], meta[3].shape[-1], sk)
                times = dict(routed=cuda_ms(
                    lambda: sparse_attn_func(q, k, v, *meta, causal=True,
                                             layout="bhsd"),
                    reps=5, warmup=1))
                for r, fwd in (("tiles", flash_attention_sparse_tiles_fwd),
                               ("gather", flash_attention_sparse_gather_fwd)):
                    times[r] = cuda_ms(lambda: fwd(q, k, v, *meta,
                                                   causal=True),
                                       reps=5, warmup=1)
                slash_cols = float(meta[0].sum()) * 64
                cells.append(dict(
                    seqlen_k=sk, target_density=target, density=dens,
                    slash_frac=share,
                    slash_frac_measured=slash_cols / max(
                        slash_cols + float(meta[2].sum()), 1.0),
                    nnz_s=meta[1].shape[-1], nnz_v=meta[3].shape[-1],
                    gather_bound_share=(64 * meta[1].shape[-1]
                                        + meta[3].shape[-1]) / sk,
                    route=route, dense_ms=dense_ms, sparse_ms=times["routed"],
                    tiles_ms=times["tiles"], gather_ms=times["gather"],
                    speedup=dense_ms / times["routed"]))
                del meta
        del q, k, v
    fit = fit_crossover(cells)
    module = dict(MIN_CONTEXT=sparse_crossover.MIN_CONTEXT,
                  MAX_DENSITY=sparse_crossover.MAX_DENSITY,
                  MIN_SLASH_FRAC=sparse_crossover.MIN_SLASH_FRAC)
    result = dict(phase="sparse_crossover", card=smi(), cells=cells, fit=fit,
                  module_constants=module,
                  module_matches_fit=all(module.get(k_) == v_
                                         for k_, v_ in fit.items()),
                  ok=len(cells) == (len(CROSSOVER_CONTEXTS)
                                    * len(CROSSOVER_SHARES)
                                    * len(CROSSOVER_DENSITIES)))
    emit(result)
    check(result["ok"], "sparse_crossover: a cell did not run")
    return result


VLLM_SPARSE_LENS = (32768, 16384)
VLLM_SPARSE_PATTERNS = 4  # distinct per-layer metadata sets, in turn


def sparse_varlen_ref(q, k, v, meta, lens, causal=True):
    """The plain version of one vllm sparse layer call: each sequence
    sliced out of the packed rows into a zero-padded batch, the plain
    sparse forward with seqlens, and the rows sliced back."""
    nseq, smax = len(lens), max(lens)
    cu = np.concatenate([[0], np.cumsum(lens)])
    h, d, hk = q.shape[1], q.shape[2], k.shape[1]
    qp = q.new_zeros(nseq, h, smax, d, dtype=torch.float32)
    kp = k.new_zeros(nseq, hk, smax, d, dtype=torch.float32)
    vp = v.new_zeros(nseq, hk, smax, d, dtype=torch.float32)
    for j, n in enumerate(lens):
        qp[j, :, :n] = q[cu[j]:cu[j + 1]].transpose(0, 1).float()
        kp[j, :, :n] = k[cu[j]:cu[j + 1]].transpose(0, 1).float()
        vp[j, :, :n] = v[cu[j]:cu[j + 1]].transpose(0, 1).float()
    lens_t = _dev_int(lens)
    out, _ = flash_attention_sparse_fwd_ref(qp, kp, vp, *meta, causal=causal,
                                            seqlens_q=lens_t, seqlens_k=lens_t)
    return torch.cat([out[j, :, :n].transpose(0, 1) for j, n in
                      enumerate(lens)])


def sparse_vllm_phase(seed=130, layers=32):
    """One long-context prefill step in vLLM's calling convention: two
    sequences (32768 and 16384 tokens) packed, causal, Mistral-7B widths,
    through 32 layer calls of vllm_compat.sparse_attn_varlen_func, each
    with its layer's MInference-style metadata (VLLM_SPARSE_PATTERNS sets in
    turn), host syncs made errors. Launches = layers per route taken; one
    layer's output held whole against the plain version, and that layer's
    call profiled."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    lens = list(VLLM_SPARSE_LENS)
    total, smax = sum(lens), max(lens)
    cu = _dev_int(_cu_of(lens))
    gen = torch.Generator(device=dev).manual_seed(seed)
    patterns = []
    for i in range(VLLM_SPARSE_PATTERNS):
        # Each layer takes the MInference head sizes in its own order.
        heads = MINF_HEADS[i:] + MINF_HEADS[:i]
        patterns.append(vs_metadata(len(lens), H, smax, smax, heads, True,
                                    seed + i))
    qkv = [(torch.randn(total, H, D, generator=gen, device=dev,
                        dtype=torch.bfloat16),
            torch.randn(total, HK, D, generator=gen, device=dev,
                        dtype=torch.bfloat16),
            torch.randn(total, HK, D, generator=gen, device=dev,
                        dtype=torch.bfloat16)) for _ in range(layers)]
    outs = [torch.empty(total, H, D, device=dev, dtype=torch.bfloat16)
            for _ in range(layers)]

    def step():
        for layer, (q, k, v) in enumerate(qkv):
            vllm_sparse_attn_varlen_func(
                q, k, v, *patterns[layer % len(patterns)], cu, cu, smax, smax,
                causal=True, out=outs[layer])

    step()  # warm-up
    torch.cuda.synchronize()
    inputs_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _zero_sparse_counts()
    dispatch_counts.clear()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    with _SyncsRaise():
        step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end)
    launches = _sparse_counts()
    routes = {f"{k_}/{r}": n for (k_, r), n in dispatch_counts.items()}
    want_routes = collections.Counter(
        sparse_route(patterns[i % len(patterns)][1].shape[-1],
                     patterns[i % len(patterns)][3].shape[-1], smax)
        for i in range(layers))
    want = dict(flash_sparse_fwd=want_routes["tiles"],
                flash_sparse_gather_fwd=want_routes["gather"],
                flash_sparse_bwd_dq=0, flash_sparse_bwd_dkv=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    q, k, v = qkv[0]
    ref = sparse_varlen_ref(q, k, v, patterns[0], lens)
    check0 = held(outs[0], ref)
    del ref
    # Where one layer call's time goes (device activity only).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vllm_sparse_attn_varlen_func(q, k, v, *patterns[0], cu, cu, smax, smax,
                                     causal=True, out=outs[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = _device_ms_by_kernel(prof)
    busy = sum(by_kernel.values())
    layer_profile = dict(
        wall_ms=wall_ms, device_busy_ms=busy,
        idle_share=1 - busy / wall_ms if busy > 0 else None,
        top_kernels=[dict(name=k_[:80], ms=v_) for k_, v_ in
                     sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]])
    dens = [metadata_density(p[0], p[2], smax, smax) for p in patterns]
    ok = (launches == want and check0["err_over_limit"] <= 1
          and sum(want_routes.values()) == layers)
    result = dict(
        phase="sparse_vllm", model="Mistral-7B-v0.1 attention widths",
        layers=layers, seq_lens=lens, query_tokens=total,
        heads_vertical_slash=list(MINF_HEADS), patterns=len(patterns),
        nnz=[[p[1].shape[-1], p[3].shape[-1]] for p in patterns],
        density=dens, step_ms=step_ms,
        query_tokens_per_s=total / (step_ms / 1e3),
        resident_inputs_gb=inputs_gb, peak_memory_gb=peak,
        host_syncs_in_layer_calls="none (set_sync_debug_mode error)",
        launches=launches, launches_expected=want, routes=routes,
        layer0=check0, layer0_profile=layer_profile,
        tolerance=ATTN_TOLERANCE, ok=ok)
    emit(result)
    check(ok, "sparse_vllm: launches off the count or layer 0 outside the "
              "tolerance")
    del qkv, outs, patterns
    gc.collect()
    torch.cuda.empty_cache()
    return result


def sparse_kernel_entries(sparse):
    """Kernels 12-15 for the kernels line: times at the vLLM prefill shape
    (forward) and the prefill-8k case (backward; forward there too),
    launches on the slice's two paths (`sparse_vllm`, `sparse_autograd`),
    each counted from zero. Fails if one of them never launched there."""
    cases = sparse["cases"]
    p32, p8 = cases["vllm-prefill-32k"], cases["prefill-8k"]
    runs = sparse["autograd"]
    paths = dict(sparse_vllm=sparse["vllm"]["launches"],
                 sparse_autograd={k: sum(a["launches"][k] for a in runs)
                                  for k in runs[0]["launches"]})
    entries = []
    for name, route, source, replaces, key, tensors in (
            ("flash_sparse_fwd", "tiles", "flash_sparse_fwd.cu",
             "flash_sparse.py:130", "fwd", ("tiles",)),
            ("flash_sparse_gather_fwd", "gather", "flash_sparse_fwd.cu",
             "flash_sparse_gather.py:127", "fwd", ("gather",)),
            ("flash_sparse_bwd_dkv", None, "flash_sparse_bwd.cu",
             "flash_sparse.py:542", "dkv", ("dk", "dv")),
            ("flash_sparse_bwd_dq", None, "flash_sparse_bwd.cu",
             "flash_sparse.py:638", "dq", ("dq", "delta"))):
        by_path = {p: c[name] for p, c in paths.items()}
        err = max(c[t]["out"]["max_abs_err"] if route else c[t]["max_abs_err"]
                  for c in cases.values() for t in tensors if t in c)
        at = p32 if route else p8
        ms_key = f"{route}_ms" if route else f"{key}_ms"
        entry = dict(
            name=name, route="cuda",
            source=f"flash_attn_tpu_torch/csrc/{source}",
            replaces=f"flash_attn_tpu/kernels/{replaces}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=err, ms=at[ms_key], plain_ms=at[f"{key}_plain_ms"],
            bound_ms=at[f"{key}_bound_ms"], bound_by=at[f"{key}_bound_by"],
            library_ms=at["library_fwd_ms"] if route else None,
            shape=(f"{at['case']}: b={at['b']} h={at['h']} hk={at['hk']} "
                   f"s={at['sq']} d={at['d']} causal, density "
                   f"{at['density']:.4f}"))
        if route:
            entry["prefill_8k"] = dict(
                ms=p8[ms_key], plain_ms=p8["fwd_plain_ms"],
                bound_ms=p8["fwd_bound_ms"], bound_by=p8["fwd_bound_by"],
                library_ms=p8["library_fwd_ms"])
        entries.append(entry)
        check(entry["launches"] > 0, f"{name} never launched on the sparse "
                                     "paths")
    return entries


def sparse_phases():
    """Every sparse phase; returns their results for the kernels line."""
    cases = {name: sparse_case(name, seed=100 + i)
             for i, name in enumerate(SPARSE_CASES)}
    autograd = [sparse_autograd_phase(),
                sparse_autograd_phase(seed=112, heads=MINF_HEADS[:3])]
    check(sorted(a["route"] for a in autograd) == ["gather", "tiles"],
          "sparse_autograd: the two cases did not take both routes")
    crossover = sparse_crossover_phase()
    vllm = sparse_vllm_phase()
    return dict(cases=cases, autograd=autograd, crossover=crossover,
                vllm=vllm)


# -- phases: blocksparse_kernels, blocksparse_fault, blocksparse_train,
#    blocksparse_varlen (mask_mod plans, kernels 9-11) -----------------------

def doc_ids(s, ndocs, dev="cuda"):
    """Per-token document ids of `ndocs` equal documents over s tokens, the
    boundaries rounded as benchmarks/benchmark_blocksparse.py rounds them."""
    bounds = np.linspace(0, s, ndocs + 1).astype(np.int64)
    return torch.tensor(np.repeat(np.arange(ndocs), np.diff(bounds)),
                        dtype=torch.int32, device=dev)


def doc_aux_mod(b, h, q_idx, kv_idx, aux):
    """Causal attention inside each document of the aux doc-id table."""
    d = aux.tensors[0]
    return (kv_idx <= q_idx) & (aux_take(d, q_idx) == aux_take(d, kv_idx))


def doc_closed_mod(s, ndocs):
    """benchmark_blocksparse.py's doc_mask: equal causal documents in closed
    form (no aux)."""
    dlen = s // ndocs

    def mask_mod(b, h, q_idx, kv_idx):
        return (kv_idx <= q_idx) & (q_idx // dlen == kv_idx // dlen)

    return mask_mod


def prefix_mod(prefix):
    def mask_mod(b, h, q_idx, kv_idx):
        return (kv_idx < prefix) | (kv_idx <= q_idx)

    return mask_mod


def causal_mod(b, h, q_idx, kv_idx):
    return kv_idx <= q_idx


def rows_gap_mod(b, h, q_idx, kv_idx):
    """Causal, with query rows 1000-1099 keeping nothing."""
    return (kv_idx <= q_idx) & ((q_idx < 1000) | (q_idx >= 1100))


def block_causal_plan(s, tile, dev="cuda"):
    """A plan with no mod (a block mask): each q-tile's diagonal kv-tile
    partial, the tiles left of it full."""
    n = -(-s // tile)
    eye = torch.eye(n, dtype=torch.bool, device=dev)[None, None]
    low = torch.ones(n, n, dtype=torch.bool, device=dev).tril(-1)[None, None]

    def pack(flags):
        order = torch.sort((~flags).to(torch.uint8), dim=-1, stable=True)
        return flags.sum(-1, dtype=torch.int32), order.indices.int()

    return BlockSparseTensors(*pack(eye), *pack(low), (tile, tile), s, s, n, n)


BF16, FP16 = torch.bfloat16, torch.float16
# name -> (b, h, hk, s, d, dtype, softcap, tile, mod, aux key, plan options):
# the first four are benchmarks/benchmark_blocksparse.py's (b 1, 16 heads of
# 128, s 8192, 512 x 512 tiles; doc_aux_2k at s 2048); "mistral-doc10"
# runs doc10 through the aux table at Mistral-7B widths (GQA).
BS_CASES = {
    "doc5": (1, 16, 16, 8192, 128, BF16, 0.0, 512, doc_closed_mod(8192, 5),
             None, {}),
    "doc10": (1, 16, 16, 8192, 128, BF16, 0.0, 512, doc_closed_mod(8192, 10),
              None, {}),
    "prefix": (1, 16, 16, 8192, 128, BF16, 0.0, 512, prefix_mod(8192 // 16),
               None, {}),
    "doc_aux_2k": (1, 16, 16, 2048, 128, BF16, 0.0, 512, doc_aux_mod,
                   (2048, 4), {}),
    "mistral-doc10": (1, 32, 8, 8192, 128, BF16, 0.0, 512, doc_aux_mod,
                      (8192, 10), {}),
    # A single-head plan of one batch row, broadcast to b 2 x 16 heads.
    "softcap30-fp16-d64": (2, 16, 16, 8000, 64, FP16, 30.0, 128, doc_aux_mod,
                           (8000, 7), dict(batch_size=1, num_heads=1)),
    "fast-sampling": (1, 16, 16, 4096, 128, BF16, 0.0, 512,
                      doc_closed_mod(4096, 10), None,
                      dict(use_fast_sampling=True)),
    "no-full-blocks": (1, 16, 16, 4096, 128, BF16, 0.0, 512,
                       doc_closed_mod(4096, 10), None,
                       dict(compute_full_blocks=False)),
    "blockmask-no-mod": (1, 16, 16, 4000, 128, BF16, 0.0, 512, None, None,
                         dict(blockmask=True)),
    "empty-rows": (1, 16, 16, 4096, 128, BF16, 0.0, 512, rows_gap_mod, None,
                   {}),
}
BS_FAULT_CASES = ("doc_aux_2k", "mistral-doc10", "softcap30-fp16-d64")


def _bs_counts():
    return dict(block_sparse_fwd=flash_attention_blocksparse_fwd.launches,
                block_sparse_bwd_dkv=flash_attention_blocksparse_bwd_dkv.launches,
                block_sparse_bwd_dq=flash_attention_blocksparse_bwd_dq.launches)


def _zero_bs_counts():
    flash_attention_blocksparse_fwd.launches = 0
    flash_attention_blocksparse_bwd_dkv.launches = 0
    flash_attention_blocksparse_bwd_dq.launches = 0


def bs_plan(name):
    """(plan, mod, aux) of a case; a CUDA planner also builds the kernels'
    execution lists."""
    b, h, _, s, _, _, _, tile, mod, aux_key, opts = BS_CASES[name]
    aux = () if aux_key is None else (doc_ids(*aux_key),)
    if opts.get("blockmask"):
        return block_causal_plan(s, tile), mod, aux
    kw = dict(batch_size=b, num_heads=h, seqlen_q=s, seqlen_k=s, tile_m=tile,
              tile_n=tile, aux_tensors=aux)
    kw.update(opts)
    return compute_block_sparsity(mod, **kw), mod, aux


def bs_check(tensors, refs, kw, lists=None):
    """Kernels 9-11 on `tensors` over `lists` (the cached ones if None),
    against the plain versions' `refs`: per-element `held` results and, for
    each kernel, its worst ratio to its limit (<= 1 passes). The backward
    kernels take the plain forward's LSE and the plain dQ's delta, and run
    twice for equal bits."""
    q, k, v, do = tensors
    plan = kw["plan"]
    kk = dict(mask_mod=kw["mask_mod"], aux_tensors=kw["aux_tensors"],
              softcap=kw["softcap"], lists=lists)
    out, lse = flash_attention_blocksparse_fwd(q, k, v, plan, **kk)
    dq, delta = flash_attention_blocksparse_bwd_dq(q, k, v, do, refs["lse"],
                                                   plan, **kk)
    dq2, delta2 = flash_attention_blocksparse_bwd_dq(q, k, v, do, refs["lse"],
                                                     plan, **kk)
    args = (q, k, v, do, refs["lse"], refs["delta"], plan)
    dk, dv = flash_attention_blocksparse_bwd_dkv(*args, **kk)
    dk2, dv2 = flash_attention_blocksparse_bwd_dkv(*args, **kk)
    torch.cuda.synchronize()
    finite = torch.isfinite(refs["lse"])
    same_empty = torch.equal(finite, torch.isfinite(lse))
    lse_err = (float((lse - refs["lse"])[finite & torch.isfinite(lse)].abs()
                     .max()) if finite.any() else 0.0)
    got = dict(out=held(out, refs["out"]), dq=held(dq, refs["dq"]),
               delta=held(delta, refs["delta"]), dk=held(dk, refs["dk"]),
               dv=held(dv, refs["dv"]), lse_max_abs_err=lse_err,
               same_empty_rows=same_empty,
               empty_rows_zero=bool((out.float()[~finite] == 0).all()),
               bwd_bitwise_deterministic=all(
                   torch.equal(x, y) for x, y in
                   ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2))),
               grads_finite=all(bool(torch.isfinite(x).all())
                                for x in (out, dq, dk, dv)))
    ratio = lambda *keys: max(got[key]["err_over_limit"] for key in keys)  # noqa: E731
    got["worst"] = dict(
        fwd=max(ratio("out"), lse_err / ATTN_LSE_TOL,
                0.0 if same_empty else float("inf")),
        dq=ratio("dq", "delta"), dkv=ratio("dk", "dv"))
    return got


def bs_word_fault(lists):
    """The lists with one row's word in one mode-2 sub-tile shifted by one
    column: the row with the fewest kept columns (a document's first row)."""
    w = lists.words
    bits = sum(((w >> i) & 1) for i in range(64))
    bits = torch.where(bits > 0, bits, 65)
    g, r = divmod(int(bits.argmin()), 64)
    words = w.clone()
    words[g, r] = w[g, r] << 1
    return dataclasses.replace(lists, words=words), dict(group=g, row=r)


def bs_drop_fault(lists):
    """The lists with one live sub-tile dropped, from the forward list and
    from the inverse list alike: the last entry of the first head's row
    block with the fewest entries (a document's first block)."""
    counts, tiles = lists.counts.clone(), lists.tiles
    inv_counts, inv_rows = lists.inv_counts.clone(), lists.inv_rows.clone()
    inv_wofs = lists.inv_wofs.clone()
    c = counts[0, 0].clone()
    mb = int(torch.where(c > 0, c, c.max() + 1).argmin())
    nb = int(tiles[0, 0, mb, int(c[mb]) - 1]) >> 2
    counts[0, 0, mb] -= 1
    n = int(inv_counts[0, 0, nb])
    row = inv_rows[0, 0, nb, :n]
    pos = int(((row >> 2) == mb).nonzero()[0, 0])
    for t in (inv_rows, inv_wofs):
        t[0, 0, nb, pos:n - 1] = t[0, 0, nb, pos + 1:n].clone()
    inv_counts[0, 0, nb] -= 1
    return dataclasses.replace(lists, counts=counts, inv_counts=inv_counts,
                               inv_rows=inv_rows, inv_wofs=inv_wofs), dict(
        row_block=mb, key_block=nb)


def bs_case(name, seed):
    """Kernels 9-11 against their plain versions on one case, with
    CUDA-event times, the bound from the exact count of kept pairs, SDPA
    with the dense boolean mask as the library yardstick, and launches;
    then, for BS_FAULT_CASES, the planted faults of blocksparse_fault."""
    b, h, hk, s, d, dtype, softcap, tile, mod, aux_key, opts = BS_CASES[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, s, d, generator=gen, device=dev, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hk, s, d, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan, mod, aux = bs_plan(name)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    lists = prepare_lists(q, k, v, plan, mask_mod=mod, aux_tensors=aux)
    kw = dict(plan=plan, mask_mod=mod, aux_tensors=aux, softcap=softcap)
    rk = dict(mask_mod=mod, aux_tensors=aux, softcap=softcap)
    up = tuple(x.float() for x in (q, k, v, do))
    refs = {}
    refs["out"], refs["lse"] = flash_attention_blocksparse_fwd_ref(
        *up[:3], plan, **rk)
    refs["dq"], refs["delta"] = _blocksparse_dq_ref(*up, refs["lse"], plan,
                                                    **rk)
    refs["dk"], refs["dv"] = _blocksparse_dkv_ref(*up, refs["lse"],
                                                  refs["delta"], plan, **rk)
    del up
    _zero_bs_counts()
    got = bs_check((q, k, v, do), refs, kw)
    launches = _bs_counts()
    ok = (max(got["worst"].values()) <= 1 and got["bwd_bitwise_deterministic"]
          and got["grads_finite"] and got["empty_rows_zero"])
    faults = []
    if name in BS_FAULT_CASES:
        for what, (bad, where) in (
                ("one row's word shifted by one column",
                 bs_word_fault(lists)),
                ("one live sub-tile dropped", bs_drop_fault(lists))):
            worst = bs_check((q, k, v, do), refs, kw, lists=bad)["worst"]
            caught = {key: x > 1 for key, x in worst.items()}
            faults.append(dict(phase="blocksparse_fault", case=name,
                               planted=what, where=where, err_over_limit=worst,
                               caught=caught, ok=all(caught.values())))
    empty = int((~torch.isfinite(refs["lse"])).sum())
    del refs
    # Kept pairs, counted from the expanded keep-mask; the same mask as
    # SDPA's boolean attn_mask (one head's when every head keeps the same).
    keep = block_sparse_keep_mask(plan, b, h, s, s, mask_mod=mod,
                                  aux_tensors=aux, device=dev)
    pairs = int(keep.sum())
    same_heads = bool((keep == keep[:, :1]).all())
    mask = keep[:, :1] if same_heads else keep
    del keep
    el = q.element_size()
    qb, kvb, stats = b * h * s * d * el, b * hk * s * d * el, b * h * s * 4
    _, lse_k = flash_attention_blocksparse_fwd(q, k, v, plan, **rk, lists=lists)
    _, delta_k = flash_attention_blocksparse_bwd_dq(q, k, v, do, lse_k, plan,
                                                    **rk, lists=lists)
    args = (q, k, v, do, lse_k, delta_k, plan)
    reps = 10 if s >= 8000 else 20
    result = dict(
        phase="blocksparse_kernels", case=name, b=b, h=h, hk=hk, s=s, d=d,
        dtype=str(dtype).split(".")[-1], softcap=softcap, tile=tile,
        plan_heads=int(plan.mask_block_cnt.shape[1]),
        plan_batch=int(plan.mask_block_cnt.shape[0]),
        options=dict(opts), **got,
        tolerance=ATTN_TOLERANCE, empty_rows=empty, launches=launches,
        plan_ms=plan_ms, kept_pairs=pairs, density=pairs / (b * h * s * s),
        sub_tiles=int(lists.counts.sum()), word_groups=int(lists.words.shape[0]),
        words_mb=lists.words.numel() * 8 / 1e6,
        fwd_ms=cuda_ms(lambda: flash_attention_blocksparse_fwd(
            q, k, v, plan, **rk, lists=lists), reps=reps),
        dq_ms=cuda_ms(lambda: flash_attention_blocksparse_bwd_dq(
            *args[:5], plan, **rk, lists=lists), reps=reps),
        dkv_ms=cuda_ms(lambda: flash_attention_blocksparse_bwd_dkv(
            *args, **rk, lists=lists), reps=reps),
        fwd_plain_ms=cuda_ms(lambda: flash_attention_blocksparse_fwd_ref(
            q, k, v, plan, **rk), reps=3, warmup=1),
        dq_plain_ms=cuda_ms(lambda: _blocksparse_dq_ref(
            *args[:5], plan, **rk), reps=3, warmup=1),
        dkv_plain_ms=cuda_ms(lambda: _blocksparse_dkv_ref(
            *args[:6], plan, **rk), reps=3, warmup=1),
        ok=ok)
    for key, per_d, nbytes in (
            ("fwd", 4, 2 * qb + 2 * kvb + stats),
            ("dkv", 8, 2 * qb + 4 * kvb + 2 * stats),
            ("dq", 6, 3 * qb + 2 * kvb + 2 * stats)):
        result[f"{key}_bound_ms"], result[f"{key}_bound_by"] = attn_bound(
            per_d, nbytes, 1, 1, d, pairs)
    if softcap == 0.0:
        # Yardstick only: SDPA with the dense boolean mask; the port never
        # calls it.
        qt, kt, vt = (x.detach().clone().requires_grad_() for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=hk != h)
        result["library_fwd_ms"] = cuda_ms(sdpa, reps=5, warmup=1)
        result["library_fwd_bwd_ms"] = cuda_ms(
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), do), reps=5,
            warmup=1)
        result["library"] = ("scaled_dot_product_attention(attn_mask=the "
                             f"expanded keep-mask{'' if same_heads else ' per head'}"
                             f"{', enable_gqa' if hk != h else ''}): a yardstick "
                             "only")
        del qt, kt, vt
    else:
        result["library_fwd_ms"] = None
        result["library"] = "none: SDPA takes no softcap"
    del mask
    emit(result)
    check(result["ok"], f"blocksparse_kernels case {name} disagrees with its "
                        "plain version or is not deterministic")
    for fault in faults:
        emit(fault)
        check(fault["ok"], f"blocksparse_fault: {fault['planted']} in case "
                           f"{name} passes a check")
    return result


def blocksparse_train_phase(vtrain, layers=24, seed=140):
    """GPT-2-medium's packed-document training attention, block-sparsely:
    GPT2M_DOCS as one 16384-token stream (b 1, 16 heads of 64, bf16), a
    doc-id aux_take mask_mod (causal inside each document), one
    `compute_block_sparsity` plan per step at the default 512 tiles (its
    execution lists built with it), then 24 layers forward and backward
    through `flash_attn_func` and autograd with every host sync made an
    error. Layer 0's output and gradients are held against
    `flash_attn_varlen_func(causal=True)` over the same documents (kernels
    6-8), which computes the same kept pairs."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tq, h, d = sum(GPT2M_DOCS), 16, 64
    ids = torch.repeat_interleave(
        torch.arange(len(GPT2M_DOCS), dtype=torch.int32, device=dev),
        torch.tensor(GPT2M_DOCS, device=dev))
    qkv = [torch.randn(3, 1, tq, h, d, generator=gen, device=dev,
                       dtype=torch.bfloat16).requires_grad_()
           for _ in range(layers)]
    do = torch.randn(1, tq, h, d, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    outs = []

    def step():
        for x in qkv:
            x.grad = None
        plan = compute_block_sparsity(doc_aux_mod, batch_size=1, num_heads=h,
                                      seqlen_q=tq, seqlen_k=tq,
                                      aux_tensors=(ids,))
        with _SyncsRaise():
            outs[:] = [flash_attn_func(x[0], x[1], x[2], mask_mod=doc_aux_mod,
                                       aux_tensors=(ids,),
                                       block_sparse_tensors=plan)
                       for x in qkv]
            torch.autograd.backward(outs, [do] * layers)
        return plan

    step()  # warm-up
    torch.cuda.synchronize()
    _zero_bs_counts()
    builds = build_execution_lists.builds
    t0 = time.perf_counter()
    plan = step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _bs_counts()
    builds = build_execution_lists.builds - builds
    want = dict(block_sparse_fwd=layers, block_sparse_bwd_dkv=layers,
                block_sparse_bwd_dq=layers)
    # Layer 0 against kernels 6-8 on the same documents.
    cu = _dev_int(_cu_of(GPT2M_DOCS))
    x = qkv[0].detach()[:, 0].clone().requires_grad_()
    ref = flash_attn_varlen_func(x[0], x[1], x[2], cu, cu, max(GPT2M_DOCS),
                                 max(GPT2M_DOCS), causal=True)
    (ref_grad,) = torch.autograd.grad(ref, (x,), do[0])
    versus = dict(out=held(outs[0][0].detach(), ref.detach()))
    for i, name in enumerate(("dq", "dk", "dv")):
        versus[name] = held(qkv[0].grad[i, 0], ref_grad[i])
    grads_finite = all(bool(torch.isfinite(y.grad).all()) for y in qkv)
    agree = max(r["err_over_limit"] for r in versus.values()) <= 1
    ok = counts == want and builds == 1 and grads_finite and agree
    t0 = time.perf_counter()
    compute_block_sparsity(doc_aux_mod, batch_size=1, num_heads=h,
                           seqlen_q=tq, seqlen_k=tq, aux_tensors=(ids,))
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    result = dict(
        phase="blocksparse_train", layers=layers, docs=len(GPT2M_DOCS),
        tokens=tq, h=h, d=d, tile=list(plan.block_size),
        live_plan_tiles=int(plan.mask_block_cnt.sum()
                            + plan.full_block_cnt.sum()),
        plan_tiles=h * plan.num_m * plan.num_n,
        step_wall_ms=wall_ms, step_ms_by_events=cuda_ms(step, reps=5, warmup=1),
        plan_and_lists_ms=plan_ms,
        varlen_train_step_ms=vtrain["step_ms_by_events"] if vtrain else None,
        launches=counts, launches_expected=want, plan_and_list_builds=builds,
        host_syncs_in_layer_calls="none (set_sync_debug_mode error)",
        layer0_vs_kernels_6_8=versus, tolerance=ATTN_TOLERANCE,
        grads_finite=grads_finite, ok=ok)
    emit(result)
    check(ok, "blocksparse_train: launches or builds off the count, "
              "non-finite gradients, or layer 0 disagrees with kernels 6-8")
    return result


def blocksparse_varlen_phase(seed=150):
    """`flash_attn_varlen_func` with a `compute_block_sparsity_varlen` plan
    (causal mask_mod) over GPT2M_DOCS packed, forward and backward, held
    against kernels 6-8 (`causal=True`) and against the plain versions;
    then with seqused_q trimming every other document by 37 rows, whose
    trimmed rows must read out 0 and lse -inf."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tq, h, d = sum(GPT2M_DOCS), 16, 64
    cu = _dev_int(_cu_of(GPT2M_DOCS))
    q, k, v, do = (torch.randn(tq, h, d, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    t0 = time.perf_counter()
    plan, _, _ = compute_block_sparsity_varlen(causal_mod, cu_seqlens_q=cu,
                                               cu_seqlens_k=cu, num_heads=h)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3

    def fwd_bwd(**kw):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out, lse, _ = flash_attn_varlen_func(*leaves, cu, cu,
                                             return_attn_probs=True, **kw)
        return (out, lse) + torch.autograd.grad(out, leaves, do)

    _zero_bs_counts()
    got = fwd_bwd(mask_mod=causal_mod, block_sparse_tensors=plan)
    torch.cuda.synchronize()
    launches = _bs_counts()
    maxlen = max(GPT2M_DOCS)
    k68 = fwd_bwd(max_seqlen_q=maxlen, max_seqlen_k=maxlen, causal=True)
    up = tuple(x.float() for x in (q, k, v, do))
    rkw = dict(causal=True)
    ref_out, ref_lse = flash_attention_varlen_fwd_ref(*up[:3], cu, cu, **rkw)
    ref_dq, ref_delta = _varlen_dq_ref(*up, ref_lse, cu, cu, **rkw)
    ref_dk, ref_dv = _varlen_dkv_ref(*up, ref_lse, ref_delta, cu, cu, **rkw)
    names = ("out", "dq", "dk", "dv")
    mine = (got[0].detach(),) + got[2:]
    vs_plain = {n: held(x, r) for n, x, r in zip(
        names, mine, (ref_out, ref_dq, ref_dk, ref_dv))}
    vs_k68 = {n: held(x, r) for n, x, r in zip(
        names, mine, (k68[0].detach(),) + k68[2:])}
    lse_err = float((got[1] - ref_lse).abs().max())
    # seqused_q: every other document loses its last 37 rows.
    used = [n - 37 if i % 2 == 0 and n > 37 else n
            for i, n in enumerate(GPT2M_DOCS)]
    out_t, lse_t, _ = flash_attn_varlen_func(
        q, k, v, cu, cu, mask_mod=causal_mod, block_sparse_tensors=plan,
        seqused_q=_dev_int(used), return_attn_probs=True)
    starts = _cu_of(GPT2M_DOCS)
    trimmed = torch.zeros(tq, dtype=torch.bool, device=dev)
    for i, n in enumerate(used):
        trimmed[starts[i] + n:starts[i + 1]] = True
    trimmed_ok = bool((out_t[trimmed] == 0).all()
                      and torch.isneginf(lse_t[:, trimmed]).all()
                      and torch.isfinite(lse_t[:, ~trimmed]).all())
    kept = held(out_t[~trimmed], mine[0][~trimmed])
    ok = (max(r["err_over_limit"] for r in (*vs_plain.values(),
                                             *vs_k68.values(), kept)) <= 1
          and lse_err <= ATTN_LSE_TOL and trimmed_ok
          and launches == dict(block_sparse_fwd=1, block_sparse_bwd_dkv=1,
                               block_sparse_bwd_dq=1))
    result = dict(phase="blocksparse_varlen", docs=len(GPT2M_DOCS), tokens=tq,
                  h=h, d=d, tile=list(plan.block_size), plan_ms=plan_ms,
                  padded_seqlen=plan.seqlen_q, vs_plain=vs_plain,
                  vs_kernels_6_8=vs_k68, lse_max_abs_err=lse_err,
                  trimmed_rows=int(trimmed.sum()),
                  trimmed_rows_out0_lse_neginf=trimmed_ok,
                  kept_rows_vs_untrimmed=kept, launches=launches,
                  tolerance=ATTN_TOLERANCE, ok=ok)
    emit(result)
    check(ok, "blocksparse_varlen disagrees with kernels 6-8 or the plain "
              "versions, or trimmed rows are not out 0 / lse -inf")
    return result


def blocksparse_phases(vtrain=None):
    """Every block-sparse phase; returns their results for the kernels
    line."""
    cases = {name: bs_case(name, seed=140 + i)
             for i, name in enumerate(BS_CASES)}
    gc.collect()
    torch.cuda.empty_cache()
    train = blocksparse_train_phase(vtrain)
    varlen = blocksparse_varlen_phase()
    return dict(cases=cases, train=train, varlen=varlen)


def blocksparse_kernel_entries(bsr):
    """Kernels 9-11 for the kernels line: times at `doc10` (b 1, h 16, s
    8192, d 128, tile 512), launches from `blocksparse_train`."""
    at, launches = bsr["cases"]["doc10"], bsr["train"]["launches"]
    entries = []
    for name, key, source, replaces, tensors in (
            ("block_sparse_fwd", "fwd", "block_sparse_fwd.cu",
             "block_sparsity.py:455", ("out",)),
            ("block_sparse_bwd_dkv", "dkv", "block_sparse_bwd.cu",
             "block_sparsity.py:807", ("dk", "dv")),
            ("block_sparse_bwd_dq", "dq", "block_sparse_bwd.cu",
             "block_sparsity.py:906", ("dq", "delta"))):
        err = max(c[t]["max_abs_err"] for c in bsr["cases"].values()
                  for t in tensors)
        entry = dict(
            name=name, route="cuda",
            source=f"flash_attn_tpu_torch/csrc/{source}",
            replaces=f"flash_attn_tpu/kernels/{replaces}",
            launches=launches[name],
            launches_by_path=dict(blocksparse_train=launches[name],
                                  blocksparse_varlen=bsr["varlen"]["launches"][name]),
            max_abs_err=err, ms=at[f"{key}_ms"], plain_ms=at[f"{key}_plain_ms"],
            bound_ms=at[f"{key}_bound_ms"], bound_by=at[f"{key}_bound_by"],
            library_ms=at["library_fwd_ms"] if key == "fwd" else None,
            shape=(f"doc10: b=1 h=16 s=8192 d=128 tile 512, kept density "
                   f"{at['density']:.4f}"))
        entries.append(entry)
        check(entry["launches"] > 0, f"{name} never launched on "
                                     "blocksparse_train")
    return entries


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", nargs="+",
        choices=("kernel", "attn", "varlen", "vllm", "decode", "sparse",
                 "blocksparse"),
        help="run only these kernel phases (kernel, attn_kernels + attn_fault, "
             "varlen_kernels + varlen_fault + varlen_train, vllm, "
             "decode_kernels + decode_fault, the sparse phases, the "
             "block-sparse phases) and stop, with no result line: for "
             "iterating on one kernel")
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
        if "sparse" in only:
            sparse_phases()
        if "blocksparse" in only:
            blocksparse_phases()
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
    sparse = sparse_phases()
    gc.collect()
    torch.cuda.empty_cache()
    bsr = blocksparse_phases(vtrain)
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
    kernels += sparse_kernel_entries(sparse)
    kernels += blocksparse_kernel_entries(bsr)
    emit({"kernels": kernels})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
