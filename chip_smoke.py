"""Smoke run of flash_attn_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (into build/kernels/), then:

  1. env      torch/CUDA versions, the card's name and power limit, build time;
  2. kernel   the paged-decode kernel against its plain PyTorch version at the
              serving path's shapes (Mistral-7B widths) and the split-KV
              schedule's edges (b 1, contexts under one tile, a short
              window), with CUDA-event times of the kernel (eager, and
              replayed from a CUDA graph), the plain version, a PyTorch
              library yardstick, and the card's bound for the same work;
              then split_fault: the kernel's partials merged with a split
              dropped, and the plain split schedule with a boundary moved
              by one token, which the check must catch;
  3. attn_kernels  the flash forward, dK/dV and dQ kernels likewise, at the
              GPT-2-medium training shape, the Mistral-7B shape (GQA, window
              4095), a short window (127), a softcap, rows that see nothing,
              lengths off the forward's tiles, and sq not a multiple of 4
              (LSE rows off a 16-byte boundary); the backward twice for
              equal bits; attn_tma_copy: the forward and the backward on
              inputs their tensor maps cannot take as they are (copied,
              counted) and on (b, s, h, d) views (taken as they are); then
              attn_fault: the window cases with the kernels handed a window
              one column wider, which every kernel's check must catch;
     varlen_kernels, varlen_fault, varlen_train, vllm: kernels 6-8 and
              vLLM's per-layer calls (see each function); kernels 6, 7 and
              8 each with its flat schedule read from its own trace, and
              each with one boundary moved that its check must catch; a
              decode-only step's 32 layer calls replayed from a CUDA graph,
              equal in bits to the eager step;
     varlen_features, varlen_features_bits, varlen_features_fault,
     varlen_train_dropout, compile_specs, vllm_alibi  kernels 6-8's feature
              instances (ALiBi, attention_chunk, dropout) against their
              plain versions at the widths of models that run each feature
              (Baichuan-13B ALiBi packed and on "phd" pools, GPT-2-medium
              documents with dropout, Llama-4-Scout chunk 8192, all at once
              at d 64), each beside the feature-free kernels on the same
              inputs; kernel 6's keep mask read back in bits at packed
              coordinates; planted faults (the keep mask in per-sequence
              coordinates, ALiBi's diagonal moved by one, a chunk edge off
              by one, dV without 1 / (1 - p)) that every check must catch;
              varlen_train's 24 layers with dropout 0.1 beside it, every
              attention launch a feature instance's in the trace; the
              compiled-specs callable against flash_attn_varlen_func in
              bits; the vllm schedule at Baichuan-13B widths with ALiBi
              (kernel 6 on chunks, kernel 5 on decode rows, from the trace);
     decode_kernels  the general decode kernel (kernel 5) against its plain
              version at Mistral-7B widths: decode, generate's 4500-token
              prefill, batch index, leftpad with a window, ALiBi, sinks,
              chunks, sink tokens, softcap, non-causal, paged "phd" views,
              TinyLlama's d 64, and a vLLM step with s_aux sinks at
              gpt-oss-20b widths, each with its split-KV schedule
              (num_splits, combine launches) and, for the decode steps,
              times replayed from a CUDA graph; then decode_fault: a
              window, leftpad or chunk off by one, and decode_split_fault:
              a split's chunk moved by one tile, the sink added in every
              partial, which every check must catch;
     sparse_kernels, sparse_fault, sparse_autograd, sparse_crossover,
     sparse_vllm  vertical-slash sparse attention (kernels 12-15): both
              forward routes and the backward against their plain versions
              on MInference-style metadata (the 32768-token Mistral-width
              prefill, 8192 forward and backward, d 64, ALiBi + softcap
              fp16, padded lengths, overlaps and garbage, empty blocks, odd
              block counts at d 64, sq not a multiple of 4),
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
              that keep nothing, s not a multiple of 4 under GQA, each
              kernel run twice for equal bits; a row's word shifted and a
              sub-tile dropped, which the checks of kernels 9, 10 and 11
              must each catch; GPT-2-medium's packed
              documents through 24 layers of flash_attn_func fwd+bwd with
              one plan per step, host syncs made errors, held against
              kernels 6-8; and flash_attn_varlen_func over a varlen plan;
     quant_kernels, quant_fault, quant_vllm  1-byte (int8, e4m3) KV
              caches: kernel 4 (the decode step and a 256-row prefill chunk,
              fused and split pools) and kernel 5 (decode, generate's late
              decode step and its prefill, a paged "phd" view with sinks),
              each with (hk,) and (b, hk) descales, against its plain
              version, twice for equal bits, at unit descales against the
              bf16 instance on the upcast pool, timed beside it with its
              bound at 1 byte per K/V element and its workspace; planted
              faults (K/V descales swapped, a V descale applied twice, an
              e4m3 pool launched as int8) that the checks must catch; the
              `vllm` phase's 43 steps x 32 layers on e4m3 "phd" pools with
              (nseq, hk) descales (mixed steps: the dequant pass and kernel
              6, timed alone; decode-only steps: kernel 4);
  4. logits   a Mistral-7B-v0.1-width model (random seeded weights, bf16, all
              32 layers): chunked prefill of a ~4500-token prompt and 8 decode
              steps through the engine's own forward, logits held against a
              plain fp32 forward under the 2x-bf16-eager contract;
  5. serve    LLMEngine.generate on 8 requests through the eager engine
              (cg=False) and then the default one, whose step programs
              replay CUDA graphs: equal tokens, tokens/s of both, peak
              memory, and proof that every attention call went through
              kernel 4 (its launches per replay = layers x steps);
     logits_graphed  the graphed engine's logits at every decode step of
              that traffic against the eager engine's, equal in bits;
     graph_fault  the decode graph replayed once over the step before's
              offsets, which the token check must catch;
  6. profile  torch.profiler device time by kernel over the prefill and the
              decode steps of 8 more requests through the graphed engine,
              beside the host wall time (the decode idle share);
     spec_serve  the serve traffic through LLMEngine with speculative_k 3
              and a TinyLlama-1.1B-width draft, graphed: tokens equal to the
              plain engine's up to near-ties, two held to an fp32 forward,
              launches = target and draft layers x their forwards; then the
              target as its own draft (at least half the drafts accepted);
     quant_serve  the same traffic on int8 pools (per-layer amax/127 scales
              from the bf16 pools) and fp8 pools (scale 1.0), graphed: pool
              bytes half of bf16's, decode tokens/s beside bf16's, launches,
              and the bf16 tokens teacher-forced through each (mean |d
              logprob| within twice the JAX package's measured drift), the
              greedy-token rule of the JAX tests reported;
     generate the same model's generate() over contiguous caches (kernel 5),
              its decode steps replayed from a CUDA graph: batch 4,
              4500-token prompts, 32 new tokens, scores held against an fp32
              forward, launches counted, cg=False equal in bits, tokens/s of
              both;
     speculative  decode_speculative with a TinyLlama-1.1B-width draft,
              tokens equal to greedy generate's;
     mla_kernels, mla_fault, mla_serve, mla_profile, mla_logits,
     mla_generate  MLA
              serving at DeepSeek-V2-Lite's attention widths (h 16, a 64-wide
              rope key, a 512-wide latent, one KV head): kernels 4 and 5's
              qv paths (csrc/mla_decode.cu) and kernel 1's qv forward
              (csrc/flash_fwd_qv.cu) against their plain versions (decode at
              b 8 on fused and split page-16 pools, a 256-token prefill
              chunk, a decode at 32768, generate's decode step on contiguous
              caches, the 4096-token forward with and without qv), twice for
              equal bits, beside SDPA over [q | qv] . [k_rope | latent]^T;
              planted faults (qv dropped, V read at offset 64, a split
              boundary moved by one key) that the checks must catch, lengths
              past the cache that the kernels must answer as the plain
              versions do; LLMEngine on the 27-layer
              model (no experts: the dense MLP on every layer) serving the
              serve traffic eager and graphed (equal tokens, every attention
              launch kernel 4's qv path, pool bytes against an MHA cache);
              the graphed prefill and decode steps under torch.profiler
              (device time by kernel, kernel 4's qv share); the cache-free and the engine's logits against an fp32 plain
              forward; generate(cg=True) over contiguous latent caches
              (kernel 5's qv path);
     mla_bwd_kernels, mla_bwd_fault, mla_train_grad, mla_train  MLA
              training: kernels 3 and 2's MLA instances (csrc/mla_bwd.cu)
              against their plain versions at DeepSeek-V2-Lite's widths,
              twice for equal bits, beside SDPA's backward; dV without
              dS^T Qv, an unwritten dQv and a head left out of the
              group's sum, which the check must catch; the 27-layer MLA
              GPT's loss and gradients against the fp32 plain model; and
              training.run.main on configs/deepseek-v2-lite-mla-synth.yaml
              for 20 steps (falling loss, tokens/s, MFU, peak memory,
              launches per step);
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
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flash_attn_tpu_torch.flash_attn_interface import (  # noqa: E402
    compile_flash_attn_varlen_func_from_specs,
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
    BLOCK_ROWS as BWD_BLOCK_ROWS,
    _bwd_dkv_ref,
    _bwd_dq_ref,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
)
from flash_attn_tpu_torch.kernels import common  # noqa: E402
from flash_attn_tpu_torch.kernels.common import (  # noqa: E402
    alibi_bias,
    aux_take,
    default_alibi_slopes,
    dropout_keep_mask,
    fold_seed,
    make_features,
    normalize_window,
    visible_mask,
)
from flash_attn_tpu_torch.kernels import flash_decode as fd  # noqa: E402
from flash_attn_tpu_torch.kernels.flash_decode import (  # noqa: E402
    combine_partials,
    flash_attention_decode_general,
    flash_attention_decode_general_split_ref,
    flash_attention_decode_ref,
    visible_columns,
    walk_ranges,
)
from flash_attn_tpu_torch.kernels import (  # noqa: E402
    flash_decode_multipage as fdm,
)
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (  # noqa: E402
    flash_attention_decode_multipage,
    flash_attention_decode_multipage_ref,
    flash_attention_decode_multipage_split_ref,
    split_ranges,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (  # noqa: E402
    flash_attention_fwd,
    flash_attention_fwd_ref,
)
from flash_attn_tpu_torch.kernels.flash_sparse import (  # noqa: E402
    _sparse_dkv_ref,
    _sparse_dq_ref,
    column_limits,
    flash_attention_sparse_bwd,
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
from flash_attn_tpu_torch.kernels import flash_varlen  # noqa: E402
from flash_attn_tpu_torch.kernels import mla_attn  # noqa: E402
from flash_attn_tpu_torch.kernels.flash_varlen import (  # noqa: E402
    _varlen_dkv_ref,
    _varlen_dq_ref,
    flash_attention_varlen_bwd_dkv,
    flash_attention_varlen_bwd_dq,
    flash_attention_varlen_fwd,
    flash_attention_varlen_fwd_ref,
    make_varlen_metadata,
    plan_mismatch,
    sm90_block_m,
    sm90_grid_tiles,
    trace_schedule,
    varlen_features,
    varlen_window,
)
from flash_attn_tpu_torch.losses.cross_entropy import (  # noqa: E402
    cross_entropy_loss,
)
from flash_attn_tpu_torch.models.adapters import (  # noqa: E402
    llama_config_to_gpt_config,
)
from flash_attn_tpu_torch.models.gpt import (  # noqa: E402
    GPTConfig,
    GPTLMHeadModel,
)
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
    quantize_to_cache_dtype,
)
from flash_attn_tpu_torch.training import run as train_run  # noqa: E402
from flash_attn_tpu_torch.training.run import load_config  # noqa: E402
from flash_attn_tpu_torch.training.trainer import (  # noqa: E402
    Trainer,
    gpt_flops_per_token,
)
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
    dequant_pages,
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


def graph_ms(fn, reps: int = 20) -> float:
    """cuda_ms of fn() captured once in a CUDA graph and replayed: the
    device time of its launches without the host's time to issue them
    (which bounds an eager call of a kernel that runs in tens of
    microseconds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


def ptxas_of(logs, fragment):
    """[registers, spill store bytes, spill load bytes] of every kernel whose
    mangled name holds `fragment`, from the build's ptxas -v output."""
    found, name, spills = [], None, (0, 0)
    for line in (ln for log in logs.values() for ln in log.splitlines()):
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and fragment in name:
            found.append([int(m.group(1)), *spills])
            name = None
    return found


def sass_counts(library, words, fragment=None):
    """How often each of `words` begins an instruction word in the
    library's SASS (cuobjdump -sass, the toolkit's or Triton's copy), over
    the kernels whose mangled name holds `fragment` (all without one); None
    without cuobjdump."""
    tools = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for tool in tools:
        if os.path.exists(tool):
            sass = subprocess.run([tool, "-sass", library], capture_output=True,
                                  text=True, timeout=300, check=True).stdout
            if fragment is not None:
                sass = "".join(f for f in sass.split("Function : ")
                               if f.split("\n", 1)[0].find(fragment) >= 0)
            return {w: len(re.findall(rf"\b{w}\w*", sass)) for w in words}
    return None


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
    # The split-KV schedule's edges: b 1 at a 4500-token context (the most
    # splits), contexts shorter than one 64-token tile (splits left empty),
    # and a short window whose edge falls inside the splits.
    ("decode-b1-ctx4500", 1, True, 16, -1, 0.0, True, False),
    ("decode-short-contexts", 1, True, 16, -1, 0.0, True, False),
    ("decode-window300", 1, False, 16, 300, 0.0, True, False),
]
# Batch and contexts of the cases that do not draw them (kernel_case).
CASE_LENS = {"decode-b1-ctx4500": (4500,),
             "decode-short-contexts": (1, 5, 17, 33, 40, 50, 63, 64),
             "split-fault": (70, 96, 129, 150, 170, 190, 200, 130)}
B, H, HK, D = 8, 32, 8, 128
MAX_CTX = 6000


def bound(seqlens, sq, window, table_shape, kv_bytes=2):
    """Least time (ms) the card needs for one call, and what bounds it:
    visible K/V rows read once (kv_bytes a value: 1 for a 1-byte pool),
    q/out/lse/table moved once, and 4*d flops per visible (query head,
    query token, column)."""
    tokens, pairs = 0, 0
    for L in seqlens:
        pos = L - sq + np.arange(sq)
        lo = np.maximum(pos - window, 0) if window >= 0 else np.zeros(sq, int)
        pairs += int(np.maximum(np.minimum(pos + 1, L) - lo, 0).sum())
        tokens += max(0, L - int(lo[0]))
    b = len(seqlens)
    nbytes = (tokens * HK * 2 * D * kv_bytes + 2 * b * sq * H * D * 2
              + b * H * sq * 4 + 4 * table_shape[0] * table_shape[1] + 4 * b)
    flops = 4 * D * H * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_inputs(name, sq, fused, page, window, softcap, permuted, phd,
                  seed):
    """The seeded inputs of a paged-decode case: (args, kwargs, seqlens)."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    if name in CASE_LENS:
        seqlens = np.asarray(CASE_LENS[name])
    else:
        seqlens = rng.randint(max(sq, 1), MAX_CTX + 1, B)
        seqlens[0] = max(seqlens[0], 4500)  # one context past the 4096 window
    batch = len(seqlens)
    max_pages = -(-MAX_CTX // page)
    npages = batch * max_pages + 1
    ids = rng.permutation(npages - 1) if permuted else np.arange(npages - 1)
    table = torch.from_numpy(ids[: batch * max_pages].reshape(batch, max_pages)
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
    q = torch.randn(batch, sq, H, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kw = dict(fused_kv_dim=D if fused else 0, window_left=window, softcap=softcap)
    return (q, k_pages, v_pages, lens, table), kw, seqlens


def paged_ref(args, kw):
    """The plain version in fp32 on the case's inputs."""
    up = [None if a is None else a.float() if a.is_floating_point() else a
          for a in args]
    return flash_attention_decode_multipage_ref(*up, **kw)


def paged_held(out, lse, ref_out, ref_lse):
    """The paged-decode check: (ok, max abs error of out, of the finite
    lse). A row that sees nothing must give out 0 and lse -inf."""
    err = (out.float() - ref_out).abs()
    fin = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[fin].abs().max()) if fin.any() else 0.0
    ok = bool((err <= OUT_ATOL + OUT_RTOL * ref_out.abs()).all()
              and lse_err <= LSE_ATOL and torch.isfinite(out).all()
              and torch.equal(fin, torch.isfinite(lse)))
    return ok, float(err.max()), lse_err


def kernel_case(name, sq, fused, page, window, softcap, permuted, phd, seed):
    args, kw, seqlens = kernel_inputs(name, sq, fused, page, window, softcap,
                                      permuted, phd, seed)
    q, k_pages, v_pages, lens, table = args
    batch = len(seqlens)
    dev = q.device
    splits = fdm.splits_of(q, k_pages, table, window)
    out, lse = flash_attention_decode_multipage(*args, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = paged_ref(args, kw)
    ok, max_err, lse_err = paged_held(out, lse, ref_out, ref_lse)
    del ref_out, ref_lse

    ms = cuda_ms(lambda: flash_attention_decode_multipage(*args, **kw))
    launches = (flash_attention_decode_multipage.launches,
                flash_attention_decode_multipage.combine_launches)
    kernel_graph_ms = graph_ms(
        lambda: flash_attention_decode_multipage(*args, **kw))
    (flash_attention_decode_multipage.launches,
     flash_attention_decode_multipage.combine_launches) = launches
    plain_ms = cuda_ms(lambda: flash_attention_decode_multipage_ref(*args, **kw),
                       reps=20, warmup=1)
    library_ms = library_graph_ms = None
    if softcap == 0.0:
        # Yardstick: one PyTorch call on K/V already gathered contiguous (no
        # PyTorch call reads a paged pool); the port never calls it.
        if fused:
            kc, vc = k_pages[..., :D], k_pages[..., 128:128 + D]
        else:
            kc, vc = k_pages, v_pages
        tl = table.long()
        kg = kc[tl].permute(0, 2, 1, 3, 4).reshape(batch, HK, -1, D).contiguous()
        vg = vc[tl].permute(0, 2, 1, 3, 4).reshape(batch, HK, -1, D).contiguous()
        cols = torch.arange(kg.shape[2], device=dev)[None, None]
        pos = (lens.long()[:, None, None] - sq
               + torch.arange(sq, device=dev)[None, :, None])
        mask = (cols < lens.long()[:, None, None]) & (cols <= pos)
        if window >= 0:
            mask &= cols >= pos - window
        mask = mask[:, None]
        qt = q.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                                  enable_gqa=True)

        library_ms = cuda_ms(sdpa)
        library_graph_ms = graph_ms(sdpa)
        del kg, vg, mask
    bound_ms, bound_by = bound(seqlens.tolist(), sq, window, tuple(table.shape))
    rows = sq * (H // HK)
    result = dict(
        phase="kernel", kernel="paged_decode", case=name, b=batch, sq=sq, h=H,
        hk=HK, d=D, page=page, fused=fused, phd_view=phd, window_left=window,
        softcap=softcap, permuted=permuted, max_ctx=int(seqlens.max()),
        design="split-kv" if rows <= fdm.SPLIT_ROWS else "rows",
        num_splits=splits,
        grid=([splits, HK, batch] if rows <= fdm.SPLIT_ROWS
              else [-(-rows // 64), HK, batch]),
        max_abs_err=max_err, lse_max_abs_err=lse_err,
        tolerance=f"|out-ref| <= {OUT_ATOL} + {OUT_RTOL}|ref|, |lse-ref| <= {LSE_ATOL}",
        ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by, graph_ms=kernel_graph_ms,
        library_graph_ms=library_graph_ms,
    )
    emit(result)
    check(ok, f"paged_decode case {name} disagrees with its plain version")
    return result


def split_fault_phase(seed=95, num_splits=3):
    """The split-KV check's power, shown with kernel_case's check at
    contexts of 70-200 tokens over three splits, where one token carries
    weight: the kernel's partials merged whole must pass; merged with split
    1 dropped, and the plain split schedule with split 1 starting one token
    late (a column no split sees), must fail."""
    args, kw, seqlens = kernel_inputs("split-fault", 1, True, 16, -1, 0.0,
                                      True, False, seed)
    q = args[0]
    ref_out, ref_lse = paged_ref(args, kw)
    o_part, lse_part = fdm._run(*args, num_splits, **kw)
    held_by = {}
    out, lse = fdm.combine_splits(o_part, lse_part, q.dtype)
    held_by["whole"] = paged_held(out, lse, ref_out, ref_lse)
    keep = [i for i in range(num_splits) if i != 1]
    out, lse = fdm.combine_splits(o_part[keep], lse_part[keep], q.dtype)
    held_by["split_dropped"] = paged_held(out, lse, ref_out, ref_lse)
    moved = [[(lo + (i == 1 and hi > lo), hi) for i, (lo, hi) in
              enumerate(split_ranges(int(n), 1, -1, num_splits))]
             for n in seqlens]
    up = [None if a is None else a.float() if a.is_floating_point() else a
          for a in args]
    out, lse = flash_attention_decode_multipage_split_ref(
        *up, num_splits, ranges=moved, **kw)
    held_by["boundary_moved"] = paged_held(out, lse, ref_out, ref_lse)
    ok = (held_by["whole"][0] and not held_by["split_dropped"][0]
          and not held_by["boundary_moved"][0])
    emit(dict(phase="split_fault", contexts=seqlens.tolist(),
              num_splits=num_splits,
              held={k: dict(ok=v[0], max_abs_err=v[1], lse_max_abs_err=v[2])
                    for k, v in held_by.items()},
              tolerance=f"|out-ref| <= {OUT_ATOL} + {OUT_RTOL}|ref|, "
                        f"|lse-ref| <= {LSE_ATOL}", ok=ok))
    check(ok, "split_fault: the whole merge fails, or a dropped split or a "
              "moved boundary passes the check")


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
    # Neither length a multiple of kernel 1's 128-row and 128-key tiles.
    ("causal-d128-fp16-sq1000-sk1100", 2, 8, 4, 1000, 1100, 128, True,
     (-1, -1), 0.0, torch.float16),
    # sq not a multiple of 4: most heads' LSE and delta rows start off a
    # 16-byte boundary, where kernel 2's 1-D TMA copies must not start.
    ("causal-gqa-sq1001", 1, 8, 2, 1001, 1001, 64, True, (-1, -1), 0.0,
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
        # Yardstick: SDPA with the window as a boolean mask, the same
        # function in one call; the port never calls it. K and V are
        # repeated to the query heads outside the timed calls, so SDPA
        # takes them as it takes a multi-head model's, without enable_gqa.
        mask = visible_mask(sq, sk, normalize_window(window, causal),
                            device=q.device)
        qt, kt, vt = (x.detach().clone().requires_grad_() for x in (
            q, k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1)))
        result["library_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), reps=10)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            torch.autograd.grad(o, (qt, kt, vt), args[3])

        result["library_fwd_bwd_ms"] = cuda_ms(sdpa_fwd_bwd, reps=10)
        result["library"] = ("scaled_dot_product_attention(attn_mask=window "
                             "mask) on K/V repeated to 32 heads: a yardstick "
                             "only")
        del mask, qt, kt, vt
    emit(result)
    check(result["ok"], f"attn_kernels case {name} disagrees with its plain "
                        "version or is not deterministic")
    return result


def attn_copy_phase(seed=29):
    """Kernels 1-3 on inputs their tensor maps cannot all take as they are:
    q with a base 2 bytes off 16 (copied first, and the copy counted), k, v
    and dO as (b, s, h, d) tensors viewed (b, h, s, d) (taken as they
    are). The backward (flash_attention_bwd, both kernels) copies q once."""
    b, h, hk, s, d = 2, 8, 2, 1000, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, s, d + 8, generator=gen, device=dev,
                    dtype=torch.bfloat16)[..., 1:d + 1]
    k, v = (torch.randn(b, s, hk, d, generator=gen, device=dev,
                        dtype=torch.bfloat16).transpose(1, 2) for _ in range(2))
    before = flash_attention_fwd.tma_copies
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    copies = flash_attention_fwd.tma_copies - before
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                               causal=True)
    out_held = held(out, ref_out)
    lse_err = float((lse - ref_lse).abs().max())
    do = torch.randn(b, s, h, d, generator=gen, device=dev,
                     dtype=torch.bfloat16).transpose(1, 2)
    before = flash_attention_bwd.tma_copies
    dq, dk, dv = flash_attention_bwd(q, k, v, ref_lse, do, causal=True)
    bwd_copies = flash_attention_bwd.tma_copies - before
    torch.cuda.synchronize()
    up = tuple(x.float() for x in (q, k, v, do)) + (ref_lse,)
    ref_dq, ref_delta = _bwd_dq_ref(*up, causal=True)
    ref_dk, ref_dv = _bwd_dkv_ref(*up, ref_delta, causal=True)
    grads = dict(dq=held(dq, ref_dq), dk=held(dk, ref_dk), dv=held(dv, ref_dv))
    ok = (out_held["err_over_limit"] <= 1 and lse_err <= ATTN_LSE_TOL
          and copies == 1 and bwd_copies == 1
          and all(g["err_over_limit"] <= 1 for g in grads.values()))
    emit(dict(phase="attn_tma_copy", b=b, h=h, hk=hk, s=s, d=d,
              q="base 2 bytes off 16: copied", kv="(b, s, h, d) views",
              dout="(b, s, h, d) view", tma_copies=copies,
              bwd_tma_copies=bwd_copies, out=out_held,
              lse_max_abs_err=lse_err, **grads, tolerance=ATTN_TOLERANCE,
              ok=ok))
    check(ok, "attn_tma_copy: kernels 1-3 disagree on strided inputs, or "
              "the copies are not one each")
    return dict(fwd=copies, bwd=bwd_copies)


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


# -- phases: attn_features, attn_features_bits, attn_features_fault,
#    attn_features_trace (kernels 1-3's feature instances vs plain,
#    csrc/attn_features.cuh) --------------------------------------------------

# name: (b, h, hk, sq, sk, d, causal, window_size, softcap, features), each
# at the published widths of a model that runs the feature.
FEATURE_CASES = {
    # GPT-2 medium with GPT-2's attention dropout 0.1.
    "dropout-gpt2m": (8, 16, 16, 2048, 2048, 64, True, (-1, -1), 0.0,
                      dict(dropout_p=0.1, dropout_seed=1234)),
    # Baichuan-13B (40 heads of 128), ALiBi with the geometric slopes, and
    # per-row (b, h) slopes at batch 2.
    "alibi-baichuan13b": (1, 40, 40, 4096, 4096, 128, True, (-1, -1), 0.0,
                          dict(alibi="h")),
    "alibi-bh-baichuan13b-b2": (2, 40, 40, 4096, 4096, 128, True, (-1, -1),
                                0.0, dict(alibi="bh")),
    # varlen_train's 16 documents (GPT2M_DOCS) as segment ids over 8 rows
    # of 2048 at gpt2m widths.
    "segments-gpt2m-docs": (8, 16, 16, 2048, 2048, 64, True, (-1, -1), 0.0,
                            dict(segments="gpt2m-docs")),
    # Llama-4-Scout (40 query and 8 kv heads of 128), attention_chunk 8192.
    "chunk8192-llama4-scout": (1, 40, 8, 16384, 16384, 128, True, (-1, -1),
                               0.0, dict(attention_chunk=8192)),
    # Mistral-7B's window 4096 with 4 sink tokens (StreamingLLM).
    "sinktok4-mistral": (1, 32, 8, 8192, 8192, 128, True, (WINDOW, -1), 0.0,
                         dict(sink_token_length=4)),
    # gpt-oss-20b (64 query and 8 kv heads of 64), window 128, learnable
    # sink.
    "sink-gptoss20b": (1, 64, 8, 4096, 4096, 64, True, (127, -1), 0.0,
                       dict(sink=True)),
    # Everything at once at d 64, softcap too.
    "all-d64": (2, 8, 2, 2048, 2048, 64, True, (255, -1), 30.0,
                dict(dropout_p=0.1, dropout_seed=-77, alibi="bh",
                     segments="random", attention_chunk=512,
                     sink_token_length=4, sink=True)),
}
# The planted faults run on this case (small; every rule a fault moves is
# in it).
FEATURE_FAULT_CASE = (2, 8, 2, 2048, 2048, 64, True, (255, -1), 0.0,
                      dict(dropout_p=0.1, dropout_seed=31, attention_chunk=512,
                           sink_token_length=4))


def feature_inputs(case, seed):
    """Seeded q, k, v, dO (bf16) and the case's feature arguments on the
    card: (kw, fkw, (q, k, v, do))."""
    b, h, hk, sq, sk, d, causal, window, softcap, spec = case
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, hk, sk, d, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    fkw = {key: spec[key] for key in ("dropout_p", "dropout_seed",
                                      "attention_chunk", "sink_token_length")
           if key in spec}
    rng = np.random.RandomState(seed)
    if spec.get("alibi"):
        slopes = default_alibi_slopes(h)
        if spec["alibi"] == "bh":
            slopes = slopes[None] * torch.from_numpy(
                rng.uniform(0.5, 2.0, (b, 1)).astype(np.float32))
        fkw["alibi_slopes"] = slopes.to(dev)
    if spec.get("segments") == "gpt2m-docs":
        ids = torch.repeat_interleave(torch.arange(len(GPT2M_DOCS)),
                                      torch.tensor(GPT2M_DOCS))
        fkw["q_segment_ids"] = ids.reshape(b, sq).int().to(dev)
        fkw["kv_segment_ids"] = fkw["q_segment_ids"]
    elif spec.get("segments") == "random":
        ids = np.sort(rng.randint(0, 6, (b, sq)), axis=1).astype(np.int32)
        ids[:, sq - 37:] = -1  # padding rows and keys: never equal
        kv = np.where(ids < 0, -2, ids)
        fkw["q_segment_ids"] = torch.from_numpy(ids).to(dev)
        fkw["kv_segment_ids"] = torch.from_numpy(kv).to(dev)
    if spec.get("sink"):
        fkw["sink"] = torch.randn(h, generator=gen, device=dev)
    return dict(causal=causal, window_size=window, softcap=softcap), fkw, (
        q, k, v, do)


def feature_pairs(case, fkw):
    """Visible (query row, key) pairs summed over the batch rows, per head:
    the visibility rules' count (dropout, ALiBi and the sink see as many)."""
    b, h, hk, sq, sk, d, causal, window, softcap, spec = case
    f = make_features(**{k: v for k, v in fkw.items() if k != "sink"})
    win = normalize_window(window, causal)
    vis = (visible_mask(sq, sk, win, "cuda") if f is None
           else f.visible(sq, sk, win, "cuda"))
    return int(vis.sum()) * (b if vis.dim() == 2 else 1)


def _dsink(out, lse, do, sink):
    """The learnable sink's gradient as the JAX vjp takes it."""
    delta = (do.float() * out.float()).sum(-1)
    w = torch.exp(sink.float()[None, :, None] - lse)
    w = torch.where(torch.isfinite(lse), w, torch.zeros_like(w))
    return -(delta * w).sum((0, 2))


@contextlib.contextmanager
def planted_murmur(index, value):
    """The plain versions' dropout hash with constant `index` of
    common.MURMUR3 changed (a planted fault)."""
    saved = common.MURMUR3
    common.MURMUR3 = saved[:index] + (value,) + saved[index + 1:]
    try:
        yield
    finally:
        common.MURMUR3 = saved


def feature_compare(case, seed, kernel_fkw=None, dv_factor=1.0):
    """Kernels 1-3 with the case's features and their plain versions on the
    same seeded inputs (the plain backward fed the plain forward's LSE and
    delta); with a learnable sink also its gradient through
    flash_attn_func's autograd against the JAX vjp's formula on the plain
    forward. `kernel_fkw` hands the kernels other features than the plain
    versions, and `dv_factor` scales the plain dV (planted faults).
    Returns (result, kw, fkw, inputs)."""
    kw, fkw, (q, k, v, do) = feature_inputs(case, seed)
    kfkw = fkw if kernel_fkw is None else dict(fkw, **kernel_fkw)
    rf = make_features(**fkw)
    kf = make_features(**kfkw)
    out, lse = flash_attention_fwd(q, k, v, **kw, **kfkw)
    torch.cuda.synchronize()
    up = tuple(x.float() for x in (q, k, v, do))
    ref_out, ref_lse = flash_attention_fwd_ref(*up[:3], **kw, features=rf)
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[finite].abs().max()) if finite.any() else 0.0
    result = dict(out=held(out, ref_out), lse_max_abs_err=lse_err,
                  rows_seeing_nothing=int((ref_out.abs().amax(-1) == 0).sum()))
    fwd_ok = bool(result["out"]["err_over_limit"] <= 1
                  and torch.equal(finite, torch.isfinite(lse))
                  and lse_err <= ATTN_LSE_TOL and torch.isfinite(out).all())
    if "sink" in fkw:
        sink = fkw["sink"].clone().requires_grad_()
        o = flash_attn_func(q, k, v, sink=sink, layout="bhsd",
                            **{key: val for key, val in kfkw.items()
                               if key != "sink"}, **kw)
        (dsink,) = torch.autograd.grad(o, (sink,), do)
        result["dsink"] = held(dsink[None], _dsink(ref_out, ref_lse, up[3],
                                                   fkw["sink"])[None])
        fwd_ok = fwd_ok and result["dsink"]["err_over_limit"] <= 1
    dq, delta = flash_attention_bwd_dq(q, k, v, do, ref_lse, **kw, features=kf)
    ref_dq, ref_delta = _bwd_dq_ref(*up, ref_lse, **kw, features=rf)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, ref_lse, ref_delta, **kw,
                                     features=kf)
    torch.cuda.synchronize()
    result.update(dq=held(dq, ref_dq), delta=held(delta, ref_delta))
    del ref_dq
    ref_dk, ref_dv = _bwd_dkv_ref(*up, ref_lse, ref_delta, **kw, features=rf)
    result.update(dk=held(dk, ref_dk), dv=held(dv, ref_dv * dv_factor))
    del ref_dk, ref_dv, ref_out, up
    result.update(
        fwd_ok=fwd_ok,
        dq_ok=result["dq"]["err_over_limit"] <= 1
        and result["delta"]["err_over_limit"] <= 1,
        dkv_ok=max(result["dk"]["err_over_limit"],
                   result["dv"]["err_over_limit"]) <= 1,
        grads_finite=all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)))
    return result, kw, fkw, (q, k, v, do, ref_lse, ref_delta)


def feature_library(case, kw, fkw, tensors):
    """SDPA on the same function where one call computes it: the ALiBi term
    as an additive float mask, segment ids, a chunk or sink tokens as a
    boolean mask (with the window and causality); K and V repeated to the
    query heads outside the timed calls. None for dropout (SDPA draws its
    own mask) and the learnable sink. A yardstick; the port never calls
    it."""
    if "dropout_p" in fkw or "sink" in fkw:
        return None
    b, h, hk, sq, sk, d = case[:6]
    q, k, v, do = tensors[:4]
    win = normalize_window(kw["window_size"], kw["causal"])
    f = make_features(**fkw)
    mask = f.visible(sq, sk, win, q.device)
    if "alibi_slopes" in fkw:
        bias = alibi_bias(fkw["alibi_slopes"], slice(0, h), sq, sk, q.device)
        mask = bias.masked_fill(~mask, float("-inf")).to(q.dtype)
        del bias
    qt, kt, vt = (x.detach().clone().requires_grad_() for x in (
        q, k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1)))
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), reps=5, warmup=1)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(o, (qt, kt, vt), do)

    both = cuda_ms(sdpa_fwd_bwd, reps=5, warmup=1)
    return dict(fwd_ms=fwd, bwd_ms=both - fwd,
                call="scaled_dot_product_attention(attn_mask="
                     + ("ALiBi float mask" if "alibi_slopes" in fkw
                        else "boolean mask") + ")")


def feature_case(name, seed):
    """One FEATURE_CASES case: held, timed against its plain versions and
    its bound, SDPA beside it where one call computes it."""
    case = FEATURE_CASES[name]
    checked, kw, fkw, tensors = feature_compare(case, seed)
    b, h, hk, sq, sk, d = case[:6]
    q, k, v, do, lse, delta = tensors
    kf = make_features(**fkw)
    big = b * h * sq * sk > 2**31
    plain = dict(reps=1 if big else 3, warmup=1)
    up = tuple(x.float() for x in (q, k, v, do))
    result = dict(
        phase="attn_features", case=name, b=b, h=h, hk=hk, sq=sq, sk=sk, d=d,
        causal=kw["causal"], window_size=list(kw["window_size"]),
        softcap=kw["softcap"], features=sorted(case[9]), **checked,
        tolerance=ATTN_TOLERANCE,
        ok=(checked["fwd_ok"] and checked["dq_ok"] and checked["dkv_ok"]
            and checked["grads_finite"]),
        fwd_ms=cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw, **fkw),
                       reps=10),
        dq_ms=cuda_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, **kw,
                                                     features=kf), reps=10),
        dkv_ms=cuda_ms(lambda: flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw, features=kf), reps=10),
        fwd_plain_ms=cuda_ms(lambda: flash_attention_fwd_ref(
            *up[:3], **kw, features=kf), **plain),
        dq_plain_ms=cuda_ms(lambda: _bwd_dq_ref(*up, lse, **kw, features=kf),
                            **plain),
        dkv_plain_ms=cuda_ms(lambda: _bwd_dkv_ref(*up, lse, delta, **kw,
                                                  features=kf), **plain),
    )
    del up
    pairs = feature_pairs(case, fkw)
    el = q.element_size()
    qb, kvb, stats = b * h * sq * d * el, b * hk * sk * d * el, b * h * sq * 4
    # As attn_kernels' bound, over the visible pairs of the features' rules
    # (summed over the batch rows): fwd 4d flops a pair, dK/dV 8d, dQ 6d.
    for key, per_d, nbytes in (
            ("fwd", 4, 2 * qb + 2 * kvb + stats),
            ("dkv", 8, 2 * qb + 4 * kvb + 2 * stats),
            ("dq", 6, 3 * qb + 2 * kvb + 2 * stats)):
        result[f"{key}_bound_ms"], result[f"{key}_bound_by"] = attn_bound(
            per_d, nbytes, 1, h, d, pairs)
    result["visible_pairs"] = pairs
    result["library"] = feature_library(case, kw, fkw, tensors)
    if "dropout_p" in fkw and name == "dropout-gpt2m":
        # The dropped share of the visible pairs, from the keep mask the
        # kernels draw (attn_features_bits shows they draw these bits).
        vis = visible_mask(sq, sk, normalize_window(kw["window_size"],
                                                    kw["causal"]), q.device)
        kept = sum(int((kf.keep(b, slice(hh, hh + 1), sq, sk, q.device)
                        & vis).sum()) for hh in range(h))
        result["dropped_fraction"] = 1.0 - kept / (b * h * int(vis.sum()))
        result["ok"] = result["ok"] and abs(
            result["dropped_fraction"] - fkw["dropout_p"]) <= 0.01
    emit(result)
    check(result["ok"], f"attn_features case {name} disagrees with its plain "
                        "version (or its dropped share is off p)")
    return result


def feature_bits_phase():
    """The keep mask read back in bits from kernel 1: V = I at sk = d, so
    out[r, c] is P[r, c] Z[r, c] / (1 - p) / l, and O's zeros are exactly
    the dropped entries; against dropout_keep_mask (the JAX hash) at
    nonzero batch rows and heads, rows 0..999 over six 192-row blocks, two
    seeds (one negative)."""
    b, h, sq, d = 3, 4, 1000, 64
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(61)
    q = 0.1 * torch.randn(b, h, sq, d, generator=gen, device=dev)
    k = 0.1 * torch.randn(b, h, d, d, generator=gen, device=dev)
    v = torch.eye(d, device=dev).expand(b, h, d, d).contiguous()
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    cases = []
    for seed, p in ((-12345, 0.25), (987654321, 0.1)):
        out, _ = flash_attention_fwd(q, k, v, dropout_p=p, dropout_seed=seed)
        keep = dropout_keep_mask(
            seed, torch.arange(b, device=dev).reshape(-1, 1, 1, 1),
            torch.arange(h, device=dev).reshape(1, -1, 1, 1), 0, 0, (sq, d),
            1.0 - p, device=dev)
        cases.append(dict(seed=seed, dropout_p=p,
                          equal_bits=bool(torch.equal(out != 0, keep)),
                          mismatched=int(((out != 0) != keep).sum()),
                          dropped_fraction=float(1 - keep.float().mean())))
    ok = all(c["equal_bits"] for c in cases)
    emit(dict(phase="attn_features_bits", b=b, h=h, sq=sq, sk=d, d=d,
              how="V = I at sk = d: O's zeros are the dropped entries",
              cases=cases, ok=ok))
    check(ok, "attn_features_bits: kernel 1's keep mask is not the hash's")


def feature_fault_phase():
    """The checks' power over the features, shown: each planted fault must
    read > 1 in the kernels' error over limit. A changed hash constant
    (fmix32's first multiplier in the plain versions), a sink-token range
    one tile (128 keys) longer in the kernels, a chunk edge off by one (the
    kernels' chunk one longer), and a dV without 1 / (1 - p) (the plain dV
    times 1 - p)."""
    spec = FEATURE_FAULT_CASE[9]
    faults = {}
    with planted_murmur(5, common.MURMUR3[5] ^ 0x10):
        faults["hash_constant"] = feature_compare(FEATURE_FAULT_CASE, 41)[0]
    faults["sink_tokens_plus_one_tile"] = feature_compare(
        FEATURE_FAULT_CASE, 42, kernel_fkw=dict(
            sink_token_length=spec["sink_token_length"] + 128))[0]
    faults["chunk_edge_off_by_one"] = feature_compare(
        FEATURE_FAULT_CASE, 43, kernel_fkw=dict(
            attention_chunk=spec["attention_chunk"] + 1))[0]
    faults["dv_without_keep_scale"] = feature_compare(
        FEATURE_FAULT_CASE, 44, dv_factor=1.0 - spec["dropout_p"])[0]
    want = {name: ("out", "dq", "dk", "dv") for name in faults}
    want["dv_without_keep_scale"] = ("dv",)
    read = {name: {t: r[t]["err_over_limit"] for t in
                   ("out", "dq", "delta", "dk", "dv")}
            for name, r in faults.items()}
    caught = {name: all(read[name][t] > 1 for t in want[name])
              for name in faults}
    emit(dict(phase="attn_features_fault", case=list(FEATURE_FAULT_CASE[:9]),
              features=sorted(spec), err_over_limit=read,
              must_exceed_1=want, caught=caught, ok=all(caught.values())))
    check(all(caught.values()), "attn_features_fault: a planted fault "
                                "passes the tolerance")


FEATURE_KERNELS = {"flash_fwd": "fwd_sm90_kernel",
                   "flash_bwd_dq": "bwd_dq_sm90_kernel",
                   "flash_bwd_dkv": "bwd_dkv_sm90_kernel"}


def _feature_counts():
    return dict(flash_fwd=flash_attention_fwd.feature_launches,
                flash_bwd_dq=flash_attention_bwd_dq.feature_launches,
                flash_bwd_dkv=flash_attention_bwd_dkv.feature_launches)


def feature_trace_phase(seed=45):
    """The feature instances' launches read from a torch.profiler trace of
    one flash_attn_func forward and backward through autograd (the all-d64
    case, traced_launches): one launch of each kernel's FeatParams
    instance, as the wrappers' counts say."""
    case = FEATURE_CASES["all-d64"]
    kw, fkw, (q, k, v, do) = feature_inputs(case, seed)
    q.requires_grad_()

    def call():
        o = flash_attn_func(q, k, v, layout="bhsd", **kw, **fkw)
        torch.autograd.grad(o, (q,), do)

    before = _feature_counts()
    call()
    torch.cuda.synchronize()
    counted = {n: c - before[n] for n, c in _feature_counts().items()}
    by_kernel = traced_launches(call)

    def instance(key, frag):
        # The kernel's template arguments end with kFeat: 0 is the
        # feature-free instance.
        m = re.search("::" + frag + r"<[^<>]*,\s*(\d+)>", key)
        return bool(m) and m.group(1) != "0"

    listed = {name: sum(c for key, c in by_kernel.items()
                        if instance(key, frag))
              for name, frag in FEATURE_KERNELS.items()}
    ok = listed == counted == dict(flash_fwd=1, flash_bwd_dq=1,
                                   flash_bwd_dkv=1)
    emit(dict(phase="attn_features_trace", case="all-d64",
              launches_listed=listed, launches_counted=counted,
              kernels=[key[:120] for key in by_kernel
                       if "sm90_kernel" in key], ok=ok))
    check(ok, "attn_features_trace: the trace's feature launches differ "
              "from the counts")
    return listed


def feature_entry(features, key, train_dropout, name, logs):
    """The kernels line's record of kernel 1, 2 or 3's feature instances
    (`key` fwd, dkv or dq): their source, ptxas registers, launches on
    train_dropout's path and the trace's, and each FEATURE_CASES case's
    time beside its plain version's, its bound and SDPA's."""
    src = "flash_fwd_features" if key == "fwd" else "flash_bwd_features"
    frag = dict(fwd="15fwd_sm90_kernel", dq="bwd_dq_sm90_kernel",
                dkv="bwd_dkv_sm90_kernel")[key]
    trace = dict(fwd="flash_fwd", dq="flash_bwd_dq", dkv="flash_bwd_dkv")[key]
    cases = {}
    for case, r in features.items():
        if case == "trace":
            continue
        lib = r["library"]
        cases[case] = dict(
            ms=r[f"{key}_ms"], plain_ms=r[f"{key}_plain_ms"],
            bound_ms=r[f"{key}_bound_ms"], bound_by=r[f"{key}_bound_by"],
            library_ms=None if lib is None else lib[
                "fwd_ms" if key == "fwd" else "bwd_ms"],
            max_abs_err=max(r[t]["max_abs_err"] for t in (
                ("out",) if key == "fwd" else ("dq", "delta") if key == "dq"
                else ("dk", "dv"))))
    return dict(source=f"flash_attn_tpu_torch/csrc/{src}.cu",
                ptxas=ptxas_of({src: logs.get(src, "")}, frag),
                launches_train_dropout=train_dropout["feature_launches"][name],
                launches_trace=features["trace"][trace], cases=cases)


def feature_phases():
    """Every FEATURE_CASES case, the bits, the planted faults, the trace."""
    results = {}
    for i, name in enumerate(FEATURE_CASES):
        results[name] = feature_case(name, seed=160 + i)
        gc.collect()
        torch.cuda.empty_cache()
    feature_bits_phase()
    feature_fault_phase()
    results["trace"] = feature_trace_phase()
    return results


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


def library_packed(q, k, v, do, cu, causal):
    """The yardstick of a packed call: SDPA on jagged torch.nested tensors
    (the port never calls it), forward, and forward with the backward to
    q, k and v for the gradient `do`. Returns (ms, fwd+bwd ms, what ran);
    a time that could not be taken is None, and `what` says why."""
    offs = cu.long()

    def sdpa(q, k, v):
        qn, kn, vn = (torch.nested.nested_tensor_from_jagged(x, offs)
                      .transpose(1, 2) for x in (q, k, v))
        return F.scaled_dot_product_attention(qn, kn, vn, is_causal=causal)

    what = f"SDPA on jagged torch.nested tensors, is_causal={causal}"
    try:
        ms = cuda_ms(lambda: sdpa(q, k, v))
    except Exception as exc:  # a yardstick: report why it did not run
        return None, None, f"not run: {type(exc).__name__}: {str(exc)[:160]}"
    leaves = tuple(x.detach().requires_grad_() for x in (q, k, v))

    def fwd_bwd():
        out = sdpa(*leaves).transpose(1, 2).values()
        torch.autograd.grad(out, leaves, do)

    try:
        return ms, cuda_ms(fwd_bwd), what
    except Exception as exc:
        return ms, None, (f"{what}; backward not run: {type(exc).__name__}: "
                          f"{str(exc)[:160]}")


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
    dq, delta = flash_attention_varlen_bwd_dq(*args, cu_q, kcu_k, **kw)
    dq2, delta2 = flash_attention_varlen_bwd_dq(*args, cu_q, kcu_k, **kw)
    ref_dq, ref_delta = _varlen_dq_ref(*up, ref_lse, cu_q, cu_k, **kw)
    dk, dv = flash_attention_varlen_bwd_dkv(*args, ref_delta, cu_q, kcu_k, **kw)
    dk2, dv2 = flash_attention_varlen_bwd_dkv(*args, ref_delta, cu_q, kcu_k,
                                              **kw)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(x, y) for x, y in
                        ((dk, dk2), (dv, dv2), (dq, dq2), (delta, delta2)))
    ref_dk, ref_dv = _varlen_dkv_ref(*up, ref_lse, ref_delta, cu_q, cu_k, **kw)

    def rows(x):  # the d values of one token and head last, for `held`
        return x.float() if layout == "thd" else x.float().transpose(0, 1)

    result.update(dq=held(rows(dq), rows(ref_dq)), delta=held(delta, ref_delta),
                  dk=held(rows(dk), rows(ref_dk)), dv=held(rows(dv), rows(ref_dv)))
    grads_finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
    # The forward handed a max_seqlen_q of 64: the same tiles, the same bits
    # (its flat schedule, like the dQ and dK/dV kernels', reads none).
    short = dict(max_seqlen_q=64)
    out_s, _ = flash_attention_varlen_fwd(q, k, v, cu_q, kcu_k, **kw, **short)
    short_grid_equal = torch.equal(out_s, out)
    result.update(
        short_grid_equal=short_grid_equal,
        fwd_ok=fwd_ok,
        dq_ok=result["dq"]["err_over_limit"] <= 1
        and result["delta"]["err_over_limit"] <= 1,
        dkv_ok=max(result["dk"]["err_over_limit"],
                   result["dv"]["err_over_limit"]) <= 1,
        bwd_bitwise_deterministic=deterministic, grads_finite=grads_finite)
    tensors = dict(args=args, delta=ref_delta, cu=(cu_q, cu_k), kw=kw,
                   maxes=maxes)
    return result, tensors


def varlen_case(name, seed):
    checked, t = varlen_compare(name, seed)
    (lens_q, lens_k, used_q, used_k, h, hk, d, causal, window, layout,
     _) = VARLEN_CASES[name]
    q, k, v, do, lse = t["args"]
    cu_q, cu_k = t["cu"]
    kw, maxes = t["kw"], t["maxes"]
    fwd_kw = dict(kw, max_seqlen_q=maxes["max_seqlen_q"])
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
            q, k, v, do, lse, cu_q, cu_k, **kw)),
        dkv_ms=cuda_ms(lambda: flash_attention_varlen_bwd_dkv(
            q, k, v, do, lse, t["delta"], cu_q, cu_k, **kw)),
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
        (result["library_fwd_ms"], result["library_fwd_bwd_ms"],
         result["library"]) = library_packed(q, k, v, do, cu_q, causal)
    result["dq_schedule"] = dq_schedule(t, lens_q, used_q, h)
    result["dkv_schedule"] = dkv_schedule(t, lens_k, used_k, hk)
    emit(result)
    check(result["ok"], f"varlen_kernels case {name} disagrees with its plain "
                        "version or is not deterministic")
    sch = result["dq_schedule"]
    check(sch["blocks_launched"] == sch["grid"][0] * h > 0
          and sch["grid"][0] == sch["grid_host"] and sch["row_tiles_each_once"],
          f"varlen_kernels case {name}: kernel 8's trace misses a block or a "
          "row tile, or visits one twice")
    sch = result["dkv_schedule"]
    check(sch["blocks_launched"] == sch["grid"][0] * hk > 0
          and sch["grid"][0] == sch["grid_host"] and sch["key_tiles_each_once"],
          f"varlen_kernels case {name}: kernel 7's trace misses a block or a "
          "key tile, or visits one twice")
    return result


def dq_schedule(t, lens_q, used_q, h):
    """Kernel 8's flat schedule as the kernel ran it on a case's inputs
    (`t` from varlen_compare): its trace (each launched block's sequence
    and first row, -1 past the last row tile) against the 128-row tiles the
    lengths give, per head; the blocks it launched and that exited."""
    q = t["args"][0]
    cu_q, cu_k = t["cu"]
    bm, nseq = BWD_BLOCK_ROWS, len(lens_q)
    rows = [min(n, n if used_q is None else used_q[j])
            for j, n in enumerate(lens_q)]
    grid_host = (sum(lens_q) + nseq * (bm - 1)) // bm
    trace = torch.full((4 * grid_host * h + 4,), -2, dtype=torch.int32,
                       device=q.device)
    trace_schedule(trace, kernel="dq")
    try:
        flash_attention_varlen_bwd_dq(*t["args"], cu_q, cu_k, **t["kw"])
        torch.cuda.synchronize()
    finally:
        trace_schedule(None, kernel="dq")
    rec = trace.view(-1, 4).cpu().numpy()
    rec = rec[rec[:, 0] != -2]
    want = sorted((j, m * bm) for j, n in enumerate(rows)
                  for m in range(-(-max(n, 0) // bm)))
    live = rec[rec[:, 2] >= 0]
    return dict(
        schedule="read from the kernel's trace",
        grid=[int(rec[:, 0].max()) + 1 if len(rec) else 0, h],
        grid_host=grid_host, blocks_launched=len(rec),
        blocks_exited=int((rec[:, 2] < 0).sum()),
        blocks_with_rows=len(live),
        row_tiles_each_once=all(
            sorted(map(tuple, live[live[:, 1] == y][:, 2:].tolist())) == want
            for y in range(h)),
        # Each sequence's last row tile first: blockIdx.x falls as the row
        # rises inside a sequence.
        last_tile_first=all(
            (np.diff(live[(live[:, 1] == 0) & (live[:, 2] == j)][:, 3]) < 0)
            .all() for j in range(nseq)))


def dkv_schedule(t, lens_k, used_k, hk):
    """Kernel 7's flat schedule as the kernel ran it on a case's inputs
    (`t` from varlen_compare): its trace (each launched block's sequence
    and first key, -1 past the last key tile) against the 128-key tiles the
    used key counts give, per kv head; the blocks it launched and that
    exited."""
    q = t["args"][0]
    cu_q, cu_k = t["cu"]
    bm, nseq = BWD_BLOCK_ROWS, len(lens_k)
    keys = [min(n, n if used_k is None else used_k[j])
            for j, n in enumerate(lens_k)]
    grid_host = (sum(lens_k) + nseq * (bm - 1)) // bm
    trace = torch.full((4 * grid_host * hk + 4,), -2, dtype=torch.int32,
                       device=q.device)
    trace_schedule(trace, kernel="dkv")
    try:
        flash_attention_varlen_bwd_dkv(*t["args"], t["delta"], cu_q, cu_k,
                                       **t["kw"])
        torch.cuda.synchronize()
    finally:
        trace_schedule(None, kernel="dkv")
    rec = trace.view(-1, 4).cpu().numpy()
    rec = rec[rec[:, 0] != -2]
    want = sorted((j, m * bm) for j, n in enumerate(keys)
                  for m in range(-(-max(n, 0) // bm)))
    live = rec[rec[:, 2] >= 0]
    return dict(
        schedule="read from the kernel's trace",
        grid=[int(rec[:, 0].max()) + 1 if len(rec) else 0, hk],
        grid_host=grid_host, blocks_launched=len(rec),
        blocks_exited=int((rec[:, 2] < 0).sum()),
        blocks_with_keys=len(live),
        key_tiles_each_once=all(
            sorted(map(tuple, live[live[:, 1] == y][:, 2:].tolist())) == want
            for y in range(hk)),
        # Each sequence's first key tile (the longest causal walk) first:
        # blockIdx.x rises with the key inside a sequence.
        first_tile_first=all(
            (np.diff(live[(live[:, 1] == 0) & (live[:, 2] == j)][:, 3]) > 0)
            .all() for j in range(nseq)))


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


MIXED_QLENS = (2041,) + (1,) * 7
MIXED_CONTEXTS = (4144, 2831, 3862, 2770, 1355, 3591, 689, 2891)


def paged_cases(seed=40):
    """Kernel 6 on vLLM pools: held against its plain version at page 16
    and 512, timed against its bound, and against the gather route; then a
    step that mixes a 2041-token chunk with seven 1-token decode rows: its
    time beside each part alone, and the flat schedule's launched and
    exited blocks as the kernel's trace gives them (the sm80 step's grid,
    cdiv(2041, 64) x 8 per head, was ~85% empty); then the sm80 route of
    pools whose page size is not a multiple of 8, held against the plain
    version (untimed). No timed case may take that route."""
    results = {}
    sm80_before = flash_attention_varlen_fwd.launches_sm80
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
    # The same step at d 64 (gpt-oss-20b's 64 query and 8 kv heads of 64),
    # page 16: the paged instances of the d-64 kernel.
    h64, hk64, d64 = GPT_OSS["h"], GPT_OSS["hk"], GPT_OSS["d"]
    st = paged_step(PAGED_QLENS, PAGED_CONTEXTS, 16, seed + 3, h=h64, hk=hk64,
                    d=d64)
    checked = paged_compare(st)
    r = dict(phase="varlen_kernels", case="paged-prefill-page16-d64",
             qlens=list(PAGED_QLENS), contexts=list(PAGED_CONTEXTS), h=h64,
             hk=hk64, d=d64, page=16, pools="phd (views)",
             window_size=[WINDOW, -1], **checked, tolerance=ATTN_TOLERANCE,
             ok=checked["fwd_ok"], fwd_ms=cuda_ms(lambda: paged_fwd(st)))
    nbytes64 = (2 * tq * h64 * d64 * 2 + 2 * needed * hk64 * d64 * 2
                + tq * h64 * 4)
    r["fwd_bound_ms"], r["fwd_bound_by"] = attn_bound(4, nbytes64, 1, h64, d64,
                                                      pairs)
    emit(r)
    check(r["ok"], "varlen_kernels: the d-64 paged case disagrees with its "
                   "plain version")
    results["d64"] = r
    del st
    # A mixed step: one long chunk and seven decode rows, against each part
    # alone.
    ctx = MIXED_CONTEXTS
    parts = {"mixed": (MIXED_QLENS, ctx), "chunk": ((2041,), ctx[:1]),
             "decode_rows": ((1,) * 7, ctx[1:])}
    ms = {}
    for key, (ql, cx) in parts.items():
        st = paged_step(ql, cx, 16, seed + 1)
        ms[key] = cuda_ms(lambda: paged_fwd(st))
        if key == "mixed":  # the gather route on a step of the vLLM loop
            ms["mixed_gather_route"] = cuda_ms(lambda: gather_then_packed(st))
            ms["mixed_again"] = cuda_ms(lambda: paged_fwd(st))
        del st
    # The flat schedule as the kernel ran it: its trace of the mixed step
    # (each launched block's sequence and first row, -1 past the last row
    # tile), against the row tiles the lengths give, per head.
    st = paged_step(MIXED_QLENS, ctx, 16, seed + 1)
    trace = torch.full((4 * 4096 * H,), -2, dtype=torch.int32,
                       device=st["q"].device)
    trace_schedule(trace)
    try:
        paged_fwd(st)
        torch.cuda.synchronize()
    finally:
        trace_schedule(None)
    del st
    rec = trace.view(-1, 4).cpu().numpy()
    rec = rec[rec[:, 0] != -2]
    bm = sm90_block_m(D)
    want = sorted((j, m * bm) for j, n in enumerate(MIXED_QLENS)
                  for m in range(-(-n // bm)))
    grid_x = int(rec[:, 0].max()) + 1 if len(rec) else 0
    tiles_once = all(
        sorted(map(tuple, rec[(rec[:, 1] == y) & (rec[:, 2] >= 0)][:, 2:]
                   .tolist())) == want for y in range(H))
    sm80_grid = -(-2041 // 64) * 8
    timed_sm80 = flash_attention_varlen_fwd.launches_sm80 - sm80_before
    r = dict(phase="varlen_kernels", case="mixed-step-grid",
             qlens=list(MIXED_QLENS), contexts=list(ctx), ms=ms,
             schedule="read from the kernel's trace",
             grid=[grid_x, H], grid_host=sm90_grid_tiles(sum(MIXED_QLENS),
                                                         len(MIXED_QLENS), D),
             blocks_launched=len(rec),
             blocks_exited=int((rec[:, 2] < 0).sum()),
             row_tiles_each_once=tiles_once,
             empty_blocks_share=float((rec[:, 2] < 0).mean()) if len(rec) else None,
             sm80_grid_empty_blocks_share=1 - (-(-2041 // 64) + 7) / sm80_grid,
             # What the seven decode rows add to the chunk's launch.
             mixed_minus_chunk_ms=ms["mixed"] - ms["chunk"],
             launches_sm80_timed=timed_sm80)
    emit(r)
    check(r["blocks_launched"] == grid_x * H > 0
          and grid_x == r["grid_host"] and tiles_once,
          "mixed-step-grid: the kernel's trace misses a block or a row tile, "
          "or visits one twice")
    check(r["blocks_exited"] == 0 and timed_sm80 == 0,
          "mixed-step-grid: blocks without a row tile, or a timed case on "
          "the sm80 route")
    results["mixed"] = r
    # Pools of 12-slot pages: the sm80 route, once, held.
    st = paged_step((200, 1, 77), (700, 301, 77), 12, seed + 2)
    before = flash_attention_varlen_fwd.launches_sm80
    checked = paged_compare(st)
    odd = dict(phase="varlen_kernels", case="odd-page12-sm80-route",
               qlens=[200, 1, 77], contexts=[700, 301, 77], page=12, **checked,
               launches_sm80=flash_attention_varlen_fwd.launches_sm80 - before,
               tolerance=ATTN_TOLERANCE)
    odd["ok"] = checked["fwd_ok"] and odd["launches_sm80"] == 1
    emit(odd)
    check(odd["ok"], "varlen_kernels: the sm80 route of 12-slot pages "
                     "disagrees with its plain version or was not taken")
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
    # The flat schedule: the mixed step's kernel handed cu_seqlens_q with
    # the chunk's end moved one row into the first decode row's.
    st = paged_step(MIXED_QLENS, MIXED_CONTEXTS, 16, 71)
    good = st["cu_q"]
    st["cu_q"] = good.clone()
    st["cu_q"][1] -= 1
    out, lse = paged_fwd(st)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_varlen_fwd_ref(
        st["q"].float(), None, None, good, None, seqused_k=st["used"],
        kv_pools=st["pools"], block_table=st["table"], **PAGED_KW)
    finite = torch.isfinite(ref_lse)
    res = held(out, ref_out)
    lse_err = float((lse - ref_lse)[finite].abs().max())
    passed = (res["err_over_limit"] <= 1 and lse_err <= ATTN_LSE_TOL
              and torch.equal(finite, torch.isfinite(lse)))
    emit(dict(phase="varlen_fault", case="mixed-step-scheduler",
              moved="cu_seqlens_q[1] - 1",
              err_over_limit={"out": res["err_over_limit"]},
              lse_max_abs_err=lse_err, caught={"fwd": not passed},
              ok=not passed))
    check(not passed, "varlen_fault: the mixed step with a cu_seqlens_q "
                      "boundary moved passes the tolerance")
    # Kernel 8's flat schedule: the dQ kernel alone handed gpt2m-packed's
    # cu_seqlens_q with the first document's end moved one row into the
    # second's, against the plain dQ on the true boundaries.
    _, t = varlen_compare("gpt2m-packed", seed=72)
    cu_q, cu_k = t["cu"]
    bad = cu_q.clone()
    bad[1] -= 1
    dq, delta = flash_attention_varlen_bwd_dq(*t["args"], bad, cu_k, **t["kw"])
    torch.cuda.synchronize()
    up = tuple(x.float() for x in t["args"][:4])
    ref_dq, ref_delta = _varlen_dq_ref(*up, t["args"][4], cu_q, cu_k, **t["kw"])
    worst = {"dq": held(dq.float(), ref_dq)["err_over_limit"],
             "delta": held(delta, ref_delta)["err_over_limit"]}
    caught = max(worst.values()) > 1
    emit(dict(phase="varlen_fault", case="dq-scheduler",
              moved="cu_seqlens_q[1] - 1 (kernel 8 only)",
              err_over_limit=worst, caught={"dq": caught}, ok=caught))
    check(caught, "varlen_fault: kernel 8 with a cu_seqlens_q boundary moved "
                  "passes the tolerance")
    # Kernel 7's flat schedule of key tiles: the dK/dV kernel alone handed
    # cu_seqlens_k with the first document's end moved one key into the
    # second's, against the plain dK/dV on the true boundaries.
    bad = cu_k.clone()
    bad[1] += 1
    dk, dv = flash_attention_varlen_bwd_dkv(*t["args"], t["delta"], cu_q, bad,
                                            **t["kw"])
    torch.cuda.synchronize()
    ref_dk, ref_dv = _varlen_dkv_ref(*up, t["args"][4], t["delta"], cu_q, cu_k,
                                     **t["kw"])
    worst = {"dk": held(dk.float(), ref_dk)["err_over_limit"],
             "dv": held(dv.float(), ref_dv)["err_over_limit"]}
    caught = max(worst.values()) > 1
    emit(dict(phase="varlen_fault", case="dkv-scheduler",
              moved="cu_seqlens_k[1] + 1 (kernel 7 only)",
              err_over_limit=worst, caught={"dkv": caught}, ok=caught))
    check(caught, "varlen_fault: kernel 7 with a cu_seqlens_k boundary moved "
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
    flash_attention_varlen_bwd_dq.tma_copies = 0
    flash_attention_varlen_bwd_dkv.tma_copies = 0
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _varlen_counts()
    dq_copies = flash_attention_varlen_bwd_dq.tma_copies
    dkv_copies = flash_attention_varlen_bwd_dkv.tma_copies
    want = dict(flash_varlen_fwd=layers, flash_varlen_bwd_dkv=layers,
                flash_varlen_bwd_dq=layers)
    grads_finite = all(bool(torch.isfinite(x.grad).all()) for x in qkv)
    ok = counts == want and grads_finite and dq_copies == dkv_copies == 0
    result = dict(phase="varlen_train", layers=layers, docs=len(GPT2M_DOCS),
                  tokens=tq, h=h, d=d, causal=True, step_wall_ms=wall_ms,
                  step_ms_by_events=cuda_ms(step, reps=5, warmup=1),
                  launches=counts, launches_expected=want,
                  dq_tma_copies=dq_copies, dkv_tma_copies=dkv_copies,
                  grads_finite=grads_finite, ok=ok)
    emit(result)
    check(ok, "varlen_train: launches off the count, a TMA copy of kernel "
              "7's or 8's inputs, or non-finite gradients")
    return result


def _varlen_counts():
    return dict(flash_varlen_fwd=flash_attention_varlen_fwd.launches,
                flash_varlen_bwd_dkv=flash_attention_varlen_bwd_dkv.launches,
                flash_varlen_bwd_dq=flash_attention_varlen_bwd_dq.launches)


def _zero_varlen_counts():
    flash_attention_varlen_fwd.launches = 0
    flash_attention_varlen_bwd_dkv.launches = 0
    flash_attention_varlen_bwd_dq.launches = 0


# -- phases: varlen_features, varlen_features_bits, varlen_features_fault,
#    varlen_train_dropout, compile_specs (kernels 6-8's feature instances,
#    csrc/flash_varlen_features.cu and csrc/flash_varlen_bwd_features.cu) --

# Baichuan-13B (https://huggingface.co/baichuan-inc/Baichuan-13B-Base
# config.json: 40 layers, 40 heads of 128, ALiBi) and Llama-4-Scout
# (https://huggingface.co/meta-llama/Llama-4-Scout-17B-16E config.json: 40
# query and 8 kv heads of 128, attention_chunk_size 8192).
BAICHUAN_13B = dict(h=40, hk=40, d=128, layers=40)
LLAMA4_SCOUT = dict(h=40, hk=8, d=128, chunk=8192)


def _seeded_lens(n, lo, hi, seed):
    return np.random.RandomState(seed).randint(lo, hi + 1, n).tolist()


# name: (lens (q and k alike), seqused_k or None, h, hk, d, causal,
# window_size, softcap, layout, features), each at the published widths of
# a model that runs the feature; "alibi-paged-phd16" reads "phd" pools.
VARLEN_FEATURE_CASES = {
    # Baichuan-13B ALiBi (geometric slopes), 8 packed sequences of
    # 512-4096 tokens.
    "alibi-baichuan13b": (_seeded_lens(8, 512, 4096, 180), None, 40, 40, 128,
                          True, (-1, -1), 0.0, "thd", dict(alibi=True)),
    # varlen_train's 16 GPT-2-medium documents in 8 x 2048 with GPT-2's
    # attention dropout 0.1.
    "dropout-gpt2m-docs": (GPT2M_DOCS, None, 16, 16, 64, True, (-1, -1), 0.0,
                           "thd", dict(dropout_p=0.1, dropout_seed=2024)),
    # Llama-4-Scout's chunked local attention over 3 documents of
    # 8192-20000 tokens.
    "chunk8192-llama4-scout": (_seeded_lens(3, 8192, 20000, 181), None, 40, 8,
                               128, True, (-1, -1), 0.0, "thd",
                               dict(attention_chunk=8192)),
    # Every feature at once with softcap 30 at d 64, head-major, one
    # sequence's used keys below its length.
    "all-d64-hsd": (doc_lengths(8192, 2048, 182), "cut", 16, 4, 64, True,
                    (255, -1), 30.0, "hsd",
                    dict(alibi=True, attention_chunk=512, dropout_p=0.1,
                         dropout_seed=-77)),
}
# The paged case: Baichuan-13B widths, the Mistral paged prefill step's
# four 512-token chunks over "phd" pools of page 16.
VARLEN_FEATURE_PAGED = "alibi-paged-phd16-baichuan13b"
# The planted faults run on this case: non-causal (a diagonal moved by one
# shifts causal ALiBi rows uniformly, which the softmax cancels).
VARLEN_FEATURE_FAULT = (doc_lengths(4096, 1500, 183), None, 8, 2, 64, False,
                        (-1, -1), 0.0, "thd",
                        dict(alibi=True, attention_chunk=512, dropout_p=0.1,
                             dropout_seed=31))


def _zero_varlen_feature_counts():
    for fn in (flash_attention_varlen_fwd, flash_attention_varlen_bwd_dq,
               flash_attention_varlen_bwd_dkv):
        fn.feature_launches = 0


def _varlen_feature_counts():
    return dict(flash_varlen_fwd=flash_attention_varlen_fwd.feature_launches,
                flash_varlen_bwd_dq=flash_attention_varlen_bwd_dq.feature_launches,
                flash_varlen_bwd_dkv=flash_attention_varlen_bwd_dkv.feature_launches)


def varlen_feature_inputs(case, seed):
    """Seeded packed q, k, v, dO (bf16, N(0, 1)) of a case on the card, its
    cu_seqlens and seqused_k, and its kwargs: (kw, fkw, tensors)."""
    lens, used, h, hk, d, causal, window, softcap, layout, spec = case
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    total = sum(lens)

    def rand(heads):
        shape = (total, heads, d) if layout == "thd" else (heads, total, d)
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, do = rand(h), rand(h)
    k, v = rand(hk), rand(hk)
    cu = _dev_int(_cu_of(lens))
    used_k = None
    if used == "cut":  # the longest sequence's last 100 keys unused
        cut = list(lens)
        cut[int(np.argmax(lens))] -= 100
        used_k = _dev_int(cut)
    fkw = {key: spec[key] for key in ("attention_chunk", "dropout_p",
                                      "dropout_seed") if key in spec}
    if spec.get("alibi"):
        fkw["alibi_slopes"] = default_alibi_slopes(h).to(dev)
    kw = dict(seqused_k=used_k, causal=causal, window_size=window,
              softcap=softcap, layout=layout)
    return kw, fkw, dict(q=q, k=k, v=v, do=do, cu=cu)


@contextlib.contextmanager
def planted_sequences(**change):
    """The varlen plain versions with each sequence's features changed
    (a planted fault): origin=(0, 0) draws the keep mask in per-sequence
    coordinates, diag_offset=+1 moves ALiBi's diagonal by one."""
    saved = flash_varlen._sequences

    def planted(*args, **kwargs):
        for *seq, fs in saved(*args, **kwargs):
            if fs is not None:
                fs = fs._replace(**{
                    key: (fs.diag_offset + val if key == "diag_offset"
                          else val) for key, val in change.items()})
            yield (*seq, fs)

    flash_varlen._sequences = planted
    try:
        yield
    finally:
        flash_varlen._sequences = saved


def varlen_feature_compare(case, seed, kernel_fkw=None, dv_factor=1.0):
    """Kernels 6-8 with a case's features and their plain versions on the
    same seeded inputs (the plain backward fed the plain forward's LSE and
    delta). `kernel_fkw` hands the kernels other features, `dv_factor`
    scales the plain dV (planted faults). Returns (result, kw, fkw,
    tensors)."""
    kw, fkw, t = varlen_feature_inputs(case, seed)
    kfkw = fkw if kernel_fkw is None else dict(fkw, **kernel_fkw)
    q, k, v, do, cu = t["q"], t["k"], t["v"], t["do"], t["cu"]
    layout = kw["layout"]
    rf = varlen_features(case[2], **fkw)

    def rows(x):  # the d values of one token and head last, for `held`
        return x.float() if layout == "thd" else x.float().transpose(0, 1)

    out, lse = flash_attention_varlen_fwd(q, k, v, cu, cu, **kw, **kfkw)
    torch.cuda.synchronize()
    up = tuple(x.float() for x in (q, k, v, do))
    ref_out, ref_lse = flash_attention_varlen_fwd_ref(*up[:3], cu, cu, **kw,
                                                      features=rf)
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[finite].abs().max()) if finite.any() else 0.0
    result = dict(out=held(rows(out), rows(ref_out)), lse_max_abs_err=lse_err)
    fwd_ok = bool(result["out"]["err_over_limit"] <= 1
                  and torch.equal(finite, torch.isfinite(lse))
                  and lse_err <= ATTN_LSE_TOL and torch.isfinite(out).all())
    del ref_out
    dq, delta = flash_attention_varlen_bwd_dq(q, k, v, do, ref_lse, cu, cu,
                                              **kw, **kfkw)
    ref_dq, ref_delta = _varlen_dq_ref(*up, ref_lse, cu, cu, **kw, features=rf)
    dk, dv = flash_attention_varlen_bwd_dkv(q, k, v, do, ref_lse, ref_delta,
                                            cu, cu, **kw, **kfkw)
    torch.cuda.synchronize()
    result.update(dq=held(rows(dq), rows(ref_dq)), delta=held(delta, ref_delta))
    del ref_dq
    ref_dk, ref_dv = _varlen_dkv_ref(*up, ref_lse, ref_delta, cu, cu, **kw,
                                     features=rf)
    result.update(dk=held(rows(dk), rows(ref_dk)),
                  dv=held(rows(dv), rows(ref_dv) * dv_factor))
    del ref_dk, ref_dv, up
    result.update(
        fwd_ok=fwd_ok,
        dq_ok=result["dq"]["err_over_limit"] <= 1
        and result["delta"]["err_over_limit"] <= 1,
        dkv_ok=max(result["dk"]["err_over_limit"],
                   result["dv"]["err_over_limit"]) <= 1,
        grads_finite=all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)))
    t.update(lse=ref_lse, delta=ref_delta)
    return result, kw, fkw, t


def varlen_feature_pairs(lens, used_k, causal, window, chunk, dev="cuda"):
    """Visible (row, key) pairs of a packed call per head under the varlen
    rules (make_varlen_metadata's intervals, the chunk's included)."""
    cu = _dev_int(_cu_of(lens), dev)
    meta = make_varlen_metadata(cu, cu, sum(lens), seqused_k=used_k,
                                causal=causal, window=window,
                                attention_chunk=chunk)
    span = (meta.hi - meta.lo + 1).clamp_min(0)
    return int(span[meta.qseg >= 0].sum())


def varlen_feature_library(case, kw, fkw, t):
    """SDPA on the same function where one call computes it: the packed
    tokens as one sequence with a block-diagonal mask holding the causal,
    window and chunk rules (a boolean mask), plus the ALiBi term (a float
    mask per head); K and V repeated to the query heads outside the timed
    calls. None for dropout (SDPA draws its own mask), a softcap (SDPA has
    none) and a mask over SDPA_MASK_BYTES. A yardstick; the port never calls
    it."""
    lens, _, h, hk = case[:4]
    if "dropout_p" in fkw:
        return None, "none: SDPA draws its own dropout mask"
    if kw["softcap"]:
        return None, "none: SDPA has no softcap"
    total = sum(lens)
    per_head = "alibi_slopes" in fkw
    if per_head and kw["seqused_k"] is not None:
        return None, "none: not built for seqused_k with ALiBi"
    nbytes = total * total * (2 * h if per_head else 1)
    if nbytes > SDPA_MASK_BYTES:
        return None, (f"none: the {nbytes / 2**30:.1f} GiB mask is past the "
                      f"{SDPA_MASK_BYTES / 2**30:.0f} GiB limit")
    q, k, v, do, cu = t["q"], t["k"], t["v"], t["do"], t["cu"]
    if kw["layout"] == "hsd":
        q, k, v, do = (x.transpose(0, 1) for x in (q, k, v, do))
    meta = make_varlen_metadata(cu, cu, total, seqused_k=kw["seqused_k"],
                                causal=kw["causal"], window=kw["window_size"],
                                attention_chunk=fkw.get("attention_chunk", 0))
    cols = torch.arange(total, device=q.device)
    mask = (cols[None] >= meta.lo[:, None]) & (cols[None] <= meta.hi[:, None])
    if per_head:
        # q and k pack the same lengths with no seqused_k here, so a row's
        # diagonal is its own packed index.
        rel = (cols[None] - cols[:, None]).abs().float()
        mask = torch.stack([
            (-fkw["alibi_slopes"][i] * rel).masked_fill(~mask, float("-inf"))
            .to(q.dtype) for i in range(h)])[None]
        del rel
    qt, kt, vt = (x.transpose(0, 1)[None].detach().clone().requires_grad_()
                  for x in (q, k.repeat_interleave(h // hk, 1),
                            v.repeat_interleave(h // hk, 1)))
    dot = do.transpose(0, 1)[None]
    fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), reps=3, warmup=1)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    both = cuda_ms(sdpa_fwd_bwd, reps=3, warmup=1)
    del mask
    return dict(fwd_ms=fwd, bwd_ms=both - fwd), (
        "scaled_dot_product_attention over the packed tokens with a "
        + ("block-diagonal ALiBi float mask" if per_head
           else "block-diagonal boolean mask"))


def varlen_feature_case(name, seed):
    """One VARLEN_FEATURE_CASES case: held, timed against its plain versions
    and its bound over the features' visible pairs, SDPA beside it where
    one call computes it."""
    case = VARLEN_FEATURE_CASES[name]
    lens, _, h, hk, d, causal, window, softcap, layout, spec = case
    checked, kw, fkw, t = varlen_feature_compare(case, seed)
    q, k, v, do, cu, lse, delta = (t[x] for x in ("q", "k", "v", "do", "cu",
                                                  "lse", "delta"))
    total = sum(lens)
    big = h * max(lens) ** 2 > 2**31
    plain = dict(reps=1 if big else 3, warmup=1)
    up = tuple(x.float() for x in (q, k, v, do))
    rf = varlen_features(h, **fkw)
    result = dict(
        phase="varlen_features", case=name, nseq=len(lens), total=total,
        max_len=max(lens), h=h, hk=hk, d=d, causal=causal,
        window_size=list(window), softcap=softcap, layout=layout,
        seqused_k=kw["seqused_k"] is not None, features=sorted(spec),
        **checked, tolerance=ATTN_TOLERANCE,
        ok=(checked["fwd_ok"] and checked["dq_ok"] and checked["dkv_ok"]
            and checked["grads_finite"]),
        fwd_ms=cuda_ms(lambda: flash_attention_varlen_fwd(
            q, k, v, cu, cu, **kw, **fkw), reps=10),
        dq_ms=cuda_ms(lambda: flash_attention_varlen_bwd_dq(
            q, k, v, do, lse, cu, cu, **kw, **fkw), reps=10),
        dkv_ms=cuda_ms(lambda: flash_attention_varlen_bwd_dkv(
            q, k, v, do, lse, delta, cu, cu, **kw, **fkw), reps=10),
        fwd_plain_ms=cuda_ms(lambda: flash_attention_varlen_fwd_ref(
            *up[:3], cu, cu, **kw, features=rf), **plain),
        dq_plain_ms=cuda_ms(lambda: _varlen_dq_ref(
            *up, lse, cu, cu, **kw, features=rf), **plain),
        dkv_plain_ms=cuda_ms(lambda: _varlen_dkv_ref(
            *up, lse, delta, cu, cu, **kw, features=rf), **plain),
        # The feature-free kernels on the same inputs (their own pairs; the
        # backward times on the features' LSE and delta, which changes no
        # work).
        free_fwd_ms=cuda_ms(lambda: flash_attention_varlen_fwd(
            q, k, v, cu, cu, **kw), reps=10),
        free_dq_ms=cuda_ms(lambda: flash_attention_varlen_bwd_dq(
            q, k, v, do, lse, cu, cu, **kw), reps=10),
        free_dkv_ms=cuda_ms(lambda: flash_attention_varlen_bwd_dkv(
            q, k, v, do, lse, delta, cu, cu, **kw), reps=10))
    del up
    pairs = varlen_feature_pairs(lens, kw["seqused_k"], causal, window,
                                 fkw.get("attention_chunk", 0))
    plain_pairs = varlen_feature_pairs(lens, kw["seqused_k"], causal, window, 0)
    el = 2
    qb, kvb, stats = total * h * d * el, total * hk * d * el, total * h * 4
    # As varlen_kernels' bound, over the visible pairs of the features'
    # rules: fwd 4d flops a pair, dK/dV 8d, dQ 6d.
    for key, per_d, nbytes in (
            ("fwd", 4, 2 * qb + 2 * kvb + stats),
            ("dkv", 8, 2 * qb + 4 * kvb + 2 * stats),
            ("dq", 6, 3 * qb + 2 * kvb + 2 * stats)):
        result[f"{key}_bound_ms"], result[f"{key}_bound_by"] = attn_bound(
            per_d, nbytes, 1, h, d, pairs)
    result.update(visible_pairs_per_head=pairs,
                  visible_pairs_without_chunk=plain_pairs)
    # Time per visible pair against the feature-free kernel's.
    result["per_pair_vs_free"] = {
        key: (result[f"{key}_ms"] / pairs)
        / (result[f"free_{key}_ms"] / plain_pairs)
        for key in ("fwd", "dq", "dkv")}
    result["library"], result["library_call"] = varlen_feature_library(
        case, kw, fkw, t)
    if "dropout_p" in fkw:
        # The dropped share of the visible pairs, from the keep mask the
        # kernels draw (varlen_features_bits shows they draw these bits).
        meta = make_varlen_metadata(cu, cu, total, seqused_k=kw["seqused_k"],
                                    causal=causal, window=window,
                                    attention_chunk=fkw.get("attention_chunk",
                                                            0))
        kept = seen = 0
        cu_h = _cu_of(lens)
        for j in range(len(lens)):
            a, b = int(cu_h[j]), int(cu_h[j + 1])
            cols = torch.arange(a, b, device=q.device)
            vis = ((cols[None] >= meta.lo[a:b, None])
                   & (cols[None] <= meta.hi[a:b, None]))
            for hh in range(h):
                keep = dropout_keep_mask(fkw["dropout_seed"], 0, hh, a, a,
                                         (b - a, b - a), 1 - fkw["dropout_p"],
                                         device=q.device)
                kept += int((keep & vis).sum())
                seen += int(vis.sum())
        result["dropped_fraction"] = 1.0 - kept / seen
        result["ok"] = result["ok"] and abs(
            result["dropped_fraction"] - fkw["dropout_p"]) <= 0.01
    emit(result)
    check(result["ok"], f"varlen_features case {name} disagrees with its "
                        "plain version (or its dropped share is off p)")
    return result


def varlen_feature_paged_case(seed=186):
    """Kernel 6's ALiBi instance reading "phd" pools at page 16, Baichuan-13B
    widths, the Mistral paged-prefill step's chunks and contexts: held
    against its plain version (which gathers the pages), timed beside it and
    against the packed ALiBi instance on the gathered pages."""
    w = BAICHUAN_13B
    st = paged_step(PAGED_QLENS, PAGED_CONTEXTS, 16, seed, h=w["h"],
                    hk=w["hk"], d=w["d"])
    slopes = default_alibi_slopes(w["h"]).to(st["q"].device)
    kw = dict(causal=True, alibi_slopes=slopes)

    def paged():
        return flash_attention_varlen_fwd(
            st["q"], None, None, st["cu_q"], None, seqused_k=st["used"],
            kv_pools=st["pools"], block_table=st["table"], **kw)

    out, lse = paged()
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_varlen_fwd_ref(
        st["q"].float(), None, None, st["cu_q"], None, seqused_k=st["used"],
        kv_pools=st["pools"], block_table=st["table"], causal=True,
        features=varlen_features(w["h"], alibi_slopes=slopes))
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[finite].abs().max())
    res = dict(out=held(out, ref_out), lse_max_abs_err=lse_err)
    del ref_out
    kp = st["k_phd"][st["pages_in_order"]].reshape(-1, w["hk"], w["d"])
    vp = st["v_phd"][st["pages_in_order"]].reshape(-1, w["hk"], w["d"])
    pairs, needed = varlen_work(PAGED_QLENS, PAGED_CONTEXTS, None, None, True,
                                (-1, -1))
    tq = sum(PAGED_QLENS)
    nbytes = (2 * tq * w["h"] * w["d"] * 2 + 2 * needed * w["hk"] * w["d"] * 2
              + tq * w["h"] * 4)
    bound_ms, bound_by = attn_bound(4, nbytes, 1, w["h"], w["d"], pairs)
    r = dict(phase="varlen_features", case=VARLEN_FEATURE_PAGED,
             qlens=list(PAGED_QLENS), contexts=list(PAGED_CONTEXTS),
             h=w["h"], hk=w["hk"], d=w["d"], page=16, pools="phd (views)",
             features=["alibi"], **res, tolerance=ATTN_TOLERANCE,
             ok=bool(res["out"]["err_over_limit"] <= 1
                     and torch.equal(finite, torch.isfinite(lse))
                     and lse_err <= ATTN_LSE_TOL),
             fwd_ms=cuda_ms(paged),
             gathered_packed_ms=cuda_ms(lambda: flash_attention_varlen_fwd(
                 st["q"], kp, vp, st["cu_q"], st["cu_k_pad"],
                 seqused_k=st["used"], **kw)),
             fwd_plain_ms=cuda_ms(lambda: flash_attention_varlen_fwd_ref(
                 st["q"], None, None, st["cu_q"], None, seqused_k=st["used"],
                 kv_pools=st["pools"], block_table=st["table"], causal=True,
                 features=varlen_features(w["h"], alibi_slopes=slopes)),
                 reps=3, warmup=1),
             fwd_bound_ms=bound_ms, fwd_bound_by=bound_by,
             visible_pairs_per_head=pairs, library=None,
             library_call="none: no PyTorch call attends over a page table")
    emit(r)
    check(r["ok"], "varlen_features: the paged ALiBi case disagrees with its "
                   "plain version")
    return r


def varlen_feature_bits_phase():
    """The keep mask read back in bits from kernel 6: three sequences of 64
    keys (= d) each, no causality, V = I per sequence, so out[r, c] is
    P Z / (1 - p) / l and O's zeros are exactly the dropped entries; against
    dropout_keep_mask (the JAX hash) at batch row 0, the packed rows and
    keys, two seeds (one negative)."""
    lens_q, lens_k, h, hk, d = (1000, 300, 37), (64, 64, 64), 4, 2, 64
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(187)
    q = (0.1 * torch.randn(sum(lens_q), h, d, generator=gen, device=dev)
         ).to(torch.bfloat16)
    k = (0.1 * torch.randn(sum(lens_k), hk, d, generator=gen, device=dev)
         ).to(torch.bfloat16)
    v = torch.eye(d, device=dev)[:, None].expand(d, hk, d).repeat(3, 1, 1).to(
        torch.bfloat16)
    cu_q, cu_k = _dev_int(_cu_of(lens_q)), _dev_int(_cu_of(lens_k))
    oq, ok_ = _cu_of(lens_q), _cu_of(lens_k)
    cases = []
    for seed, p in ((-12345, 0.25), (987654321, 0.1)):
        out, _ = flash_attention_varlen_fwd(q, k, v, cu_q, cu_k, dropout_p=p,
                                            dropout_seed=seed)
        keep = torch.zeros(out.shape, dtype=torch.bool, device=dev)
        for j in range(3):
            keep[oq[j]:oq[j + 1]] = dropout_keep_mask(
                seed, 0, torch.arange(h, device=dev).reshape(-1, 1, 1),
                int(oq[j]), int(ok_[j]), (lens_q[j], d), 1.0 - p,
                device=dev).transpose(0, 1)
        cases.append(dict(seed=seed, dropout_p=p,
                          equal_bits=bool(torch.equal(out != 0, keep)),
                          mismatched=int(((out != 0) != keep).sum()),
                          dropped_fraction=float(1 - keep.float().mean())))
    ok = all(c["equal_bits"] and abs(c["dropped_fraction"] - c["dropout_p"])
             <= 0.01 for c in cases)
    emit(dict(phase="varlen_features_bits", lens_q=list(lens_q),
              lens_k=list(lens_k), h=h, d=d,
              how="V = I per 64-key sequence: O's zeros are the dropped "
                  "entries, at packed rows and keys",
              cases=cases, ok=ok))
    check(ok, "varlen_features_bits: kernel 6's keep mask is not the hash's "
              "at packed coordinates, or its dropped share is off p")


def varlen_feature_fault_phase():
    """The checks' power over the varlen features: each planted fault must
    read > 1 in the kernels' error over limit. The plain versions' keep
    mask in per-sequence coordinates (origin 0, 0), their ALiBi diagonal
    moved by one, the kernels' chunk one longer (a chunk edge off by one),
    and a dV without 1 / (1 - p) (the plain dV times 1 - p)."""
    spec = VARLEN_FEATURE_FAULT[9]
    faults = {}
    with planted_sequences(origin=(0, 0)):
        faults["keep_mask_per_sequence"] = varlen_feature_compare(
            VARLEN_FEATURE_FAULT, 191)[0]
    with planted_sequences(diag_offset=1):
        faults["alibi_diag_plus_one"] = varlen_feature_compare(
            VARLEN_FEATURE_FAULT, 192)[0]
    faults["chunk_edge_off_by_one"] = varlen_feature_compare(
        VARLEN_FEATURE_FAULT, 193, kernel_fkw=dict(
            attention_chunk=spec["attention_chunk"] + 1))[0]
    faults["dv_without_keep_scale"] = varlen_feature_compare(
        VARLEN_FEATURE_FAULT, 194, dv_factor=1.0 - spec["dropout_p"])[0]
    want = {name: ("out", "dq", "dk", "dv") for name in faults}
    want["dv_without_keep_scale"] = ("dv",)
    read = {name: {x: r[x]["err_over_limit"] for x in
                   ("out", "dq", "delta", "dk", "dv")}
            for name, r in faults.items()}
    caught = {name: all(read[name][x] > 1 for x in want[name])
              for name in faults}
    lens = VARLEN_FEATURE_FAULT[0]
    emit(dict(phase="varlen_features_fault", nseq=len(lens), total=sum(lens),
              case=list(VARLEN_FEATURE_FAULT[2:9]), features=sorted(spec),
              err_over_limit=read, must_exceed_1=want, caught=caught,
              ok=all(caught.values())))
    check(all(caught.values()), "varlen_features_fault: a planted fault "
                                "passes the tolerance")


VARLEN_FEATURE_KERNELS = {"flash_varlen_fwd": "varlen_fwd_sm90_kernel",
                          "flash_varlen_bwd_dq": "varlen_dq_sm90_kernel",
                          "flash_varlen_bwd_dkv": "varlen_dkv_sm90_kernel"}


def varlen_train_dropout_phase(vtrain, layers=24, seed=50, p=0.1):
    """varlen_train's 24 layers with attention dropout 0.1 (a seed per
    layer, fold_seed), in the same call: its step time beside varlen_train's
    (timed again here, in turns), the launches counted, and every attention
    launch of a traced step read from the trace as a feature instance's
    (kFeat 2): the most of each kernel over three traced steps
    (traced_launches), since one trace can miss a launch."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cu = _dev_int(_cu_of(GPT2M_DOCS))
    tq, h, d = sum(GPT2M_DOCS), 16, 64
    qkv = [torch.randn(3, tq, h, d, generator=gen, device=dev,
                       dtype=torch.bfloat16).requires_grad_()
           for _ in range(layers)]
    do = torch.randn(tq, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
    maxlen = max(GPT2M_DOCS)

    def step(drop):
        kw = [dict(dropout_p=p, dropout_seed=fold_seed(seed, i)) if drop
              else {} for i in range(layers)]
        outs = [flash_attn_varlen_func(x[0], x[1], x[2], cu, cu, maxlen,
                                       maxlen, causal=True, **kw[i])
                for i, x in enumerate(qkv)]
        torch.autograd.backward(outs, [do] * layers)

    step(True)  # warm-up
    torch.cuda.synchronize()
    _zero_varlen_counts()
    _zero_varlen_feature_counts()
    step(True)
    torch.cuda.synchronize()
    counts, fcounts = _varlen_counts(), _varlen_feature_counts()
    grads_finite = all(bool(torch.isfinite(x.grad).all()) for x in qkv)
    # In turns: plain, dropout, dropout, plain.
    ms = dict(varlen_train=[], varlen_train_dropout=[])
    for drop in (False, True, True, False):
        ms["varlen_train_dropout" if drop else "varlen_train"].append(
            cuda_ms(lambda: step(drop), reps=5, warmup=1))
    listed = traced_launches(lambda: step(True))
    traced = {name: dict(features=sum(c for key, c in listed.items()
                                      if (kernel_feat(key, frag) or 0) != 0),
                         feature_free=sum(c for key, c in listed.items()
                                          if kernel_feat(key, frag) == 0))
              for name, frag in VARLEN_FEATURE_KERNELS.items()}
    want = {name: layers for name in VARLEN_FEATURE_KERNELS}
    ok = (counts == want and fcounts == want and grads_finite
          and all(t == dict(features=layers, feature_free=0)
                  for t in traced.values()))
    plain_ms = float(np.median(ms["varlen_train"]))
    drop_ms = float(np.median(ms["varlen_train_dropout"]))
    result = dict(phase="varlen_train_dropout", layers=layers,
                  docs=len(GPT2M_DOCS), tokens=tq, h=h, d=d, causal=True,
                  dropout_p=p, step_ms=ms, step_ms_median=dict(
                      varlen_train=plain_ms, varlen_train_dropout=drop_ms),
                  rate_vs_varlen_train=plain_ms / drop_ms,
                  varlen_train_step_ms_earlier=vtrain["step_ms_by_events"],
                  launches=counts, feature_launches=fcounts,
                  launches_expected=want, launches_traced=traced,
                  grads_finite=grads_finite, ok=ok)
    emit(result)
    check(ok, "varlen_train_dropout: launches off the count, an attention "
              "launch in the trace that is not a feature instance's, or "
              "non-finite gradients")
    return result


def compile_specs_phase(seed=188):
    """compile_flash_attn_varlen_func_from_specs's callable at
    gpt2m-packed's shapes against flash_attn_varlen_func: equal bits."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tq, h, d = sum(GPT2M_DOCS), 16, 64
    q, k, v = (torch.randn(tq, h, d, generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    cu = _dev_int(_cu_of(GPT2M_DOCS))
    t0 = time.perf_counter()
    fn = compile_flash_attn_varlen_func_from_specs(
        total_q=tq, total_k=tq, nseq=len(GPT2M_DOCS), num_heads=h,
        head_dim=d, causal=True, window_size=(255, -1), softcap=30.0)
    compile_s = time.perf_counter() - t0
    got = fn(q, k, v, cu, cu)
    want = flash_attn_varlen_func(q, k, v, cu, cu, causal=True,
                                  window_size=(255, -1), softcap=30.0)
    refused = False
    try:
        fn(q[:-1], k, v, cu, cu)
    except ValueError:
        refused = True
    ok = bool(torch.equal(got, want)) and refused
    emit(dict(phase="compile_specs", total=tq, nseq=len(GPT2M_DOCS), h=h, d=d,
              window_size=[255, -1], softcap=30.0, compile_s=compile_s,
              equal_bits=bool(torch.equal(got, want)),
              other_shape_refused=refused, ok=ok))
    check(ok, "compile_specs: the compiled callable differs from "
              "flash_attn_varlen_func, or takes a tensor of another shape")


def varlen_feature_phases(vtrain):
    """Every VARLEN_FEATURE_CASES case and the paged one, the bits, the
    planted faults, varlen_train_dropout, compile_specs."""
    results = {}
    for i, name in enumerate(VARLEN_FEATURE_CASES):
        results[name] = varlen_feature_case(name, seed=180 + i)
        gc.collect()
        torch.cuda.empty_cache()
    results[VARLEN_FEATURE_PAGED] = varlen_feature_paged_case()
    varlen_feature_bits_phase()
    varlen_feature_fault_phase()
    gc.collect()
    torch.cuda.empty_cache()
    results["train_dropout"] = varlen_train_dropout_phase(vtrain)
    compile_specs_phase()
    return results


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


def kernel_feat(key, fragment):
    """The kFeat template argument (the last) of a kernel the profiler
    lists under `key` whose name is `fragment`, or None for another
    kernel: 0 is the feature-free instance."""
    m = re.search("::" + fragment + r"<[^<>]*,\s*(\d+)>", key)
    return int(m.group(1)) if m else None


def traced_launches(fn, cycles=3):
    """{kernel name: launches} that torch.profiler lists over one call of
    `fn`: the most of each kernel over `cycles` traced calls, after a
    warm-up cycle of another call. A trace only loses records (a first
    cycle's has missed 1-4 of 40 launches on the H100, and so has a single
    cycle after a warm-up), so the most any cycle lists is the count a
    whole trace gives."""
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=cycles),
                 on_trace_ready=lambda p: seen.append(
                     _device_ms_by_kernel(p, counts=True))) as prof:
        for _ in range(2 * cycles):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return {key: max(cycle.get(key, 0) for cycle in seen)
            for key in set().union(*seen)}


def vllm_ref(q, kp, vp, cu_q, used, table, qlens, ctx, window, slopes):
    """A vLLM layer call's plain answer on "phd" pools (kp, vp): kernel 6's
    plain version over the pages; with ALiBi, its decode rows (a step whose
    rows are all single tokens) through kernel 5's plain version, as the
    call routes them."""
    pools = (kp.transpose(1, 2), vp.transpose(1, 2))
    if slopes is not None and max(qlens) <= 4:
        out, _ = flash_attention_decode_ref(
            q.float().reshape(len(qlens), 1, *q.shape[1:]), *pools, used,
            block_table=table, alibi_slopes=slopes, causal=True,
            window_left=window[0])
        return out.reshape(q.shape)
    ref, _ = flash_attention_varlen_fwd_ref(
        q.float(), None, None, cu_q, None, seqused_k=used, kv_pools=pools,
        block_table=table, causal=True, window_size=window,
        features=None if slopes is None else varlen_features(
            q.shape[1], alibi_slopes=slopes))
    return ref


class _SyncsRaise:
    """torch.cuda.set_sync_debug_mode("error") inside the block: any host
    sync raises."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


def vllm_graph_step(calls, layers):
    """A decode-only step's layer calls (`calls`, as vllm_phase makes them)
    captured once in a CUDA graph and replayed, as vLLM runs its decode
    batches: every layer's output against the eager step's in bits, and
    the replayed step's CUDA-event ms beside the eager step's."""
    every = tuple(range(layers))
    eager = calls(keep=every)
    eager_ms = cuda_ms(calls, reps=10)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed = calls(keep=every)
    graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(graphed[i], eager[i]) for i in every)
    ms = cuda_ms(graph.replay, reps=10)
    del graph
    return dict(layers=layers, equal_bits=equal, replay_ms=ms,
                eager_ms=eager_ms, replay_over_eager=ms / eager_ms)


def vllm_phase(seed=2, layers=32, quant=None, widths=None):
    """One scheduler loop in vLLM's calling convention at Mistral-7B
    widths: 32 layers, each with its own (num_blocks, 16, 8, 128) bf16 K
    and V pools; the 8 prompts of the serve phase under a 2048-token budget,
    32 decode steps each. Per step: new K/V rows written into every layer's
    pools by plain indexing (vLLM's reshape_and_cache), one
    get_scheduler_metadata, then one vllm_compat.flash_attn_varlen_func per
    layer with host syncs made errors.

    widths (phase `vllm_alibi`): another model's (h, hk, d), window and
    ALiBi slopes (h,): the mixed steps run kernel 6's ALiBi instance on the
    pools, the decode-only steps kernel 5 (route paged-decode-alibi); the
    launches of both are also read from the profiled steps' traces.

    quant (a 1-byte dtype; phase `quant_vllm`): the pools hold that dtype,
    each layer's K and V quantized on write with its own scale, and every
    call passes k_descale/v_descale of shape (nseq, hk) expanded from it, as
    vLLM does; the mixed steps take the dequant pass and kernel 6, the
    decode-only steps kernel 4. Layer 0 is held against the plain path on
    the dequantized pools; the dequant pass of one layer is timed alone."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    w = widths or dict(h=H, hk=HK, d=D, window=(WINDOW, -1), slopes=None,
                       model="Mistral-7B-v0.1 attention widths")
    h_, hk_, d_, window = w["h"], w["hk"], w["d"], tuple(w["window"])
    slopes = w["slopes"]
    alibi = {} if slopes is None else dict(alibi_slopes=slopes)
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
    pool_dtype = quant or torch.bfloat16
    pools = [(torch.zeros(num_blocks, VLLM_PAGE, hk_, d_, device=dev,
                          dtype=pool_dtype),
              torch.zeros(num_blocks, VLLM_PAGE, hk_, d_, device=dev,
                          dtype=pool_dtype)) for _ in range(layers)]
    pool_gb = 2 * layers * pools[0][0].numel() * pools[0][0].element_size() / 1e9
    # A 1-byte pool's per-layer (K, V) scales, each (hk,) on the card.
    scales = [tuple(torch.full((HK,), float(x), device=dev)
                    for x in rng.uniform(0.5, 1.5, 2))
              for _ in range(layers if quant is not None else 0)]
    dequant_ms = scratch_gb = None
    _zero_varlen_counts()
    flash_attention_varlen_fwd.launches_sm80 = 0
    flash_attention_decode_multipage.launches = 0
    flash_attention_decode_multipage.combine_launches = 0
    flash_attention_decode_general.launches = 0
    _zero_varlen_feature_counts()
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
        new_kv = torch.randn(layers, 2, tq, hk_, d_, generator=gen,
                             device=dev, dtype=torch.bfloat16)
        for layer, (kp, vp) in enumerate(pools):  # vLLM's reshape_and_cache
            if quant is None:
                kp[page_ids, slots] = new_kv[layer, 0]
                vp[page_ids, slots] = new_kv[layer, 1]
                continue
            for pool, new, scale in zip((kp, vp), new_kv[layer],
                                        scales[layer]):
                pool.view(torch.uint8)[page_ids, slots] = quantize_to_cache_dtype(
                    new[None], scale, quant)[0].view(torch.uint8)
        q = torch.randn(layers, tq, h_, d_, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        cu_q = _dev_int(_cu_of(qlens))
        used = _dev_int(ctx)
        table = _dev_int(req_table[reqs])
        max_q, max_k = max(qlens), max(ctx)
        kind = "mixed" if max_q > 4 else "decode"
        meta = get_scheduler_metadata(
            len(rows), max_q, max_k, h_, hk_, d_, cache_seqlens=used,
            cu_seqlens_q=cu_q, causal=True, window_size=window,
            page_size=VLLM_PAGE)
        # The layers' calls reuse the step's plan without a host read.
        plan_reused += plan_mismatch(
            meta.plan, cu_seqlens_q=cu_q, seqused_k=used, causal=True,
            window_size=window, host_read=False) is None

        def descales(layer):
            if quant is None:
                return {}
            return dict(k_descale=scales[layer][0].expand(len(rows), HK),
                        v_descale=scales[layer][1].expand(len(rows), HK))

        def calls(keep=()):
            kept = {}
            for layer, (kp, vp) in enumerate(pools):
                o = vllm_flash_attn_varlen_func(
                    q[layer], kp, vp, max_q, cu_q, max_k, seqused_k=used,
                    causal=True, window_size=window, block_table=table,
                    scheduler_metadata=meta, **alibi, **descales(layer))
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
            if quant is not None:  # the plain path: the pools dequantized
                kp, vp = (pool.float() * scale[:, None] for pool, scale
                          in zip((kp, vp), scales[layer]))
            ref = vllm_ref(q[layer], kp, vp, cu_q, used, table, qlens, ctx,
                           window, slopes)
            checks.append(dict(step=si, layer=layer, kind=kind, **held(o, ref)))
            del kp, vp
        if quant is not None and kind == "mixed" and dequant_ms is None:
            # The dequant pass of one layer's K and V alone, times layers.
            kp, vp = (pool.transpose(1, 2) for pool in pools[0])
            dequant_ms = layers * cuda_ms(lambda: (
                dequant_pages(kp, table, descales(0)["k_descale"]),
                dequant_pages(vp, table, descales(0)["v_descale"])))
            scratch_gb = 2 * table.numel() * VLLM_PAGE * HK * D * 2 / 1e9
        if kind not in profiles and (kind == "decode" or si >= 2):
            counts_before = (flash_attention_varlen_fwd.launches,
                             flash_attention_decode_multipage.launches,
                             dict(dispatch_counts),
                             flash_attention_decode_multipage.combine_launches,
                             flash_attention_decode_general.launches,
                             flash_attention_varlen_fwd.feature_launches)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            graph = (vllm_graph_step(calls, layers) if kind == "decode"
                     and quant is None and slopes is None else None)
            listed = None if slopes is None else traced_launches(calls)
            # The profiled replay (and the graph's calls) is not part of
            # the scheduler loop's count.
            flash_attention_varlen_fwd.launches = counts_before[0]
            flash_attention_decode_multipage.launches = counts_before[1]
            flash_attention_decode_multipage.combine_launches = counts_before[3]
            flash_attention_decode_general.launches = counts_before[4]
            flash_attention_varlen_fwd.feature_launches = counts_before[5]
            dispatch_counts.clear()
            dispatch_counts.update(counts_before[2])
            by_kernel = _device_ms_by_kernel(prof)
            busy = sum(by_kernel.values())
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
            profiles[kind] = dict(step=si, wall_ms=wall,
                                  device_busy_ms=busy if busy > 0 else None,
                                  idle_share=1 - busy / wall if busy > 0 else None,
                                  top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
            if graph is not None:
                profiles[kind]["graph"] = graph
            if slopes is not None:
                # The attending kernels' launches as the trace lists them:
                # kernel 6's ALiBi instance (kFeat 1, paged) on a mixed
                # step, kernel 5 (split or rows; its combine apart) on a
                # decode-only step.
                profiles[kind]["launches_listed"] = dict(
                    varlen_fwd_alibi=sum(
                        c for key, c in listed.items()
                        if kernel_feat(key, "varlen_fwd_sm90_kernel") == 1),
                    general_decode=sum(
                        c for key, c in listed.items()
                        if "::decode_split_kernel<" in key
                        or "::decode_kernel<" in key),
                    other_attention=sum(
                        c for key, c in listed.items()
                        if "paged_" in key or (
                            "varlen_fwd_sm90_kernel" in key and
                            kernel_feat(key, "varlen_fwd_sm90_kernel") != 1)))
        del q, new_kv
    n_mixed, n_decode = kinds.count("mixed"), kinds.count("decode")
    launches = dict(flash_varlen_fwd=flash_attention_varlen_fwd.launches,
                    paged_decode=flash_attention_decode_multipage.launches,
                    flash_varlen_bwd_dkv=flash_attention_varlen_bwd_dkv.launches,
                    flash_varlen_bwd_dq=flash_attention_varlen_bwd_dq.launches)
    want = dict(flash_varlen_fwd=layers * n_mixed, paged_decode=layers * n_decode,
                flash_varlen_bwd_dkv=0, flash_varlen_bwd_dq=0)
    routes = {f"{k}/{r}": n for (k, r), n in dispatch_counts.items()}
    mixed_route = ("varlen/paged-prefill-inkernel" if quant is None
                   else "varlen/paged-prefill-dequant")
    want_routes = {mixed_route: layers * n_mixed,
                   "varlen/paged-decode": layers * n_decode}
    traced_ok = True
    if slopes is not None:
        launches.update(
            flash_varlen_fwd_features=flash_attention_varlen_fwd.feature_launches,
            general_decode=flash_attention_decode_general.launches)
        want.update(paged_decode=0,
                    flash_varlen_fwd_features=layers * n_mixed,
                    general_decode=layers * n_decode)
        want_routes = {mixed_route: layers * n_mixed,
                       "varlen/paged-decode-alibi": layers * n_decode}
        traced_ok = (profiles["mixed"]["launches_listed"] == dict(
            varlen_fwd_alibi=layers, general_decode=0, other_attention=0)
            and profiles["decode"]["launches_listed"] == dict(
                varlen_fwd_alibi=0, general_decode=layers, other_attention=0))
    worst = max(c["err_over_limit"] for c in checks)
    mixed_ms = [t for t, k in zip(attn_ms, kinds) if k == "mixed"]
    decode_ms = [t for t, k in zip(attn_ms, kinds) if k == "decode"]
    ok = (launches == want and routes == want_routes and worst <= 1
          and n_mixed > 0 and n_decode > 0 and plan_reused == len(steps)
          and flash_attention_varlen_fwd.launches_sm80 == 0 and traced_ok
          and profiles["decode"].get("graph", dict(equal_bits=True))[
              "equal_bits"])
    result = dict(
        phase=("vllm_alibi" if slopes is not None else "vllm" if quant is None
               else "quant_vllm"),
        model=w["model"], layers=layers,
        pool_layout=f"phd (num_blocks, 16, {hk_}, {d_}) "
                    f"{str(pool_dtype)[6:]} per layer, K and V"
                    + ("" if quant is None else ", descales (nseq, hk)")
                    + ("" if slopes is None else ", ALiBi slopes (h,)"),
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
        launches_sm80=flash_attention_varlen_fwd.launches_sm80,
        combine_launches=flash_attention_decode_multipage.combine_launches,
        checked=len(checks), worst_err_over_limit=worst,
        tolerance=ATTN_TOLERANCE, profile=profiles, ok=ok)
    if quant is not None:
        mixed_mean = result["attention_ms_per_mixed_step"]
        result.update(dequant_pass_ms_per_mixed_step=dequant_ms,
                      dequant_share_of_mixed_step=dequant_ms / mixed_mean,
                      dequant_scratch_gb_per_mixed_call=scratch_gb)
    emit(result)
    check(ok, f"{result['phase']}: launches or routes off the count (or off "
              "the trace), a layer's output outside the tolerance, or the "
              "decode step replayed from a graph not equal in bits to the "
              "eager step")
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


def decode_bound(c, pairs, kv_rows, kv_bytes=2):
    """Least time: each visible K/V row read once (kv_bytes a value), q/out/
    lse moved once; 4d flops per visible pair (`pairs` over all heads,
    `kv_rows` over all kv heads)."""
    el = 2
    q_rows = c["b"] * c["sq"] * c["h"]
    nbytes = (kv_rows * 2 * c["d"] * kv_bytes + 2 * q_rows * c["d"] * el
              + q_rows * 4)
    return attn_bound(4, nbytes, 1, 1, c["d"], pairs)


def decode_library(c, q, k, v, lens, kw):
    """The yardstick: SDPA with enable_gqa on the same cache rows cut to the
    longest length, with a boolean mask (a float bias with ALiBi). Returns
    (the call, what it runs) or (None, why not)."""
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
    return (lambda: F.scaled_dot_product_attention(
        qt, ks, vs, attn_mask=mask, enable_gqa=True)), what


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


# Kernel 5's decode steps, also timed replayed from a CUDA graph (an eager
# call of a kernel that runs in tens of microseconds is bound by the host).
DECODE_GRAPH_CASES = ("decode", "generate-decode", "spec-verify-sq5")


def decode_case(name, seed):
    checked, (c, q, k, v, lens, kw) = decode_compare(name, seed)
    mask = decode_masks(c, lens, kw, int(lens.max()))
    pairs = int(mask.sum()) * c["h"]
    kv_rows = int(mask.any(dim=2).sum()) * c["hk"]
    del mask
    bound_ms, bound_by = decode_bound(c, pairs, kv_rows)
    library_fn, library = decode_library(c, q, k, v, lens, kw)
    rows = c["sq"] * c["h"] // c["hk"]
    splits = fd.splits_of(q, k, kw.get("block_table"),
                          window_left=kw["window_left"],
                          attention_chunk=kw["attention_chunk"],
                          sink_token_length=kw["sink_token_length"])

    def call():
        return flash_attention_decode_general(q, k, v, lens, **kw)

    counts = (flash_attention_decode_general.launches,
              flash_attention_decode_general.combine_launches)
    call()
    combines = flash_attention_decode_general.combine_launches - counts[1]
    times = dict(ms=cuda_ms(call))
    if name in DECODE_GRAPH_CASES:
        times["graph_ms"] = graph_ms(call)
        times["library_graph_ms"] = library_fn and graph_ms(library_fn)
    (flash_attention_decode_general.launches,
     flash_attention_decode_general.combine_launches) = counts
    result = dict(
        phase="decode_kernels", kernel="general_decode", case=name,
        **{key: (str(val).split(".")[-1] if key == "dtype" else val)
           for key, val in c.items() if key != "lens"},
        lens=list(c["lens"]), **checked, tolerance=ATTN_TOLERANCE,
        design=("split-kv, warps on keys" if rows <= fd.SPLIT_ROWS
                else "split-kv, warps on rows" if splits > 1 else "rows"),
        num_splits=splits, combine_launches_per_call=combines,
        grid=([splits, c["hk"], c["b"]] if rows <= fd.SPLIT_ROWS or splits > 1
              else [-(-rows // 64), c["hk"], c["b"]]),
        **times,
        plain_ms=cuda_ms(lambda: flash_attention_decode_ref(q, k, v, lens, **kw),
                         reps=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, visible_pairs=pairs,
        kv_rows_read=kv_rows,
        library_ms=library_fn and cuda_ms(library_fn, reps=10),
        library=library)
    result["ok"] = bool(result["ok"] and combines == int(splits > 1))
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


def decode_split_fault_phase(seed=96, num_splits=3):
    """The split-KV check's power on kernel 5, shown with decode_compare's
    check at Mistral-7B widths with a learnable sink and contexts of 200-700
    tokens over three splits: the kernel's partials merged by its combine
    must pass; the plain split schedule with split 1's chunk moved one tile
    later (a tile no split sees, another seen twice), and with the sink
    added in every partial as well as once in the merge, must fail, each by
    more than its limit."""
    c = dict(DECODE_DEFAULTS, b=4, smax=768, lens=(700, 333, 512, 200),
             sink=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(c["b"], 1, H, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(c["b"], HK, c["smax"], D, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    lens = _dev_int(c["lens"])
    sink = torch.randn(H, generator=gen, device=dev) + 2.0
    kw = dict(causal=True, window_left=-1, attention_chunk=0,
              sink_token_length=0, softcap=0.0)
    ref_out, ref_lse = flash_attention_decode_ref(q.float(), k, v, lens,
                                                  sink=sink, **kw)
    run_kw = dict(kw, block_table=None, cache_batch_idx=None,
                  cache_leftpad=None, alibi_slopes=None, sink=sink,
                  softmax_scale=None)
    qf = q.float()

    def held_by(out, lse):
        lse_err = float((lse - ref_lse).abs().max())
        worst = max(held(out, ref_out)["err_over_limit"],
                    lse_err / ATTN_LSE_TOL)
        return dict(err_over_limit=worst, lse_max_abs_err=lse_err,
                    ok=worst <= 1)

    combines = flash_attention_decode_general.combine_launches
    results = dict(whole=held_by(*fd._run(q, k, v, lens, num_splits,
                                          **run_kw)))
    check(flash_attention_decode_general.combine_launches == combines + 1,
          "decode_split_fault: the split call launched no combine")
    ranges = [walk_ranges(n, 0, 1, num_splits, causal=True, window_left=-1,
                          attention_chunk=0, sink_token_length=0)
              for n in c["lens"]]
    moved = [[(lo + 64 * (i == 1 and hi > lo), hi + 64 * (i == 1 and hi > lo))
              for i, (lo, hi) in enumerate(r)] for r in ranges]
    results["chunk_moved_one_tile"] = held_by(
        *flash_attention_decode_general_split_ref(qf, k, v, lens, num_splits,
                                                  ranges=moved, sink=sink,
                                                  **kw))
    parts = [flash_attention_decode_ref(
        qf, k, v, lens, sink=sink, out_dtype=torch.float32,
        col_range=tuple(torch.tensor([r[s][i] for r in ranges], device=dev)
                        for i in (0, 1)), **kw) for s in range(num_splits)]
    o, lse = combine_partials(
        torch.stack([p[0] for p in parts] + [torch.zeros_like(parts[0][0])]),
        torch.stack([p[1].permute(0, 2, 1) for p in parts]
                    + [sink.expand(c["b"], 1, H)]))
    results["sink_in_every_partial"] = held_by(o, lse.permute(0, 2, 1))
    ok = (results["whole"]["ok"]
          and all(not r["ok"] for key, r in results.items() if key != "whole"))
    emit(dict(phase="decode_split_fault", contexts=list(c["lens"]),
              num_splits=num_splits, held=results, tolerance=ATTN_TOLERANCE,
              ok=ok))
    check(ok, "decode_split_fault: the kernel's merged partials fail, or a "
              "moved chunk or a sink in every partial passes the check")


# -- phases 3 and 4: the model and the engine ---------------------------------

class TimedEngine(LLMEngine):
    """LLMEngine whose steps are timed (host clock around a synchronised
    step) by kind. With `record` set, each decode step's (request ids, fp32
    logits rows) are kept in `decode_logits`."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.seconds = {"prefill": 0.0, "decode": 0.0}
        self.record = False
        self.decode_logits = []

    def step(self):
        p0 = self.prefill_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().step()
        torch.cuda.synchronize()
        kind = "prefill" if self.prefill_steps > p0 else "decode"
        self.seconds[kind] += time.perf_counter() - t0
        if self.record and kind == "decode" and out:
            self.decode_logits.append(([o.request_id for o in out],
                                       self.last_logits[:len(out)].clone()))
        return out

    def capture_s(self):
        """Host seconds of the graphs' first calls (warm-up and capture)."""
        return sum(g.capture_s for g in self.graphs.values())


def logits_phase(engine, model, prompt_len=4500, decode_steps=8, seed=1,
                 phase="logits",
                 label="Mistral-7B-v0.1 widths, random weights (seed 0)"):
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
        phase=phase, model=label,
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


def serve_prompts(vocab_size, seed=2):
    """The serve phase's 8 prompts (seed 2) and their lengths."""
    rng = np.random.RandomState(seed)
    lens = serve_prompt_lens(rng)
    return lens, [rng.randint(0, vocab_size, int(n)).tolist() for n in lens]


SERVE_NEW = 32


def warm_up(engine):
    """One short request through the engine, so that each of its step
    programs has run once (and, graphed, been captured) before a timed
    run: the host seconds it took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate([[1, 2, 3]], 2)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serve_run(engine, prompts, max_new=SERVE_NEW):
    """engine.generate over `prompts`, after `warm_up`, with the step logits
    recorded: (tokens, stats) with prefill and decode tokens/s, peak
    memory, kernel 4's launches against layers x steps, the warm-up's and
    the graphs' capture seconds, and the first request id."""
    c = engine.model.config
    warm_s = warm_up(engine)
    torch.cuda.reset_peak_memory_stats()
    p0, d0 = engine.prefill_steps, engine.decode_steps
    s0 = dict(engine.seconds)
    first_id = max(engine.outputs.keys(), default=-1) + 1
    engine.record, engine.decode_logits = True, []
    flash_attention_decode_multipage.launches = 0
    flash_attention_decode_multipage.qv_launches = 0
    flash_attention_decode_multipage.combine_launches = 0
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine.record = False
    launches = flash_attention_decode_multipage.launches
    steps = (engine.prefill_steps - p0) + (engine.decode_steps - d0)
    prefill_s = engine.seconds["prefill"] - s0["prefill"]
    decode_s = engine.seconds["decode"] - s0["decode"]
    prefill_tokens = int(sum(len(p) - 1 for p in prompts))
    decode_tokens = sum(len(o) for o in outs)
    decode_steps = engine.decode_steps - d0
    return outs, dict(
        graphed=bool(engine.graphs["prefill"].captured),
        prefill_steps=engine.prefill_steps - p0,
        decode_steps=engine.decode_steps - d0,
        prefill_tokens=prefill_tokens, decode_tokens=decode_tokens,
        prefill_s=prefill_s, decode_s=decode_s,
        prefill_tokens_per_s=prefill_tokens / prefill_s,
        decode_tokens_per_s=decode_tokens / decode_s,
        decode_ms_per_step=1e3 * decode_s / max(decode_steps, 1),
        warm_up_s=warm_s, capture_s=engine.capture_s(), wall_s=wall,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        kernel_launches=launches, layers_x_steps=c.n_layer * steps,
        qv_launches=flash_attention_decode_multipage.qv_launches,
        combine_launches=flash_attention_decode_multipage.combine_launches,
        launches_ok=launches > 0 and launches == c.n_layer * steps,
        first_request_id=first_id)


def step_margins(engine, n_requests, base):
    """Each request's top-2 logit margin at each of its decode steps, from
    the steps `serve_run` recorded (requests base .. base + n - 1)."""
    margins = [[] for _ in range(n_requests)]
    for ids, rows in engine.decode_logits:
        top2 = rows.topk(2, dim=-1).values
        for rid, m in zip(ids, (top2[:, 0] - top2[:, 1]).tolist()):
            margins[rid - base].append(m)
    return margins


def serve_phase(engine, model, eager):
    """The serve traffic (8 prompts, 32 new tokens) through the graphed
    engine (`engine`, step programs replayed from CUDA graphs), beside the
    eager engine's run of the same traffic (`eager`: tokens, stats and
    recorded logits from `serve_run` with cg=False): equal tokens, and on
    both kernel 4's launches = layers x steps. Returns (result, tokens,
    the graphed run's decode logits, each request's step margins)."""
    c = model.config
    lens, prompts = serve_prompts(c.vocab_size)
    eager_outs, eager_stats, eager_logits = eager
    outs, stats = serve_run(engine, prompts)
    tokens_equal = outs == eager_outs
    ok = (stats["launches_ok"] and eager_stats["launches_ok"] and tokens_equal
          and all(len(o) == SERVE_NEW for o in outs)
          and all(0 <= t < c.vocab_size for o in outs for t in o))
    result = dict(
        phase="serve", requests=len(prompts), prompt_lens=lens.tolist(),
        max_new_tokens=SERVE_NEW, engine=vars(ENGINE) | {"device_put_fn": None},
        **stats, eager=eager_stats, tokens_equal_to_eager=tokens_equal,
        decode_tokens_per_s_over_eager=stats["decode_tokens_per_s"]
        / eager_stats["decode_tokens_per_s"],
        prefill_tokens_per_s_over_eager=stats["prefill_tokens_per_s"]
        / eager_stats["prefill_tokens_per_s"], ok=ok)
    emit(result)
    check(ok, "serve: the graphed engine's tokens differ from the eager "
              "engine's, launches != layers x steps, or malformed outputs")
    return (result, outs, engine.decode_logits,
            step_margins(engine, len(prompts), stats["first_request_id"]))


def logits_graphed_phase(graphed_logits, eager_logits, logits_limit):
    """The graphed engine's logits at every decode step of the serve
    traffic against the eager engine's: equal bits (the same kernels on the
    same inputs), else within the logits phase's limit."""
    steps = len(graphed_logits)
    same_rows = steps == len(eager_logits) and all(
        a[0] == b[0] for a, b in zip(graphed_logits, eager_logits))
    equal = diff = None
    if same_rows:
        equal = all(torch.equal(a[1], b[1])
                    for a, b in zip(graphed_logits, eager_logits))
        diff = max(float((a[1] - b[1]).abs().max())
                   for a, b in zip(graphed_logits, eager_logits))
    ok = bool(same_rows and (equal or diff <= logits_limit))
    emit(dict(phase="logits_graphed", decode_steps=steps,
              rows=sum(len(a[0]) for a in graphed_logits),
              same_requests_per_step=same_rows, equal_bits=equal,
              max_abs_diff=diff, limit_if_not_equal=logits_limit, ok=ok))
    check(ok, "logits_graphed: the graphed engine's logits differ from the "
              "eager engine's beyond the logits limit")


def rotary_rebuild(model, max_seqlen):
    """A plain forward one token longer than the engine's `max_seqlen`,
    which makes every layer's rotary embedding build a longer table, then
    as many tensors of a superseded table's size as there were tables,
    filled with 1e4: the memory the rebuild freed, if it freed any, now
    holds garbage. Returns (the filler, which the caller holds while it
    replays the engine's graphs, and the table lengths before and
    after)."""
    rotary = model.transformer.layers[0].mixer.rotary
    key = torch.device("cuda", torch.cuda.current_device())
    before = rotary._cached[key][0]
    ids = torch.zeros((1, max_seqlen + 1), dtype=torch.long, device="cuda")
    with torch.no_grad():
        model(ids, num_last_tokens=1)
    after = rotary._cached[key][0]
    table = (before, rotary.dim // 2)
    filler = [torch.full(table, 1e4, device="cuda")
              for _ in range(4 * model.config.n_layer)]
    torch.cuda.synchronize()
    return filler, (before, after)


def graph_fault_phase(engine, prompts, eager_outs, max_new=8):
    """The serve check's power: two requests through the graphed engine,
    once as they are (tokens equal to the eager engine's first `max_new`)
    and once with the decode graph replayed at its second step over the
    step before's offsets (tokens, tables and the rest refreshed): the
    tokens must then differ from the eager engine's. Before them, a plain
    forward longer than the engine's max_seqlen rebuilds the rotary tables
    the captured graphs read (`rotary_rebuild`): the control run shows
    that the graphs still read the tables they were captured over."""
    filler, table_lens = rotary_rebuild(engine.model, engine.config.max_seqlen)
    upload = engine._upload
    runs = {}
    for name in ("control", "stale_offsets"):
        decodes = [0]

        def upload_stale(start=0, name=name, decodes=decodes):
            stale = engine._offsets.clone()  # the last step's offsets
            upload(start)
            if name == "stale_offsets" and start == engine._decode_start:
                decodes[0] += 1
                if decodes[0] == 2:  # put back after the upload
                    engine._offsets.copy_(stale)

        engine._upload = upload_stale
        try:
            runs[name] = engine.generate([prompts[i] for i in FAULT_PROMPTS],
                                         max_new)
        finally:
            del engine._upload
    del filler
    want = [eager_outs[i][:max_new] for i in FAULT_PROMPTS]
    ok = (runs["control"] == want and runs["stale_offsets"] != want
          and table_lens[1] > table_lens[0])
    emit(dict(phase="graph_fault", requests=list(FAULT_PROMPTS),
              new_tokens=max_new, rotary_table_lens=table_lens,
              control_equal=runs["control"] == want,
              stale_offsets_equal=runs["stale_offsets"] == want,
              stale_offsets_tokens=runs["stale_offsets"], eager_tokens=want,
              ok=ok))
    check(ok, "graph_fault: the control run after a rotary rebuild differs "
              "from eager, or the replay over stale offsets passes the token "
              "check")


# The serve prompts of graph_fault and of spec_serve's held and
# target-as-draft runs: the two shortest (689 and 1355 tokens).
FAULT_PROMPTS = (5, 3)
SPEC_K = 3


def spec_serve_phase(model, logits_limit, plain_outs, plain_margins,
                     plain_stats):
    """LLMEngine with speculative_k 3 and a TinyLlama-1.1B-width draft
    (random weights, seed 1) on the serve traffic, graphed: tokens equal to
    the plain graphed engine's, except past a step whose top-2 margin there
    is within the logits limit; two requests' tokens held to one fp32
    forward each (`_tokens_held`); kernel 4's launches = target layers x
    (prefill steps + rounds) + draft layers x (prefill steps + k x rounds).
    Then the target as its own draft on two prompts, 16 new tokens: at
    least half of the drafts accepted. Rounds, accepted drafts per round,
    tokens/s beside the plain engine's, and kernel 4's route for the verify
    (k + 1 rows x the group)."""
    c = model.config
    _, prompts = serve_prompts(c.vocab_size)
    draft = GPTLMHeadModel(llama_config_to_gpt_config(TINYLLAMA_1B),
                           device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    config = dataclasses.replace(ENGINE, speculative_k=SPEC_K)
    group = c.n_head // c.resolved_n_head_kv
    result = dict(phase="spec_serve", target="Mistral-7B-v0.1 widths (seed 0)",
                  draft="TinyLlama-1.1B widths, random weights (seed 1)",
                  speculative_k=SPEC_K, requests=len(prompts),
                  new_tokens=SERVE_NEW,
                  verify_route=("split" if (SPEC_K + 1) * group
                                <= fdm.SPLIT_ROWS else "rows"),
                  verify_packed_rows=(SPEC_K + 1) * group)

    def run(draft_model, ps, max_new):
        eng = TimedEngine(model, config, device="cuda", draft_model=draft_model)
        warm_s = warm_up(eng)
        counts0 = (eng.prefill_steps, eng.spec_rounds, eng.spec_drafted,
                   eng.spec_accepted)
        eng.seconds = {"prefill": 0.0, "decode": 0.0}
        flash_attention_decode_multipage.launches = 0
        flash_attention_decode_multipage.combine_launches = 0
        outs = eng.generate(ps, max_new)
        torch.cuda.synchronize()
        p, r, drafted, accepted = (
            a - b for a, b in zip((eng.prefill_steps, eng.spec_rounds,
                                   eng.spec_drafted, eng.spec_accepted),
                                  counts0))
        dl = draft_model.config.n_layer
        want = c.n_layer * (p + r) + dl * (p + SPEC_K * r)
        stats = dict(
            prefill_steps=p, rounds=r, drafted=drafted, accepted=accepted,
            accepted_per_round_per_row=accepted / max(drafted / SPEC_K, 1),
            decode_tokens=sum(len(o) for o in outs),
            decode_s=eng.seconds["decode"],
            decode_tokens_per_s=sum(len(o) for o in outs)
            / eng.seconds["decode"],
            warm_up_s=warm_s, capture_s=eng.capture_s(),
            launches=flash_attention_decode_multipage.launches,
            launches_expected=want,
            combine_launches=flash_attention_decode_multipage.combine_launches,
            combine_launches_expected=(c.n_layer * r + dl * SPEC_K * r
                                       if result["verify_route"] == "split"
                                       else dl * SPEC_K * r),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        stats["launches_ok"] = (want == stats["launches"] and
                                stats["combine_launches"]
                                == stats["combine_launches_expected"])
        del eng
        torch.cuda.empty_cache()
        return outs, stats

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, stats = run(draft, prompts, SERVE_NEW)
    del draft
    torch.cuda.empty_cache()
    divergences = []
    for i, (got, want) in enumerate(zip(outs, plain_outs)):
        j = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if j is not None:
            divergences.append(dict(request=i, step=j,
                                    plain_top2_margin=plain_margins[i][j]))
    near_ties_only = all(d["plain_top2_margin"] <= logits_limit
                         for d in divergences)
    held = {}
    for i in FAULT_PROMPTS:
        seq = torch.tensor([prompts[i] + outs[i]], device="cuda")
        ok_i, worst, not_argmax = _tokens_held(model, seq, len(prompts[i]),
                                               logits_limit)
        held[i] = dict(ok=ok_i, worst_margin=worst,
                       tokens_not_ref_argmax=not_argmax)
    self_outs, self_stats = run(model, [prompts[i] for i in FAULT_PROMPTS],
                                SPEC_SELF_NEW)
    self_ok = (self_stats["launches_ok"]
               and 2 * self_stats["accepted"] >= self_stats["drafted"]
               and all(len(o) == SPEC_SELF_NEW for o in self_outs))
    ok = (stats["launches_ok"] and near_ties_only
          and all(h["ok"] for h in held.values())
          and all(len(o) == SERVE_NEW for o in outs) and self_ok)
    result.update(
        **stats, equal_to_plain=not divergences, divergences=divergences,
        margin_limit=logits_limit, near_ties_only=near_ties_only,
        tokens_held=held, margin_limit_held=2 * logits_limit,
        plain_decode_tokens_per_s=plain_stats["decode_tokens_per_s"],
        decode_tokens_per_s_over_plain=stats["decode_tokens_per_s"]
        / plain_stats["decode_tokens_per_s"],
        self_draft=dict(self_stats, requests=list(FAULT_PROMPTS),
                        new_tokens=SPEC_SELF_NEW, ok=self_ok),
        ok=ok)
    emit(result)
    check(ok, "spec_serve: tokens differ from the plain engine's away from a "
              "near-tie, a token off the plain forward, too few drafts "
              "accepted with the target as its own draft, or launches off "
              "the count")
    return result


def _zero_all_counts():
    _zero_attn_counts()
    _zero_varlen_counts()
    flash_attention_decode_multipage.launches = 0
    flash_attention_decode_general.launches = 0
    flash_attention_decode_general.combine_launches = 0


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
    call; its decode steps replayed from a CUDA graph, cg=True) at batch 4
    on 4500-token prompts, 32 new tokens, greedy, with scores: the scores
    of every batch row at every step against an fp32 plain forward (one
    row at a time) under the 2x bf16-eager contract, every token the
    argmax of its step's scores, launches = layers x forward calls with no
    other attention kernel, peak memory; cg=False in the same call, whose
    sequences and scores must be equal in bits; decode tokens/s of both
    (the walls of whole generates of 32 and 16 new tokens: their
    difference is 16 steps); then the eager decode timed call by call
    under the profiler."""
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
    # Each of the 31 decode steps splits (b 4: 8 splits) and merges once a
    # layer; the prefill (18000 packed rows) does not split.
    combines = flash_attention_decode_general.combine_launches
    combines_want = c.n_layer * (GEN_NEW - 1)
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
    # cg=False: the same steps run eagerly, equal in bits.
    eager = model.generate(ids, length, return_dict_in_generate=True,
                           output_scores=True, cg=False)
    cg_equal = (torch.equal(eager.sequences, seqs)
                and torch.equal(eager.scores, scores))
    del eager

    def timed_generate(new, cg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids, GEN_PROMPT + new, cg=cg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # Whole generates of 32 and of 16 new tokens in turns: their walls'
    # difference is 16 decode steps, with the prefill and (graphed) the
    # warm-up and capture of the step in both.
    half = GEN_NEW // 2
    walls = {}
    for cg in (True, False, False, True):
        for new in (GEN_NEW, half):
            walls.setdefault((cg, new), []).append(timed_generate(new, cg))
    by_cg = {}
    for cg, name in ((True, "graphed"), (False, "eager")):
        step_s = (min(walls[cg, GEN_NEW]) - min(walls[cg, half])) / (
            GEN_NEW - half)
        by_cg[name] = dict(wall_s_32_new=walls[cg, GEN_NEW],
                           wall_s_16_new=walls[cg, half],
                           # a whole call: prefill, (graphed) warm-up and
                           # capture, 31 decode steps
                           whole_call_s=min(walls[cg, GEN_NEW]),
                           decode_ms_per_step=1e3 * step_s,
                           decode_tokens_per_s=GEN_BATCH / step_s)
    by_cg["graphed_over_eager"] = (by_cg["graphed"]["decode_tokens_per_s"]
                                   / by_cg["eager"]["decode_tokens_per_s"])
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
    k5 = sum(v for k, v in by_kernel.items()
             if re.search(r"\bdecode_(split_|combine_)?kernel", k))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    profiled = dict(
        forwards_wall_ms=1e3 * sum(seconds),
        device_busy_ms=busy if busy > 0 else None,
        idle_share=1 - busy / (1e3 * sum(seconds)) if busy > 0 else None,
        general_decode_ms=k5 if busy > 0 else None,
        general_decode_share=k5 / busy if busy > 0 else None,
        top_kernels=[dict(name=k[:80], ms=v) for k, v in top])
    ok = (argmax_ok and scores_ok and counts == want
          and combines == combines_want and cg_equal)
    result = dict(
        phase="generate", model="Mistral-7B-v0.1 widths, random weights (seed 0)",
        layers=c.n_layer, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
        new_tokens=GEN_NEW, cache=f"contiguous (b, hk, {length}, d) bf16 per layer",
        scores_checked=f"all {GEN_BATCH} rows x {GEN_NEW - 1} steps",
        max_abs_err_port=err_port,
        max_abs_err_bf16_eager=err_bf16, floor=floor,
        limit=2 * err_bf16 + floor, scores_ok=scores_ok,
        tokens_are_argmax_of_scores=argmax_ok, launches=counts,
        launches_expected=want, general_decode_combine_launches=combines,
        combine_launches_expected=combines_want, wall_s=wall,
        peak_memory_gb=peak,
        prefill_s=prefill_s,
        prefill_tokens_per_s=GEN_BATCH * GEN_PROMPT / prefill_s,
        decode_steps=len(seconds) - 1, decode_s=decode_s,
        decode_tokens_per_s=GEN_BATCH * (len(seconds) - 1) / decode_s,
        profile=profiled, logits_limit_of_logits_phase=logits_limit,
        cg_equal_to_eager_bits=cg_equal, cg=by_cg, ok=ok)
    emit(result)
    check(ok, "generate: scores outside the 2x bf16-eager contract, a token "
              "not the argmax of its step, launches off the count, or cg=True "
              "not equal in bits to cg=False")
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
    counts["general_decode_combine"] = (
        flash_attention_decode_general.combine_launches)
    rounds = target_calls[0] - 1
    # The prefills do not split; every verify (gamma + 1 tokens, 20 packed
    # rows) and draft step does.
    want = dict({k: 0 for k in counts},
                general_decode=(model.config.n_layer * (1 + rounds)
                                + draft.config.n_layer
                                * (1 + SPEC_GAMMA * rounds)),
                general_decode_combine=(model.config.n_layer * rounds
                                        + draft.config.n_layer * SPEC_GAMMA
                                        * rounds))
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


def _device_ms_by_kernel(prof, counts=False):
    """{kernel name: device ms} from a torch.profiler run; with `counts`,
    {kernel name: the number of its launches the profiler listed}."""
    from torch.autograd import DeviceType

    return {e.key: e.count if counts else e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


# Kernel 4's kernels by the names the profiler lists: the ones that attend
# (split-KV or warps on rows) and the split-KV combine.
PAGED_ATTEND = ("paged_split_kernel", "paged_decode_kernel")
PAGED_COMBINE = ("paged_combine_kernel",)


def _listed(by_kernel, names):
    return sum(v for k, v in by_kernel.items() if any(n in k for n in names))


def profile_phase(engine, model, n_requests=8, prompt_len=2048, max_new=8,
                  seed=3):
    """Where a step's time goes: torch.profiler (device activity only, to
    keep its cost on the host small) over all prefill steps and then all
    decode steps of a small batch through the graphed engine, device time
    by kernel beside the host-clock wall time, and whether the profiler
    listed the kernels of the replayed graphs one by one (kernel 4 among
    them). The same traffic runs once before without the profiler: its
    wall per step beside the profiled device time gives the idle share
    without the profiler's own cost. Checks that the profiler listed kernel
    4's launches from the replayed graphs one by one: layers x steps of
    them, and as many combines as the wrappers' counters (which StepGraph
    moves on each replay by what its capture launched) say."""
    from torch.profiler import ProfilerActivity, profile

    c = model.config
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, c.vocab_size, prompt_len).tolist()
               for _ in range(n_requests)]
    result = dict(phase="profile", requests=n_requests, prompt_len=prompt_len,
                  max_new_tokens=max_new, layers=c.n_layer)
    for profiled in (False, True):
        base = max(engine.outputs.keys(), default=-1) + 1
        ids = range(base, base + n_requests)
        for rid, prompt in zip(ids, prompts):
            engine.add_request(rid, prompt, max_new)
        for kind in ("prefill", "decode"):
            steps, by_kernel, wall_ms, moved = _profiled_steps(
                engine, ids, kind, profiled)
            if not profiled:
                result[kind] = dict(steps_unprofiled=steps,
                                    wall_ms_unprofiled=wall_ms)
                continue
            _profile_entry(result[kind], engine, kind, steps, by_kernel,
                           wall_ms, moved)
    result["ok"] = all(result[kind]["launches_listed_ok"]
                       for kind in ("prefill", "decode"))
    emit(result)
    check(result["ok"], "profile: the profiler did not list kernel 4's "
                        "launches from the replayed graphs as layers x steps")
    return result


def _profiled_steps(engine, ids, kind, profiled):
    """Runs the engine's prefill steps of requests `ids` (kind "prefill":
    while any waits or prefills) or all its decode steps, under
    torch.profiler (device activity only) when `profiled`: (steps,
    {kernel: device ms} and {kernel: launches listed} or None, host wall
    ms, kernel 4's launch and combine counters' moves)."""
    from torch.profiler import ProfilerActivity, profile

    more = {
        # waiting or prefilling (scheduler states 0 and 1)
        "prefill": lambda: any(engine.sched.request_state(r) in (0, 1)
                               for r in ids),
        "decode": lambda: engine.sched.num_active() > 0,
    }[kind]
    steps = 0
    counters = (flash_attention_decode_multipage.launches,
                flash_attention_decode_multipage.combine_launches)
    with (profile(activities=[ProfilerActivity.CUDA]) if profiled
          else contextlib.nullcontext()) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while more():
            engine.step()
            steps += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    moved = (flash_attention_decode_multipage.launches - counters[0],
             flash_attention_decode_multipage.combine_launches - counters[1])
    by_kernel = ((_device_ms_by_kernel(prof), _device_ms_by_kernel(prof, True))
                 if profiled else None)
    return steps, by_kernel, wall_ms, moved


def _profile_entry(entry, engine, kind, steps, by_kernel, wall_ms, moved,
                   attend_names=PAGED_ATTEND, combine_names=PAGED_COMBINE):
    """profile_phase's numbers for one kind of step, into `entry`; kernel
    4's kernels by the names the profiler lists them under."""
    by_kernel, listed = by_kernel
    busy = sum(by_kernel.values())
    attn = _listed(by_kernel, attend_names + combine_names)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    same_steps = steps == entry["steps_unprofiled"]
    want = engine.model.config.n_layer * steps
    attend, combine = (_listed(listed, attend_names),
                       _listed(listed, combine_names))
    entry.update(
        steps=steps, wall_ms=wall_ms,
        device_busy_ms=busy if busy > 0 else None,
        idle_share=1 - busy / wall_ms if busy > 0 else None,
        idle_share_unprofiled=(1 - busy / entry["wall_ms_unprofiled"]
                               if busy > 0 and same_steps else None),
        paged_decode_ms=attn if busy > 0 else None,
        paged_decode_share=attn / busy if busy > 0 else None,
        top_kernels=[dict(name=k[:80], ms=v) for k, v in top],
        graphed=engine.graphs[kind].captured,
        # kernel 4 as the profiler listed it, and as the counters say
        launches_listed=attend, combine_launches_listed=combine,
        launches_counted=moved[0], combine_launches_counted=moved[1],
        layers_x_steps=want,
        launches_listed_ok=(attend == want == moved[0]
                            and combine == moved[1]),
    )


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


def _zero_feature_counts():
    flash_attention_fwd.feature_launches = 0
    flash_attention_bwd_dq.feature_launches = 0
    flash_attention_bwd_dkv.feature_launches = 0


def _expected_counts(config, steps):
    """Launches of a training run: per layer and step one forward, and a
    second one when remat recomputes it in the backward; one dK/dV and one
    dQ."""
    fwd = 2 if config.remat != "none" else 1
    return dict(flash_fwd=fwd * config.n_layer * steps,
                flash_bwd_dkv=config.n_layer * steps,
                flash_bwd_dq=config.n_layer * steps)


def train_grad_phase(batch=1, seed=4, overrides=(), dropout_seed=None):
    """One loss and gradient of the full-depth GPT-2-medium model through
    the port (kernels, bf16 compute, fp32 params) against the plain model
    in fp32 and in bf16 eager; `overrides` (dotted config settings) switch
    on attention dropout, whose masks both take from `dropout_seed`, or
    ALiBi."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, _, dcfg = load_config(GPT2M_CONFIG, list(overrides))
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
    loss = cross_entropy_loss(model(ids, dropout_seed=dropout_seed).float(),
                              labels)
    grads = torch.autograd.grad(loss, params)
    counts = _attn_counts()
    loss32 = gpt_loss_ref(model, ids, labels, dtype=torch.float32,
                          dropout_seed=dropout_seed)
    grads32 = torch.autograd.grad(loss32, params)
    loss16 = gpt_loss_ref(model, ids, labels, dtype=torch.bfloat16,
                          dropout_seed=dropout_seed)
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
        f"fp32 weights (seed {seed})", overrides=list(overrides),
        dropout_seed=dropout_seed, layers=config.n_layer,
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


def train_phase(overrides=(), phase="train"):
    """`training.run.main` on configs/gpt2m-synth.yaml as it is, cut to
    TRAIN_STEPS steps with a short warmup (and `overrides`, dotted
    settings, for train_dropout); launches of the three attention kernels
    counted over this phase only."""
    argv = ["--config", GPT2M_CONFIG,
            "--set", f"train.total_steps={TRAIN_STEPS}",
            "--set", f"train.warmup_steps={TRAIN_WARMUP}"]
    for setting in overrides:
        argv += ["--set", setting]
    config, train_config, dcfg = load_config(GPT2M_CONFIG, argv[3::2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_attn_counts()
    _zero_feature_counts()
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
    if overrides:
        # With dropout every attention launch is a feature instance's.
        ok = ok and _feature_counts() == want
    result = dict(
        phase=phase, config="configs/gpt2m-synth.yaml",
        overrides=argv[2:], layers=config.n_layer, n_embd=config.n_embd,
        heads=config.n_head, vocab=config.vocab_size, remat=config.remat,
        batch=dcfg["batch_size"], seqlen=dcfg["seqlen"],
        steps=steps, tokens_per_s=report["tokens_per_s"], mfu=report["mfu"],
        mfu_peak="989 TFLOP/s (H100 SXM bf16 dense, data sheet)",
        wall_s=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, launches_expected=want, ok=ok)
    if overrides:
        result["feature_launches"] = _feature_counts()
    emit(result)
    check(ok, f"{phase}: non-finite or non-falling loss, or launches off "
              "the count")
    return result


def train_seeds_phase(seed=5, steps=2):
    """Dropout's seeds in training: the gpt2m trainer (attn_pdrop 0.1) on
    the same weights and batches with TrainConfig.seed 0, 0 and 1, `steps`
    steps each: one seed gives equal bits (losses and the weights after),
    two seeds differ."""
    config, train_config, dcfg = load_config(GPT2M_CONFIG,
                                             ["model.attn_pdrop=0.1"])
    rng = np.random.RandomState(seed)
    shape = (dcfg["batch_size"], dcfg["seqlen"] + 1)
    batches = [rng.randint(0, config.vocab_size, shape) for _ in range(steps)]
    runs = []
    for train_seed in (0, 0, 1):
        model = GPTLMHeadModel(
            config, device="cuda", param_dtype=torch.float32,
            generator=torch.Generator(device="cuda").manual_seed(seed))
        trainer = Trainer(model, dataclasses.replace(train_config,
                                                     seed=train_seed))
        losses = [float(trainer.train_step(x[:, :-1], x[:, 1:])[0])
                  for x in batches]
        head = model.transformer.layers[0].mixer.Wq.weight.detach().clone()
        runs.append((losses, head))
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()
    same = runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    differ = runs[0][0] != runs[2][0] and not torch.equal(runs[0][1],
                                                           runs[2][1])
    ok = same and differ
    emit(dict(phase="train_seeds", config="configs/gpt2m-synth.yaml",
              overrides=["model.attn_pdrop=0.1"], steps=steps,
              losses={f"seed {s} run {i}": r[0] for i, (s, r) in
                      enumerate(zip((0, 0, 1), runs))},
              one_seed_equal_bits=same, two_seeds_differ=differ, ok=ok))
    check(ok, "train_seeds: one seed does not repeat its bits, or two "
              "seeds agree")


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
            for name in ("fwd_sm90_kernel", "bwd_dkv_sm90_kernel",
                         "bwd_dq_sm90_kernel")}
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
    # nqb 21 and nkb 31: the last block of either backward kernel has one
    # 64-row block or key tile, its second warpgroup none.
    "odd-blocks-d64": (1, 8, 2, 1300, 1950, 64, True, torch.bfloat16, 0.0,
                       False, None, None, True),
    # sq not a multiple of 4: kernel 13's LSE and delta rows start off a
    # 16-byte boundary.
    "odd-lengths-d64": (1, 8, 2, 1001, 1503, 64, True, torch.bfloat16, 0.0,
                        False, None, None, True),
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
        """Both forward routes (kernel 12 twice, for equal bits, its TMA
        copies counted) and the backward kernels on metadata m."""
        plan = plan_sparse(*m, keep_table=bwd, **plans)
        gplan = plan_gather(*m, **plans)
        flash_attention_sparse_tiles_fwd.tma_copies = 0
        tiles, tiles2 = (flash_attention_sparse_tiles_fwd(
            q, k, v, *m, plan=plan, **kw) for _ in range(2))
        got = dict(
            fwd_tiles_bitwise_deterministic=all(
                torch.equal(x, y) for x, y in zip(tiles, tiles2)),
            fwd_tiles_tma_copies=flash_attention_sparse_tiles_fwd.tma_copies)
        del tiles2
        for route, (out, lse) in (
                ("tiles", tiles),
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
    ok = (got["tiles"]["ok"] and got["gather"]["ok"]
          and got["fwd_tiles_bitwise_deterministic"]
          and got["fwd_tiles_tma_copies"] == 0)
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
    # Kernel 12 computes whole listed 64 x 64 tiles: their 4 d flops per
    # element at the card's bf16 rate, beside the visible pairs' bound.
    result["listed_tiles"] = int(plan.counts.sum())
    result["fwd_listed_bound_ms"] = (result["listed_tiles"] * 64 * 64 * 4 * d
                                     / BF16_FLOPS_PER_S * 1e3)
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
            if bwd:
                qt, kt, vt = (x.detach().clone().requires_grad_()
                              for x in (q, k, v))

                def sdpa_fwd_bwd():
                    o = F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)
                    torch.autograd.grad(o, (qt, kt, vt), do)

                result["library_fwd_bwd_ms"] = cuda_ms(sdpa_fwd_bwd, **reps)
                del qt, kt, vt
            result["library"] = ("scaled_dot_product_attention(attn_mask="
                                 "visibility, enable_gqa=True): a yardstick")
        except Exception as exc:  # a yardstick: report why it did not run
            result["library"] = f"not run: {type(exc).__name__}: {exc}"[:200]
        del mask
    emit(result)
    emit(fault)
    check(result["ok"], f"sparse_kernels case {name} disagrees with its "
                        "plain version, is not deterministic or copied "
                        "kernel 12's inputs")
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
    flash_attention_sparse_bwd.tma_copies = 0
    flash_attention_sparse_tiles_fwd.tma_copies = 0
    out = sparse_attn_func(*leaves, *meta, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = _sparse_counts()
    tma_copies = flash_attention_sparse_bwd.tma_copies
    fwd_copies = flash_attention_sparse_tiles_fwd.tma_copies
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
    ok = (launches == want and fwd_copies == 0
          and all(c["err_over_limit"] <= 1 for c in checks.values()))
    result = dict(phase="sparse_autograd", b=b, h=h, hk=hk, s=sq, d=d,
                  layout="bshd", route=route, launches=launches,
                  launches_expected=want, routes=routes,
                  fwd_tma_copies=fwd_copies, bwd_tma_copies=tma_copies,
                  **checks,
                  tolerance=ATTN_TOLERANCE, ok=ok)
    emit(result)
    check(ok, "sparse_autograd: launches off the count, a copy of kernel 12's "
              "inputs, or a gradient outside the tolerance")
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
        combine_launches=flash_attention_decode_multipage.combine_launches,
        layer0=check0, layer0_profile=layer_profile,
        tolerance=ATTN_TOLERANCE, ok=ok)
    emit(result)
    check(ok, "sparse_vllm: launches off the count or layer 0 outside the "
              "tolerance")
    del qkv, outs, patterns
    gc.collect()
    torch.cuda.empty_cache()
    return result


def sparse_kernel_entries(sparse, logs):
    """Kernels 12-15 for the kernels line: times at the vLLM prefill shape
    (forward) and the prefill-8k case (backward; forward there too),
    launches on the slice's two paths (`sparse_vllm`, `sparse_autograd`),
    each counted from zero; their ptxas registers and spills and SASS
    counts (kernel 12 also its listed tiles' bound). Fails if one of them
    never launched there, or if a kernel's SASS lacks wgmma or its loads
    (TMA; cp.async for kernel 15), or has atomics."""
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
        if route == "tiles":
            # Kernel 12's Hopper kernel alone: wgmma and TMA loads, no
            # atomics; LDL and STL are spill loads and stores. Beside the
            # visible pairs' bound, that of the listed tiles it computes.
            kernel = "sparse_fwd_sm90_kernel"
            main = ptxas_of(logs, kernel + "I13__nv_bfloat16Li128ELb0ELb0E")
            entry.update(
                design="wgmma+tma, two 64-row warpgroups merging their tile "
                       "lists, K/V once per merged step, two blocks per SM",
                ptxas=ptxas_of(logs, kernel), ptxas_main_path=main,
                sass=sass_counts(_build.library_path("flash_sparse_fwd"),
                                 ("HGMMA", "UTMALDG", "ATOM", "RED", "LDL",
                                  "STL"), kernel),
                tma_copies=sum(a["fwd_tma_copies"] for a in runs),
                listed_tiles=at["listed_tiles"],
                listed_tiles_bound_ms=at["fwd_listed_bound_ms"])
            entry["prefill_8k"].update(
                listed_tiles=p8["listed_tiles"],
                listed_tiles_bound_ms=p8["fwd_listed_bound_ms"])
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma or TMA loads, or atomics, in its SASS")
            check(bool(entry["ptxas"]), f"{kernel}: not in the build's ptxas "
                                        "output")
        if route == "gather":
            # Kernel 15's Hopper kernel alone: wgmma, cp.async gathers
            # (LDGSTS), no atomics; LDL and STL are spill loads and stores.
            kernel = "gather_sm90_kernel"
            entry.update(
                design="wgmma, cp.async row gathers into swizzled stages "
                       "by a producer warpgroup, two blocks per SM",
                ptxas=ptxas_of(logs, kernel),
                sass=sass_counts(_build.library_path("flash_sparse_fwd"),
                                 ("HGMMA", "LDGSTS", "ATOM", "RED", "LDL",
                                  "STL"), kernel))
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["LDGSTS"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma or cp.async, or atomics, in its SASS")
        elif not route:
            if p8.get("library_fwd_bwd_ms") is not None:
                # SDPA's backward alone: its forward+backward less its
                # forward.
                entry["library_bwd_ms"] = (p8["library_fwd_bwd_ms"]
                                           - p8["library_fwd_ms"])
            # The Hopper kernel's instructions alone (no atomics: ATOM and
            # RED must be 0; LDL and STL are spill loads and stores).
            kernel = f"sparse_{key}_sm90_kernel"
            entry.update(
                design="wgmma+tma", ptxas=ptxas_of(logs, kernel),
                sass=sass_counts(_build.library_path("flash_sparse_bwd"),
                                 ("HGMMA", "UTMALDG", "ATOM", "RED", "LDL",
                                  "STL"), kernel),
                tma_copies=sum(a["bwd_tma_copies"] for a in runs))
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma or TMA loads, or atomics, in its SASS")
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
    # s not a multiple of 4: kernel 10's LSE and delta rows start off a
    # 16-byte boundary; GQA.
    "doc-aux-odd-length": (1, 4, 2, 2001, 64, BF16, 0.0, 128, doc_aux_mod,
                           (2001, 3), {}),
}
BS_FAULT_CASES = ("doc_aux_2k", "mistral-doc10", "softcap30-fp16-d64")


def _bs_counts():
    return dict(block_sparse_fwd=flash_attention_blocksparse_fwd.launches,
                block_sparse_bwd_dkv=flash_attention_blocksparse_bwd_dkv.launches,
                block_sparse_bwd_dq=flash_attention_blocksparse_bwd_dq.launches)


def _zero_bs_counts():
    flash_attention_blocksparse_fwd.launches = 0
    flash_attention_blocksparse_fwd.tma_copies = 0
    flash_attention_blocksparse_bwd_dq.tma_copies = 0
    flash_attention_blocksparse_bwd_dkv.tma_copies = 0
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
    kernels take the plain forward's LSE and the plain dQ's delta; every
    kernel runs twice for equal bits."""
    q, k, v, do = tensors
    plan = kw["plan"]
    kk = dict(mask_mod=kw["mask_mod"], aux_tensors=kw["aux_tensors"],
              softcap=kw["softcap"], lists=lists)
    out, lse = flash_attention_blocksparse_fwd(q, k, v, plan, **kk)
    out2, lse2 = flash_attention_blocksparse_fwd(q, k, v, plan, **kk)
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
               fwd_bitwise_deterministic=(torch.equal(out, out2)
                                          and torch.equal(lse, lse2)),
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
          and got["fwd_bitwise_deterministic"] and got["grads_finite"]
          and got["empty_rows_zero"])
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
        fwd_tma_copies=flash_attention_blocksparse_fwd.tma_copies,
        dq_tma_copies=flash_attention_blocksparse_bwd_dq.tma_copies,
        dkv_tma_copies=flash_attention_blocksparse_bwd_dkv.tma_copies,
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
    check(result["fwd_tma_copies"] == 0, f"blocksparse_kernels case {name}: "
                                         "the forward copied an input")
    check(result["dq_tma_copies"] == 0, f"blocksparse_kernels case {name}: "
                                        "kernel 11 copied an input")
    check(result["dkv_tma_copies"] == 0, f"blocksparse_kernels case {name}: "
                                         "kernel 10 copied an input")
    for fault in faults:
        emit(fault)
        # Each planted fault must be caught by every kernel: 9 (fwd), 11
        # (dq) and 10 (dkv).
        check(fault["ok"], f"blocksparse_fault: {fault['planted']} in case "
                           f"{name} passes the check of kernel(s) "
                           f"{[k for k, c in fault['caught'].items() if not c]}")
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
    dkv_copies = flash_attention_blocksparse_bwd_dkv.tma_copies
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
    ok = (counts == want and builds == 1 and grads_finite and agree
          and dkv_copies == 0)
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
        dkv_tma_copies=dkv_copies,
        host_syncs_in_layer_calls="none (set_sync_debug_mode error)",
        layer0_vs_kernels_6_8=versus, tolerance=ATTN_TOLERANCE,
        grads_finite=grads_finite, ok=ok)
    emit(result)
    check(ok, "blocksparse_train: launches or builds off the count, a TMA "
              "copy of kernel 10's inputs, non-finite gradients, or layer 0 "
              "disagrees with kernels 6-8")
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


def blocksparse_kernel_entries(bsr, logs):
    """Kernels 9-11 for the kernels line: times at `doc10` (b 1, h 16, s
    8192, d 128, tile 512), launches from `blocksparse_train`; for kernel 9
    also at `prefix` and `doc5` beside SDPA's, for kernels 10 and 11 at
    `prefix` and `softcap30-fp16-d64`; for all three their ptxas registers
    and spills and SASS counts. Fails if one of them never launched there,
    or if a kernel's SASS has no wgmma or TMA load (10 and 11: or bulk
    copy), or has atomics."""
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
        if key != "fwd" and at.get("library_fwd_bwd_ms") is not None:
            # SDPA's backward alone: its forward+backward less its forward.
            entry["library_bwd_ms"] = (at["library_fwd_bwd_ms"]
                                       - at["library_fwd_ms"])
        if key == "dkv":
            # Kernel 10 at prefix and softcap30-fp16-d64 too, and its
            # instructions: UBLKCP are the bulk copies of the mode-2 words.
            for other in ("prefix", "softcap30-fp16-d64"):
                c = bsr["cases"][other]
                entry[other] = dict(
                    ms=c["dkv_ms"], plain_ms=c["dkv_plain_ms"],
                    bound_ms=c["dkv_bound_ms"], bound_by=c["dkv_bound_by"],
                    shape=(f"{other}: b={c['b']} h={c['h']} s={c['s']} "
                           f"d={c['d']} tile {c['tile']}, kept density "
                           f"{c['density']:.4f}"))
            kernel = "bs_dkv_sm90_kernel"
            entry.update(
                design="wgmma+tma, two 64-key blocks' inverse lists merged "
                       "per block, one query head of the group after "
                       "another, mode-2 words by bulk copy",
                ptxas=ptxas_of(logs, kernel),
                sass=sass_counts(_build.library_path("block_sparse_bwd"),
                                 ("HGMMA", "UTMALDG", "UBLKCP", "ATOM", "RED",
                                  "LDL", "STL"), kernel),
                tma_copies=dict(
                    cases=sum(c["dkv_tma_copies"]
                              for c in bsr["cases"].values()),
                    blocksparse_train=bsr["train"]["dkv_tma_copies"]))
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["UBLKCP"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma, TMA or bulk loads, or atomics, in its "
                  "SASS")
            check(all(r[0] <= 255 for r in entry["ptxas"]),
                  f"{kernel}: more than 255 registers")
        if key == "dq":
            # Kernel 11 at prefix and softcap30-fp16-d64 too, and its
            # instructions: UBLKCP are the bulk copies of the mode-2 words.
            for other in ("prefix", "softcap30-fp16-d64"):
                c = bsr["cases"][other]
                entry[other] = dict(
                    ms=c["dq_ms"], plain_ms=c["dq_plain_ms"],
                    bound_ms=c["dq_bound_ms"], bound_by=c["dq_bound_by"],
                    shape=(f"{other}: b={c['b']} h={c['h']} s={c['s']} "
                           f"d={c['d']} tile {c['tile']}, kept density "
                           f"{c['density']:.4f}"))
            kernel = "bs_dq_sm90_kernel"
            entry.update(
                design="wgmma+tma, two 64-row blocks' lists merged per block, "
                       "walked twice, mode-2 words by bulk copy",
                ptxas=ptxas_of(logs, kernel),
                sass=sass_counts(_build.library_path("block_sparse_bwd"),
                                 ("HGMMA", "UTMALDG", "UBLKCP", "ATOM", "RED",
                                  "LDL", "STL"), kernel),
                tma_copies=sum(c["dq_tma_copies"]
                               for c in bsr["cases"].values()))
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["UBLKCP"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma, TMA or bulk loads, or atomics, in its "
                  "SASS")
        if key == "fwd":
            for other in ("prefix", "doc5"):
                c = bsr["cases"][other]
                entry[other] = dict(
                    ms=c["fwd_ms"], plain_ms=c["fwd_plain_ms"],
                    bound_ms=c["fwd_bound_ms"], bound_by=c["fwd_bound_by"],
                    library_ms=c["library_fwd_ms"],
                    shape=(f"{other}: b=1 h=16 s=8192 d=128 tile 512, kept "
                           f"density {c['density']:.4f}"))
            # The Hopper kernel's instructions (no atomics: ATOM and RED
            # must be 0; LDL and STL are spill loads and stores).
            kernel = "bs_fwd_sm90_kernel"
            entry.update(
                design="wgmma+tma, two 64-row blocks' lists merged per block",
                ptxas=ptxas_of(logs, kernel),
                sass=sass_counts(_build.library_path("block_sparse_fwd"),
                                 ("HGMMA", "UTMALDG", "ATOM", "RED", "LDL",
                                  "STL"), kernel),
                tma_copies=sum(c["fwd_tma_copies"]
                               for c in bsr["cases"].values()))
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma or TMA loads, or atomics, in its SASS")
        entries.append(entry)
        check(entry["launches"] > 0, f"{name} never launched on "
                                     "blocksparse_train")
    return entries


# -- phases: quant_kernels, quant_fault, quant_serve (1-byte KV caches) ------

QUANT = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}
# Kernel 4's cases: the engine's decode step and a prefill chunk of 256
# rows (b 8, page 16, window 4095), on fused and split pools.
QUANT_PAGED = {"decode": 1, "prefill": 256}
# Kernel 5's cases (DECODE_CASES' inputs): contiguous decode steps, the
# long-call rows kernel (generate's prefill) and vLLM's paged "phd" view with
# sinks.
QUANT_DECODE = ("decode", "generate-decode", "prefill", "paged-phd-sinks")


def quantized(x, scale, dtype):
    """x (..., hk, d) quantized per kv head with scale (hk,), as the engine
    writes it."""
    return quantize_to_cache_dtype(x, scale, dtype)


def descale_forms(scale, b, rng, form):
    """A (hk,) scale as the kernels take it: "hk" as it is, "b-hk" one per
    batch row and kv head (vLLM's layout), varied around it."""
    if form == "hk":
        return scale
    vary = torch.from_numpy(rng.uniform(0.75, 1.25, (b, HK)).astype(np.float32))
    return (scale[None] * vary.to(scale.device)).contiguous()


def peak_extra_bytes(fn):
    """fn()'s result (out, lse) and the device memory the call held above
    what was allocated before it, less its outputs' bytes: its workspaces
    (partials), where a 16-bit copy of a pool would show."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in out)
    return out, torch.cuda.max_memory_allocated() - before - outputs


def quant_paged_inputs(sq, fused, dtype, seed):
    """Kernel 4's seeded inputs on a 1-byte pool: (q, k_pool, v_pool or None,
    lens, table, (hk,) K and V scales, seqlens)."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    seqlens = rng.randint(max(sq, 1), MAX_CTX + 1, B)
    seqlens[0] = max(seqlens[0], 4500)
    max_pages = -(-MAX_CTX // 16)
    npages = B * max_pages + 1
    table = _dev_int(rng.permutation(npages - 1)[: B * max_pages]
                     .reshape(B, max_pages))
    ks, vs = (torch.from_numpy(rng.uniform(0.03, 0.05, HK).astype(np.float32))
              .to(dev) for _ in range(2))
    k, v = (quantized(torch.randn(npages, 16, HK, D, generator=gen, device=dev,
                                  dtype=torch.bfloat16), s, dtype)
            .transpose(1, 2).contiguous() for s in (ks, vs))
    if fused:  # K at [:D], V at [128:128 + D] (allocate_fused_paged_kv_cache)
        pool = allocate_fused_paged_kv_cache(npages, 16, HK, D, dtype=dtype,
                                             device=dev)
        pool.view(torch.uint8)[..., :D] = k.view(torch.uint8)
        pool.view(torch.uint8)[..., 128:128 + D] = v.view(torch.uint8)
        k, v = pool, None
    q = torch.randn(B, sq, H, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    return q, k, v, _dev_int(seqlens), table, ks, vs, seqlens


def quant_paged_case(case, dtype_name, fused, form, seed):
    """Kernel 4 on a 1-byte pool against its plain version (the check of
    phase `kernel`), twice for equal bits, and at unit descales against the
    bf16 instance on the pool upcast: equal bits from the rows kernel (the
    upcast is exact and the key order the same). The split-KV kernel's two
    instances walk the same keys in the same order but their compiled
    arithmetic rounds a few scores apart (seen on the H100; the cause, most
    likely a multiply and subtract fused into one FMA in one instance only,
    is not traced), so there the check's tolerance holds them. Also its
    time, eager and from a CUDA graph, beside the bf16 instance's on the
    upcast pool, its bound at 1 byte per K/V element, and the workspace the
    call holds beside its outputs, which must stay under the pool's own
    bytes (a bf16 copy of it would not)."""
    sq = QUANT_PAGED[case]
    dtype = QUANT[dtype_name]
    q, k, v, lens, table, ks, vs, seqlens = quant_paged_inputs(
        sq, fused, dtype, seed)
    rng = np.random.RandomState(seed + 1)
    kd, vd = (descale_forms(s, B, rng, form) for s in (ks, vs))
    kw = dict(fused_kv_dim=D if fused else 0, window_left=WINDOW)

    def call(kp=k, vp=v, **scales):
        return flash_attention_decode_multipage(q, kp, vp, lens, table, **kw,
                                                **scales)

    (out, lse), extra = peak_extra_bytes(lambda: call(k_scale=kd, v_scale=vd))
    again = call(k_scale=kd, v_scale=vd)
    ref_out, ref_lse = flash_attention_decode_multipage_ref(
        q.float(), k, v, lens, table, k_scale=kd, v_scale=vd, **kw)
    ok, max_err, lse_err = paged_held(out, lse, ref_out, ref_lse)
    del ref_out, ref_lse
    ones = torch.ones_like(kd)
    unit = call(k_scale=ones, v_scale=ones)
    k16, v16 = (None if x is None else x.to(torch.bfloat16) for x in (k, v))
    bf16 = call(k16, v16)
    pool_bytes = sum(x.numel() for x in (k, v) if x is not None)
    stable = all(torch.equal(a, b) for a, b in zip((out, lse), again))
    unit_equal = all(torch.equal(a, b) for a, b in zip(unit, bf16))
    split = sq * (H // HK) <= fdm.SPLIT_ROWS
    unit_held, unit_err, _ = paged_held(unit[0], unit[1], bf16[0].float(),
                                        bf16[1])
    times = dict(ms=cuda_ms(lambda: call(k_scale=kd, v_scale=vd)),
                 bf16_ms=cuda_ms(lambda: call(k16, v16)))
    launches = (flash_attention_decode_multipage.launches,
                flash_attention_decode_multipage.combine_launches)
    if sq == 1:
        times.update(graph_ms=graph_ms(lambda: call(k_scale=kd, v_scale=vd)),
                     bf16_graph_ms=graph_ms(lambda: call(k16, v16)))
    (flash_attention_decode_multipage.launches,
     flash_attention_decode_multipage.combine_launches) = launches
    del k16, v16, bf16
    bound_ms, bound_by = bound(seqlens.tolist(), sq, WINDOW, tuple(table.shape),
                               kv_bytes=1)
    result = dict(
        phase="quant_kernels", kernel="paged_decode", case=case,
        kv_dtype=dtype_name, fused=fused, descales=form, b=B, sq=sq, h=H,
        hk=HK, d=D, page=16, window_left=WINDOW,
        num_splits=fdm.splits_of(q, k, table, WINDOW),
        max_abs_err=max_err, lse_max_abs_err=lse_err,
        tolerance=f"|out-ref| <= {OUT_ATOL} + {OUT_RTOL}|ref|, |lse-ref| <= {LSE_ATOL}",
        design="split-kv" if split else "rows", bit_stable=stable,
        unit_descales_equal_bf16_bits=unit_equal,
        unit_descales_max_abs_diff_bf16=unit_err,
        **times, plain_ms=cuda_ms(lambda: flash_attention_decode_multipage_ref(
            q, k, v, lens, table, k_scale=kd, v_scale=vd, **kw), reps=3,
            warmup=1),
        bound_ms=bound_ms, bound_by=bound_by,
        bf16_bound_ms=bound(seqlens.tolist(), sq, WINDOW, tuple(table.shape))[0],
        pool_mb=pool_bytes / 1e6, call_workspace_mb=extra / 1e6,
        library_ms=None,
        library="none: no single PyTorch call takes a 1-byte pool",
        ok=bool(ok and stable and extra < pool_bytes
                and (unit_equal or (split and unit_held))))
    emit(result)
    check(result["ok"], f"quant_kernels: kernel 4 {case} {dtype_name} "
                        f"{'fused' if fused else 'split'} {form}")
    return result


def quant_decode_inputs(name, dtype, form, seed):
    """Kernel 5's case `name` (decode_inputs) with its caches quantized per
    kv head: (c, q, k, v, lens, kw with the descales, rng)."""
    c, q, k, v, lens, kw = decode_inputs(name, seed)
    rng = np.random.RandomState(seed + 1)
    ks, vs = (torch.from_numpy(rng.uniform(0.03, 0.05, c["hk"])
                               .astype(np.float32)).to(q.device)
              for _ in range(2))
    # (.., hk, s, d) caches and views: quantize along their kv-head axis.
    k, v = (quantized(x.transpose(1, 2), s, dtype).transpose(1, 2)
            for x, s in ((k, ks), (v, vs)))
    kw = dict(kw, k_scale=descale_forms(ks, c["b"], rng, form),
              v_scale=descale_forms(vs, c["b"], rng, form))
    return c, q, k, v, lens, kw


def quant_decode_case(name, dtype_name, form, seed):
    """Kernel 5 on a 1-byte cache, checked and timed as quant_paged_case
    does (held per element as phase `decode_kernels` holds it; at unit
    descales equal bits to the bf16 instance from the rows kernel, held by
    the tolerance from the split-KV kernel)."""
    c, q, k, v, lens, kw = quant_decode_inputs(name, QUANT[dtype_name], form,
                                               seed)

    def call(kc=k, vc=v, **over):
        return flash_attention_decode_general(q, kc, vc, lens,
                                              **dict(kw, **over))

    (out, lse), extra = peak_extra_bytes(call)
    again = call()
    ref_out, ref_lse = flash_attention_decode_ref(q.float(), k, v, lens, **kw)
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[finite].abs().max()) if finite.any() else 0.0
    checked = held(out, ref_out)
    ok = bool(checked["err_over_limit"] <= 1 and lse_err <= ATTN_LSE_TOL
              and torch.equal(finite, torch.isfinite(lse)))
    del ref_out, ref_lse
    ones = torch.ones_like(kw["k_scale"])
    unit = call(k_scale=ones, v_scale=ones)
    k16, v16 = k.to(torch.bfloat16), v.to(torch.bfloat16)
    bf16 = call(k16, v16, k_scale=None, v_scale=None)
    stable = all(torch.equal(a, b) for a, b in zip((out, lse), again))
    unit_equal = all(torch.equal(a, b) for a, b in zip(unit, bf16))
    rows = c["sq"] * c["h"] // c["hk"]
    splits = fd.splits_of(q, k, kw.get("block_table"),
                          window_left=kw["window_left"],
                          attention_chunk=kw["attention_chunk"],
                          sink_token_length=kw["sink_token_length"])
    split = rows <= fd.SPLIT_ROWS or splits > 1
    unit_checked = held(unit[0], bf16[0].float())
    mask = decode_masks(c, lens, kw, int(lens.max()))
    pairs = int(mask.sum()) * c["h"]
    kv_rows = int(mask.any(dim=2).sum()) * c["hk"]
    del mask
    counts = (flash_attention_decode_general.launches,
              flash_attention_decode_general.combine_launches)
    times = dict(ms=cuda_ms(call),
                 bf16_ms=cuda_ms(lambda: call(k16, v16, k_scale=None,
                                              v_scale=None)))
    if c["sq"] == 1:
        times.update(graph_ms=graph_ms(call),
                     bf16_graph_ms=graph_ms(lambda: call(
                         k16, v16, k_scale=None, v_scale=None)))
    (flash_attention_decode_general.launches,
     flash_attention_decode_general.combine_launches) = counts
    del k16, v16, bf16
    bound_ms, bound_by = decode_bound(c, pairs, kv_rows, kv_bytes=1)
    cache_bytes = k.numel() + v.numel()
    result = dict(
        phase="quant_kernels", kernel="general_decode", case=name,
        kv_dtype=dtype_name, descales=form, b=c["b"], sq=c["sq"], h=c["h"],
        hk=c["hk"], d=c["d"], page=c["page"], out=checked,
        lse_max_abs_err=lse_err, tolerance=ATTN_TOLERANCE,
        design="split-kv" if split else "rows", num_splits=splits,
        bit_stable=stable, unit_descales_equal_bf16_bits=unit_equal,
        unit_descales_vs_bf16=unit_checked,
        **times, plain_ms=cuda_ms(
            lambda: flash_attention_decode_ref(q, k, v, lens, **kw), reps=3,
            warmup=1),
        bound_ms=bound_ms, bound_by=bound_by,
        bf16_bound_ms=decode_bound(c, pairs, kv_rows)[0],
        cache_mb=cache_bytes / 1e6, call_workspace_mb=extra / 1e6,
        library_ms=None,
        library="none: no single PyTorch call takes a 1-byte cache",
        ok=bool(ok and stable and extra < cache_bytes and (
            unit_equal or (split and unit_checked["err_over_limit"] <= 1))))
    emit(result)
    check(result["ok"], f"quant_kernels: kernel 5 {name} {dtype_name} {form}")
    return result


def quant_kernels_phase():
    """Every 1-byte instance family of kernels 4 and 5 at the main paths'
    shapes: int8 and e4m3, fused and split pools (kernel 4), (hk,) and
    (b, hk) descales. Returns {key: result}."""
    results, seed = {}, 300
    for case in QUANT_PAGED:
        for dtype_name in QUANT:
            for fused in (True, False):
                for form in ("hk", "b-hk"):
                    key = ("paged_decode", case, dtype_name, fused, form)
                    results[key] = quant_paged_case(case, dtype_name, fused,
                                                    form, seed)
                    seed += 1
    for name in QUANT_DECODE:
        for dtype_name in QUANT:
            for form in ("hk", "b-hk"):
                key = ("general_decode", name, dtype_name, form)
                results[key] = quant_decode_case(name, dtype_name, form, seed)
                seed += 1
                gc.collect()
                torch.cuda.empty_cache()
    return results


def quant_fault_phase(seed=390):
    """The checks' power on 1-byte caches, each planted fault handed to the
    kernel alone: K and V descales swapped (distinct per head), a V descale
    applied twice (kernels 4 and 5), and an e4m3 pool launched as int8
    (kernel 4). Each must fail its case's check; the unfaulted call must
    pass."""
    q, k, v, lens, table, ks, vs, _ = quant_paged_inputs(
        1, True, torch.float8_e4m3fn, seed)
    kw = dict(fused_kv_dim=D, window_left=WINDOW)
    ref = flash_attention_decode_multipage_ref(q.float(), k, v, lens, table,
                                               k_scale=ks, v_scale=vs, **kw)
    faults = {"none": (k, ks, vs), "k/v descales swapped": (k, vs, ks),
              "v descale twice": (k, ks, vs * vs),
              "e4m3 pool as int8": (k.view(torch.int8), ks, vs)}
    results = []
    for fault, (pool, kd, vd) in faults.items():
        out, lse = flash_attention_decode_multipage(
            q, pool, v, lens, table, k_scale=kd, v_scale=vd, **kw)
        ok, max_err, lse_err = paged_held(out, lse, *ref)
        results.append(dict(kernel="paged_decode", fault=fault, held=ok,
                            max_abs_err=max_err, lse_max_abs_err=lse_err))
    c, q, k, v, lens, kw = quant_decode_inputs("decode", torch.int8, "b-hk",
                                               seed + 1)
    ref_out, _ = flash_attention_decode_ref(q.float(), k, v, lens, **kw)
    for fault, over in (("none", {}),
                        ("k/v descales swapped", dict(k_scale=kw["v_scale"],
                                                      v_scale=kw["k_scale"])),
                        ("v descale twice", dict(v_scale=kw["v_scale"] ** 2))):
        out, _ = flash_attention_decode_general(q, k, v, lens,
                                                **dict(kw, **over))
        checked = held(out, ref_out)
        results.append(dict(kernel="general_decode", fault=fault,
                            held=checked["err_over_limit"] <= 1,
                            err_over_limit=checked["err_over_limit"]))
    ok = all(r["held"] == (r["fault"] == "none") for r in results)
    emit(dict(phase="quant_fault", cases=results, ok=ok))
    check(ok, "quant_fault: a planted fault passed, or the unfaulted call "
              "failed")


def forced_logprobs(engine, prompts, forced):
    """Teacher-forced log-probabilities through the engine's own forward
    and pools: each prompt[:-1] by prefill chunks, then decode steps fed
    prompt[-1] and the forced tokens. Returns (the log-probability of each
    forced token, whether it is the step's argmax), each (n, steps)."""
    cfg, dev = engine.config, engine.device
    n, steps = len(prompts), len(forced[0])
    rng = np.random.RandomState(11)
    tables = np.full((n, cfg.max_pages_per_seq), cfg.num_pages, np.int32)
    ids = iter(rng.permutation(cfg.num_pages))
    for i, p in enumerate(prompts):
        for j in range(-(-(len(p) + steps) // cfg.page_size)):
            tables[i, j] = next(ids)
    tables_t = torch.from_numpy(tables).to(dev)
    chunk = cfg.prefill_chunk
    for i, p in enumerate(prompts):
        for start in range(0, len(p) - 1, chunk):
            ids_c = p[start:min(start + chunk, len(p) - 1)]
            tokens = np.zeros((1, chunk), np.int64)
            tokens[0, :len(ids_c)] = ids_c
            engine._apply(torch.from_numpy(tokens).to(dev),
                          torch.tensor([start], dtype=torch.int32, device=dev),
                          tables_t[i:i + 1])
    toks = torch.tensor([[p[-1]] for p in prompts], device=dev)
    offs = torch.tensor([len(p) - 1 for p in prompts], dtype=torch.int32,
                        device=dev)
    forced_t = torch.tensor(forced, device=dev)
    rows, top1 = [], []
    for s in range(steps):
        logits = engine._apply(toks, offs, tables_t)[:, -1]
        rows.append(torch.log_softmax(logits, dim=-1).gather(
            1, forced_t[:, s:s + 1])[:, 0])
        top1.append(logits.argmax(dim=-1) == forced_t[:, s])
        toks, offs = forced_t[:, s:s + 1], offs + 1
    return torch.stack(rows, dim=1), torch.stack(top1, dim=1)


def pool_bytes(caches):
    return sum(t.numel() * t.element_size() for entry in caches.values()
               for t in ((entry.k, entry.v) if hasattr(entry, "k")
                         else (entry,) if torch.is_tensor(entry) else entry)
               if t is not None)


# The JAX package's measured drift of its quantized serving path, mean
# |Δ logprob| against a bf16 cache in nats per token
# (benchmarks/QUANT_KV_ACCURACY.md, 12 layers): accuracy figures, no time.
QUANT_DRIFT = {"int8": 0.0247, "fp8": 0.0572}


def quant_serve_phase(engine, model, seed=2, max_new=32):
    """LLMEngine on 1-byte pools at the serve phase's traffic (its 8 prompts,
    32 new tokens): int8 at per-layer amax/127 scales read from the bf16
    engine's pools (the JAX package's recipe,
    benchmarks/QUANT_KV_ACCURACY.md), and fp8 (e4m3) at scale 1.0. Against
    the bf16 engine run in this phase: the bf16 tokens teacher-forced
    through each engine, whose mean |Δ logprob| must stay within twice the
    JAX package's measured drift (QUANT_DRIFT); pool bytes half of bf16's;
    launches = layers x steps; decode tokens/s, every engine graphed (its
    step programs replayed from CUDA graphs, captured by `warm_up` before
    the timed run). Each quantized engine's tokens equal those of an eager
    engine (cg=False) of its kind on the same traffic, and its decode
    logits are compared with that engine's in bits. The JAX test's greedy-token
    rule (every sequence agrees for >= 2 tokens, the agreeing prefixes hold
    >= 60% of the tokens) is reported, not required: with random weights at
    these widths the top two logits of a step lie closer than the drift of
    either cache (one flipped token sends the rest of a greedy sequence
    elsewhere), so it measures the weights' near-ties, not the cache."""
    c = model.config
    lens, prompts = serve_prompts(c.vocab_size, seed)

    def run(eng):
        warm_up(eng)
        p0, d0 = eng.prefill_steps, eng.decode_steps
        s0 = dict(eng.seconds)
        flash_attention_decode_multipage.launches = 0
        eng.record, eng.decode_logits = True, []
        outs = eng.generate(prompts, max_new)
        eng.record = False
        steps = eng.prefill_steps - p0 + eng.decode_steps - d0
        decode_s = eng.seconds["decode"] - s0["decode"]
        return outs, dict(
            graphed=eng.graphs["decode"].captured,
            decode_tokens_per_s=sum(len(o) for o in outs) / decode_s,
            prefill_s=eng.seconds["prefill"] - s0["prefill"],
            decode_s=decode_s, steps=steps,
            launches=flash_attention_decode_multipage.launches,
            launches_ok=flash_attention_decode_multipage.launches
            == c.n_layer * steps)

    base, base_stats = run(engine)
    engine.decode_logits = []
    base_lp, base_top1 = forced_logprobs(engine, prompts, base)
    scales = {i: max(float(pool.abs().amax()), 1e-6) / 127.0
              for i, pool in engine.caches.items()}
    result = dict(phase="quant_serve", requests=len(prompts),
                  prompt_lens=lens.tolist(), max_new_tokens=max_new,
                  bf16=dict(base_stats, pool_gb=pool_bytes(engine.caches) / 1e9),
                  int8_scales=[min(scales.values()), max(scales.values())])
    ok = base_stats["launches_ok"]
    for kind, scale in (("int8", scales), ("fp8", 1.0)):
        config = dataclasses.replace(ENGINE, kv_cache_dtype=kind,
                                     kv_cache_scale=scale)
        eager = TimedEngine(model, config, device="cuda", cg=False)
        eager_outs, eager_stats = run(eager)
        eager_logits = eager.decode_logits
        del eager
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = TimedEngine(model, config, device="cuda")
        outs, stats = run(eng)
        tokens_equal = outs == eager_outs
        logits_equal = (len(eng.decode_logits) == len(eager_logits) and all(
            a[0] == b[0] and torch.equal(a[1], b[1])
            for a, b in zip(eng.decode_logits, eager_logits)))
        del eager_logits
        eng.decode_logits = []
        prefixes = []
        for gb, gq in zip(base, outs):
            n = 0
            while n < len(gb) and gb[n] == gq[n]:
                n += 1
            prefixes.append(n)
        lp, top1 = forced_logprobs(eng, prompts, base)
        drift = (lp - base_lp).abs()
        tokens_ok = (min(prefixes) >= 2
                     and sum(prefixes) >= int(0.6 * max_new * len(base)))
        half = 2 * pool_bytes(eng.caches) == pool_bytes(engine.caches)
        drift_ok = float(drift.mean()) <= 2 * QUANT_DRIFT[kind]
        result[kind] = dict(
            stats, tokens_equal_to_eager=tokens_equal,
            logits_equal_to_eager_bits=logits_equal,
            eager=eager_stats,
            decode_tokens_per_s_over_eager=stats["decode_tokens_per_s"]
            / eager_stats["decode_tokens_per_s"],
            pool_gb=pool_bytes(eng.caches) / 1e9, pools_half=half,
            agreeing_prefixes=prefixes, tokens_rule=tokens_ok,
            teacher_forced_top1=float(top1.float().mean()),
            bf16_teacher_forced_top1=float(base_top1.float().mean()),
            drift_limit=2 * QUANT_DRIFT[kind], drift_ok=drift_ok,
            decode_tokens_per_s_over_bf16=stats["decode_tokens_per_s"]
            / base_stats["decode_tokens_per_s"],
            mean_abs_dlogprob=float(drift.mean()),
            p99_abs_dlogprob=float(drift.flatten().quantile(0.99)),
            max_abs_dlogprob=float(drift.max()),
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        ok = (ok and drift_ok and half and stats["launches_ok"]
              and eager_stats["launches_ok"] and tokens_equal)
        del eng
        torch.cuda.empty_cache()
    result["ok"] = ok
    emit(result)
    check(ok, "quant_serve: the logprob drift, the pools' bytes, the "
              "launches or the graphed engine's tokens against the eager "
              "engine's failed")
    return result


def quant_kernel_entry(quant, qserve, qvllm, logs, kernel):
    """The 1-byte instances of kernel 4 or 5 for the kernels line: their
    times beside the bf16 instance's in the same case, bounds at 1 byte per
    K/V element, and ptxas registers and spills by pool kind."""
    rows = {}
    for key, r in quant.items():
        if key[0] != kernel:
            continue
        if r["descales"] != "hk" or (kernel == "paged_decode" and not r["fused"]):
            continue
        rows[f"{r['case']}/{r['kv_dtype']}"] = {
            k: r.get(k) for k in ("ms", "graph_ms", "bf16_ms", "bf16_graph_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "bf16_bound_ms")}
    errs = [r.get("max_abs_err", r.get("out", {}).get("max_abs_err", 0.0))
            for key, r in quant.items() if key[0] == kernel]
    if kernel == "paged_decode":
        kinds = {"same": [], "int8": [], "e4m3": []}
        for name, regs in ptxas_named({"paged_decode": logs["paged_decode"]},
                                      "paged_").items():
            kinds[paged_kind(name)].append(regs)
        launches = dict(quant_serve_int8=qserve["int8"]["launches"],
                        quant_serve_fp8=qserve["fp8"]["launches"],
                        quant_vllm=qvllm["launches"]["paged_decode"])
    else:
        kinds = {src: ptxas_of({src: logs[src]}, "decode_")
                 for src in ("decode_int8", "decode_e4m3", "decode_scaled")}
        launches = {}
    return dict(cases=rows, max_abs_err=max(errs), ptxas_by_kind=kinds,
                launches_by_path=launches)


def paged_kind(name):
    """The pool kind of a kernel 4 instance from its mangled name: its
    element type is its last template argument (int8_t mangles as `a`)."""
    return ("e4m3" if "__nv_fp8_e4m3" in name
            else "int8" if "EaEEv" in name else "same")


def ptxas_named(logs, fragment):
    """{mangled name: [registers, spill store bytes, spill load bytes]} of
    every kernel whose name holds `fragment`."""
    found, name, spills = {}, None, (0, 0)
    for line in (ln for log in logs.values() for ln in log.splitlines()):
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and fragment in name:
            found[name] = [int(m.group(1)), *spills]
            name = None
    return found


def vllm_alibi_phase():
    """The vllm phase's scheduler loop at Baichuan-13B widths (40 heads of
    128, all 40 layers) with its ALiBi slopes on bf16 "phd" pools of page
    16: kernel 6's ALiBi instance on the mixed steps, kernel 5 on the
    decode-only steps."""
    w = BAICHUAN_13B
    return vllm_phase(layers=w["layers"], widths=dict(
        h=w["h"], hk=w["hk"], d=w["d"], window=(-1, -1),
        slopes=default_alibi_slopes(w["h"]).to("cuda"),
        model="Baichuan-13B attention widths, ALiBi"))


def varlen_feature_entry(vfeat, valibi, key, name, logs):
    """The kernels line's record of kernel 6, 7 or 8's feature instances
    (`key` fwd, dkv or dq): their source and ptxas registers, their launches
    on varlen_train_dropout's path (and vllm_alibi's, for the forward), and
    each varlen_features case's time beside its plain version's, its bound
    and SDPA's."""
    src = "flash_varlen_features" if key == "fwd" else "flash_varlen_bwd_features"
    frag = VARLEN_FEATURE_KERNELS[name]
    tensors = dict(fwd=("out",), dq=("dq", "delta"), dkv=("dk", "dv"))[key]
    cases = {}
    for case, r in vfeat.items():
        if case == "train_dropout" or f"{key}_ms" not in r:
            continue
        lib = r["library"]
        cases[case] = dict(
            ms=r[f"{key}_ms"], plain_ms=r[f"{key}_plain_ms"],
            bound_ms=r[f"{key}_bound_ms"], bound_by=r[f"{key}_bound_by"],
            library_ms=None if lib is None else lib[
                "fwd_ms" if key == "fwd" else "bwd_ms"],
            max_abs_err=max(r[t]["max_abs_err"] for t in tensors))
    paths = dict(varlen_train_dropout=vfeat["train_dropout"][
        "feature_launches"][name])
    if key == "fwd":
        paths["vllm_alibi"] = valibi["launches"]["flash_varlen_fwd_features"]
    return dict(source=f"flash_attn_tpu_torch/csrc/{src}.cu",
                ptxas=ptxas_of({src: logs.get(src, "")}, frag),
                launches_by_path=paths, cases=cases)


# -- MLA serving: DeepSeek-V2-Lite's latent attention --------------------------

# DeepSeek-V2-Lite, https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json:
# its attention and dense layers at their published widths. Cut, as the JAX
# model allows: no experts (every layer takes the dense SwiGLU MLP at
# intermediate_size 10944, the model's layer-0 form), no YaRN rope scaling
# (factor 40, mscale 0.707), the JAX module's softmax scale (dn + dr)^-0.5;
# random seeded weights.
DEEPSEEK_V2_LITE = dict(
    hidden_size=2048, num_hidden_layers=27, num_attention_heads=16,
    kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, intermediate_size=10944,
    vocab_size=102400, rms_norm_eps=1e-6, rope_theta=10000.0,
    tie_word_embeddings=False)
MLA_H, MLA_D, MLA_DV = 16, 64, 512  # query heads, rope key, latent
MLA_SCALE = (128 + 64) ** -0.5
MLA_ENGINE = EngineConfig(max_batch_size=8, page_size=16, num_pages=2304,
                          max_pages_per_seq=264, prefill_chunk=256,
                          max_seqlen=8192)
MLA_GEN_BATCH, MLA_GEN_PROMPT, MLA_GEN_NEW = 4, 2048, 32
# Per (query head, visible key): the score 2 (d + dv), P C 2 dv.
MLA_FLOPS_PER_PAIR = 2 * (MLA_D + MLA_DV) + 2 * MLA_DV


def mla_config():
    c = DEEPSEEK_V2_LITE
    return GPTConfig(
        vocab_size=c["vocab_size"], n_positions=0, n_embd=c["hidden_size"],
        n_layer=c["num_hidden_layers"], n_head=c["num_attention_heads"],
        n_inner=c["intermediate_size"], activation_function="swiglu",
        rms_norm=True, layer_norm_epsilon=c["rms_norm_eps"],
        rotary_emb_base=c["rope_theta"], attn_type="mla",
        kv_lora_rank=c["kv_lora_rank"], q_lora_rank=c["q_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        qkv_proj_bias=False, out_proj_bias=False, mlp_fc1_bias=False,
        mlp_fc2_bias=False, tie_word_embeddings=c["tie_word_embeddings"],
        dtype=torch.bfloat16)


# name -> the call: kernel 4 over the engine's page-16 pools (decode at
# b 8 over the serve contexts, fused and split; a 256-token prefill chunk;
# a decode at 32768), kernel 5 over generate's contiguous caches (its decode
# step at b 4), kernel 1's cache-free qv forward of a 4096-token sequence,
# and its d-64 / dv-512 forward without qv (the kHasQv=false instances that
# flash_attn_func takes for a 512-wide v).
MLA_CASES = {
    "decode-fused": dict(kernel=4, fused=True, sq=1, lens=DECODE_LENS),
    "decode-split": dict(kernel=4, fused=False, sq=1, lens=DECODE_LENS),
    "prefill-chunk-256": dict(kernel=4, fused=True, sq=256, lens=DECODE_LENS),
    "decode-ctx32768": dict(kernel=4, fused=True, sq=1, lens=(32768,) * 8),
    "decode-contiguous": dict(
        kernel=5, sq=1, lens=(MLA_GEN_PROMPT + MLA_GEN_NEW - 1,) * 4,
        smax=MLA_GEN_PROMPT + MLA_GEN_NEW),
    "fwd-qv-s4096": dict(kernel=1, b=2, s=4096),
    "fwd-noqv-s4096": dict(kernel=1, b=2, s=4096, qv=False),
}
MLA_TOLERANCE = (f"|out-ref| <= {OUT_ATOL} + {OUT_RTOL}|ref|, |lse-ref| <= "
                 f"{LSE_ATOL}; share = the largest error over its limit")


def mla_share(out, lse, ref_out, ref_lse):
    """(share of the tolerance used: max over out of |out - ref| / (atol +
    rtol |ref|) and over the finite lse of |lse - ref| / atol; it must be
    <= 1, and rows that see nothing must agree; max abs error of out)."""
    err = (out.float() - ref_out.float()).abs()
    share = float((err / (OUT_ATOL + OUT_RTOL * ref_out.float().abs())).max())
    fin = torch.isfinite(ref_lse)
    if fin.any():
        share = max(share, float((lse - ref_lse)[fin].abs().max()) / LSE_ATOL)
    if not (torch.isfinite(out).all() and torch.equal(fin, torch.isfinite(lse))):
        share = float("inf")
    return share, float(err.max())


def mla_inputs(name, seed):
    """The seeded inputs of an MLA kernel case: a dict with the kernel's
    call, its plain version's, the yardstick's (one SDPA call over [q | qv]
    . [k_rope | latent]^T with V = latent, on the cache gathered
    contiguous), the bound and the tensors."""
    c = MLA_CASES[name]
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    if c["kernel"] == 1:
        b, s = c["b"], c["s"]
        q, k = randn(b, MLA_H, s, MLA_D), randn(b, 1, s, MLA_D)
        v = randn(b, 1, s, MLA_DV)
        qv = randn(b, MLA_H, s, MLA_DV) if c.get("qv", True) else None
        kw = dict(qv=qv, causal=True, softmax_scale=MLA_SCALE)
        pairs = MLA_H * b * s * (s + 1) // 2
        qd = MLA_D + (MLA_DV if qv is not None else 0)  # the score's depth
        nbytes = b * s * (2 * MLA_H * (qd + MLA_DV) + 2 * (MLA_D + MLA_DV)
                          + 4 * MLA_H)
        lib_q = q if qv is None else torch.cat([q, qv], -1)
        lib_k = k if qv is None else torch.cat([k, v], -1)
        return dict(
            kernel=lambda: flash_attention_fwd(q, k, v, **kw),
            plain=lambda: flash_attention_fwd_ref(q, k, v, **kw),
            ref=lambda: flash_attention_fwd_ref(
                q.float(), k.float(), v.float(),
                qv=None if qv is None else qv.float(), causal=True,
                softmax_scale=MLA_SCALE),
            library=lambda: F.scaled_dot_product_attention(
                lib_q, lib_k, v, is_causal=True, scale=MLA_SCALE,
                enable_gqa=True),
            pairs=pairs, nbytes=nbytes, flops_per_pair=2 * qd + 2 * MLA_DV,
            b=b, sq=s, ctx=[s] * b, design="rows")
    lens = np.asarray(c["lens"])
    b, sq = len(lens), c["sq"]
    q, qv = randn(b, sq, MLA_H, MLA_D), randn(b, sq, MLA_H, MLA_DV)
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    if c["kernel"] == 4:
        page = MLA_ENGINE.page_size
        max_pages = -(-int(lens.max()) // page)
        npages = b * max_pages + 1
        table = torch.from_numpy(rng.permutation(npages - 1)[:b * max_pages]
                                 .reshape(b, max_pages).astype(np.int32)).to(dev)
        if c["fused"]:
            pool = allocate_fused_paged_kv_cache(npages, page, 1, MLA_D,
                                                 MLA_DV, device=dev)
            pool.normal_(generator=gen)
            pools = (pool, None)
            views = (pool[..., :MLA_D], pool[..., 128:128 + MLA_DV])
            pkw = dict(fused_kv_dim=MLA_D, fused_kv_dim_v=MLA_DV)
        else:
            pools = views = (randn(npages, 1, page, MLA_D),
                             randn(npages, 1, page, MLA_DV))
            pkw = {}
        kw = dict(qv=qv, softmax_scale=MLA_SCALE, **pkw)
        args = (q, *pools, lens_t, table)
        kernel = lambda: flash_attention_decode_multipage(*args, **kw)
        plain = lambda: flash_attention_decode_multipage_ref(*args, **kw)
        ref = lambda: flash_attention_decode_multipage_ref(
            *args, out_dtype=torch.float32, **kw)
        tl = table.long()
        kg, vg = (x[tl].permute(0, 2, 1, 3, 4).reshape(b, 1, -1, x.shape[-1])
                  for x in views)
        extra = dict(args=args, kw=kw, table=table, views=views)
        table_bytes = 4 * table.numel()
    else:
        smax = c["smax"]
        kg, vg = randn(b, 1, smax, MLA_D), randn(b, 1, smax, MLA_DV)
        kw = dict(qv=qv, softmax_scale=MLA_SCALE)
        kernel = lambda: flash_attention_decode_general(q, kg, vg, lens_t, **kw)
        plain = lambda: flash_attention_decode_ref(q, kg, vg, lens_t, **kw)
        ref = lambda: flash_attention_decode_ref(
            q, kg, vg, lens_t, out_dtype=torch.float32, **kw)
        extra = {}
        table_bytes = 0
    lib_k = torch.cat([kg, vg], -1).contiguous()
    lib_v = vg.contiguous()
    lib_q = torch.cat([q, qv], -1).transpose(1, 2)
    cols = torch.arange(lib_k.shape[2], device=dev)[None, None]
    pos = (lens_t.long()[:, None, None] - sq
           + torch.arange(sq, device=dev)[None, :, None])
    mask = ((cols < lens_t.long()[:, None, None]) & (cols <= pos))[:, None]
    pairs = MLA_H * sum(int(L) * sq - sq * (sq - 1) // 2 for L in lens)
    nbytes = (1152 * int(lens.sum()) + b * sq * MLA_H * 2 * (MLA_D + 2 * MLA_DV)
              + b * MLA_H * sq * 4 + table_bytes + 4 * b)
    return dict(
        kernel=kernel, plain=plain, ref=ref,
        library=lambda: F.scaled_dot_product_attention(
            lib_q, lib_k, lib_v, attn_mask=mask, scale=MLA_SCALE,
            enable_gqa=True),
        pairs=pairs, nbytes=nbytes, b=b, sq=sq, ctx=lens.tolist(),
        design="split-kv" if sq * MLA_H <= 16 else "rows",
        q=q, qv=qv, lens=lens_t, **extra)


def mla_bound(pairs, nbytes, flops_per_pair=MLA_FLOPS_PER_PAIR):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops_per_pair * pairs / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def mla_case(name, seed):
    """One MLA kernel case: the kernel against its plain version (fp32) on
    the same inputs, twice for equal bits, timed (eager, from a CUDA graph
    for decode steps), beside its plain version, the SDPA yardstick and the
    card's bound for the work."""
    c = MLA_CASES[name]
    t = mla_inputs(name, seed)
    out, lse = t["kernel"]()
    out2, lse2 = t["kernel"]()
    torch.cuda.synchronize()
    bits_equal = torch.equal(out, out2) and torch.equal(lse, lse2)
    del out2, lse2
    ref_out, ref_lse = t["ref"]()
    share, max_err = mla_share(out, lse, ref_out, ref_lse)
    del ref_out, ref_lse
    counts = (flash_attention_fwd.launches, flash_attention_fwd.qv_launches,
              flash_attention_decode_multipage.launches,
              flash_attention_decode_multipage.qv_launches,
              flash_attention_decode_multipage.combine_launches,
              flash_attention_decode_general.launches,
              flash_attention_decode_general.qv_launches,
              flash_attention_decode_general.combine_launches)
    ms = cuda_ms(t["kernel"], reps=10 if c["kernel"] == 1 else 20)
    kernel_graph_ms = (graph_ms(t["kernel"]) if t["design"] == "split-kv"
                       else None)
    plain_ms = cuda_ms(t["plain"], reps=3, warmup=1)
    library_ms = cuda_ms(t["library"], reps=5, warmup=1)
    (flash_attention_fwd.launches, flash_attention_fwd.qv_launches,
     flash_attention_decode_multipage.launches,
     flash_attention_decode_multipage.qv_launches,
     flash_attention_decode_multipage.combine_launches,
     flash_attention_decode_general.launches,
     flash_attention_decode_general.qv_launches,
     flash_attention_decode_general.combine_launches) = counts
    bound_ms, bound_by = mla_bound(
        t["pairs"], t["nbytes"],
        t.get("flops_per_pair", MLA_FLOPS_PER_PAIR))
    splits = (fdm.splits_of(t["q"], t["views"][0], t["table"], -1)
              if c["kernel"] == 4 else
              fdm.num_splits_for(t["b"], 1, 1, MLA_H, c["smax"], -1,
                                 fdm.sm_count(0)) if c["kernel"] == 5 else 1)
    ok = share <= 1.0 and bits_equal
    result = dict(
        phase="mla_kernels", case=name, kernel=c["kernel"], b=t["b"],
        sq=t["sq"], h=MLA_H, hk=1, d=MLA_D, dv=MLA_DV,
        has_qv=c.get("qv", True), contexts=[min(t["ctx"]), max(t["ctx"])],
        cache=("fused page-16 pool" if c.get("fused") else "split page-16 pools"
               if c["kernel"] == 4 else "contiguous" if c["kernel"] == 5
               else "dense (b, s, h, .)"),
        design=t["design"], num_splits=splits, max_abs_err=max_err,
        tolerance_share=share, tolerance=MLA_TOLERANCE,
        bits_equal_run_to_run=bits_equal, ms=ms, graph_ms=kernel_graph_ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, bound_share=bound_ms / ms,
        visible_pairs=t["pairs"], bytes=t["nbytes"], ok=ok)
    emit(result)
    check(ok, f"mla_kernels case {name}: off its plain version or not equal "
              "in bits run to run")
    return result


def mla_fault_phase(seed=97, num_splits=3):
    """The MLA checks' power: planted faults whose share of the tolerance
    must read > 1: the qv term dropped (the kernel handed a zero qv), the
    V section read at offset 64 instead of 128 of the fused pool (the
    kernel handed that view), and the plain split schedule with split 1
    starting one key late (at contexts of 70-200 keys over three splits,
    where one key carries weight); the kernel's own three-split call on
    those inputs must pass, and so must its calls with lengths past the
    keys the cache holds (a page table or a contiguous cache too short),
    where it sees only the cache's keys, as the plain versions do."""
    t = mla_inputs("decode-fused", seed)
    ref_out, ref_lse = t["ref"]()
    shares = {}
    kw = dict(t["kw"], qv=torch.zeros_like(t["qv"]))
    shares["qv_dropped"] = mla_share(
        *flash_attention_decode_multipage(*t["args"], **kw), ref_out,
        ref_lse)[0]
    pool = t["args"][1]
    shares["v_at_offset_64"] = mla_share(
        *mla_attn.decode(t["q"], t["qv"], pool[..., :MLA_D],
                         pool[..., MLA_D:MLA_D + MLA_DV], t["lens"],
                         t["table"], fdm.splits_of(t["q"], t["views"][0],
                                                   t["table"], -1),
                         MLA_SCALE), ref_out, ref_lse)[0]
    del ref_out, ref_lse
    # Short contexts over three splits.
    lens = np.random.RandomState(seed).randint(70, 201, t["b"])
    lens_t = torch.from_numpy(lens.astype(np.int32)).cuda()
    q, qv, table = t["q"], t["qv"], t["table"]
    ref_out, ref_lse = flash_attention_decode_multipage_ref(
        q, pool, None, lens_t, table, out_dtype=torch.float32, **t["kw"])
    shares["kernel_three_splits"] = mla_share(
        *mla_attn.decode(q, qv, *t["views"], lens_t, table, num_splits,
                         MLA_SCALE), ref_out, ref_lse)[0]
    moved = [[(lo + (i == 1 and hi > lo), hi) for i, (lo, hi) in
              enumerate(split_ranges(int(n), 1, -1, num_splits))]
             for n in lens]
    shares["split_boundary_moved"] = mla_share(
        *flash_attention_decode_multipage_split_ref(
            q, pool, None, lens_t, table, num_splits, ranges=moved,
            **t["kw"]), ref_out, ref_lse)[0]
    # Lengths past the cache: kernel 4 past its table's pages, kernel 5
    # past a 256-key contiguous cache.
    cap = table.shape[1] * MLA_ENGINE.page_size
    over = torch.full_like(t["lens"], cap + 7)
    args = (q, pool, None, over, table)
    shares["kernel_lengths_past_pages"] = mla_share(
        *flash_attention_decode_multipage(*args, **t["kw"]),
        *flash_attention_decode_multipage_ref(*args, out_dtype=torch.float32,
                                              **t["kw"]))[0]
    smax = 256
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kc, vc = (torch.randn(4, 1, smax, w, generator=gen, device="cuda",
                          dtype=torch.bfloat16) for w in (MLA_D, MLA_DV))
    lens4 = torch.tensor([smax, smax + 5, smax + 300, 3 * smax],
                         dtype=torch.int32, device="cuda")
    kw = dict(qv=qv[:4], softmax_scale=MLA_SCALE)
    shares["kernel_lengths_past_smax"] = mla_share(
        *flash_attention_decode_general(q[:4], kc, vc, lens4, **kw),
        *flash_attention_decode_ref(q[:4], kc, vc, lens4,
                                    out_dtype=torch.float32, **kw))[0]
    ok = all(v <= 1.0 if k.startswith("kernel_") else v > 1.0
             for k, v in shares.items())
    emit(dict(phase="mla_fault", tolerance=MLA_TOLERANCE,
              short_contexts=lens.tolist(), num_splits=num_splits,
              tolerance_share=shares, ok=ok))
    check(ok, "mla_fault: a planted fault passes the check, or one of the "
              "kernel's own calls (three splits, lengths past the cache) "
              "fails it")


def _mla_counts():
    return dict(
        flash_fwd_qv=flash_attention_fwd.qv_launches,
        flash_fwd=flash_attention_fwd.launches,
        paged_decode=flash_attention_decode_multipage.launches,
        paged_decode_qv=flash_attention_decode_multipage.qv_launches,
        general_decode=flash_attention_decode_general.launches,
        general_decode_qv=flash_attention_decode_general.qv_launches)


def _zero_mla_counts():
    flash_attention_fwd.launches = flash_attention_fwd.qv_launches = 0
    flash_attention_decode_multipage.launches = 0
    flash_attention_decode_multipage.qv_launches = 0
    flash_attention_decode_multipage.combine_launches = 0
    flash_attention_decode_general.launches = 0
    flash_attention_decode_general.qv_launches = 0
    flash_attention_decode_general.combine_launches = 0


def mla_serve_phase(model):
    """LLMEngine on the DeepSeek-V2-Lite-width model, fused latent pools,
    serving the serve phase's traffic (8 prompts, seed 2, 32 new tokens):
    eagerly (cg=False), then graphed; equal tokens; on both every attention
    launch of the steps a qv launch of kernel 4 (layers x steps); the
    pools' bytes against an MHA cache at the same widths; prefill and
    decode tokens/s. Returns (result, the graphed engine)."""
    c = model.config
    lens, prompts = serve_prompts(c.vocab_size)
    runs = {}
    engine = None
    for cg in (False, True):
        engine = TimedEngine(model, MLA_ENGINE, device="cuda", cg=cg)
        outs, stats = serve_run(engine, prompts)
        runs[cg] = (outs, stats)
        if not cg:
            pools = pool_bytes(engine.caches)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    (eager_outs, eager), (outs, graphed) = runs[False], runs[True]
    tokens = MLA_ENGINE.page_size * (MLA_ENGINE.num_pages + 1)
    mha_bytes = c.n_layer * tokens * c.n_head * (
        c.qk_nope_head_dim + c.qk_rope_head_dim + c.v_head_dim) * 2
    launches_ok = all(s["launches_ok"] and s["qv_launches"] == s["kernel_launches"]
                      for s in (eager, graphed))
    ok = launches_ok and outs == eager_outs and graphed["graphed"]
    for stats in (eager, graphed):
        stats["prefill_ms_per_step"] = (1e3 * stats["prefill_s"]
                                        / max(stats["prefill_steps"], 1))
    keys = ("prefill_tokens_per_s", "decode_tokens_per_s", "decode_ms_per_step",
            "prefill_ms_per_step",
            "prefill_steps", "decode_steps", "kernel_launches", "qv_launches",
            "combine_launches", "layers_x_steps", "peak_memory_gb",
            "capture_s", "wall_s")
    result = dict(
        phase="mla_serve", model="DeepSeek-V2-Lite attention widths, dense "
        "MLP 10944 on all 27 layers, random weights (seed 0)",
        layers=c.n_layer, prompt_lens=lens.tolist(), new_tokens=SERVE_NEW,
        pool="fused rope|latent page pools, page 16, one KV head",
        pool_gb=pools / 1e9, mha_cache_gb=mha_bytes / 1e9,
        pool_over_mha=pools / mha_bytes,
        bytes_per_token_per_layer=dict(
            latent_pool=pools // (c.n_layer * tokens),
            latent_unpadded=2 * (c.qk_rope_head_dim + c.kv_lora_rank),
            mha_expanded=mha_bytes // (c.n_layer * tokens)),
        graphed={k: graphed[k] for k in keys},
        eager={k: eager[k] for k in keys},
        graphed_over_eager_decode=(graphed["decode_tokens_per_s"]
                                   / eager["decode_tokens_per_s"]),
        tokens_equal=outs == eager_outs, launches_ok=launches_ok, ok=ok)
    emit(result)
    check(ok, "mla_serve: graphed tokens differ from eager, or an attention "
              "launch that is not kernel 4's qv path")
    return result, engine


# Kernel 4's qv path by the names the profiler lists: the attention kernel
# (split-KV for decode, 64-row tiles for chunks) and the split-KV combine.
MLA_ATTEND = ("mla_attn_kernel",)
MLA_COMBINE = ("mla_combine_kernel",)


def mla_profile_phase(engine, model):
    """Where a graphed MLA step's time goes: `mla_serve`'s traffic (8
    prompts, seed 2, 32 new tokens) through the graphed engine once more,
    its prefill steps and then its decode steps under torch.profiler
    (device activity only), as profile_phase does for the MHA engine:
    device time by kernel beside the host wall, per step, and kernel 4's
    qv kernels' share. The same traffic runs first without the profiler,
    for the wall per step without the profiler's cost. Fails if the
    profiler lists no time of kernel 4's qv kernel in either kind of
    step."""
    c = model.config
    _, prompts = serve_prompts(c.vocab_size)
    result = dict(phase="mla_profile", requests=len(prompts),
                  max_new_tokens=SERVE_NEW, layers=c.n_layer)
    for profiled in (False, True):
        base = max(engine.outputs.keys(), default=-1) + 1
        ids = range(base, base + len(prompts))
        for rid, prompt in zip(ids, prompts):
            engine.add_request(rid, prompt, SERVE_NEW)
        for kind in ("prefill", "decode"):
            steps, by_kernel, wall_ms, moved = _profiled_steps(
                engine, ids, kind, profiled)
            if not profiled:
                result[kind] = dict(steps_unprofiled=steps,
                                    wall_ms_unprofiled=wall_ms)
                continue
            entry = result[kind]
            _profile_entry(entry, engine, kind, steps, by_kernel, wall_ms,
                           moved, MLA_ATTEND, MLA_COMBINE)
            n = max(steps, 1)
            entry.update(
                wall_ms_per_step_unprofiled=(entry["wall_ms_unprofiled"]
                                             / max(entry["steps_unprofiled"], 1)),
                device_busy_ms_per_step=(entry["device_busy_ms"] or 0.0) / n,
                mla_kernel_ms_per_step=(entry["paged_decode_ms"] or 0.0) / n)
    result["ok"] = all(result[kind]["graphed"]
                       and (result[kind]["paged_decode_ms"] or 0.0) > 0.0
                       for kind in ("prefill", "decode"))
    emit(result)
    check(result["ok"], "mla_profile: the profiler listed no time of kernel "
                        "4's qv kernel, or a step was not graphed")
    return result


def mla_logits_phase(engine, model, prompt_len=2048, seed=1):
    """The model's cache-free logits (kernel 1's qv forward in every layer)
    over a 2048-token prompt against an fp32 plain forward (the expanded,
    un-absorbed MLA: utils.testing), and the engine's prefill-chunk and
    decode logits (logits_phase), each under the 2x bf16-eager contract."""
    c = model.config
    decode = logits_phase(engine, model, prompt_len=prompt_len, seed=seed,
                          phase="mla_logits_engine",
                          label="DeepSeek-V2-Lite attention widths, random "
                                "weights (seed 0)")
    rng = np.random.RandomState(seed + 1)
    ids = torch.from_numpy(rng.randint(0, c.vocab_size, (1, prompt_len))).cuda()
    _zero_mla_counts()
    with torch.no_grad():
        port = model(ids).float()[0]
    counts = _mla_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref32 = gpt_forward_ref(model, ids, dtype=torch.float32)[0]
    err_port = (port - ref32).abs().max().item()
    del port
    ref16 = gpt_forward_ref(model, ids, dtype=torch.bfloat16)[0].float()
    err_bf16 = (ref16 - ref32).abs().max().item()
    floor = LOGIT_FLOOR_FRACTION * ref32.abs().max().item()
    del ref16, ref32
    want = dict(flash_fwd_qv=c.n_layer, flash_fwd=c.n_layer)
    launches_ok = all(counts[k] == v for k, v in want.items())
    ok = err_port <= 2 * err_bf16 + floor and launches_ok
    result = dict(
        phase="mla_logits", cache_free=dict(
            prompt_len=prompt_len, positions_compared=prompt_len,
            max_abs_err_port=err_port, max_abs_err_bf16_eager=err_bf16,
            floor=floor, limit=2 * err_bf16 + floor, launches=counts,
            launches_expected=want),
        engine=dict((k, decode[k]) for k in (
            "max_abs_err_port", "max_abs_err_bf16_eager", "floor", "limit",
            "rows_compared", "argmax_agreement")),
        ok=ok)
    emit(result)
    check(ok, "mla_logits: cache-free logits outside the 2x bf16-eager "
              "contract, or a layer not on kernel 1's qv forward")
    return dict(result, limit=decode["limit"])


def mla_generate_phase(model, logits_limit, seed=6):
    """`generate(cg=True)` of the MLA model over contiguous latent caches
    (kernel 5's qv path in every layer, the prefill and each decode step),
    batch 4, 2048-token prompts, 32 new tokens, greedy with scores: every
    row's scores against an fp32 plain forward under the 2x bf16-eager
    contract, launches = layers x forwards, all qv launches; cg=False equal
    in bits; decode tokens/s from the walls of 32 and 16 new tokens."""
    c = model.config
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(
        0, c.vocab_size, (MLA_GEN_BATCH, MLA_GEN_PROMPT))).cuda()
    length = MLA_GEN_PROMPT + MLA_GEN_NEW
    _zero_mla_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, length, return_dict_in_generate=True,
                         output_scores=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _mla_counts()
    want = dict(general_decode=c.n_layer * MLA_GEN_NEW,
                general_decode_qv=c.n_layer * MLA_GEN_NEW, paged_decode=0,
                flash_fwd=0)
    launches_ok = all(counts[k] == v for k, v in want.items())
    seqs, scores = out.sequences, out.scores
    argmax_ok = bool(torch.equal(scores.argmax(-1), seqs[:, MLA_GEN_PROMPT + 1:]))
    torch.backends.cuda.matmul.allow_tf32 = False
    err_port = err_bf16 = ref_max = 0.0
    for i in range(MLA_GEN_BATCH):
        row = seqs[i:i + 1, :length - 1]
        ref32 = gpt_forward_ref(model, row, dtype=torch.float32)[
            0, MLA_GEN_PROMPT:]
        ref16 = gpt_forward_ref(model, row, dtype=torch.bfloat16)[
            0, MLA_GEN_PROMPT:].float()
        err_port = max(err_port, (scores[i] - ref32).abs().max().item())
        err_bf16 = max(err_bf16, (ref16 - ref32).abs().max().item())
        ref_max = max(ref_max, ref32.abs().max().item())
        del ref32, ref16
    floor = LOGIT_FLOOR_FRACTION * ref_max
    scores_ok = (bool(torch.isfinite(scores).all())
                 and err_port <= 2 * err_bf16 + floor)
    eager = model.generate(ids, length, return_dict_in_generate=True,
                           output_scores=True, cg=False)
    cg_equal = (torch.equal(eager.sequences, seqs)
                and torch.equal(eager.scores, scores))
    del eager, out, scores

    def timed(new, cg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids, MLA_GEN_PROMPT + new, cg=cg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    half = MLA_GEN_NEW // 2
    by_cg = {}
    for cg, name in ((True, "graphed"), (False, "eager")):
        walls = {new: min(timed(new, cg) for _ in range(2))
                 for new in (MLA_GEN_NEW, half)}
        step_s = (walls[MLA_GEN_NEW] - walls[half]) / (MLA_GEN_NEW - half)
        by_cg[name] = dict(whole_call_s=walls[MLA_GEN_NEW],
                           decode_ms_per_step=1e3 * step_s,
                           decode_tokens_per_s=MLA_GEN_BATCH / step_s)
    ok = argmax_ok and scores_ok and launches_ok and cg_equal
    result = dict(
        phase="mla_generate", batch=MLA_GEN_BATCH, prompt_len=MLA_GEN_PROMPT,
        new_tokens=MLA_GEN_NEW,
        cache=f"contiguous (rope (b, 1, {length}, 64), latent (b, 1, "
              f"{length}, 512)) bf16 per layer",
        max_abs_err_port=err_port, max_abs_err_bf16_eager=err_bf16,
        floor=floor, limit=2 * err_bf16 + floor, scores_ok=scores_ok,
        tokens_are_argmax_of_scores=argmax_ok, launches=counts,
        launches_expected=want, cg_equal_to_eager_bits=cg_equal, wall_s=wall,
        cg=by_cg, logits_limit_of_mla_logits=logits_limit, ok=ok)
    emit(result)
    check(ok, "mla_generate: scores outside the contract, a token not the "
              "argmax of its step, launches off the count, or cg=True not "
              "equal in bits to cg=False")
    return result


def mla_phases():
    """The MLA phases in order; returns what the kernels line needs."""
    cases = {name: mla_case(name, seed=300 + i)
             for i, name in enumerate(MLA_CASES)}
    mla_fault_phase()
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTLMHeadModel(mla_config(), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    emit(dict(phase="mla_model", layers=model.config.n_layer,
              params_b=sum(p.numel() for p in model.parameters()) / 1e9,
              memory_gb=torch.cuda.memory_allocated() / 1e9))
    serve, engine = mla_serve_phase(model)
    mla_profile_phase(engine, model)
    logits = mla_logits_phase(engine, model)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    gen = mla_generate_phase(model, logits["limit"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(cases=cases, serve=serve, logits=logits, generate=gen)


def mla_kernel_entries(mla, logs):
    """The kernels line's entries of the qv instances: kernel 4's and
    kernel 5's qv paths (csrc/mla_decode.cu) and kernel 1's qv forward
    (csrc/flash_fwd_qv.cu), each with its cases, registers and the
    launches of its main path (mla_serve graphed, mla_generate,
    mla_logits's cache-free forward)."""
    cases = mla["cases"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(case):
        return dict({k: cases[case][k] for k in keys},
                    graph_ms=cases[case]["graph_ms"],
                    tolerance_share=cases[case]["tolerance_share"],
                    has_qv=cases[case]["has_qv"],
                    shape=f"b={cases[case]['b']} sq={cases[case]['sq']} h=16 "
                          f"hk=1 d=64 dv=512, contexts "
                          f"{cases[case]['contexts']}, {cases[case]['cache']}")

    dec = {"mla_decode": logs.get("mla_decode", "")}
    fwd = {"flash_fwd_qv": logs.get("flash_fwd_qv", "")}
    k4 = [n for n, cs in MLA_CASES.items() if cs["kernel"] == 4]
    k1 = [n for n, cs in MLA_CASES.items() if cs["kernel"] == 1]
    return [
        dict(name="mla_decode_paged", route="cuda",
             source="flash_attn_tpu_torch/csrc/mla_decode.cu",
             replaces="flash_attn_tpu/kernels/flash_decode_multipage.py:65",
             path="kernel 4's qv path (qv term at :262)",
             launches=mla["serve"]["graphed"]["qv_launches"],
             launches_by_path=dict(
                 mla_serve=mla["serve"]["graphed"]["qv_launches"],
                 mla_serve_eager=mla["serve"]["eager"]["qv_launches"]),
             max_abs_err=max(cases[n]["max_abs_err"] for n in k4),
             **{k: cases["decode-fused"][k] for k in keys},
             shape=entry("decode-fused")["shape"],
             cases={n: entry(n) for n in k4},
             ptxas=dict(attn=ptxas_of(dec, "mla_attn_kernel"),
                        combine=ptxas_of(dec, "mla_combine_kernel"))),
        dict(name="mla_decode_contiguous", route="cuda",
             source="flash_attn_tpu_torch/csrc/mla_decode.cu",
             replaces="flash_attn_tpu/kernels/flash_decode.py:56",
             path="kernel 5's qv path (qv term at :187)",
             launches=mla["generate"]["launches"]["general_decode_qv"],
             max_abs_err=cases["decode-contiguous"]["max_abs_err"],
             **{k: cases["decode-contiguous"][k] for k in keys},
             graph_ms=cases["decode-contiguous"]["graph_ms"],
             shape=entry("decode-contiguous")["shape"],
             ptxas=dict(attn=ptxas_of(dec, "mla_attn_kernel"))),
        dict(name="flash_fwd_qv", route="cuda",
             source="flash_attn_tpu_torch/csrc/flash_fwd_qv.cu",
             replaces="flash_attn_tpu/kernels/flash_fwd.py:95",
             path="kernel 1's qv forward (qv term at :291)",
             launches=mla["logits"]["cache_free"]["launches"]["flash_fwd_qv"],
             max_abs_err=max(cases[n]["max_abs_err"] for n in k1),
             **{k: cases["fwd-qv-s4096"][k] for k in keys},
             shape=entry("fwd-qv-s4096")["shape"],
             cases={n: entry(n) for n in k1},
             ptxas=dict(attn=ptxas_of(fwd, "mla_attn_kernel"))),
    ]


# -- MLA training: kernels 2-3's qv backward, DeepSeek-V2-Lite in the trainer --

MLA_TRAIN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "configs", "deepseek-v2-lite-mla-synth.yaml")
MLA_TRAIN_STEPS, MLA_TRAIN_WARMUP = 20, 5
# name -> a backward call at DeepSeek-V2-Lite's attention widths (16 query
# heads over one latent head, d 64, dv 512): with qv (MLA training's) and
# without (the dv-512 backward), causal and not, at the trainer's b 2 and
# s 4096, and lengths that are not a multiple of 4 (LSE and delta rows off
# a 16-byte boundary), one in fp16.
MLA_BWD_CASES = {
    "qv-causal-s4096": dict(s=4096, causal=True),
    "qv-noncausal-s4096": dict(s=4096, causal=False),
    "qv-causal-s4001": dict(s=4001, causal=True),
    "qv-noncausal-s4001-fp16": dict(s=4001, causal=False,
                                    dtype=torch.float16),
    "noqv-causal-s4096": dict(s=4096, causal=True, qv=False),
    "noqv-noncausal-s4001": dict(s=4001, causal=False, qv=False),
}


def mla_bwd_inputs(s, causal, qv=True, dtype=torch.bfloat16, b=2, seed=0):
    """Seeded backward inputs (b, h, s, .) at MLA's widths, the plain
    forward's lse (fp32, from the same inputs) and the softmax scale."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    t = dict(q=randn(b, MLA_H, s, MLA_D), k=randn(b, 1, s, MLA_D),
             v=randn(b, 1, s, MLA_DV), do=randn(b, MLA_H, s, MLA_DV),
             qv=randn(b, MLA_H, s, MLA_DV) if qv else None, causal=causal,
             scale=MLA_SCALE if qv else MLA_D ** -0.5)
    up = {n: None if t[n] is None else t[n].float()
          for n in ("q", "k", "v", "qv")}
    _, t["lse"] = flash_attention_fwd_ref(
        up["q"], up["k"], up["v"], qv=up["qv"], causal=causal,
        softmax_scale=t["scale"])
    return t


def mla_bwd_run(t, heads=slice(None)):
    """The two kernels on `t` (query heads `heads` of it): (dq, delta,
    dqv, dk, dv)."""
    q, qv, do = (None if t[n] is None else t[n][:, heads]
                 for n in ("q", "qv", "do"))
    lse = t["lse"][:, heads].contiguous()
    dq, delta, dqv = mla_attn.backward_dq(q, qv, t["k"], t["v"], do, lse,
                                          t["scale"], t["causal"])
    dk, dv = mla_attn.backward_dkv(q, qv, t["k"], t["v"], do, lse, delta,
                                   t["scale"], t["causal"])
    return dq, delta, dqv, dk, dv


def mla_bwd_plain_args(t):
    """The plain versions' arguments on `t` in fp32: (args, kwargs)."""
    up = {n: None if t[n] is None else t[n].float()
          for n in ("q", "k", "v", "do", "qv")}
    kw = dict(qv=up["qv"], causal=t["causal"], softmax_scale=t["scale"])
    return (up["q"], up["k"], up["v"], up["do"], t["lse"]), kw


def mla_bwd_ref(t):
    """The plain versions in fp32 on the same inputs: (dq, delta, dqv, dk,
    dv), dqv None without qv."""
    args, kw = mla_bwd_plain_args(t)
    dq, delta, *dqv = _bwd_dq_ref(*args, **kw)
    dk, dv = _bwd_dkv_ref(*args, delta, **kw)
    return dq, delta, (dqv or [None])[0], dk, dv


MLA_BWD_NAMES = ("dq", "delta", "dqv", "dk", "dv")


def mla_bwd_held(got, ref):
    """{name: held(...)} of each output present in both."""
    return {n: held(g, r) for n, g, r in zip(MLA_BWD_NAMES, got, ref)
            if g is not None and r is not None}


def mla_bwd_bound(b, s, causal, has_qv, el=2):
    """Least times of the dQ and dK/dV kernels on this card: the flops of
    each visible (query head, key) pair (dQ: S 2 (d + dv) with qv, else
    2d, dP 2dv, dQ 2d, dQv 2dv; dK/dV: S, dP, P^T dO 2dv, dS^T Qv 2dv, dK
    2d; delta rides on P and dP), and the bytes each reads and writes
    once."""
    pairs = b * MLA_H * visible_pairs(s, s, causal, (-1, -1))
    sd = 2 * (MLA_D + (MLA_DV if has_qv else 0))
    flops = dict(dq=sd + 2 * MLA_DV + 2 * MLA_D + (2 * MLA_DV if has_qv else 0),
                 dkv=sd + 2 * MLA_DV + 2 * MLA_DV
                 + (2 * MLA_DV if has_qv else 0) + 2 * MLA_D)
    rows = b * MLA_H * s
    q_rows = rows * (MLA_D + (MLA_DV if has_qv else 0)) * el  # q, qv
    do_rows = rows * MLA_DV * el
    kv = b * s * (MLA_D + MLA_DV) * el
    stats = rows * 4  # lse, delta
    # dQ writes dq (and dqv) and delta; dK/dV reads delta, writes dk, dv.
    nbytes = dict(dq=2 * q_rows + do_rows + kv + 2 * stats,
                  dkv=q_rows + do_rows + 2 * kv + 2 * stats)
    out = {}
    for key in ("dq", "dkv"):
        t_ops = flops[key] * pairs / BF16_FLOPS_PER_S * 1e3
        t_bytes = nbytes[key] / HBM_BYTES_PER_S * 1e3
        out[key] = (max(t_ops, t_bytes),
                    "operations" if t_ops >= t_bytes else "bytes")
    return out, pairs


def mla_bwd_library_ms(t):
    """SDPA's backward over the concatenated operands ([q | qv] . [k |
    latent]^T, V the latent, enable_gqa): its forward+backward less its
    forward, the yardstick of kernels 2-3's qv instances; the port never
    calls it."""
    cat_q = (t["q"] if t["qv"] is None else torch.cat([t["q"], t["qv"]], -1))
    cat_k = (t["k"] if t["qv"] is None else torch.cat([t["k"], t["v"]], -1))
    lq, lk, lv = (x.detach().clone().requires_grad_()
                  for x in (cat_q, cat_k, t["v"]))

    def fwd():
        return F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=t["causal"], scale=t["scale"],
            enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (lq, lk, lv), t["do"])

    fwd_ms = cuda_ms(fwd, reps=5, warmup=1)
    return cuda_ms(fwd_bwd, reps=5, warmup=1) - fwd_ms


def mla_bwd_case(name, seed):
    """One backward case: both kernels against their plain versions (fp32)
    under ATTN_TOLERANCE, twice for equal bits, timed beside the plain
    versions, SDPA's backward and the card's bound."""
    c = MLA_BWD_CASES[name]
    has_qv = c.get("qv", True)
    t = mla_bwd_inputs(c["s"], c["causal"], has_qv,
                       c.get("dtype", torch.bfloat16), seed=seed)
    got = mla_bwd_run(t)
    again = mla_bwd_run(t)
    torch.cuda.synchronize()
    bits = all(x is None or torch.equal(x, y) for x, y in zip(got, again))
    del again
    checked = mla_bwd_held(got, mla_bwd_ref(t))
    dq_ms = cuda_ms(lambda: mla_attn.backward_dq(
        t["q"], t["qv"], t["k"], t["v"], t["do"], t["lse"], t["scale"],
        t["causal"]), reps=10)
    delta = got[1]
    dkv_ms = cuda_ms(lambda: mla_attn.backward_dkv(
        t["q"], t["qv"], t["k"], t["v"], t["do"], t["lse"], delta,
        t["scale"], t["causal"]), reps=10)
    args, kw = mla_bwd_plain_args(t)
    dq_plain_ms = cuda_ms(lambda: _bwd_dq_ref(*args, **kw), reps=2, warmup=1)
    dkv_plain_ms = cuda_ms(lambda: _bwd_dkv_ref(*args, delta, **kw), reps=2,
                           warmup=1)
    del args, kw
    library_bwd_ms = mla_bwd_library_ms(t)
    bounds, pairs = mla_bwd_bound(t["q"].shape[0], c["s"], c["causal"], has_qv,
                                  t["q"].element_size())
    worst = max(h["err_over_limit"] for h in checked.values())
    finite = all(bool(torch.isfinite(x).all()) for x in got if x is not None)
    ok = worst <= 1.0 and bits and finite
    result = dict(
        phase="mla_bwd_kernels", case=name, b=t["q"].shape[0], sq=c["s"],
        sk=c["s"], h=MLA_H, hk=1, d=MLA_D, dv=MLA_DV, has_qv=has_qv,
        causal=c["causal"], dtype=str(t["q"].dtype).split(".")[-1],
        held=checked, err_over_limit=worst, tolerance=ATTN_TOLERANCE,
        bits_equal_run_to_run=bits, dq_ms=dq_ms, dkv_ms=dkv_ms,
        dq_plain_ms=dq_plain_ms, dkv_plain_ms=dkv_plain_ms,
        library_bwd_ms=library_bwd_ms,
        dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
        dkv_bound_ms=bounds["dkv"][0], dkv_bound_by=bounds["dkv"][1],
        dq_bound_share=bounds["dq"][0] / dq_ms,
        dkv_bound_share=bounds["dkv"][0] / dkv_ms, visible_pairs=pairs,
        ok=ok)
    emit(result)
    check(ok, f"mla_bwd_kernels case {name}: off its plain version, not "
              "finite, or not equal in bits run to run")
    return result


def mla_bwd_fault_phase(s=2048, seed=98):
    """The backward checks' power: planted faults whose worst share of the
    tolerance must read > 1 against the plain versions: dV without its
    dS^T Qv term (the kernels' dV less that term, computed in fp32 from
    the plain pieces), a dQv the kernel never wrote (zeros), and one query
    head of the group left out of the dK/dV sum (the kernels handed heads
    1-15 of 16)."""
    t = mla_bwd_inputs(s, True, b=1, seed=seed)
    got = mla_bwd_run(t)
    ref = mla_bwd_ref(t)
    ok_clean = max(h["err_over_limit"] for h in mla_bwd_held(got, ref).values())
    # P^T dO alone, from the plain pieces, gives the dS^T Qv term of dV.
    s_raw = (torch.matmul(t["q"].float(), t["k"].float().transpose(-1, -2))
             + torch.matmul(t["qv"].float(), t["v"].float().transpose(-1, -2)))
    vis = visible_mask(s, s, normalize_window((-1, -1), True), s_raw.device)
    p = torch.where(vis, torch.exp(s_raw * t["scale"] - t["lse"][..., None]),
                    torch.zeros_like(s_raw))
    del s_raw
    pdo = torch.matmul(p.transpose(-1, -2), t["do"].float()).sum(1,
                                                                 keepdim=True)
    del p
    qv_term = ref[4] - pdo
    shares = dict(
        dv_without_dsT_qv=held(got[4].float() - qv_term, ref[4])[
            "err_over_limit"],
        dqv_not_written=held(torch.zeros_like(ref[2]), ref[2])[
            "err_over_limit"])
    part = mla_bwd_run(t, heads=slice(1, None))
    shares["one_head_left_out"] = max(held(part[3], ref[3])["err_over_limit"],
                                      held(part[4], ref[4])["err_over_limit"])
    caught = all(v > 1.0 for v in shares.values())
    ok = caught and ok_clean <= 1.0
    emit(dict(phase="mla_bwd_fault", b=1, s=s, h=MLA_H, causal=True,
              clean_err_over_limit=ok_clean, fault_err_over_limit=shares,
              every_fault_caught=caught, tolerance=ATTN_TOLERANCE, ok=ok))
    check(ok, "mla_bwd_fault: a planted fault passed the check, or the clean "
              "kernels failed it")


def _mla_train_counts():
    return dict(flash_fwd_qv=flash_attention_fwd.qv_launches,
                mla_bwd_dq=flash_attention_bwd_dq.qv_launches,
                mla_bwd_dkv=flash_attention_bwd_dkv.qv_launches,
                attention=_attn_counts())


def _zero_mla_train_counts():
    _zero_attn_counts()
    flash_attention_fwd.qv_launches = 0
    flash_attention_bwd_dq.qv_launches = 0
    flash_attention_bwd_dkv.qv_launches = 0


def _mla_expected(config, steps):
    """Per layer and step: kernel 1's qv forward once, and again when remat
    recomputes the block; each backward kernel once. Every attention launch
    is a qv launch."""
    fwd = (2 if config.remat != "none" else 1) * config.n_layer * steps
    bwd = config.n_layer * steps
    return dict(flash_fwd_qv=fwd, mla_bwd_dq=bwd, mla_bwd_dkv=bwd,
                attention=dict(flash_fwd=fwd, flash_bwd_dkv=bwd,
                               flash_bwd_dq=bwd))


def mla_train_grad_phase(seqlen=2048, batch=1, seed=4):
    """One loss and gradient of the DeepSeek-V2-Lite-width MLA GPT (all 27
    layers, configs/deepseek-v2-lite-mla-synth.yaml, remat "full") through
    the kernels, bf16 compute and fp32 weights, against the plain model
    (utils.testing.gpt_loss_ref, MLA expanded per head) in fp32 and in bf16
    eager: the 2x-bf16-eager contract of train_grad. The three gradient
    sets never live at once: each is held to fp32's and dropped."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, _, _ = load_config(MLA_TRAIN_CONFIG)
    model = GPTLMHeadModel(
        config, device="cuda", param_dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    rng = np.random.RandomState(seed)
    tokens = torch.from_numpy(rng.randint(
        0, config.vocab_size, (batch, seqlen + 1))).cuda()
    ids, labels = tokens[:, :-1], tokens[:, 1:]
    _zero_mla_train_counts()
    loss = cross_entropy_loss(model(ids).float(), labels)
    grads = torch.autograd.grad(loss, params)
    counts = _mla_train_counts()
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    loss32 = gpt_loss_ref(model, ids, labels, dtype=torch.float32)
    grads32 = torch.autograd.grad(loss32, params)

    def worst(gs):
        errs = {n: _max_rel(g, g32) for n, g, g32 in zip(names, gs, grads32)}
        name = max(errs, key=errs.get)
        return errs[name], name

    port_grad, port_at = worst(grads)
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    loss16 = gpt_loss_ref(model, ids, labels, dtype=torch.bfloat16)
    grads16 = torch.autograd.grad(loss16, params)
    bf16_grad, bf16_at = worst(grads16)
    del grads16, grads32
    loss_err = abs(loss.item() - loss32.item())
    loss_err16 = abs(loss16.item() - loss32.item())
    loss_floor = LOSS_FLOOR_FRACTION * abs(loss32.item())
    want = _mla_expected(config, 1)
    ok = (finite and loss_err <= 2 * loss_err16 + loss_floor
          and port_grad <= 2 * bf16_grad + GRAD_FLOOR and counts == want)
    result = dict(
        phase="mla_train_grad", model="DeepSeek-V2-Lite widths "
        "(configs/deepseek-v2-lite-mla-synth.yaml), random fp32 weights "
        f"(seed {seed})", layers=config.n_layer,
        params_b=sum(p.numel() for p in params) / 1e9, batch=batch,
        seqlen=seqlen, compute_dtype="bfloat16", remat=config.remat,
        loss_port=loss.item(), loss_fp32=loss32.item(),
        loss_bf16_eager=loss16.item(), loss_err_port=loss_err,
        loss_err_bf16_eager=loss_err16, loss_limit=2 * loss_err16 + loss_floor,
        grad_rel_err_port=port_grad, grad_worst_tensor_port=port_at,
        grad_rel_err_bf16_eager=bf16_grad, grad_worst_tensor_bf16=bf16_at,
        grad_limit=2 * bf16_grad + GRAD_FLOOR, launches=counts,
        launches_expected=want,
        contract="err <= 2 x bf16-eager err + floor (loss: 1e-3 |loss|, "
                 "gradients: 1e-2 relative)", ok=ok)
    del model, params, loss, loss16
    gc.collect()
    torch.cuda.empty_cache()
    emit(result)
    check(ok, "mla_train_grad outside the 2x bf16-eager contract, not "
              "finite, or launches off the count")
    return result


def mla_train_phase():
    """`training.run.main` on configs/deepseek-v2-lite-mla-synth.yaml (27
    layers, b 2 x s 4096, remat "full"), MLA_TRAIN_STEPS steps with a short
    warmup: falling loss, tokens/s and MFU against the MLA-aware 6N,
    peak memory, and the launches of kernel 1's qv forward and the two
    backward kernels, counted over this phase only."""
    argv = ["--config", MLA_TRAIN_CONFIG,
            "--set", f"train.total_steps={MLA_TRAIN_STEPS}",
            "--set", f"train.warmup_steps={MLA_TRAIN_WARMUP}"]
    config, _, dcfg = load_config(MLA_TRAIN_CONFIG, argv[3::2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_mla_train_counts()
    t0 = time.perf_counter()
    report = train_run.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _mla_train_counts()
    steps = report["steps"]
    losses = [s["loss"] for s in steps]
    n = len(steps)
    want = _mla_expected(config, n)
    ok = (n == MLA_TRAIN_STEPS and all(np.isfinite(losses))
          and losses[-1] < losses[0] and counts == want)
    result = dict(
        phase="mla_train", config="configs/deepseek-v2-lite-mla-synth.yaml",
        overrides=argv[2:], layers=config.n_layer, n_embd=config.n_embd,
        heads=config.n_head, kv_lora_rank=config.kv_lora_rank,
        vocab=config.vocab_size, remat=config.remat,
        batch=dcfg["batch_size"], seqlen=dcfg["seqlen"], steps=steps,
        tokens_per_s=report["tokens_per_s"], mfu=report["mfu"],
        flops_per_token=gpt_flops_per_token(config),
        mfu_peak="989 TFLOP/s (H100 SXM bf16 dense, data sheet); 6N with "
                 "MLA's own matrices, no attention term",
        wall_s=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, launches_expected=want,
        launches_per_step={k: counts[k] / max(n, 1) for k in
                           ("flash_fwd_qv", "mla_bwd_dq", "mla_bwd_dkv")},
        ok=ok)
    emit(result)
    check(ok, "mla_train: non-finite or non-falling loss, or launches off "
              "the count")
    return result


def mla_train_phases():
    """The MLA training phases in order; returns what the kernels line
    needs."""
    cases = {name: mla_bwd_case(name, seed=320 + i)
             for i, name in enumerate(MLA_BWD_CASES)}
    mla_bwd_fault_phase()
    gc.collect()
    torch.cuda.empty_cache()
    grad = mla_train_grad_phase()
    train = mla_train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(cases=cases, grad=grad, train=train)


def mla_train_kernel_entries(mlat, logs):
    """The kernels line's entries of kernels 3 and 2's MLA instances
    (csrc/mla_bwd.cu): each at the main path's case (qv, causal, b 2 s
    4096), its other cases, registers and spills, and its launches in
    mla_train."""
    cases = mlat["cases"]
    main = cases["qv-causal-s4096"]
    lib = {"mla_bwd": logs.get("mla_bwd", "")}
    entries = []
    for key, name, kernel, replaces, outs in (
            ("dq", "mla_bwd_dq", "mla_bwd_dq_kernel", "flash_bwd.py:449",
             ("dq", "delta", "dqv")),
            ("dkv", "mla_bwd_dkv", "mla_bwd_dkv_kernel", "flash_bwd.py:233",
             ("dk", "dv"))):
        err = max(c["held"][o]["max_abs_err"] for c in cases.values()
                  for o in outs if o in c["held"])
        entries.append(dict(
            name=name, route="cuda",
            source="flash_attn_tpu_torch/csrc/mla_bwd.cu",
            replaces=f"flash_attn_tpu/kernels/{replaces}",
            path=("kernel 3's qv path (dQv, qv at :467-498)" if key == "dq"
                  else "kernel 2's qv path (dS^T Qv in dV, qv at :381-386)"),
            design="mma.sync from ldmatrix, 512 threads, 32-row x 32-key "
                   "tiles, cp.async double buffering, no atomics",
            launches=mlat["train"]["launches"][name],
            launches_by_path=dict(
                mla_train=mlat["train"]["launches"][name],
                mla_train_grad=mlat["grad"]["launches"][name]),
            max_abs_err=err, ms=main[f"{key}_ms"],
            plain_ms=main[f"{key}_plain_ms"], bound_ms=main[f"{key}_bound_ms"],
            bound_by=main[f"{key}_bound_by"],
            # SDPA's backward computes dq, dk and dv at once: the same
            # figure stands beside both kernels.
            library_ms=main["library_bwd_ms"],
            shape="b=2 sq=sk=4096 h=16 hk=1 d=64 dv=512 causal bf16, qv",
            cases={n: {k: c[k] for k in (f"{key}_ms", f"{key}_plain_ms",
                                         f"{key}_bound_ms", "library_bwd_ms",
                                         "err_over_limit")}
                   for n, c in cases.items()},
            ptxas=ptxas_of(lib, kernel)))
    return entries


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    choices = ("kernel", "attn", "features", "varlen", "varlen_features",
               "vllm", "decode", "sparse", "blocksparse", "quant", "mla",
               "mla_bwd_kernels", "mla_train")
    parser.add_argument(
        "--only", nargs="+", metavar="PHASES",
        help=f"run only these kernel phases, {', '.join(choices)}, named "
             "apart or with commas (kernel, attn_kernels + attn_fault, "
             "the attn_features phases, "
             "varlen_kernels + varlen_fault + varlen_train, the "
             "varlen_features phases (varlen_train first) + vllm_alibi, "
             "vllm, "
             "decode_kernels + decode_fault, the sparse phases, the "
             "block-sparse phases, quant_kernels + quant_fault + quant_vllm "
             "+ quant_serve, the MLA serving phases, mla_bwd_kernels + "
             "mla_bwd_fault, mla_train_grad + mla_train) and stop, with no "
             "result line: for iterating on one kernel")
    only = parser.parse_args(argv).only
    if only:
        only = [name for arg in only for name in arg.split(",") if name]
        unknown = sorted(set(only) - set(choices))
        if unknown:
            parser.error(f"--only: unknown phases {unknown}")
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
                     or "spill" in ln or "Function properties" in ln
                     or "Performance Loss" in ln]))

    if only:
        if "kernel" in only:
            for i, case in enumerate(CASES):
                kernel_case(*case, seed=10 + i)
            split_fault_phase()
        if "attn" in only:
            for i, c in enumerate(ATTN_CASES):
                attn_case(*c, seed=20 + i)
            attn_copy_phase()
            attn_fault_phase()
        if "features" in only:
            feature_phases()
        if "varlen" in only:
            for i, name in enumerate(VARLEN_CASES):
                varlen_case(name, seed=30 + i)
            paged_cases()
            varlen_fault_phase()
            varlen_train_phase()
        if "varlen_features" in only:
            varlen_feature_phases(varlen_train_phase())
            vllm_alibi_phase()
        if "vllm" in only:
            vllm_phase()
        if "decode" in only:
            for i, name in enumerate(DECODE_CASES):
                decode_case(name, seed=70 + i)
            vllm_sinks_case()
            decode_fault_phase()
            decode_split_fault_phase()
        if "sparse" in only:
            sparse_phases()
        if "blocksparse" in only:
            blocksparse_phases()
        if "quant" in only:
            quant_kernels_phase()
            quant_fault_phase()
            vllm_phase(quant=torch.float8_e4m3fn)
            gc.collect()
            torch.cuda.empty_cache()
            model = GPTLMHeadModel(
                llama_config_to_gpt_config(MISTRAL_7B), device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
            quant_serve_phase(TimedEngine(model, ENGINE, device="cuda"), model)
        if "mla" in only:
            mla_phases()
        if "mla_bwd_kernels" in only:
            for i, name in enumerate(MLA_BWD_CASES):
                mla_bwd_case(name, seed=320 + i)
            mla_bwd_fault_phase()
        if "mla_train" in only:
            mla_train_grad_phase()
            mla_train_phase()
        print(smi(), flush=True)
        return 0

    cases = [kernel_case(*case, seed=10 + i) for i, case in enumerate(CASES)]
    split_fault_phase()
    attn = {c[0]: attn_case(*c, seed=20 + i) for i, c in enumerate(ATTN_CASES)}
    tma_copies = attn_copy_phase()
    attn_fault_phase()
    features = feature_phases()
    gc.collect()
    torch.cuda.empty_cache()
    varlen = {name: varlen_case(name, seed=30 + i)
              for i, name in enumerate(VARLEN_CASES)}
    paged = paged_cases()
    varlen_fault_phase()
    vtrain = varlen_train_phase()
    vfeat = varlen_feature_phases(vtrain)
    gc.collect()
    torch.cuda.empty_cache()
    vllm = vllm_phase()
    gc.collect()
    torch.cuda.empty_cache()
    valibi = vllm_alibi_phase()
    gc.collect()
    torch.cuda.empty_cache()
    decodes = {name: decode_case(name, seed=70 + i)
               for i, name in enumerate(DECODE_CASES)}
    vllm_sinks = vllm_sinks_case()
    decode_fault_phase()
    decode_split_fault_phase()
    gc.collect()
    torch.cuda.empty_cache()
    quant = quant_kernels_phase()
    quant_fault_phase()
    qvllm = vllm_phase(quant=torch.float8_e4m3fn)
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
    # The eager engine (cg=False) first: the logits contract, then the
    # serve traffic, whose tokens and logits the graphed engine must give.
    eager = TimedEngine(model, ENGINE, device="cuda", cg=False)
    torch.cuda.synchronize()
    emit(dict(phase="model", layers=config.n_layer,
              params_b=sum(p.numel() for p in model.parameters()) / 1e9,
              init_s=time.perf_counter() - t0,
              memory_gb=torch.cuda.memory_allocated() / 1e9))
    logits = logits_phase(eager, model)
    _, prompts = serve_prompts(config.vocab_size)
    eager_outs, eager_stats = serve_run(eager, prompts)
    eager_logits = eager.decode_logits
    # Dropping an engine frees its pools at once, with no cyclic GC.
    pools, held = pool_bytes(eager.caches), torch.cuda.memory_allocated()
    del eager
    eager_stats.update(pool_gb=pools / 1e9, freed_on_del_gb=(
        held - torch.cuda.memory_allocated()) / 1e9)
    check(eager_stats["freed_on_del_gb"] >= eager_stats["pool_gb"],
          "serve: dropping the eager engine did not free its pools")
    torch.cuda.empty_cache()
    engine = TimedEngine(model, ENGINE, device="cuda")
    serve, serve_outs, graphed_logits, margins = serve_phase(
        engine, model, (eager_outs, eager_stats, eager_logits))
    logits_graphed_phase(graphed_logits, eager_logits, logits["limit"])
    del graphed_logits, eager_logits
    engine.decode_logits = []
    graph_fault_phase(engine, prompts, eager_outs)
    engine_profile = profile_phase(engine, model)
    spec_serve = spec_serve_phase(model, logits["limit"], serve_outs, margins,
                                  serve)
    qserve = quant_serve_phase(engine, model)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    gen = generate_phase(model, logits["limit"])
    spec = speculative_phase(model, logits["limit"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    mla = mla_phases()
    mlat = mla_train_phases()

    train_grad_phase()
    gc.collect()
    torch.cuda.empty_cache()
    train_grad_phase(overrides=["model.attn_pdrop=0.1"], dropout_seed=2718)
    gc.collect()
    torch.cuda.empty_cache()
    train_grad_phase(overrides=["model.use_alibi=true"])
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    train_dropout = train_phase(["model.attn_pdrop=0.1"], phase="train_dropout")
    emit(dict(phase="train_dropout_vs_train",
              tokens_per_s=dict(train=train["tokens_per_s"],
                                train_dropout=train_dropout["tokens_per_s"]),
              ratio=train_dropout["tokens_per_s"] / train["tokens_per_s"]))
    gc.collect()
    torch.cuda.empty_cache()
    train_seeds_phase()
    gc.collect()
    torch.cuda.empty_cache()
    train_profile_phase()

    decode, prefill, phd = cases[0], cases[4], cases[6]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict(
        name="paged_decode", route="cuda",
        source="flash_attn_tpu_torch/csrc/paged_decode.cu",
        replaces="flash_attn_tpu/kernels/flash_decode_multipage.py:65",
        design="split-kv (decode: sq * group <= 16 rows), warps on rows "
               "(prefill chunks)",
        num_splits=decode["num_splits"], grid=decode["grid"],
        graph_ms=decode["graph_ms"], library_graph_ms=decode["library_graph_ms"],
        ptxas={part: [regs for name, regs in ptxas_named(logs, frag).items()
                      if paged_kind(name) == "same"]
               for part, frag in (("split", "paged_split_kernel"),
                                  ("combine", "paged_combine_kernel"),
                                  ("rows", "paged_decode_kernel"))},
        launches=serve["kernel_launches"],
        # serve and spec_serve replay the engine's step programs from CUDA
        # graphs; serve_eager runs them eagerly.
        launches_by_path=dict(serve=serve["kernel_launches"],
                              serve_eager=serve["eager"]["kernel_launches"],
                              spec_serve=spec_serve["launches"],
                              vllm=vllm["launches"]["paged_decode"]),
        combine_launches_by_path=dict(
            serve=serve["combine_launches"],
            serve_eager=serve["eager"]["combine_launches"],
            spec_serve=spec_serve["combine_launches"],
            vllm=vllm["combine_launches"]),
        serve_graphed=serve["graphed"],
        # the profile phase's graphed steps: kernel 4's launches as the
        # profiler listed them beside the wrapper's counter
        graphed_launches_listed={
            kind: dict((k, engine_profile[kind][k]) for k in (
                "launches_listed", "launches_counted",
                "combine_launches_listed", "combine_launches_counted"))
            for kind in ("prefill", "decode")},
        vllm_decode_step_graph=vllm["profile"]["decode"]["graph"],
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
        quant=quant_kernel_entry(quant, qserve, qvllm, logs, "paged_decode"),
    )]
    dec, pre = decodes["decode"], decodes["prefill"]
    general_err = max([c["out"]["max_abs_err"] for c in decodes.values()]
                      + [vllm_sinks["out"]["max_abs_err"]])
    graph_keys = keys + ("graph_ms", "library_graph_ms", "num_splits")
    kernels.append(dict(
        name="general_decode", route="cuda",
        source="flash_attn_tpu_torch/csrc/decode.cu",
        replaces="flash_attn_tpu/kernels/flash_decode.py:56",
        design="split-kv (at most 64 packed rows on a small grid: warps on "
               "keys up to 16 rows, else on rows) with a combine kernel; "
               "warps on rows for long calls",
        num_splits=dec["num_splits"], grid=dec["grid"],
        graph_ms=dec["graph_ms"], library_graph_ms=dec["library_graph_ms"],
        ptxas=dict(split=ptxas_of({"decode": logs["decode"]},
                                  "decode_split_kernel"),
                   combine=ptxas_of({"decode": logs["decode"]},
                                    "decode_combine_kernel"),
                   # The mangled name's length prefix keeps out the
                   # paged decode's paged_decode_kernel.
                   rows=ptxas_of({"decode": logs["decode"]},
                                 "13decode_kernel")),
        sass=sass_counts(_build.library_path("decode"),
                         ("HMMA", "LDGSTS", "ATOM", "RED", "LDL", "STL")),
        launches=gen["launches"]["general_decode"],
        launches_by_path=dict(
            generate=gen["launches"]["general_decode"],
            speculative=spec["launches"]["general_decode"],
            vllm_sinks=vllm_sinks["kernel5_launches"]),
        combine_launches_by_path=dict(
            generate=gen["general_decode_combine_launches"],
            speculative=spec["launches"]["general_decode_combine"]),
        # generate's decode steps replay one CUDA graph (cg=True).
        generate_cg=gen["cg"],
        max_abs_err=general_err, max_err=general_err,
        **{k: dec[k] for k in keys},
        generate_decode=dict(
            {k: decodes["generate-decode"][k] for k in graph_keys},
            shape="generate's late decode step: b=4 sq=1 smax 4532"),
        spec_verify_sq5=dict(
            {k: decodes["spec-verify-sq5"][k] for k in graph_keys},
            shape="speculative verify: b=1 sq=5 (20 packed rows) smax 1093"),
        shape="decode: b=8 sq=1 h=32 hk=8 d=128 contiguous smax 4608, "
              "window 4095, bf16",
        prefill=dict({k: pre[k] for k in keys},
                     shape="generate's prefill: b=4 sq=4500 smax 4532, "
                           "otherwise as decode"),
        vllm_sinks=dict({k: vllm_sinks[k] for k in keys},
                        shape="vLLM mixed step with s_aux, gpt-oss-20b "
                              "widths, phd page 16"),
        quant=quant_kernel_entry(quant, qserve, qvllm, logs, "general_decode"),
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
        if key == "fwd":
            design = dict(
                design="wgmma+tma",
                # The feature instances, in flash_fwd_features, go apart.
                ptxas=ptxas_of({"flash_fwd": logs.get("flash_fwd", "")},
                               "15fwd_sm90_kernel"),
                sass=sass_counts(_build.library_path("flash_fwd"),
                                 ("HGMMA", "UTMALDG")),
                tma_copies=tma_copies["fwd"])
        else:
            # SDPA's backward alone: its forward+backward less its forward.
            # The library also holds the varlen mode: count this kernel's
            # instructions alone (no atomics: ATOM and RED must be 0; LDL
            # and STL are spill loads and stores).
            kernel = f"bwd_{key}_sm90_kernel"
            design = dict(
                design="wgmma+tma",
                ptxas=ptxas_of({"flash_bwd": logs.get("flash_bwd", "")},
                               kernel),
                sass=sass_counts(_build.library_path("flash_bwd"),
                                 ("HGMMA", "UTMALDG", "ATOM", "RED", "LDL",
                                  "STL"), kernel),
                tma_copies=tma_copies["bwd"],
                library_bwd_ms=gpt2m["library_fwd_bwd_ms"]
                - gpt2m["library_fwd_ms"])
            sass = design["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma or TMA loads, or atomics, in its SASS")
        kernels.append(dict(**design,
            name=name, route="cuda",
            source=f"flash_attn_tpu_torch/csrc/{source}",
            replaces=f"flash_attn_tpu/kernels/{replaces}",
            launches=train["launches"][name], max_abs_err=err, max_err=err,
            features=feature_entry(features, key, train_dropout, name, logs),
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
                         **({} if key == "fwd" else dict(
                             library_bwd_ms=mistral["library_fwd_bwd_ms"]
                             - mistral["library_fwd_ms"])),
                         shape="b=1 h=32 hk=8 s=8192 d=128 causal window "
                               "4095 bf16"),
        ))
    gpt2m_v, p16 = varlen["gpt2m-packed"], paged[16]
    # The feature-free instances' registers from their own libraries (the
    # feature instances, in flash_varlen_features and
    # flash_varlen_bwd_features, go apart).
    varlen_lib = dict(fwd="flash_fwd", dq="flash_bwd", dkv="flash_bwd")
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
        if key != "fwd" and gpt2m_v.get("library_fwd_bwd_ms") is not None:
            # SDPA's backward alone: its forward+backward less its forward.
            entry["library_bwd_ms"] = (gpt2m_v["library_fwd_bwd_ms"]
                                       - gpt2m_v["library_fwd_ms"])
        if key == "dkv":
            # The Hopper kernel's instructions alone (no atomics: ATOM and
            # RED must be 0; LDL and STL are spill loads and stores), its
            # flat schedule of key tiles at gpt2m-packed from its own trace,
            # and the main path's instance (bf16, d 64, no softcap) against
            # the 148 bytes kernel 8's spills there; kernel 2, which shares
            # its consumer (dkv_range_walk), beside it.
            kernel = "varlen_dkv_sm90_kernel"
            sch = gpt2m_v["dkv_schedule"]
            own = {"flash_bwd": logs.get("flash_bwd", "")}
            main = ptxas_of(own, kernel + "I13__nv_bfloat16Li64ELb0ELi0E")
            entry.update(
                design="wgmma+tma, kernel 2's dK/dV on a flat schedule of "
                       "128-key tiles",
                ptxas=ptxas_of(own, kernel), ptxas_main_path=main,
                main_path_spill_bytes_within_kernel8s=bool(
                    main and main[0][1] <= 148),
                ptxas_kernel2=ptxas_of({"flash_bwd": logs.get("flash_bwd", "")},
                                       "bwd_dkv_sm90_kernel"),
                sass=sass_counts(_build.library_path("flash_bwd"),
                                 ("HGMMA", "UTMALDG", "ATOM", "RED", "LDL",
                                  "STL"), kernel),
                tma_copies=dict(varlen_train=vtrain["dkv_tma_copies"]),
                schedule=dict(
                    blocks_from="the kernel's schedule trace",
                    grid=sch["grid"], blocks_launched=sch["blocks_launched"],
                    blocks_exited=sch["blocks_exited"],
                    blocks_with_keys=sch["blocks_with_keys"]))
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma or TMA loads, or atomics, in its SASS")
            check(all(r[0] <= 255 for r in entry["ptxas"]),
                  f"{kernel}: more than 255 registers")
        if key == "dq":
            # The Hopper kernel's instructions alone (no atomics: ATOM and
            # RED must be 0; LDL and STL are spill loads and stores), and
            # its flat schedule at gpt2m-packed from its own trace.
            kernel = "varlen_dq_sm90_kernel"
            sch = gpt2m_v["dq_schedule"]
            entry.update(
                design="wgmma+tma, kernel 3's dQ on a flat tile schedule",
                ptxas=ptxas_of({"flash_bwd": logs.get("flash_bwd", "")},
                               kernel),
                sass=sass_counts(_build.library_path("flash_bwd"),
                                 ("HGMMA", "UTMALDG", "ATOM", "RED", "LDL",
                                  "STL"), kernel),
                tma_copies=dict(varlen_train=vtrain["dq_tma_copies"]),
                schedule=dict(
                    blocks_from="the kernel's schedule trace",
                    grid=sch["grid"], blocks_launched=sch["blocks_launched"],
                    blocks_exited=sch["blocks_exited"]))
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma or TMA loads, or atomics, in its SASS")
        if key == "fwd":
            entry["max_abs_err"] = max(err, *(r["out"]["max_abs_err"]
                                              for r in paged.values()
                                              if "out" in r))
            # The Hopper kernel's instructions alone (no atomics: ATOM and
            # RED must be 0; LDL and STL are spill loads and stores).
            kernel = "varlen_fwd_sm90_kernel"
            entry.update(
                design="wgmma+tma, flat tile schedule, page pieces by TMA",
                ptxas=ptxas_of({"flash_fwd": logs.get("flash_fwd", "")},
                               kernel),
                sass=sass_counts(_build.library_path("flash_fwd"),
                                 ("HGMMA", "UTMALDG", "ATOM", "RED", "LDL",
                                  "STL"), kernel),
                tma_copies=flash_attention_varlen_fwd.tma_copies,
                launches_sm80=dict(vllm=vllm["launches_sm80"],
                                   timed=paged["mixed"]["launches_sm80_timed"]),
                mixed_step=dict(
                    ms=paged["mixed"]["ms"]["mixed"],
                    blocks_from="the kernel's schedule trace",
                    blocks_launched=paged["mixed"]["blocks_launched"],
                    blocks_exited=paged["mixed"]["blocks_exited"]))
            sass = entry["sass"]
            check(sass is None or (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0
                                   and sass["ATOM"] == sass["RED"] == 0),
                  f"{kernel}: no wgmma or TMA loads, or atomics, in its SASS")
            entry["paged"] = dict(
                ms=p16["fwd_ms"], plain_ms=p16["fwd_plain_ms"],
                bound_ms=p16["fwd_bound_ms"], bound_by=p16["fwd_bound_by"],
                library_ms=None,
                shape="Mistral paged prefill: 4 x 512-token chunks at "
                      "contexts 2831-6000, h=32 hk=8 d=128, window 4095, "
                      "page 16, phd views")
        entry["features"] = varlen_feature_entry(vfeat, valibi, key, name,
                                                 logs)
        kernels.append(entry)
    kernels += sparse_kernel_entries(sparse, logs)
    kernels += blocksparse_kernel_entries(bsr, logs)
    kernels += mla_kernel_entries(mla, logs)
    kernels += mla_train_kernel_entries(mlat, logs)
    emit({"kernels": kernels})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
