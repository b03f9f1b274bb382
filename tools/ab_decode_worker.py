"""One checkout's decode kernels timed on request, for tools/ab_kernels.py.

    python3 tools/ab_decode_worker.py --root build/parent

Imports `flash_attn_tpu_torch` from `--root` (any checkout whose public
decode API matches: `flash_attention_decode_multipage`,
`flash_attention_decode_general` and `vllm_compat.flash_attn_varlen_func`),
builds the inputs below once, prints "ready", then answers each "time" line
on standard input with one JSON line of CUDA-event medians (ms) and stops
at "quit" or the end of its input; keys ending in "/graph" time the call
replayed from a CUDA graph. The inputs are chip_smoke.py's: kernel 4
at its "decode", "decode-phd-view" and "prefill" cases (b 8, Mistral-7B
widths, page 16, window 4095, contexts drawn as there), kernel 5 at its
"decode", "generate-decode", "spec-verify-sq5" and "prefill" cases
(contiguous caches, Mistral-7B widths, window 4095), and a vLLM decode-only
step: 32 layer
calls of `vllm_compat.flash_attn_varlen_func` over per-layer "phd" pools,
one decode row for each of 8 requests at contexts 2863-4176. Seeds are
fixed, so every checkout times the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

H, HK, D, B, PAGE, WINDOW, MAX_CTX = 32, 8, 128, 8, 16, 4095, 6000
DECODE_LENS = (2831, 4144, 3862, 3591, 2891, 3377, 4012, 3105)
VLLM_LENS = tuple(n + 32 for n in (2831, 3862, 2770, 1355, 3591, 689, 2891,
                                   4144))
LAYERS = 32
# Kernel 5's cases: (name, sq, smax, cache lengths); generate's at batch 4
# on 4500-token prompts with 32 new tokens, the speculative verify's gamma
# + 1 = 5 tokens over 1024 + 64 + 5 slots.
GENERAL_CASES = (
    ("decode", 1, 4608, DECODE_LENS),
    ("generate-decode", 1, 4532, (4501, 4511, 4521, 4531)),
    ("spec-verify-sq5", 5, 1093, (1093,)),
    ("prefill", 4500, 4532, (4500,) * 4),
)


def cuda_ms(torch, fn, reps=20, warmup=3):
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


def captured(torch, fn):
    """fn() captured in a CUDA graph, whose replay runs its launches without
    the host's time to issue them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def paged_case(torch, kv, sq, fused, phd, seed):
    """chip_smoke.py's kernel_case inputs (permuted table)."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    seqlens = rng.randint(max(sq, 1), MAX_CTX + 1, B)
    seqlens[0] = max(seqlens[0], 4500)
    max_pages = -(-MAX_CTX // PAGE)
    npages = B * max_pages + 1
    ids = rng.permutation(npages - 1)
    table = torch.from_numpy(ids[: B * max_pages].reshape(B, max_pages)
                             .astype(np.int32)).to(dev)
    lens = torch.from_numpy(seqlens.astype(np.int32)).to(dev)
    if fused:
        k = kv.allocate_fused_paged_kv_cache(npages, PAGE, HK, D, device=dev)
        v = None
    else:
        k, v = (torch.empty(npages, PAGE, HK, D, device=dev,
                            dtype=torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        v.normal_(generator=gen)
    k.normal_(generator=gen)
    q = torch.randn(B, sq, H, D, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kw = dict(fused_kv_dim=D if fused else 0, window_left=WINDOW)
    return (q, k, v, lens, table), kw


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    root = os.path.abspath(parser.parse_args(argv).root)
    sys.path.insert(0, root)
    import torch

    from flash_attn_tpu_torch import vllm_compat
    from flash_attn_tpu_torch.kernels.flash_decode import (
        flash_attention_decode_general,
    )
    from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
        flash_attention_decode_multipage,
    )
    from flash_attn_tpu_torch.runtime import kv_cache

    dev = torch.device("cuda")
    calls = {}
    for name, sq, fused, phd, seed in (("decode", 1, True, False, 10),
                                       ("prefill", 256, True, False, 14),
                                       ("decode-phd-view", 1, False, True, 16)):
        args, kw = paged_case(torch, kv_cache, sq, fused, phd, seed)
        calls[f"paged_decode/{name}"] = (
            lambda a=args, k=kw: flash_attention_decode_multipage(*a, **k))

    gen = torch.Generator(device=dev).manual_seed(70)
    for name, sq, smax, lens in GENERAL_CASES:
        q5 = torch.randn(len(lens), sq, H, D, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        k5, v5 = (torch.randn(len(lens), HK, smax, D, generator=gen,
                              device=dev, dtype=torch.bfloat16)
                  for _ in range(2))
        lens5 = torch.tensor(lens, dtype=torch.int32, device=dev)
        calls[f"general_decode/{name}"] = (
            lambda q=q5, k=k5, v=v5, n=lens5: flash_attention_decode_general(
                q, k, v, n, causal=True, window_left=WINDOW))

    rng = np.random.RandomState(2)
    pages = [-(-n // PAGE) for n in VLLM_LENS]
    num_blocks = sum(pages) + 1
    ids = rng.permutation(num_blocks)
    table = np.zeros((B, max(pages)), np.int32)
    start = 0
    for i, n in enumerate(pages):
        table[i, :n] = ids[start:start + n]
        start += n
    pools = [tuple(torch.randn(num_blocks, PAGE, HK, D, generator=gen,
                               device=dev, dtype=torch.bfloat16)
                   for _ in range(2)) for _ in range(LAYERS)]
    qv = torch.randn(LAYERS, B, H, D, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    cu_q = torch.arange(B + 1, dtype=torch.int32, device=dev)
    used = torch.tensor(VLLM_LENS, dtype=torch.int32, device=dev)
    table = torch.from_numpy(table).to(dev)
    meta = vllm_compat.get_scheduler_metadata(
        B, 1, max(VLLM_LENS), H, HK, D, cache_seqlens=used, cu_seqlens_q=cu_q,
        causal=True, window_size=(WINDOW, -1), page_size=PAGE)

    def vllm_step():
        for layer, (kp, vp) in enumerate(pools):
            vllm_compat.flash_attn_varlen_func(
                qv[layer], kp, vp, 1, cu_q, max(VLLM_LENS), seqused_k=used,
                causal=True, window_size=(WINDOW, -1), block_table=table,
                scheduler_metadata=meta)

    calls["vllm/decode_step_32_layers"] = vllm_step
    for fn in calls.values():  # builds the kernels
        fn()
    torch.cuda.synchronize()
    # The kernels alone: each call replayed from a CUDA graph.
    for key in [k for k in calls if not k.startswith("vllm")]:
        calls[key + "/graph"] = captured(torch, calls[key]).replay
    print("ready", flush=True)
    for line in sys.stdin:
        if line.strip() != "time":
            break
        print(json.dumps({k: cuda_ms(torch, fn, reps=10 if k.startswith("vllm")
                                     else 20)
                          for k, fn in calls.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
