"""Smoke run of flash_attn_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (into build/kernels/), then:

  1. env      torch/CUDA versions, the card's name and power limit, build time;
  2. kernels  each kernel against its plain PyTorch version at the serving
              path's shapes (Mistral-7B widths), with CUDA-event times of the
              kernel, the plain version, a PyTorch library yardstick, and the
              card's bound for the same work;
  3. logits   a Mistral-7B-v0.1-width model (random seeded weights, bf16, all
              32 layers): chunked prefill of a ~4500-token prompt and 8 decode
              steps through the engine's own forward, logits held against a
              plain fp32 forward under the 2x-bf16-eager contract;
  4. serve    LLMEngine.generate on 8 requests, tokens/s, peak memory, and
              proof that every attention call went through the kernel;
  5. profile  torch.profiler device time by kernel over the prefill and the
              decode steps of 8 more requests, beside the host wall time.

One JSON line per phase; then the {"kernels": [...]} line, the card's name
and power limit, and {"ok": true, "device": {...}} as the last line. Any
failed check raises, so the exit code is non-zero and no result is printed.
It needs a CUDA device and the rest of this repository beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flash_attn_tpu_torch.kernels import _build  # noqa: E402
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (  # noqa: E402
    flash_attention_decode_multipage,
    flash_attention_decode_multipage_ref,
)
from flash_attn_tpu_torch.models.adapters import (  # noqa: E402
    llama_config_to_gpt_config,
)
from flash_attn_tpu_torch.models.gpt import GPTLMHeadModel  # noqa: E402
from flash_attn_tpu_torch.runtime.engine import (  # noqa: E402
    EngineConfig,
    LLMEngine,
)
from flash_attn_tpu_torch.runtime.kv_cache import (  # noqa: E402
    allocate_fused_paged_kv_cache,
    allocate_paged_kv_cache,
)
from flash_attn_tpu_torch.utils.testing import gpt_forward_ref  # noqa: E402

# Mistral-7B-v0.1, https://huggingface.co/mistralai/Mistral-7B-v0.1 config.json
MISTRAL_7B = dict(
    hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, intermediate_size=14336, vocab_size=32000,
    rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=4096,
    tie_word_embeddings=False,
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

# (name, sq, fused, page, window_left, softcap, permuted table)
CASES = [
    ("decode", 1, True, 16, WINDOW, 0.0, True),          # the engine's decode
    ("decode-split", 1, False, 16, -1, 0.0, True),
    ("decode-page128-contiguous", 1, True, 128, -1, 0.0, False),
    ("decode-softcap30", 1, True, 16, -1, 30.0, True),
    ("prefill", 256, True, 16, WINDOW, 0.0, True),       # an engine prefill chunk
    ("prefill-split-page128", 256, False, 128, -1, 0.0, True),
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


def kernel_case(name, sq, fused, page, window, softcap, permuted, seed):
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
        hk=HK, d=D, page=page, fused=fused, window_left=window,
        softcap=softcap, permuted=permuted, max_ctx=int(seqlens.max()),
        max_abs_err=float(err.max()), lse_max_abs_err=lse_err,
        tolerance=f"|out-ref| <= {OUT_ATOL} + {OUT_RTOL}|ref|, |lse-ref| <= {LSE_ATOL}",
        ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by,
    )
    emit(result)
    check(ok, f"paged_decode case {name} disagrees with its plain version")
    return result


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


def serve_phase(engine, model, seed=2):
    c = model.config
    rng = np.random.RandomState(seed)
    lens = rng.randint(256, 5001, 8)
    lens[int(rng.randint(8))] = int(rng.randint(4097, 5001))  # past the window
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


def main():
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
                     or "spill" in ln]))

    cases = [kernel_case(*case, seed=10 + i) for i, case in enumerate(CASES)]

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
    logits_phase(engine, model)
    serve = serve_phase(engine, model)
    profile_phase(engine, model)

    decode, prefill = cases[0], cases[4]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [dict(
        name="paged_decode", route="cuda",
        source="flash_attn_tpu_torch/csrc/paged_decode.cu",
        replaces="flash_attn_tpu/kernels/flash_decode_multipage.py:65",
        launches=serve["kernel_launches"],
        max_abs_err=max(c["max_abs_err"] for c in cases),
        max_err=max(c["max_abs_err"] for c in cases),
        kernel_ms=decode["ms"],
        **{k: decode[k] for k in keys},
        shape="decode: b=8 sq=1 h=32 hk=8 d=128 page=16 fused, window 4095",
        prefill=dict({k: prefill[k] for k in keys},
                     shape="prefill chunk: b=8 sq=256, otherwise as decode"),
    )]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
