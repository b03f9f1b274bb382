"""Serving engine: continuous batching over paged KV pools (counterpart of
flash_attn_tpu/runtime/engine.py).

The host loop is the JAX engine's: the scheduler admits requests, allocates
pages and assembles batches; each step runs the model once on a fixed
(max_batch, prefill_chunk) prefill batch or a (max_batch, 1) decode batch,
and every attention call of that forward goes to the paged decode kernel.
PyTorch runs eagerly, so there is no compiled step: the KV pools are
updated in place where the JAX engine donates them.

Position accounting: the scheduler is fed `len(prompt) - 1` as the prompt
length. Prefill appends prompt[:-1] to the cache, and decode always feeds
the newest known token (prompt[-1] first, then each sample), so the cache
length always equals the scheduler's position counter. Chunked prefill
writes full fixed-size chunks; garbage tail positions stay invisible because
attention masks by true cache lengths, and each later token overwrites its
slot before it becomes visible. One extra "trash" page absorbs the writes
of padded chunk tails and padded batch rows.

Quantized KV serving (`kv_cache_dtype` "int8", "fp8" or "fp8_e4m3"): every
layer's pool holds 1-byte elements beside per-kv-head dequant scales
(`kv_cache_scale`, a scalar or a {layer: scalar} dict), half the bytes of
a bf16 pool; new K/V are quantized on write and the decode kernels
dequantize in-kernel. Fused K|V pools are the default for them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from flash_attn_tpu_torch.modules.mha import InferenceParams
from flash_attn_tpu_torch.runtime.generation import sample_tokens
from flash_attn_tpu_torch.runtime.kv_cache import (
    QuantPagedKV,
    allocate_fused_paged_kv_cache,
    allocate_paged_kv_cache,
)
from flash_attn_tpu_torch.runtime.prefix_cache import PrefixCache
from flash_attn_tpu_torch.runtime.scheduler import make_scheduler
from flash_attn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class EngineConfig:
    """The JAX engine's fields and defaults; see flash_attn_tpu/runtime/
    engine.py for each. speculative_k and device_put_fn are not ported yet
    and must keep their defaults."""

    max_batch_size: int = 8
    page_size: int = 128
    num_pages: int = 512
    max_pages_per_seq: int = 32
    prefill_chunk: int = 256
    max_seqlen: int = 4096
    top_k: int = 1
    top_p: float = 0.0
    temperature: float = 1.0
    eos_token_id: Optional[int] = None
    prefer_native_scheduler: bool = True
    enable_prefix_caching: bool = False
    prefix_cache_pages: Optional[int] = None  # None -> num_pages // 4
    decode_depth: int = 1
    kv_window_tokens: int = 0
    speculative_k: int = 0
    fused_kv_pages: Optional[bool] = None  # None: fused for >= 2-byte dtypes
    kv_cache_dtype: Optional[str] = None
    kv_cache_scale: float | dict = 1.0
    device_put_fn: Optional[object] = None


@dataclasses.dataclass
class RequestOutput:
    request_id: int
    prompt: List[int]
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False


def _check_ported(config: EngineConfig):
    unported = {
        "speculative_k > 0": (config.speculative_k > 0,
                              "ROADMAP queue 1, item 5 (speculative decoding)"),
        "device_put_fn": (config.device_put_fn is not None,
                          "ROADMAP queue 1, item 12 (parallelism)"),
    }
    for name, (hit, item) in unported.items():
        if hit:
            raise NotImplementedError(f"EngineConfig {name} is not ported yet: {item}")


# kv_cache_dtype's names and the pool dtypes they select.
QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                "fp8_e4m3": torch.float8_e4m3fn}


def quant_dtype(config: EngineConfig, mc) -> Optional[torch.dtype]:
    """The pools' 1-byte dtype, or None without kv_cache_dtype. Raises
    ValueError, as the JAX engine does, for a name it does not know and for
    a model the quantized pools cannot serve: MLA's latent caches, ALiBi
    (the paged decode kernel's feature set excludes it) and a V head dim
    other than the head dim."""
    name = config.kv_cache_dtype
    if name is None:
        return None
    if name not in QUANT_DTYPES:
        raise ValueError(f"kv_cache_dtype {name!r} not in {list(QUANT_DTYPES)}")
    if getattr(mc, "attn_type", "mha") == "mla":
        raise ValueError("kv_cache_dtype is not supported with MLA latent "
                         "caches (absorbed qv needs >= 16-bit V)")
    if getattr(mc, "use_alibi", False):
        raise ValueError("kv_cache_dtype requires the paged decode kernel, "
                         "which excludes ALiBi")
    dv = getattr(mc, "v_head_dim", None)
    if dv is not None and dv != mc.resolved_head_dim:
        raise ValueError("kv_cache_dtype with v_head_dim != head_dim is not "
                         "supported")
    return QUANT_DTYPES[name]


class LLMEngine:
    """Continuous-batching engine for a `GPTLMHeadModel`.

    Runs on `device` (CUDA unless named; the CPU only on request), which
    must be where the model's weights are. `generator` (a torch.Generator on
    that device; seed 0 when None) drives non-greedy sampling.
    `prefill_steps` and `decode_steps` count the model forwards run."""

    def __init__(self, model, config: EngineConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        _check_ported(config)
        qdtype = quant_dtype(config, model.config)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.config = config
        mc = model.config
        hk, d = mc.resolved_n_head_kv, mc.resolved_head_dim
        self._trash_page = config.num_pages
        fused = config.fused_kv_pages
        if fused is None:
            # One half-size copy per page for quantized pools.
            fused = qdtype is not None or (not mc.use_alibi
                                           and mc.dtype.itemsize >= 2)
        pool_args = (config.num_pages + 1, config.page_size, hk, d)
        if qdtype is not None:
            self.caches = {}
            for i in range(mc.n_layer):
                scale = config.kv_cache_scale
                if isinstance(scale, dict):
                    scale = scale[i]
                ks, vs = (torch.full((hk,), float(scale), dtype=torch.float32,
                                     device=self.device) for _ in range(2))
                if fused:
                    pools = (allocate_fused_paged_kv_cache(
                        *pool_args, dtype=qdtype, device=self.device), None)
                else:
                    pools = allocate_paged_kv_cache(*pool_args, dtype=qdtype,
                                                    device=self.device)
                self.caches[i] = QuantPagedKV(*pools, k_scale=ks, v_scale=vs)
        elif fused:
            self.caches = {
                i: allocate_fused_paged_kv_cache(*pool_args, dtype=mc.dtype,
                                                 device=self.device)
                for i in range(mc.n_layer)
            }
        else:
            self.caches = {
                i: allocate_paged_kv_cache(*pool_args, dtype=mc.dtype,
                                           device=self.device)
                for i in range(mc.n_layer)
            }
        self.sched = make_scheduler(
            config.num_pages, config.page_size, config.max_batch_size,
            config.max_pages_per_seq, config.prefill_chunk,
            prefer_native=config.prefer_native_scheduler,
        )
        self.prefix_cache = None
        if config.enable_prefix_caching:
            budget = (config.prefix_cache_pages
                      if config.prefix_cache_pages is not None
                      else max(1, config.num_pages // 4))
            self.prefix_cache = PrefixCache(config.page_size, budget)
        if config.decode_depth > 1:
            self.sched.set_decode_depth(config.decode_depth)
        if config.kv_window_tokens > 0:
            self.sched.set_window(config.kv_window_tokens)
        self.outputs: Dict[int, RequestOutput] = {}
        self._prompts: Dict[int, List[int]] = {}
        self._max_new: Dict[int, int] = {}
        self._generator = (
            generator if generator is not None
            else torch.Generator(device=self.device).manual_seed(0)
        )
        self.prefill_steps = 0
        self.decode_steps = 0

    # -- model steps --------------------------------------------------------

    @torch.no_grad()
    def _apply(self, tokens, offsets, block_tables, *, num_last_tokens=1):
        """One forward over (b, s) tokens at per-row cache offsets; appends
        their K/V to the engine's pools in place. Returns the fp32 logits of
        the last `num_last_tokens` positions."""
        ip = InferenceParams(
            max_seqlen=self.config.max_seqlen,
            max_batch_size=tokens.shape[0],
            seqlen_offset=offsets,
            key_value_memory_dict=self.caches,
            block_table=block_tables,
        )
        logits = self.model(tokens, inference_params=ip,
                            num_last_tokens=num_last_tokens)
        return logits.float()

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _decode(self, tokens, offsets, tables) -> np.ndarray:
        """decode_depth forwards, each feeding its samples to the next.
        Returns (max_batch, decode_depth) tokens."""
        cfg = self.config
        toks, offs = self._to_device(tokens), self._to_device(offsets)
        tables = self._to_device(tables)
        samples = []
        for _ in range(cfg.decode_depth):
            logits = self._apply(toks, offs, tables)
            self.decode_steps += 1
            nxt = sample_tokens(logits[:, -1], self._generator, top_k=cfg.top_k,
                                top_p=cfg.top_p, temperature=cfg.temperature)
            samples.append(nxt)
            toks, offs = nxt[:, None], offs + 1
        return torch.stack(samples, dim=1).cpu().numpy()

    # -- public API ---------------------------------------------------------

    def add_request(self, request_id: int, prompt_tokens: List[int],
                    max_new_tokens: int):
        if len(prompt_tokens) < 1:
            raise ValueError("a request needs at least one prompt token")
        shared: List[int] = []
        if self.prefix_cache is not None:
            # Only the prefill portion (prompt[:-1]) lives in the cache
            # before decode, so match full pages of that.
            shared = self.prefix_cache.lookup(prompt_tokens[:-1])
        rc = self.sched.add_request(request_id, len(prompt_tokens) - 1,
                                    max_new_tokens, shared_pages=shared)
        if rc != 0:
            raise ValueError(f"request rejected (code {rc})")
        self._prompts[request_id] = list(prompt_tokens)
        self._max_new[request_id] = max_new_tokens
        self.outputs[request_id] = RequestOutput(request_id, list(prompt_tokens))

    def step(self) -> List[RequestOutput]:
        """Run one engine step; returns outputs updated this step."""
        batch = self.sched.next_batch()
        cfg = self.config
        touched: List[RequestOutput] = []
        if batch.kind == 0:
            # Page pressure: unfinished work but no schedulable batch means
            # the pool is starved — drop the prefix registry's pins and
            # retry once before reporting idle.
            if (self.prefix_cache is not None and len(self.prefix_cache) > 0
                    and (self.sched.num_active() > 0 or any(
                        self.sched.request_state(r) in (0, 1)
                        for r in self.outputs))):
                self.prefix_cache.evict(
                    len(self.prefix_cache), self.sched.unpin_pages
                )
                batch = self.sched.next_batch()
            if batch.kind == 0:
                return touched

        n = len(batch.request_ids)
        mb = cfg.max_batch_size
        tables = np.full((mb, cfg.max_pages_per_seq), self._trash_page, np.int32)
        tables[:n] = np.where(batch.block_tables < 0, self._trash_page,
                              batch.block_tables)
        if batch.kind == 1:  # batched prefill chunks, fixed (mb, chunk) shape
            tokens = np.zeros((mb, cfg.prefill_chunk), np.int32)
            offsets = np.zeros(mb, np.int32)
            for i, rid in enumerate(batch.request_ids):
                pos = int(batch.positions[i])
                ln = int(batch.chunk_lens[i])
                chunk = self._prompts[int(rid)][pos : pos + ln]
                tokens[i, : len(chunk)] = chunk
                offsets[i] = pos
            self._apply(self._to_device(tokens), self._to_device(offsets),
                        self._to_device(tables))
            self.prefill_steps += 1
            ids = list(map(int, batch.request_ids))
            self.sched.report(ids, [0] * n, [0] * n)
            if self.prefix_cache is not None:
                # Register full prompt pages of requests whose prefill just
                # completed (state RUNNING); raw tables (-1 padded), not the
                # trash-substituted copy.
                for i, rid in enumerate(ids):
                    if self.sched.request_state(rid) == 2:
                        self.prefix_cache.register(
                            self._prompts[rid][:-1],
                            [int(p) for p in batch.block_tables[i]],
                            self.sched.pin_pages,
                        )
                self.prefix_cache.evict_to_budget(self.sched.unpin_pages)
            touched.extend(self.outputs[r] for r in ids)
            return touched

        tokens = np.zeros((mb, 1), np.int32)
        for i, rid in enumerate(batch.request_ids):
            out = self.outputs[int(rid)]
            tokens[i, 0] = (
                out.tokens[-1] if out.tokens else self._prompts[int(rid)][-1]
            )
        offsets = np.zeros(mb, np.int32)
        offsets[:n] = batch.positions
        nxt = self._decode(tokens, offsets, tables)
        produced, done = [], []
        for i, rid in enumerate(batch.request_ids):
            rid = int(rid)
            out = self.outputs[rid]
            # Keep at most the scheduler-planned count (clamped to the
            # request's remaining budget), stopping at EOS; overshoot
            # tokens beyond that were written to invisible cache slots.
            kept = 0
            fin = False
            for j in range(min(int(batch.chunk_lens[i]), nxt.shape[1])):
                tok = int(nxt[i, j])
                out.tokens.append(tok)
                kept += 1
                if ((cfg.eos_token_id is not None and tok == cfg.eos_token_id)
                        or len(out.tokens) >= self._max_new[rid]):
                    fin = True
                    break
            out.finished = fin
            produced.append(kept)
            done.append(1 if fin else 0)
            touched.append(out)
        self.sched.report(list(map(int, batch.request_ids)), produced, done)
        return touched

    def run_to_completion(self, max_steps: int = 100000):
        steps = 0
        while self.sched.num_active() > 0 or any(
            self.sched.request_state(rid) in (0, 1) for rid in self.outputs
        ):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("engine did not converge")
        return self.outputs

    def generate(self, prompts: List[List[int]], max_new_tokens: int):
        """Batch convenience wrapper; returns generated token lists."""
        base = max(self.outputs.keys(), default=-1) + 1
        for i, p in enumerate(prompts):
            self.add_request(base + i, p, max_new_tokens)
        self.run_to_completion()
        return [self.outputs[base + i].tokens for i in range(len(prompts))]
