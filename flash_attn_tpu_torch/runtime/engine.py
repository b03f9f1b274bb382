"""Serving engine: continuous batching over paged KV pools (counterpart of
flash_attn_tpu/runtime/engine.py).

The host loop is the JAX engine's: the scheduler admits requests, allocates
pages and assembles batches; each step runs one of the engine's step
programs on a fixed (max_batch, prefill_chunk) prefill batch or a
(max_batch, 1) decode batch, and every attention call of those forwards
goes to the paged decode kernel (kernel 4). The programs mirror the JAX
engine's jitted functions: prefill; decode, with `decode_depth` forwards
and samplings unrolled in one program; and with `speculative_k` the
speculative prefill (target, then draft, over one chunk) and round (k
greedy draft steps, then one (max_batch, k + 1) target verify).

Where the JAX engine compiles each program once (XLA jit), the port
captures it once in a CUDA graph and replays it (`runtime.graphs.StepGraph`;
the graphs share one memory pool). Every program reads static `tokens`,
`offsets` and `tables` tensors, which the host writes in place through one
pinned staging buffer; its results land in static outputs, and a decode or
speculative step reads its sampled tokens to the host once, as the JAX
engine's `np.asarray(nxt)` does. The KV pools are allocated once and are
never replaced: prefix caching and window eviction change only what goes
into `tables`. `cg=False` runs the same programs eagerly.

Position accounting: the scheduler is fed `len(prompt) - 1` as the prompt
length. Prefill appends prompt[:-1] to the cache, and decode always feeds
the newest known token (prompt[-1] first, then each sample), so the cache
length always equals the scheduler's position counter. Chunked prefill
writes full fixed-size chunks; garbage tail positions stay invisible because
attention masks by true cache lengths, and each later token overwrites its
slot before it becomes visible. One extra "trash" page absorbs the writes
of padded chunk tails and padded batch rows. A speculative round writes all
k + 1 tokens to the target's pools and k to the draft's; rejected ones lie
past the kept length and are overwritten before they become visible.

An MLA model (`GPTConfig(attn_type="mla")`) is served from latent page
pools with one KV head: a fused rope|latent pool per layer by default, or
(rope, latent) pools under `fused_kv_pages=False`; every attention call is
kernel 4's qv path. Speculative decoding takes MLA targets and drafts alike
(each model's pools follow its own config).

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
from flash_attn_tpu_torch.runtime.graphs import StepGraph
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
    engine.py for each. device_put_fn is not ported yet and must keep its
    default."""

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
    if config.device_put_fn is not None:
        raise NotImplementedError("EngineConfig device_put_fn is not ported "
                                  "yet: ROADMAP queue 1, item 12 (parallelism)")


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
    that device; seed 0 when None) drives non-greedy sampling. With
    `config.speculative_k` > 0, `draft_model` (a `GPTLMHeadModel` with its
    own weights, on the same device) proposes that many greedy tokens a
    round, in pools that mirror the target's pages. `cg` (the name of
    `generate`'s argument): on CUDA each step program is captured once in a
    CUDA graph and replayed; False runs the same programs eagerly.

    `prefill_steps` counts prefill programs run, `decode_steps` decode
    forwards; `spec_rounds`, `spec_drafted` and `spec_accepted` count
    speculative rounds, the draft tokens they proposed for scheduled rows
    and those the target's verify accepted. `last_logits` holds the fp32
    logits of the newest decode forward, (max_batch, vocab)."""

    def __init__(self, model, config: EngineConfig, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 draft_model=None, cg: bool = True):
        _check_ported(config)
        k = config.speculative_k
        if k > 0:
            # The JAX engine's rules (engine.py:266-290).
            if draft_model is None:
                raise ValueError("speculative_k needs a draft_model")
            if config.top_k != 1:
                raise ValueError("engine speculative decoding is greedy-only "
                                 "(top_k=1)")
            if config.decode_depth > 1:
                raise ValueError("speculative_k and decode_depth are exclusive")
        qdtype = quant_dtype(config, model.config)
        if k > 0:
            quant_dtype(config, draft_model.config)
        self.device = resolve_device(device)
        for name, m in (("model", model), ("draft model", draft_model)):
            if m is not None and m.device != self.device:
                raise ValueError(f"the {name} is on {m.device}, the engine "
                                 f"on {self.device}")
        self.model = model
        self.config = config
        self._trash_page = config.num_pages
        self.caches = self._allocate_pools(model.config, qdtype)
        self.draft_model = draft_model if k > 0 else None
        # Draft pools mirror the target's block tables: same page ids, a
        # pool per draft layer.
        self.draft_caches = (self._allocate_pools(draft_model.config, qdtype)
                             if k > 0 else None)
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
        if k > 0:
            # Page planning per round: k accepted drafts + the bonus token.
            self.sched.set_decode_depth(k + 1)
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
        self.spec_rounds = self.spec_drafted = self.spec_accepted = 0
        self._make_buffers()
        capture = dict(capture=cg, pool=(torch.cuda.graph_pool_handle()
                                         if cg and self.device.type == "cuda"
                                         else None))
        self.graphs = {"prefill": StepGraph(self._prefill_program, self.device,
                                            **capture)}
        if k > 0:
            self.graphs["round"] = StepGraph(self._round_program, self.device,
                                             **capture)
        else:
            self.graphs["decode"] = StepGraph(
                self._decode_program, self.device,
                generators=[self._generator] if config.top_k != 1 else [],
                **capture)

    def _allocate_pools(self, mc, qdtype) -> dict:
        """Zeroed page pools for every layer of a model of config `mc`:
        fused K|V pools unless `fused_kv_pages` says otherwise (or ALiBi or
        a 1-byte model dtype rules them out), 1-byte `QuantPagedKV` pools
        with `kv_cache_dtype`."""
        config = self.config
        if mc.attn_type == "mla":
            return self._allocate_latent_pools(mc)
        hk, d = mc.resolved_n_head_kv, mc.resolved_head_dim
        fused = config.fused_kv_pages
        if fused is None:
            # One half-size copy per page for quantized pools.
            fused = qdtype is not None or (not mc.use_alibi
                                           and mc.dtype.itemsize >= 2)
        pool_args = (config.num_pages + 1, config.page_size, hk, d)
        caches = {}
        for i in range(mc.n_layer):
            if qdtype is None and fused:
                caches[i] = allocate_fused_paged_kv_cache(
                    *pool_args, dtype=mc.dtype, device=self.device)
            elif qdtype is None:
                caches[i] = allocate_paged_kv_cache(*pool_args, dtype=mc.dtype,
                                                    device=self.device)
            else:
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
                caches[i] = QuantPagedKV(*pools, k_scale=ks, v_scale=vs)
        return caches

    def _allocate_latent_pools(self, mc) -> dict:
        """An MLA model's page pools, one KV head each (the JAX engine's
        latent branch): a fused rope|latent pool per layer (rope at [0,
        dr), latent at [round_up(dr, 128), + dc)) by default for a >= 2-byte
        dtype, else, or under fused_kv_pages=False, (rope, latent) pools."""
        config = self.config
        fused = config.fused_kv_pages
        if fused is None:
            fused = mc.dtype.itemsize >= 2
        args = (config.num_pages + 1, config.page_size, 1)
        dr, dc = mc.qk_rope_head_dim, mc.kv_lora_rank
        if fused:
            return {i: allocate_fused_paged_kv_cache(
                        *args, dr, dc, dtype=mc.dtype, device=self.device)
                    for i in range(mc.n_layer)}
        return {i: tuple(allocate_paged_kv_cache(*args, width, mc.dtype,
                                                 device=self.device)[0]
                         for width in (dr, dc))
                for i in range(mc.n_layer)}

    def _make_buffers(self):
        """The programs' static tensors: one int32 device buffer holding the
        prefill tokens (mb, chunk), the decode tokens (mb, 1), the offsets
        (mb,) and the block tables (mb, max_pages), in that order, and its
        staging twin on the host (pinned on CUDA), which the host writes
        and copies over without a sync; the outputs; and the host buffer
        that a step's one read lands in."""
        cfg = self.config
        mb, chunk, k = cfg.max_batch_size, cfg.prefill_chunk, cfg.speculative_k
        sizes = (mb * chunk, mb, mb, mb * cfg.max_pages_per_seq)
        ends = np.cumsum(sizes)
        pinned = self.device.type == "cuda"
        self._inputs = torch.zeros(int(ends[-1]), dtype=torch.int32,
                                   device=self.device)
        self._staging = torch.zeros(int(ends[-1]), dtype=torch.int32,
                                    pin_memory=pinned)
        self._decode_start = int(ends[0])
        # The copy of the previous step's inputs, which must have run before
        # the host writes the staging buffer again.
        self._uploaded = torch.cuda.Event() if pinned else None

        def views(buf):
            parts = torch.split(buf, sizes)
            return (parts[0].view(mb, chunk), parts[1].view(mb, 1), parts[2],
                    parts[3].view(mb, cfg.max_pages_per_seq))

        (self._prefill_tokens, self._decode_tokens, self._offsets,
         self._tables) = views(self._inputs)
        self._host = tuple(t.numpy() for t in views(self._staging))
        width = 2 * k + 1 if k > 0 else cfg.decode_depth
        self._sampled = torch.zeros((mb, width), dtype=torch.int32,
                                    device=self.device)
        self._read_back = torch.zeros((mb, width), dtype=torch.int32,
                                      pin_memory=pinned)
        self.last_logits = torch.zeros(
            (mb, self.model.config.padded_vocab_size), dtype=torch.float32,
            device=self.device)

    # -- step programs --------------------------------------------------------

    @torch.no_grad()
    def _apply(self, tokens, offsets, block_tables, *, num_last_tokens=1,
               model=None, caches=None):
        """One forward of `model` (the target by default) over (b, s) tokens
        at per-row cache offsets; appends their K/V to `caches` (the
        target's pools by default) in place. Returns the fp32 logits of the
        last `num_last_tokens` positions."""
        model = self.model if model is None else model
        ip = InferenceParams(
            max_seqlen=self.config.max_seqlen,
            max_batch_size=tokens.shape[0],
            seqlen_offset=offsets,
            key_value_memory_dict=self.caches if caches is None else caches,
            block_table=block_tables,
        )
        logits = model(tokens, inference_params=ip,
                       num_last_tokens=num_last_tokens)
        return logits.float()

    def _prefill_program(self):
        """Appends a (mb, chunk) prefill batch to the pools (the target's,
        then the draft's); the logits are not kept (the last prompt token
        goes through decode)."""
        args = (self._prefill_tokens, self._offsets, self._tables)
        self._apply(*args)
        if self.draft_model is not None:
            self._apply(*args, model=self.draft_model,
                        caches=self.draft_caches)

    def _decode_program(self):
        """decode_depth forwards, each feeding its samples to the next, into
        `_sampled` (mb, decode_depth)."""
        cfg = self.config
        toks, offs = self._decode_tokens, self._offsets
        for j in range(cfg.decode_depth):
            logits = self._apply(toks, offs, self._tables)[:, -1]
            nxt = sample_tokens(logits, self._generator, top_k=cfg.top_k,
                                top_p=cfg.top_p, temperature=cfg.temperature)
            self._sampled[:, j].copy_(nxt)
            toks, offs = nxt[:, None], offs + 1
        self.last_logits.copy_(logits)

    def _round_program(self):
        """One speculative round: k greedy draft steps, then the target
        verifies the newest known token and the k drafts in one forward.
        Writes `_sampled` (mb, 2k + 1): the drafts, then the target's
        argmax at each of the k + 1 positions."""
        k = self.config.speculative_k
        toks, offs = self._decode_tokens, self._offsets
        for j in range(k):
            logits = self._apply(toks, offs, self._tables,
                                 model=self.draft_model,
                                 caches=self.draft_caches)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            self._sampled[:, j].copy_(nxt)
            toks, offs = nxt[:, None], offs + 1
        seq = torch.cat([self._decode_tokens, self._sampled[:, :k]], dim=1)
        logits = self._apply(seq, self._offsets, self._tables,
                             num_last_tokens=k + 1)
        self._sampled[:, k:].copy_(torch.argmax(logits, dim=-1))

    # -- host side of a step ----------------------------------------------------

    def _stage(self):
        """The host's views of the staging buffer, (prefill tokens, decode
        tokens, offsets, tables), once the copy of the last step's inputs
        has run."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
        return self._host

    def _upload(self, start: int = 0):
        """Copies the staged inputs from element `start` on into the static
        inputs, without a sync."""
        self._inputs[start:].copy_(self._staging[start:], non_blocking=True)
        if self._uploaded is not None:
            self._uploaded.record()

    def _read_sampled(self) -> np.ndarray:
        """The step's one device-to-host read: the sampled tokens."""
        return self._read_back.copy_(self._sampled).numpy()

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
        prefill_tokens, decode_tokens, offsets, tables = self._stage()
        tables.fill(self._trash_page)
        tables[:n] = np.where(batch.block_tables < 0, self._trash_page,
                              batch.block_tables)
        offsets.fill(0)
        if batch.kind == 1:  # batched prefill chunks, fixed (mb, chunk) shape
            prefill_tokens.fill(0)
            for i, rid in enumerate(batch.request_ids):
                pos = int(batch.positions[i])
                ln = int(batch.chunk_lens[i])
                chunk = self._prompts[int(rid)][pos : pos + ln]
                prefill_tokens[i, : len(chunk)] = chunk
                offsets[i] = pos
            self._upload()
            self.graphs["prefill"]()
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

        decode_tokens.fill(0)
        for i, rid in enumerate(batch.request_ids):
            out = self.outputs[int(rid)]
            decode_tokens[i, 0] = (
                out.tokens[-1] if out.tokens else self._prompts[int(rid)][-1]
            )
        offsets[:n] = batch.positions
        self._upload(self._decode_start)
        k = cfg.speculative_k
        if k > 0:
            self.graphs["round"]()
            host = self._read_sampled()
            self.spec_rounds += 1
            cand = []
            for i in range(n):
                a = 0
                while a < k and host[i, a] == host[i, k + a]:
                    a += 1  # greedy acceptance: draft matches target pred
                cand.append([int(t) for t in host[i, k : k + a + 1]])
                self.spec_accepted += a
            self.spec_drafted += k * n
        else:
            self.graphs["decode"]()
            host = self._read_sampled()  # (mb, decode_depth)
            self.decode_steps += cfg.decode_depth
            cand = [[int(t) for t in host[i]] for i in range(n)]
        produced, done = [], []
        for i, rid in enumerate(batch.request_ids):
            rid = int(rid)
            out = self.outputs[rid]
            # Keep at most the scheduler-planned count (clamped to the
            # request's remaining budget), stopping at EOS; overshoot
            # tokens beyond that were written to invisible cache slots.
            kept = 0
            fin = False
            for tok in cand[i][: int(batch.chunk_lens[i])]:
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
