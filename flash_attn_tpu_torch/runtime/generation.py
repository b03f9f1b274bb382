"""Text generation (counterpart of flash_attn_tpu/runtime/generation.py):
token sampling, the autoregressive `decode` loop, `GenerationMixin.generate`
over contiguous KV caches, and speculative decoding.

Differences from the JAX module, by design:
  * The loops are Python loops where the JAX module runs `lax.scan` and
    `lax.while_loop` on the device. `decode` makes no host read: with `cg`
    on CUDA (`generate`'s default) it captures one (b, 1) step, sampling
    and EOS masking included, in a CUDA graph (`runtime.graphs.StepGraph`)
    and replays it, where the JAX module jits its step;
    `decode_speculative` reads each verify round's outcome to the host once
    (the JAX loop reads once per generation).
  * Randomness comes from an explicit `torch.Generator` (the JAX functions
    take a PRNG key); the two give different numbers from one seed.
  * Apply functions take no params: the module holds its weights, and the
    caches are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from flash_attn_tpu_torch.modules.mha import InferenceParams
from flash_attn_tpu_torch.runtime.graphs import StepGraph


def sample_tokens(
    logits: torch.Tensor,  # (b, vocab)
    generator: Optional[torch.Generator] = None,
    *,
    top_k: int = 1,
    top_p: float = 0.0,
    min_p: float = 0.0,
    temperature: float = 1.0,
) -> torch.Tensor:
    """top-k / top-p / min-p / temperature sampling; top_k=1 is greedy
    (argmax, the first maximum on ties). Returns (b,) int32.

    Reads nothing to the host, so a step that samples can be captured in a
    CUDA graph: the draw is the one `torch.multinomial(probs, 1)` makes
    (the argmax of probs / q, q ~ Exp(1) from `generator`), without its
    checks of the probabilities, which read the device."""
    if top_k == 1:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / temperature
    neg_inf = float("-inf")
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg_inf)
    if min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        logits = logits.masked_fill(probs < min_p * pmax, neg_inf)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep the smallest set with cumulative probability >= top_p.
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, neg_inf)
    probs = torch.softmax(logits, dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


@dataclasses.dataclass
class GenerationOutput:
    """What `decode` and `decode_speculative` return."""

    sequences: torch.Tensor                 # (b, prompt + new)
    scores: Optional[torch.Tensor] = None   # (b, new - 1, vocab) if asked
    lengths: Optional[torch.Tensor] = None  # (b,) tokens committed, eos included


def decode(
    input_ids: torch.Tensor,  # (b, prompt_len)
    apply_fn: Callable,  # (tokens, caches, offsets, num_last_tokens) -> (logits, caches)
    caches: Dict,
    max_new_tokens: int,
    *,
    top_k: int = 1,
    top_p: float = 0.0,
    min_p: float = 0.0,
    temperature: float = 1.0,
    eos_token_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    return_scores: bool = False,
    cg: bool = False,
) -> GenerationOutput:
    """Greedy or sampled autoregressive decode: a prefill of the prompt,
    then max_new_tokens - 1 one-token steps. As in the JAX function, the
    scores are the fp32 logits of those steps (step i's predicts new token
    i + 1; the prefill's are not kept), and once a row has sampled the eos
    token every later token of it is eos.

    With `cg`, the one-token step, its sampling and EOS masking run over
    static token, offset and finished buffers and write their token and
    scores at a step index on the device: on CUDA captured once in a CUDA
    graph and replayed, with no host read; elsewhere run eagerly, the same
    code. `apply_fn` must then update the caches in place."""
    b, prompt_len = input_ids.shape
    dev = input_ids.device
    sample = dict(top_k=top_k, top_p=top_p, min_p=min_p,
                  temperature=temperature)
    offsets = torch.zeros((b,), dtype=torch.int32, device=dev)
    logits, caches = apply_fn(input_ids, caches, offsets, 1)
    token = sample_tokens(logits[:, -1], generator, **sample)
    finished = (token == eos_token_id if eos_token_id is not None
                else torch.zeros((b,), dtype=torch.bool, device=dev))
    offset = offsets + prompt_len
    if cg:
        return _decode_graphed(input_ids, apply_fn, caches, max_new_tokens,
                               token, offset, finished, logits.shape[-1],
                               sample, eos_token_id, generator, return_scores)
    tokens, scores = [], []
    for _ in range(max_new_tokens - 1):
        logits, caches = apply_fn(token[:, None], caches, offset, 1)
        nxt = sample_tokens(logits[:, -1], generator, **sample)
        if eos_token_id is not None:
            nxt = torch.where(finished, torch.full_like(nxt, eos_token_id), nxt)
            finished = finished | (nxt == eos_token_id)
        if return_scores:
            scores.append(logits[:, -1])
        tokens.append(token)
        token, offset = nxt, offset + 1
    tokens.append(token)
    new = torch.stack(tokens, dim=1).to(input_ids.dtype)
    out_scores = None
    if return_scores:
        out_scores = (torch.stack(scores, dim=1) if scores
                      else logits.new_zeros((b, 0, logits.shape[-1])))
    return GenerationOutput(sequences=torch.cat([input_ids, new], dim=1),
                            scores=out_scores)


def _decode_graphed(input_ids, apply_fn, caches, max_new_tokens, token,
                    offset, finished, vocab, sample, eos_token_id, generator,
                    return_scores) -> GenerationOutput:
    """`decode`'s one-token steps as one `StepGraph` over static buffers
    (token, offset, finished, and the step index into the outputs)."""
    b = input_ids.shape[0]
    dev = input_ids.device
    steps = max(max_new_tokens - 1, 0)
    new = torch.empty((b, steps + 1), dtype=input_ids.dtype, device=dev)
    scores = (torch.empty((b, steps, vocab), dtype=torch.float32, device=dev)
              if return_scores else None)
    step = torch.zeros((1,), dtype=torch.long, device=dev)

    def one_step():
        logits, _ = apply_fn(token[:, None], caches, offset, 1)
        nxt = sample_tokens(logits[:, -1], generator, **sample)
        if eos_token_id is not None:
            nxt = nxt.masked_fill(finished, eos_token_id)
            finished.logical_or_(nxt == eos_token_id)
        if return_scores:
            scores.index_copy_(1, step, logits[:, -1:].float())
        new.index_copy_(1, step, token[:, None].to(new.dtype))
        token.copy_(nxt)
        offset.add_(1)
        step.add_(1)

    graph = StepGraph(one_step, dev,
                      generators=[generator] if sample["top_k"] != 1 else [])
    for _ in range(steps):
        graph()
    new[:, -1] = token
    return GenerationOutput(sequences=torch.cat([input_ids, new], dim=1),
                            scores=scores)


def make_apply_fn(model, max_seqlen: int, max_batch: int):
    """The (tokens, caches, offsets, num_last_tokens) -> (fp32 logits,
    caches) step of `decode` for a GPTLMHeadModel. The caches are updated
    in place; the dict comes back as it went in."""

    def apply_fn(tokens, caches, offsets, num_last_tokens):
        ip = InferenceParams(max_seqlen=max_seqlen, max_batch_size=max_batch,
                             seqlen_offset=offsets,
                             key_value_memory_dict=dict(caches))
        with torch.no_grad():
            logits = model(tokens, inference_params=ip,
                           num_last_tokens=num_last_tokens)
        return logits.float(), ip.key_value_memory_dict

    return apply_fn


class GenerationMixin:
    """`generate` for a model with `allocate_inference_cache`."""

    def generate(
        self,
        input_ids: torch.Tensor,
        max_length: int,
        *,
        top_k: int = 1,
        top_p: float = 0.0,
        min_p: float = 0.0,
        temperature: float = 1.0,
        eos_token_id: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        return_dict_in_generate: bool = False,
        output_scores: bool = False,
        cg: bool = True,
    ):
        """Generate up to `max_length` tokens in all (prompt included)
        through contiguous caches of that length. `cg` (the reference's
        CUDA-graph cache; the JAX package jits instead): the decode steps
        replay one captured CUDA graph on the card (`decode`'s `cg`)."""
        b, prompt = input_ids.shape
        caches = self.allocate_inference_cache(b, max_length).key_value_memory_dict
        apply_fn = make_apply_fn(self, max_length, b)
        out = decode(
            input_ids, apply_fn, caches, max_length - prompt, top_k=top_k,
            top_p=top_p, min_p=min_p, temperature=temperature,
            eos_token_id=eos_token_id, generator=generator,
            return_scores=output_scores, cg=cg)
        return out if return_dict_in_generate else out.sequences


def sample_speculative(
    target_probs: torch.Tensor,  # (b, g + 1, vocab)
    draft_probs: torch.Tensor,   # (b, g, vocab)
    draft_tokens: torch.Tensor,  # (b, g)
    generator: Optional[torch.Generator] = None,
):
    """Rejection-sampling acceptance. Returns (tokens (b, g + 1),
    num_accepted (b,)): tokens[i, :num_accepted] are accepted draft tokens,
    tokens[i, num_accepted] the corrected sample (from the residual
    max(p_target - p_draft, 0)) or, when all were accepted, the bonus sample
    from target_probs[:, g]. Entries past that are arbitrary."""
    b, g = draft_tokens.shape
    dev = draft_tokens.device
    vocab = target_probs.shape[-1]
    u = torch.rand((b, g), generator=generator, device=dev)
    dt = draft_tokens.long()[..., None]
    p_t = torch.gather(target_probs[:, :g], -1, dt)[..., 0]
    p_d = torch.gather(draft_probs, -1, dt)[..., 0]
    accept = u < torch.clamp(p_t / p_d.clamp_min(1e-9), max=1.0)
    num_accepted = torch.cumprod(accept.int(), dim=-1).sum(dim=-1)
    rows = torch.arange(b, device=dev)
    idx = num_accepted.clamp(max=g - 1)
    residual = (target_probs[rows, idx] - draft_probs[rows, idx]).clamp_min(0.0)
    total = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(total > 0, residual / total.clamp_min(1e-9),
                           torch.full_like(residual, 1.0 / vocab))
    # The JAX module samples categorical(log(max(p, 1e-20))).
    corrected = torch.multinomial(residual.clamp_min(1e-20), 1,
                                  generator=generator)[:, 0]
    bonus = torch.multinomial(target_probs[:, g].clamp_min(1e-20), 1,
                              generator=generator)[:, 0]
    final = torch.where(num_accepted == g, bonus, corrected).to(torch.int32)
    tokens = torch.cat([draft_tokens.to(torch.int32),
                        torch.zeros((b, 1), dtype=torch.int32, device=dev)], 1)
    at = torch.arange(g + 1, device=dev)[None] == num_accepted[:, None]
    return torch.where(at, final[:, None], tokens), num_accepted


def decode_speculative(
    input_ids: torch.Tensor,  # (1, prompt), batch 1 as in the reference
    target_apply: Callable,
    target_caches: Dict,
    draft_apply: Callable,
    draft_caches: Dict,
    max_new_tokens: int,
    *,
    gamma: int = 4,
    top_k: int = 1,
    temperature: float = 1.0,
    eos_token_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> GenerationOutput:
    """Speculative decoding, as the JAX function: both models prefill
    prompt[:-1]; then each round the draft proposes `gamma` tokens one by
    one, the target scores [last, d_1..d_gamma] in one forward, and the
    accepted prefix plus one corrected (or bonus) token is committed. Greedy
    (top_k=1) accepts exact argmax matches, so its tokens are the target's
    own greedy ones. All gamma + 1 tokens are appended to both caches every
    round; rejected ones stay as stale rows past the committed length, never
    visible (later rounds overwrite them), so the caches need gamma + 1
    slots beyond prompt + max_new_tokens. One host read per round (the
    round's tokens and how many are accepted) steers the loop. `lengths`
    is the committed count, which may exceed max_new_tokens; `sequences`
    is cut to it."""
    if input_ids.shape[0] != 1:
        raise ValueError("decode_speculative takes batch 1, as the reference")
    dev = input_ids.device
    prompt_len = input_ids.shape[1]
    greedy = top_k == 1
    g = gamma
    temp = 1.0 if greedy else temperature
    if prompt_len > 1:
        z = torch.zeros((1,), dtype=torch.int32, device=dev)
        _, target_caches = target_apply(input_ids[:, :-1], target_caches, z, 1)
        _, draft_caches = draft_apply(input_ids[:, :-1], draft_caches, z, 1)

    buf_len = max_new_tokens + g + 1
    buf = [0] * buf_len
    count, offset, finished = 0, prompt_len - 1, False
    last = input_ids[:, -1:]
    while count < max_new_tokens and not finished:
        off_vec = torch.full((1,), offset, dtype=torch.int32, device=dev)
        cur, d_tokens, d_probs = last, [], []
        for i in range(g):
            logits, draft_caches = draft_apply(cur, draft_caches, off_vec + i, 1)
            if greedy:
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            else:
                d_probs.append(torch.softmax(logits[:, -1] / temp, dim=-1))
                tok = sample_tokens(logits[:, -1], generator, top_k=top_k,
                                    temperature=temperature)
            d_tokens.append(tok)
            cur = tok[:, None].to(input_ids.dtype)
        draft_tokens = torch.stack(d_tokens, dim=1)  # (1, g)
        chunk = torch.cat([last, draft_tokens.to(input_ids.dtype)], dim=1)
        t_logits, target_caches = target_apply(chunk, target_caches, off_vec,
                                               g + 1)
        if greedy:
            t_argmax = torch.argmax(t_logits, dim=-1).to(torch.int32)
            host = torch.cat([draft_tokens[0], t_argmax[0]]).tolist()
            drafted, target = host[:g], host[g:]
            n_acc = 0
            while n_acc < g and drafted[n_acc] == target[n_acc]:
                n_acc += 1
            row = drafted + [0]
            row[n_acc] = target[n_acc]
        else:
            target_probs = torch.softmax(t_logits / temp, dim=-1)
            tokens, n_acc_arr = sample_speculative(
                target_probs, torch.stack(d_probs, dim=1), draft_tokens,
                generator)
            host = torch.cat([n_acc_arr.to(torch.int32), tokens[0]]).tolist()
            n_acc, row = host[0], host[1:]
        n = n_acc + 1  # committed this round
        if eos_token_id is not None:
            eos_pos = next((i for i in range(n) if row[i] == eos_token_id),
                           g + 1)
            finished = finished or eos_pos <= n_acc
            n = min(n, eos_pos + 1)
        for i in range(n):
            if count + i < buf_len:
                buf[count + i] = row[i]
        last = torch.full((1, 1), row[n - 1], dtype=input_ids.dtype,
                          device=dev)
        count += n
        offset += n
    new = torch.tensor([buf[:min(count, max_new_tokens)]],
                       dtype=input_ids.dtype, device=dev)
    return GenerationOutput(sequences=torch.cat([input_ids, new], dim=1),
                            lengths=torch.tensor([count], device=dev))
