"""Plain reference computations for checking the port: the attention oracle
(counterpart of flash_attn_tpu/utils/testing.py `attention_ref`: causal
and windows aligned bottom-right for seqlen_q != seqlen_k, GQA, softcap,
key padding and leftpad, chunks, sink tokens, a learnable sink),
its packed-varlen form, the vertical-slash sparse oracle, attention under
a dense keep-mask (block-sparse plans), random padding masks, a
full-sequence GPT forward with no cache, and its loss as a gradient
oracle."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flash_attn_tpu_torch.kernels.common import (
    alibi_bias,
    default_alibi_slopes,
    dropout_keep_mask,
    fold_seed,
)
from flash_attn_tpu_torch.layers.rotary import RotaryEmbedding
from flash_attn_tpu_torch.losses.cross_entropy import cross_entropy_loss
from flash_attn_tpu_torch.models.gpt import GATED_ACTIVATIONS
from flash_attn_tpu_torch.modules.mlp import ACT2FN
from flash_attn_tpu_torch.ops.rotary import apply_rotary_emb


def _key_cols(seqlen_k, key_leftpad, device):
    """Key columns, leftpad-relative with key_leftpad ((b, 1, 1, sk); the
    columns below a row's leftpad become 2**30), else (sk,)."""
    col = torch.arange(seqlen_k, device=device)
    if key_leftpad is None:
        return col
    lp = key_leftpad.to(device).long().reshape(-1, 1, 1, 1)
    return torch.where(col >= lp, col - lp, torch.full_like(col - lp, 2**30))


def _key_len(seqlen_k, key_padding_mask):
    if key_padding_mask is None:
        return seqlen_k
    return key_padding_mask.sum(-1).reshape(-1, 1, 1, 1)


def construct_local_mask(seqlen_q: int, seqlen_k: int,
                         window_size: Tuple[Optional[int], Optional[int]],
                         device=None, *, sink_token_length: int = 0,
                         key_padding_mask: Optional[torch.Tensor] = None,
                         key_leftpad: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """Boolean mask of entries to DROP: a window aligned bottom-right to
    each row's key length (key_padding_mask's count, else seqlen_k), in
    leftpad-relative columns with key_leftpad; (None, wr) for causal-style
    masks without a left edge; the first sink_token_length columns stay
    visible past the left edge. (sq, sk), or (b, 1, sq, sk) with a padding
    mask or leftpad."""
    row = torch.arange(seqlen_q, device=device)[:, None]
    col = _key_cols(seqlen_k, key_leftpad, device)
    sk = _key_len(seqlen_k, key_padding_mask)
    diag = row + sk - seqlen_q
    if window_size[0] is None:
        return col > diag + window_size[1]
    limit = diag + window_size[1]
    if key_padding_mask is None:
        limit = torch.clamp(limit, max=seqlen_k)
    else:
        limit = torch.minimum(limit, sk)
    return (col > limit) | ((col < diag - window_size[0])
                            & (col >= sink_token_length))


def construct_chunk_mask(seqlen_q: int, seqlen_k: int, attention_chunk: int,
                         device=None, *,
                         key_padding_mask: Optional[torch.Tensor] = None,
                         key_leftpad: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """Boolean mask of entries to DROP for chunked (Llama-4-style)
    attention (counterpart of flash_attn_tpu/utils/testing.py:66): query
    row i, aligned bottom-right at diag = i + sk - sq, sees only the keys
    of its own chunk [diag - diag % chunk, + chunk), in leftpad-relative
    columns with key_leftpad (floor modulo, so negative diagonals round
    toward -inf)."""
    row = torch.arange(seqlen_q, device=device)[:, None]
    col = _key_cols(seqlen_k, key_leftpad, device)
    diag = row + _key_len(seqlen_k, key_padding_mask) - seqlen_q
    lo = diag - torch.remainder(diag, attention_chunk)
    return (col < lo) | (col >= lo + attention_chunk)


def attention_ref(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, hk, d)
    v: torch.Tensor,  # (b, sk, hk, dv)
    *,
    key_padding_mask: Optional[torch.Tensor] = None,  # (b, sk) bool
    key_leftpad: Optional[torch.Tensor] = None,       # (b,)
    causal: bool = False,
    q_descale: Optional[torch.Tensor] = None,         # (b, hk)
    k_descale: Optional[torch.Tensor] = None,         # (b, hk)
    v_descale: Optional[torch.Tensor] = None,         # (b, hk)
    window_size: Tuple[Optional[int], Optional[int]] = (None, None),
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    learnable_sink: Optional[torch.Tensor] = None,    # (h,)
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
    alibi_slopes: Optional[torch.Tensor] = None,      # (h,) or (b, h)
    dropout_p: float = 0.0,
    dropout_mask: Optional[torch.Tensor] = None,      # (b, h, sq, sk) keep
):
    """Exact attention; returns (output (b, sq, h, dv), probs (b, h, sq,
    sk)), both in q's dtype. upcast=False keeps the products in the input
    dtype (the "eager low-precision" run of the tolerance contract); the
    softmax is computed in fp32 either way. Keys outside key_padding_mask
    are dropped; windows and chunks are aligned to each row's key count in
    leftpad-relative columns (the reference oracle's rules); a learnable
    sink adds exp(sink) to each row's softmax denominator. ALiBi subtracts
    slope |j - i - (sk - sq)| after the softcap; dropout (the JAX oracle's
    dropout_mask, the keep mask) zeroes the dropped probabilities of the
    output's product and scales it by 1 / (1 - dropout_p); the returned
    probabilities are the undropped ones. The descales
    (the JAX oracle's) multiply q (per kv head of its group), k and v in
    fp32 before anything else: a 1-byte cache is held to this oracle on its
    dequantized values."""
    if causal:
        window_size = (window_size[0], 0)
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    b, seqlen_q, h, d = q.shape
    seqlen_k, hk = k.shape[1], k.shape[2]
    if q_descale is not None:
        qd = q_descale.float().repeat_interleave(h // hk, dim=-1)
        q = (q.float() * qd.reshape(b, 1, h, 1)).to(q.dtype)
    if k_descale is not None:
        k = (k.float() * k_descale.float().reshape(b, 1, hk, 1)).to(k.dtype)
    if v_descale is not None:
        v = (v.float() * v_descale.float().reshape(b, 1, hk, 1)).to(v.dtype)
    k = k.repeat_interleave(h // hk, dim=2)
    v = v.repeat_interleave(h // hk, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bthd,bshd->bhts", q * scale, k).float()
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if key_padding_mask is not None:
        scores = scores.masked_fill(~key_padding_mask.reshape(b, 1, 1, seqlen_k),
                                    float("-inf"))
    wl = window_size[0] if window_size[0] is not None and window_size[0] >= 0 else None
    wr = window_size[1] if window_size[1] is not None and window_size[1] >= 0 else None
    masks = dict(key_padding_mask=key_padding_mask, key_leftpad=key_leftpad)
    if wl is not None or wr is not None:
        mask = construct_local_mask(
            seqlen_q, seqlen_k, (wl, seqlen_k if wr is None else wr),
            device=q.device, sink_token_length=sink_token_length, **masks)
        scores = scores.masked_fill(mask, float("-inf"))
    if attention_chunk > 0:
        scores = scores.masked_fill(construct_chunk_mask(
            seqlen_q, seqlen_k, attention_chunk, device=q.device, **masks),
            float("-inf"))
    if alibi_slopes is not None:
        scores = scores + alibi_bias(alibi_slopes, slice(0, h), seqlen_q,
                                     seqlen_k, q.device)
    row_max = scores.amax(dim=-1, keepdim=True)
    if learnable_sink is not None:
        sink = learnable_sink.float().to(q.device).reshape(1, h, 1, 1)
        row_max = torch.maximum(row_max, sink)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    unnorm = torch.exp(scores - row_max)
    denom = unnorm.sum(dim=-1, keepdim=True)
    if learnable_sink is not None:
        denom = denom + torch.exp(sink - row_max)
    attention = torch.where(denom > 0, unnorm / denom.clamp_min(1e-37),
                            torch.zeros_like(unnorm))
    dropped = attention
    if dropout_mask is not None:
        dropped = torch.where(dropout_mask.to(q.device), attention,
                              torch.zeros_like(attention)) / (1.0 - dropout_p)
    output = torch.einsum("bhts,bshd->bthd", dropped.to(v.dtype), v)
    return output.to(dtype_og), attention.to(dtype_og)


def varlen_attention_ref(
    q: torch.Tensor,  # (total_q, h, d)
    k: torch.Tensor,  # (total_k, hk, d)
    v: torch.Tensor,  # (total_k, hk, dv)
    cu_seqlens_q: torch.Tensor,
    cu_seqlens_k: torch.Tensor,
    *,
    seqused_q: Optional[torch.Tensor] = None,
    seqused_k: Optional[torch.Tensor] = None,
    causal: bool = False,
    window_size: Tuple[Optional[int], Optional[int]] = (None, None),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
) -> torch.Tensor:
    """Packed varlen attention as `attention_ref` run on each sequence alone
    (bottom-right aligned within it), its rows cut to seqused_q and its
    keys to seqused_k. Returns out (total_q, h, dv); rows past seqused_q
    and rows that see nothing give 0. Differentiable."""
    cu_q = cu_seqlens_q.tolist()
    cu_k = cu_seqlens_k.tolist()
    used_q = None if seqused_q is None else seqused_q.tolist()
    used_k = None if seqused_k is None else seqused_k.tolist()
    outs = []
    for j in range(len(cu_q) - 1):
        q0, q1, k0, k1 = cu_q[j], cu_q[j + 1], cu_k[j], cu_k[j + 1]
        rows = q1 - q0 if used_q is None else min(q1 - q0, used_q[j])
        keys = k1 - k0 if used_k is None else min(k1 - k0, used_k[j])
        zero = q.new_zeros((q1 - q0, q.shape[1], v.shape[2]))
        if rows <= 0 or keys <= 0:
            outs.append(zero)
            continue
        o, _ = attention_ref(q[q0:q0 + rows][None], k[k0:k0 + keys][None],
                             v[k0:k0 + keys][None], causal=causal,
                             window_size=window_size, softcap=softcap,
                             softmax_scale=softmax_scale, upcast=upcast)
        outs.append(torch.cat([o[0], zero[rows:]]))
    return torch.cat(outs)


def sparse_attention_ref(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, hk, d)
    v: torch.Tensor,  # (b, sk, hk, d)
    block_count: torch.Tensor,   # (b, h, cdiv(sq, 64))
    block_offset: torch.Tensor,  # (b, h, nqb, NNZ_S)
    column_count: torch.Tensor,  # (b, h, nqb)
    column_index: torch.Tensor,  # (b, h, nqb, NNZ_V)
    *,
    causal: bool = False,
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # (h,) or (b, h)
    seqlens_q: Optional[torch.Tensor] = None,     # (b,)
    seqlens_k: Optional[torch.Tensor] = None,
    upcast: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact vertical-slash sparse attention, an oracle independent of the
    port's planners and plain versions: the rows of 64-row block m attend
    key columns [off, off + 64) for each of its first block_count offsets
    (unaligned offsets taken as they are, MInference's meaning) and each of
    its first column_count vertical columns, those in [0, sk); then row i
    sees column j only if i < len_q, j < len_k and, with causal,
    j <= i + len_k - len_q; ALiBi subtracts slope * |j - i - (len_k -
    len_q)| after the softcap. Returns (out (b, sq, h, d) in q's dtype, lse
    (b, h, sq) fp32, -inf on rows that see nothing); differentiable."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    keep = torch.zeros(b, h, sq, sk, dtype=torch.bool)
    bc, bo = block_count.tolist(), block_offset.tolist()
    cc, ci = column_count.tolist(), column_index.tolist()
    for bi in range(b):
        for hi in range(h):
            for m in range(len(bc[bi][hi])):
                rows = slice(64 * m, 64 * (m + 1))
                for off in bo[bi][hi][m][:bc[bi][hi][m]]:
                    keep[bi, hi, rows, max(off, 0):max(off + 64, 0)] = True
                for col in ci[bi][hi][m][:cc[bi][hi][m]]:
                    if 0 <= col < sk:
                        keep[bi, hi, rows, col] = True
    len_q = (torch.full((b,), sq) if seqlens_q is None
             else seqlens_q.cpu().long())[:, None, None, None]
    len_k = (torch.full((b,), sk) if seqlens_k is None
             else seqlens_k.cpu().long())[:, None, None, None]
    row = torch.arange(sq)[:, None]
    col = torch.arange(sk)[None]
    keep &= (row < len_q) & (col < len_k)
    rel = col - row - (len_k - len_q)
    if causal:
        keep &= rel <= 0
    keep = keep.to(q.device)
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    k = k.repeat_interleave(h // hk, dim=2)
    v = v.repeat_interleave(h // hk, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().cpu()
        slopes = slopes.reshape(1, h) if slopes.dim() == 1 else slopes
        scores = scores - (slopes[:, :, None, None]
                           * rel.abs().float()).to(scores.device)
    scores = scores.masked_fill(~keep, float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    unnorm = torch.exp(scores - row_max)
    denom = unnorm.sum(dim=-1, keepdim=True)
    attention = torch.where(denom > 0, unnorm / denom.clamp_min(1e-37),
                            torch.zeros_like(unnorm))
    lse = torch.where(denom > 0, row_max + torch.log(denom.clamp_min(1e-37)),
                      torch.full_like(denom, float("-inf")))[..., 0]
    output = torch.einsum("bhts,bshd->bthd", attention.to(v.dtype), v)
    return output.to(dtype_og), lse


def masked_attention_ref(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, hk, d)
    v: torch.Tensor,  # (b, sk, hk, dv)
    keep: torch.Tensor,  # (b | 1, h | 1, sq, sk) bool
    *,
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    upcast: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention under a dense keep-mask (True: row i sees column j),
    for block-sparse plans expanded element by element. Returns (out (b,
    sq, h, dv) in q's dtype, lse (b, h, sq) fp32, -inf on rows that keep
    nothing, whose out is 0); differentiable."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    dtype_og = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    k = k.repeat_interleave(h // hk, dim=2)
    v = v.repeat_interleave(h // hk, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores.masked_fill(~keep.to(scores.device), float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    unnorm = torch.exp(scores - row_max)
    denom = unnorm.sum(dim=-1, keepdim=True)
    attention = torch.where(denom > 0, unnorm / denom.clamp_min(1e-37),
                            torch.zeros_like(unnorm))
    lse = torch.where(denom > 0, row_max + torch.log(denom.clamp_min(1e-37)),
                      torch.full_like(denom, float("-inf")))[..., 0]
    output = torch.einsum("bhts,bshd->bthd", attention.to(v.dtype), v)
    return output.to(dtype_og), lse


def generate_random_padding_mask(max_seqlen: int, batch_size: int,
                                 device=None, mode: str = "random",
                                 zero_lengths: bool = False,
                                 generator: Optional[torch.Generator] = None,
                                 ) -> torch.Tensor:
    """(batch_size, max_seqlen) bool mask of each row's first `length`
    tokens (counterpart of flash_attn_tpu/utils/testing.py:235): lengths
    full, within 20 of max_seqlen ("random"), or from a third up
    ("third"); with zero_lengths, rows 0, 5, 10, ... and the last are
    empty."""
    if mode == "full":
        lengths = torch.full((batch_size, 1), max_seqlen, device=device)
    elif mode == "random":
        lengths = torch.randint(max(0 if zero_lengths else 1, max_seqlen - 20),
                                max_seqlen + 1, (batch_size, 1), device=device,
                                generator=generator)
    elif mode == "third":
        lengths = torch.randint(max_seqlen // 3, max_seqlen + 1,
                                (batch_size, 1), device=device,
                                generator=generator)
    else:
        raise ValueError(mode)
    if zero_lengths:
        idx = torch.arange(batch_size, device=device)
        empty = (idx % 5 == 0) | (idx == batch_size - 1)
        lengths = torch.where(empty[:, None], 0, lengths)
    return torch.arange(max_seqlen, device=device)[None] < lengths


@torch.no_grad()
def gpt_forward_ref(model_or_state_dict, input_ids: torch.Tensor,
                    config=None, dtype=torch.float32) -> torch.Tensor:
    """Logits (b, s, vocab) of a plain full-sequence forward with no cache.

    Takes a `GPTLMHeadModel` or its state_dict (then `config` too). Weights
    are cast to `dtype` one at a time as they are used, so an fp32
    reference of a bf16 model needs little more memory than the model.
    Norms, softmax and the residual stream follow the model's own precision
    rules; `dtype` sets that of the products and activations."""
    if isinstance(model_or_state_dict, nn.Module):
        return _gpt_logits(model_or_state_dict.state_dict(),
                           model_or_state_dict.config, input_ids, dtype)
    return _gpt_logits(model_or_state_dict, config, input_ids, dtype)


def gpt_loss_ref(model: nn.Module, input_ids: torch.Tensor,
                 labels: torch.Tensor, dtype=torch.float32,
                 dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy of the plain forward's logits (cast to fp32),
    differentiable in the model's parameters: the gradient oracle of a
    training step. Attention is `attention_ref` (plain, no kernel); with
    `dropout_seed` and the config's attn_pdrop, layer i drops with the keep
    mask of fold_seed(dropout_seed, i), as the model's training forward
    does."""
    params = dict(model.named_parameters())
    logits = _gpt_logits(params, model.config, input_ids, dtype, dropout_seed)
    return cross_entropy_loss(logits.float(), labels)


def _gpt_logits(sd, config, input_ids, dtype, dropout_seed=None):
    c = config
    if not c.prenorm or c.parallel_block or c.attn_type not in ("mha", "mla"):
        raise NotImplementedError("gpt_forward_ref covers the pre-norm, "
                                  "sequential-block MHA and MLA models")
    h, hk, d = c.n_head, c.resolved_n_head_kv, c.resolved_head_dim
    b, s = input_ids.shape

    def w(name):
        t = sd.get(name)
        return None if t is None else t.to(dtype)

    def linear(x, name):
        return F.linear(x, w(name + ".weight"), w(name + ".bias"))

    def norm(x, name):
        x = x.float()
        if c.rms_norm:
            y = x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                                + c.layer_norm_epsilon)
            return (y * sd[name + ".weight"].float()).to(dtype)
        return F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"].float(),
                            sd[name + ".bias"].float(),
                            c.layer_norm_epsilon).to(dtype)

    ids = input_ids.to(sd["transformer.embeddings.word_embeddings.weight"].device)
    x = F.embedding(ids, w("transformer.embeddings.word_embeddings.weight"))
    if c.n_positions > 0:
        pos = c.position_offset + torch.arange(s, device=ids.device)
        x = x + F.embedding(pos, w("transformer.embeddings.position_embeddings.weight"))[None]
    if c.embed_scale is not None:
        x = x * torch.tensor(c.embed_scale, dtype=dtype)
    rot_dim = (c.qk_rope_head_dim if c.attn_type == "mla"
               else int(c.rotary_emb_fraction * d))
    if rot_dim > 0:
        cos, sin = RotaryEmbedding(rot_dim, base=c.rotary_emb_base).cos_sin(
            s, device=ids.device)
    acc = torch.float32 if c.residual_in_fp32 else dtype
    residual = None
    gated = c.activation_function in GATED_ACTIVATIONS
    slopes = default_alibi_slopes(h).to(ids.device) if c.use_alibi else None
    act = ACT2FN[c.activation_function]
    upcast = dtype == torch.float32
    for i in range(c.n_layer):
        p = f"transformer.layers.{i}."
        residual = x.to(acc) if residual is None else residual + x.to(acc)
        y = norm(residual, p + "norm1")
        if c.attn_type == "mla":
            o = _mla_ref(c, y, p + "mixer.", w, linear, cos, sin, upcast)
        else:
            q = linear(y, p + "mixer.Wq").reshape(b, s, h, d)
            k = linear(y, p + "mixer.Wk").reshape(b, s, hk, d)
            v = linear(y, p + "mixer.Wv").reshape(b, s, hk, d)
            if rot_dim > 0:
                rot = dict(interleaved=c.rotary_emb_interleaved)
                q = apply_rotary_emb(q, cos, sin, **rot)
                k = apply_rotary_emb(k, cos, sin, **rot)
            drop = {}
            if dropout_seed is not None and c.attn_pdrop > 0:
                drop = dict(dropout_p=c.attn_pdrop, dropout_mask=dropout_keep_mask(
                    fold_seed(dropout_seed, i),
                    torch.arange(b, device=ids.device).reshape(-1, 1, 1, 1),
                    torch.arange(h, device=ids.device).reshape(1, -1, 1, 1), 0, 0,
                    (s, s), 1.0 - c.attn_pdrop, device=ids.device))
            o, _ = attention_ref(q, k, v, causal=True,
                                 window_size=(c.window_size[0], None),
                                 softcap=c.softcap, upcast=upcast,
                                 alibi_slopes=slopes, **drop)
            del drop
        residual = residual + linear(o.reshape(b, s, -1),
                                     p + "mixer.out_proj").to(acc)
        y = norm(residual, p + "norm2")
        if gated:
            y = act(linear(y, p + "mlp.fc1_gate")) * linear(y, p + "mlp.fc1_up")
        else:
            y = act(linear(y, p + "mlp.fc1"))
        x = linear(y, p + "mlp.fc2")
    residual = residual + x.to(acc)
    hidden = norm(residual, "transformer.ln_f")
    head = ("transformer.embeddings.word_embeddings.weight"
            if c.tie_word_embeddings else "lm_head.weight")
    return F.linear(hidden, w(head))


def _mla_ref(c, y, prefix, w, linear, cos, sin, upcast):
    """An MLA layer's attention output (b, s, h, dv) in the expanded form,
    independent of the absorbed one the module computes: per-head keys
    [W_uk c | k_rope] and values W_uv c, through `attention_ref` at the
    scale (dn + dr)^-0.5."""
    b, s, _ = y.shape
    h, dc = c.n_head, c.kv_lora_rank
    dn = c.qk_nope_head_dim or c.resolved_head_dim
    q = (linear(linear(y, prefix + "W_dq"), prefix + "W_uq") if c.q_lora_rank
         else linear(y, prefix + "W_q")).reshape(b, s, h, -1)
    ckv = linear(y, prefix + "W_dkv")
    lat, k_rope = ckv[..., :dc], ckv[..., dc:]
    q_rope = apply_rotary_emb(q[..., dn:], cos, sin)
    k_rope = apply_rotary_emb(k_rope[:, :, None], cos, sin)
    k_nope = torch.einsum("bsc,hnc->bshn", lat, w(prefix + "W_uk"))
    v = torch.einsum("bsc,hcv->bshv", lat, w(prefix + "W_uv"))
    qf = torch.cat([q[..., :dn], q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, h, k_rope.shape[-1])], dim=-1)
    o, _ = attention_ref(qf, kf, v, causal=True, upcast=upcast)
    return o
