"""Dense flash-attention forward (counterpart of
flash_attn_tpu/kernels/flash_fwd.py).

`flash_attention_fwd` takes q (b, h, sq, d) and k/v (b, hk, sk, d) and
returns (out (b, h, sq, d) in q's dtype, lse (b, h, sq) fp32, natural log).
On CUDA tensors it launches the hand-written kernel in `csrc/flash_fwd.cu`;
on CPU tensors it computes `flash_attention_fwd_ref`, the plain version of
the same function, which is also what the kernel is checked against on the
card. Ported features: scale, bottom-right-aligned causal, sliding window,
GQA/MQA, softcap. Every other feature of the JAX signature raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels.common import (
    check_rows_dense,
    normalize_window,
    raise_unported,
    rows_readable,
    visible_mask,
)

# Arguments of the JAX kernels' signature that the port does not take yet:
# name -> (value that means "not used", ROADMAP item).
_UNPORTED = {
    "qv": (None, "queue 2, kernels 1-3: qv (MLA absorbed scores)"),
    "bias": (None, "queue 2, kernels 1-3: additive bias and dBias"),
    "alibi_slopes": (None, "queue 2, kernels 1-3: ALiBi"),
    "sink": (None, "queue 2, kernels 1-3: learnable sink"),
    "q_segment_ids": (None, "queue 2, kernels 1-3: segment ids"),
    "kv_segment_ids": (None, "queue 2, kernels 1-3: segment ids"),
    "q_descale": (None, "queue 2, kernels 1-3: descales"),
    "k_descale": (None, "queue 2, kernels 1-3: descales"),
    "v_descale": (None, "queue 2, kernels 1-3: descales"),
    "attention_chunk": (0, "queue 2, kernels 1-3: attention_chunk"),
    "sink_token_length": (0, "queue 2, kernels 1-3: sink tokens"),
    "dropout_p": (0.0, "queue 2, kernels 1-3: murmur3 dropout"),
    "score_mod": (None, "queue 2, kernels 1-3: score_mod/mask_mod"),
    "mask_mod": (None, "queue 2, kernels 1-3: score_mod/mask_mod"),
    "aux_tensors": ((), "queue 2, kernels 1-3: score_mod/mask_mod"),
    "aux_scalars": ((), "queue 2, kernels 1-3: score_mod/mask_mod"),
    "cp_world_size": (1, "queue 1, item 12: context parallelism"),
    "cp_rank": (0, "queue 1, item 12: context parallelism"),
    "cp_tot_seqlen_k": (None, "queue 1, item 12: context parallelism"),
    "output_scale": (1.0, "queue 2, kernels 1-3: output quantization"),
    "out_quant_dtype": (None, "queue 2, kernels 1-3: output quantization"),
}


def check_unported(**extras) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for an argument
    of the JAX kernels' signature that the port does not take yet and that
    the caller set to something other than its "not used" value."""
    raise_unported(_UNPORTED, extras)


def _scale(head_dim: int, softmax_scale: Optional[float]) -> float:
    return head_dim**-0.5 if softmax_scale is None else float(softmax_scale)


def scores(q, k, scale: float, softcap: float):
    """fp32 scores of q (b, g, sq, d) against k (b, 1, sk, d): s * scale,
    or tanh(s * scale / softcap) * softcap. Returns (scores, tanh term or
    None); the backward needs the tanh term for the softcap's chain rule."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if softcap > 0.0:
        t = torch.tanh(s * (scale / softcap))
        return t * softcap, t
    return s * scale, None


def flash_attention_fwd_ref(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, hk, sk, d)
    v: torch.Tensor,  # (b, hk, sk, d)
    *,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    visible: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, in fp32, one kv head's group of
    query heads at a time (so the (sq, sk) scores of all heads never exist
    at once). Returns (out in q's dtype, lse fp32); a row that sees no
    column gives out 0 and lse -inf. `visible`, a (sq, sk) bool mask,
    replaces the causal/window rule (the varlen plain versions pass each
    sequence's)."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    scale = _scale(d, softmax_scale)
    if visible is None:
        visible = visible_mask(sq, sk, normalize_window(window_size, causal),
                               q.device)
    out = torch.empty(b, h, sq, v.shape[3], dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    for g in range(hk):
        heads = slice(g * group, (g + 1) * group)
        s, _ = scores(q[:, heads], k[:, g:g + 1], scale, softcap)
        s = s.masked_fill(~visible, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)  # exp(-inf) = 0 on masked columns
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, v[:, g:g + 1].float()) / l.clamp_min(1e-37)
        out[:, heads] = torch.where(l > 0, o, torch.zeros_like(o)).to(q.dtype)
        lse[:, heads] = torch.where(
            l > 0, m + torch.log(l.clamp_min(1e-37)),
            torch.full_like(l, float("-inf")))[..., 0]
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, hk, sk, d)
    v: torch.Tensor,  # (b, hk, sk, d)
    *,
    qv: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_descale: Optional[torch.Tensor] = None,
    k_descale: Optional[torch.Tensor] = None,
    v_descale: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = False,
    window_size: Tuple[int, int] = (-1, -1),
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    softcap: float = 0.0,
    dropout_p: float = 0.0,
    score_mod=None,
    mask_mod=None,
    aux_tensors=(),
    aux_scalars=(),
    cp_world_size: int = 1,
    cp_rank: int = 0,
    cp_tot_seqlen_k: Optional[int] = None,
    output_scale: float = 1.0,
    out_quant_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense flash-attention forward. Returns (out (b, h, sq, d) in q's
    dtype, lse (b, h, sq) fp32 natural-log sum-exp of the scaled scores).

    CUDA tensors launch `csrc/flash_fwd.cu` (and count the launch in
    `flash_attention_fwd.launches`; a q, k or v that TMA cannot address is
    copied first, counted in `flash_attention_fwd.tma_copies`); CPU tensors
    take `flash_attention_fwd_ref`."""
    check_unported(
        qv=qv, bias=bias, alibi_slopes=alibi_slopes, sink=sink,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        q_descale=q_descale, k_descale=k_descale, v_descale=v_descale,
        attention_chunk=attention_chunk, sink_token_length=sink_token_length,
        dropout_p=dropout_p, score_mod=score_mod,
        mask_mod=mask_mod, aux_tensors=tuple(aux_tensors or ()),
        aux_scalars=tuple(aux_scalars or ()), cp_world_size=cp_world_size,
        cp_rank=cp_rank, cp_tot_seqlen_k=cp_tot_seqlen_k,
        output_scale=output_scale, out_quant_dtype=out_quant_dtype,
    )
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, **kw)
    return _launch(q, k, v, **kw)


flash_attention_fwd.launches = 0
flash_attention_fwd.tma_copies = 0


def check_kernel_inputs(d: int, h: int, hk: int, **tensors) -> None:
    """What the CUDA attention kernels take: one CUDA device, bf16/fp16,
    head dim 64 or 128, whole GQA groups, rows the 16-byte copies can
    read."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {first.device}")
    if first.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the CUDA kernels take bf16/fp16, got {first.dtype}")
    if d not in (64, 128):
        raise ValueError(f"the CUDA kernels take head dim 64 or 128, got {d}")
    if hk == 0 or h % hk != 0:
        raise ValueError(f"{h} query heads do not group over {hk} kv heads")
    for name, t in tensors.items():
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{first.dtype} on {first.device}")
        check_rows_dense(name, t)


def check_shapes(q, k, v) -> None:
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} takes k and v (b, hk, sk, d); "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if sq == 0 or k.shape[2] == 0:
        raise ValueError("the CUDA kernels take non-empty sequences")


@functools.lru_cache(maxsize=None)
def _kernel():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("flash_fwd").flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def strides_arg(*tensors) -> ctypes.Array:
    """The (batch, head, seq) element strides of each tensor, flattened."""
    flat = [t.stride(i) for t in tensors for i in range(3)]
    return (ctypes.c_longlong * len(flat))(*flat)


def tma_addressable(t: torch.Tensor) -> bool:
    """Whether the kernel's TMA tensor maps take `t` (b, h, s, d) as it is:
    a dense last dim, a 16-byte aligned base, and (batch, head, seq) strides
    that are multiples of 16 bytes (`check_rows_dense`'s rule for 2-byte
    types), none of them 0 on a dimension that is stepped."""
    return rows_readable(t) and all(
        n == 1 or st > 0 for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def tma_ready(t: torch.Tensor, owner=flash_attention_fwd) -> torch.Tensor:
    """`t` itself when TMA takes it, else a contiguous copy, counted in
    `owner.tma_copies` (the wrapper that needs it)."""
    if tma_addressable(t):
        return t
    owner.tma_copies += 1
    return t.contiguous()


def stats_ready(t: torch.Tensor, owner) -> torch.Tensor:
    """A contiguous fp32 LSE or delta `t` as the backward kernels' 1-D tensor
    maps take it: itself on a 16-byte aligned base, else a copy, counted in
    `owner.tma_copies`."""
    if t.data_ptr() % 16 == 0:
        return t
    owner.tma_copies += 1
    return t.clone()


def _launch(q, k, v, *, softmax_scale, causal, window_size, softcap):
    check_shapes(q, k, v)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
    check_kernel_inputs(d, h, hk, q=q, k=k, v=v)
    left, right = normalize_window(window_size, causal)
    # q's strides, so a (b, s, h, d) view stays one; the kernel's 16-byte
    # stores take them (multiples of 8 elements).
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides_arg(q, k, v, out),
        b, h, hk, sq, sk, d, _scale(d, softmax_scale), left, right,
        float(softcap), int(q.dtype == torch.float16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return out, lse
