"""Dense flash-attention forward (counterpart of
flash_attn_tpu/kernels/flash_fwd.py).

`flash_attention_fwd` takes q (b, h, sq, d) and k/v (b, hk, sk, d) and
returns (out (b, h, sq, d) in q's dtype, lse (b, h, sq) fp32, natural log).
On CUDA tensors it launches the hand-written kernel in `csrc/flash_fwd.cu`;
on CPU tensors it computes `flash_attention_fwd_ref`, the plain version of
the same function, which is also what the kernel is checked against on the
card. Ported features: scale, bottom-right-aligned causal, sliding window,
GQA/MQA, softcap, and (`kernels.common.Features`) ALiBi, the learnable
sink, segment ids, attention_chunk, sink tokens and murmur3 dropout, which
run in kernel 1's instances of `csrc/flash_fwd_features.cu`. Every other
feature of the JAX signature raises NotImplementedError naming its ROADMAP
item.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels import mla_attn
from flash_attn_tpu_torch.kernels.common import (
    Features,
    alibi_bias,
    check_rows_dense,
    keep_threshold,
    make_features,
    normalize_window,
    raise_unported,
    rows_readable,
    visible_mask,
)

# Arguments of the JAX kernels' signature that the port does not take yet:
# name -> (value that means "not used", ROADMAP item).
_UNPORTED = {
    "bias": (None, "queue 2, kernels 1-3: additive bias and dBias"),
    "q_descale": (None, "queue 2, kernels 1-3: descales"),
    "k_descale": (None, "queue 2, kernels 1-3: descales"),
    "v_descale": (None, "queue 2, kernels 1-3: descales"),
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


def qv_scale(d: int, dv: int, softmax_scale: Optional[float]) -> float:
    """The default scale with qv, (d + dv)^-0.5, as the JAX kernel's."""
    return (d + dv)**-0.5 if softmax_scale is None else float(softmax_scale)


def scores(q, k, scale: float, softcap: float, qv=None, v=None):
    """fp32 scores of q (b, g, sq, d) against k (b, 1, sk, d), plus MLA's
    qv (b, g, sq, dv) against v (b, 1, sk, dv) when qv is given: s *
    scale, or tanh(s * scale / softcap) * softcap. Returns (scores, tanh
    term or None); the backward needs the tanh term for the softcap's chain
    rule."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if qv is not None:
        s = s + torch.matmul(qv.float(), v.float().transpose(-1, -2))
    if softcap > 0.0:
        t = torch.tanh(s * (scale / softcap))
        return t * softcap, t
    return s * scale, None


# Elements of one pass's (b, heads, sq, sk) scores in the plain versions
# with features: query heads of a group go in slices of at most this many
# elements, so that the scores, the keep mask and the ALiBi term of a long
# sequence fit beside each other.
REF_PASS_ELEMENTS = 1 << 26


def head_passes(g: int, group: int, b: int, sq: int, sk: int,
                features: Optional[Features]):
    """The slices of kv head g's query heads that the plain versions take
    at once: the whole group without features, else as many heads as
    REF_PASS_ELEMENTS allows (at least one)."""
    n = group if features is None else max(
        1, min(group, REF_PASS_ELEMENTS // max(b * sq * sk, 1)))
    return [slice(h0, min(h0 + n, (g + 1) * group))
            for h0 in range(g * group, (g + 1) * group, n)]


def feature_scores(s, features: Optional[Features], heads: slice, sq, sk):
    """Scores with the ALiBi term of query heads `heads`, if any."""
    if features is None or features.alibi_slopes is None:
        return s
    return s + alibi_bias(features.alibi_slopes, heads, sq, sk, s.device,
                          features.diag_offset)


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
    features: Optional[Features] = None,
    qv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, in fp32, one kv head's group of
    query heads at a time (so the (sq, sk) scores of all heads never exist
    at once; with features, slices of it, `head_passes`). Returns (out in
    q's dtype, lse fp32); a row that sees no column gives out 0 and lse
    -inf (with a learnable sink, lse = sink). `visible`, a (sq, sk) bool
    mask, replaces the causal/window rule (the varlen plain versions pass
    each sequence's). `features` as the JAX kernel takes them: the ALiBi
    term after the softcap, the visibility rules, exp(sink) in each row's
    sum, and dropout: m and l from the undropped P, P V from P times the
    keep mask, out times 1 / (1 - p). `qv` (b, h, sq, dv), MLA's absorbed
    query, adds qv . V to the raw scores (V is also the P V operand), and
    the default scale is then (d + dv)^-0.5."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    scale = (_scale(d, softmax_scale) if qv is None
             else qv_scale(d, v.shape[3], softmax_scale))
    window = normalize_window(window_size, causal)
    if visible is None:
        visible = (visible_mask(sq, sk, window, q.device) if features is None
                   else features.visible(sq, sk, window, q.device))
    out = torch.empty(b, h, sq, v.shape[3], dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    sink = None if features is None else features.sink
    drop = features is not None and features.dropout_p > 0
    for g in range(hk):
        for heads in head_passes(g, group, b, sq, sk, features):
            s, _ = scores(q[:, heads], k[:, g:g + 1], scale, softcap,
                          qv=None if qv is None else qv[:, heads],
                          v=v[:, g:g + 1])
            s = feature_scores(s, features, heads, sq, sk)
            s = s.masked_fill(~visible, float("-inf"))
            m = s.amax(dim=-1, keepdim=True)
            if sink is not None:
                sink_h = sink.float().to(q.device)[heads].reshape(1, -1, 1, 1)
                m = torch.maximum(m, sink_h)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            p = torch.exp(s - m)  # exp(-inf) = 0 on masked columns
            l = p.sum(dim=-1, keepdim=True)
            if sink is not None:
                l = l + torch.exp(sink_h - m)
            if drop:
                keep = features.keep(b, heads, sq, sk, q.device)
                p = torch.where(keep, p, torch.zeros_like(p)) / (
                    1.0 - features.dropout_p)
                del keep
            o = torch.matmul(p, v[:, g:g + 1].float()) / l.clamp_min(1e-37)
            out[:, heads] = torch.where(l > 0, o,
                                        torch.zeros_like(o)).to(q.dtype)
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
    dropout_seed=None,
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
    copied first, counted in `flash_attention_fwd.tma_copies`), or with
    features `csrc/flash_fwd_features.cu` (counted in `launches` and in
    `feature_launches`); CPU tensors take `flash_attention_fwd_ref`.
    `dropout_seed` is an int or a scalar tensor (a CUDA one is read back),
    the JAX default 0 when None."""
    check_unported(
        bias=bias, q_descale=q_descale, k_descale=k_descale,
        v_descale=v_descale, score_mod=score_mod,
        mask_mod=mask_mod, aux_tensors=tuple(aux_tensors or ()),
        aux_scalars=tuple(aux_scalars or ()), cp_world_size=cp_world_size,
        cp_rank=cp_rank, cp_tot_seqlen_k=cp_tot_seqlen_k,
        output_scale=output_scale, out_quant_dtype=out_quant_dtype,
    )
    features = make_features(
        alibi_slopes=alibi_slopes, sink=sink, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, attention_chunk=attention_chunk,
        sink_token_length=sink_token_length, dropout_p=dropout_p,
        dropout_seed=dropout_seed)
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap)
    mla = qv is not None or v.shape[3] != q.shape[3]
    if mla:
        check_qv(features, window_size, softcap)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, **kw, features=features,
                                       qv=qv)
    if mla:
        # MLA's widths: csrc/flash_fwd_qv.cu, with or without qv.
        scale = (qv_scale(q.shape[3], v.shape[3], softmax_scale)
                 if qv is not None else _scale(q.shape[3], softmax_scale))
        out = mla_attn.forward(q, qv, k, v, scale, causal)
        flash_attention_fwd.launches += 1
        flash_attention_fwd.qv_launches += qv is not None
        return out
    return _launch(q, k, v, features, **kw)


flash_attention_fwd.launches = 0
flash_attention_fwd.qv_launches = 0
flash_attention_fwd.feature_launches = 0
flash_attention_fwd.tma_copies = 0


def check_qv(features: Optional[Features], window_size, softcap) -> None:
    """The qv forward (and MLA's dv-512 forward) is causal or not, with no
    window, softcap or feature; raises NotImplementedError on the others,
    on the CPU as on the card."""
    if (features is not None or tuple(window_size) != (-1, -1)
            or softcap > 0.0):
        raise NotImplementedError(
            "qv (MLA) with a window, a softcap or attention features is not "
            "ported yet: ROADMAP queue 2, kernels 1-3 (qv with features)")


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


@functools.lru_cache(maxsize=None)
def _features_kernel():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("flash_fwd_features").flash_fwd_features
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_int] + FEATURE_ARGTYPES
                   + [ctypes.c_void_p])
    return fn


# ctypes types of the feature arguments of the C entry points
# (feature_args): slopes, slope_b, q_seg, kv_seg, q_seg_b, kv_seg_b, sink
# (forward only), chunk, sink_tokens, dropout, seed, keep_threshold,
# keep_scale.
FEATURE_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_uint, ctypes.c_uint, ctypes.c_float]


def feature_tensors(f: Features, q: torch.Tensor, sk: int) -> dict:
    """The features' tensors as the kernels read them, on q's device:
    slopes and sink fp32 contiguous, segment ids int32 contiguous. Raises
    on shapes the kernels do not take."""
    b, h, sq = q.shape[:3]
    out = {}
    if f.alibi_slopes is not None:
        s = f.alibi_slopes.to(q.device, torch.float32).contiguous()
        if s.shape not in ((h,), (b, h)):
            raise ValueError(f"alibi_slopes must be ({h},) or ({b}, {h}), got "
                             f"{tuple(s.shape)}")
        out["slopes"] = s
    if f.sink is not None:
        s = f.sink.to(q.device, torch.float32).contiguous()
        if s.shape != (h,):
            raise ValueError(f"sink must be ({h},), got {tuple(s.shape)}")
        out["sink"] = s
    if f.q_segment_ids is not None:
        out["q_seg"] = f.q_segment_ids.to(q.device, torch.int32).contiguous()
        out["kv_seg"] = f.kv_segment_ids.to(q.device, torch.int32).contiguous()
        if out["q_seg"].shape != (b, sq) or out["kv_seg"].shape != (b, sk):
            raise ValueError(f"segment ids must be ({b}, {sq}) and ({b}, "
                             f"{sk})")
    return out


def feature_args(f: Features, tensors: dict, with_sink: bool = True) -> list:
    """The feature arguments of the C entry points (FEATURE_ARGTYPES; the
    backward's take no sink): pointers of `tensors` (feature_tensors), the
    batch strides, and the dropout threshold and scale."""
    def ptr(name):
        t = tensors.get(name)
        return None if t is None else t.data_ptr()

    slopes = tensors.get("slopes")
    args = [ptr("slopes"),
            slopes.shape[1] if slopes is not None and slopes.dim() == 2 else 0,
            ptr("q_seg"), ptr("kv_seg"),
            tensors["q_seg"].shape[1] if "q_seg" in tensors else 0,
            tensors["kv_seg"].shape[1] if "kv_seg" in tensors else 0]
    if with_sink:
        args.append(ptr("sink"))
    drop = f.dropout_p > 0
    return args + [f.attention_chunk, f.sink_token_length, int(drop),
                   f.dropout_seed & 0xFFFFFFFF,
                   keep_threshold(1.0 - f.dropout_p) if drop else 0,
                   1.0 / (1.0 - f.dropout_p)]


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


def _launch(q, k, v, features, *, softmax_scale, causal, window_size,
            softcap):
    """Kernel 1, or with `features` its instance in
    csrc/flash_fwd_features.cu."""
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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), strides_arg(q, k, v, out),
            b, h, hk, sq, sk, d, _scale(d, softmax_scale), left, right,
            float(softcap), int(q.dtype == torch.float16))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if features is None:
        rc = _kernel()(*args, stream)
    else:
        tensors = feature_tensors(features, q, sk)
        rc = _features_kernel()(*args, *feature_args(features, tensors),
                                stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.feature_launches += features is not None
    return out, lse
