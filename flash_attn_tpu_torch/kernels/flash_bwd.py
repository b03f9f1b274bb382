"""Dense flash-attention backward (counterpart of
flash_attn_tpu/kernels/flash_bwd.py).

`flash_attention_bwd` returns (dq, dk, dv) from q, k, v, the forward's lse
and dout through two kernel wrappers, each with its own launch count:

  * `flash_attention_bwd_dq` (Q-stationary, `csrc/flash_bwd.cu`
    flash_bwd_dq; plain version `_bwd_dq_ref`), which returns dq and
    delta = sum_j P dP per query row;
  * `flash_attention_bwd_dkv` (KV-stationary, flash_bwd_dkv; plain version
    `_bwd_dkv_ref`), which takes that delta; its dK/dV already sum the
    query heads of each GQA group.

On the card both run the Hopper kernels of `csrc/flash_bwd_sm90.cuh`
(wgmma, TMA, mbarriers); `bwd_walks` is a plain mirror of their tile walks.
A q, k, v or dout that the kernels' TMA tensor maps cannot take as it is
is copied first, counted in `flash_attention_bwd.tma_copies`.

Both plain versions recompute P from Q, K and the LSE exactly as the JAX
kernels' `_recompute_p_and_ds` does, not by autograd. The JAX package takes
delta = rowsum(dO * O) instead; the two are equal in exact arithmetic, but
with a bf16 O the rowsum no longer matches the recomputed P and dP, and the
error it leaves in dS reaches the k-projection gradients magnified (see
csrc/flash_bwd_sm90.cuh). CUDA tensors launch the kernels; CPU tensors take
the plain versions. The features are those of `kernels.flash_fwd`: with
ALiBi, segment ids, attention_chunk, sink tokens or dropout the kernels'
instances of `csrc/flash_bwd_features.cu` run (counted in `launches` and
`feature_launches`); a learnable sink alone needs none, its LSE carries
it. The rest raise NotImplementedError.

At MLA's widths (d 64, dv 512, `kernels.mla_attn.check_pair`) both
wrappers take `qv`, MLA's absorbed query (S = Q K^T + Qv V^T, V the
latent): the dQ kernel then also returns dQv = dS V and the dK/dV kernel
adds dS^T Qv to dV. On the card these calls, and the dv-512 backward
without qv, run `csrc/mla_bwd.cu` (kernels 3 and 2's MLA instances,
counted in `launches`, with qv also in `qv_launches`); qv with a window, a
softcap or features raises, as the forward does (`check_qv`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels import mla_attn
from flash_attn_tpu_torch.kernels.common import (
    Features,
    make_features,
    normalize_window,
    visible_mask,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (
    FEATURE_ARGTYPES,
    _scale,
    check_kernel_inputs,
    check_qv,
    check_shapes,
    check_unported,
    feature_args,
    feature_scores,
    feature_tensors,
    head_passes,
    qv_scale,
    scores,
    stats_ready,
    strides_arg,
    tma_ready,
)

# Rows per block of csrc/flash_bwd_sm90.cuh (query rows of the dQ kernel,
# keys of the dK/dV kernel).
BLOCK_ROWS = 128


def walk_tile(d, softcap):
    """The tile each block walks (keys per K/V tile of the dQ walk, query
    rows per Q/dO tile of the dK/dV walk), as csrc/flash_bwd_sm90.cuh's
    walk_tile."""
    return 128 if d == 64 and not softcap else 64


def bwd_walks(sq, sk, h, hk, d, causal=False, window_size=(-1, -1),
              softcap=0.0):
    """Plain mirror of the dense backward kernels' tile walks (one batch
    row). Returns (dkv, dq): dkv holds (key block, kv head, query head,
    first query row) for each step of each dK/dV block, the blocks in grid
    order (first key blocks first) and each block's steps in its order; dq
    holds (query block, query head, first key) for each step of one pass of
    each dQ block (the kernel walks its tiles twice), the last query blocks
    first. A step covers BLOCK_ROWS keys (dK/dV) or rows (dQ) and a tile of
    walk_tile(d, softcap) rows (dK/dV) or keys (dQ)."""
    left, right = normalize_window(window_size, causal)
    off, group, tile = sk - sq, h // hk, walk_tile(d, softcap > 0)
    dkv = []
    for kb in range(-(-sk // BLOCK_ROWS)):
        key0 = kb * BLOCK_ROWS
        key_last = min(key0 + BLOCK_ROWS, sk) - 1
        q_lo = max(key0 - off - right, 0) if right >= 0 else 0
        q_hi = min(key_last - off + left, sq - 1) if left >= 0 else sq - 1
        qt_lo = q_lo // tile
        n_qt = q_hi // tile - qt_lo + 1 if q_hi >= q_lo else 0
        for g in range(hk):
            dkv += [(kb, g, g * group + it // n_qt, (qt_lo + it % n_qt) * tile)
                    for it in range(n_qt * group)]
    dq = []
    n_m = -(-sq // BLOCK_ROWS)
    for x in range(n_m):
        mb = n_m - 1 - x
        row0 = mb * BLOCK_ROWS
        row_last = min(row0 + BLOCK_ROWS, sq) - 1
        col_lo = max(row0 + off - left, 0) if left >= 0 else 0
        col_hi = min(row_last + off + right, sk - 1) if right >= 0 else sk - 1
        tile_lo = col_lo // tile
        n_tiles = col_hi // tile - tile_lo + 1 if col_hi >= col_lo else 0
        for head in range(h):
            dq += [(mb, head, (tile_lo + i) * tile) for i in range(n_tiles)]
    return dkv, dq


def _p_dp(q, k, v, do, lse, g, heads, scale, softcap, visible,
          features=None, qv=None):
    """P, dP and the softcap's tanh term (or None) of query heads `heads`
    (of kv head g), fp32 (b, n, sq, sk): P recomputed from the scores (with
    the ALiBi term, and qv . v with qv) and the LSE, 0 where masked and on
    rows with lse = -inf. With dropout, also P Z / (1 - p) for dV, and dP
    becomes dP Z / (1 - p), as `_recompute_p_and_ds` does; else that P is P
    itself."""
    s, t = scores(q[:, heads], k[:, g:g + 1], scale, softcap,
                  qv=None if qv is None else qv[:, heads], v=v[:, g:g + 1])
    sq, sk = s.shape[-2:]
    s = feature_scores(s, features, heads, sq, sk)
    lse_g = lse[:, heads, :, None]
    keep = visible & torch.isfinite(lse_g)
    p = torch.where(keep, torch.exp(s - lse_g), torch.zeros_like(s))
    dp = torch.matmul(do[:, heads].float(),
                      v[:, g:g + 1].float().transpose(-1, -2))
    p_drop = p
    if features is not None and features.dropout_p > 0:
        z = features.keep(q.shape[0], heads, sq, sk, q.device)
        rp = 1.0 / (1.0 - features.dropout_p)
        p_drop = torch.where(z, p, torch.zeros_like(p)) * rp
        dp = torch.where(z, dp, torch.zeros_like(dp)) * rp
    return p, dp, t, p_drop


def _ds(p, dp, delta, scale, t):
    """dS = P * (dP - delta) * scale, times 1 - tanh^2 under a softcap."""
    ds = p * (dp - delta[..., None]) * scale
    return ds if t is None else ds * (1.0 - t * t)


def _setup(q, k, v, qv, softmax_scale, causal, window_size, visible,
           features):
    h, sq, d = q.shape[1:]
    hk, sk = k.shape[1], k.shape[2]
    if visible is None:
        window = normalize_window(window_size, causal)
        visible = (visible_mask(sq, sk, window, q.device) if features is None
                   else features.visible(sq, sk, window, q.device))
    return h // hk, _bwd_scale(q, v, qv, softmax_scale), visible


def _bwd_scale(q, v, qv, softmax_scale):
    """The softmax scale: d^-0.5 by default, (d + dv)^-0.5 with qv."""
    d = q.shape[3]
    return (_scale(d, softmax_scale) if qv is None
            else qv_scale(d, v.shape[3], softmax_scale))


def _bwd_dkv_ref(q, k, v, do, lse, delta, *, softmax_scale=None, causal=False,
                 window_size=(-1, -1), softcap=0.0, visible=None,
                 features: Optional[Features] = None, qv=None):
    """Plain version of the dK/dV kernel: (dk, dv) in k's and v's dtypes,
    each kv head's group of query heads summed, in fp32. `visible`, a
    (sq, sk) bool mask, replaces the causal/window rule; `features` as in
    `flash_attention_fwd_ref` (dV takes P Z / (1 - p) with dropout); with
    `qv` (b, h, sq, dv) dV also takes dS^T Qv, and the default scale is
    (d + dv)^-0.5."""
    group, scale, visible = _setup(q, k, v, qv, softmax_scale, causal,
                                   window_size, visible, features)
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for g in range(k.shape[1]):
        dk_g = dv_g = 0.0
        for heads in head_passes(g, group, b, sq, sk, features):
            p, dp, t, p_drop = _p_dp(q, k, v, do, lse, g, heads, scale,
                                     softcap, visible, features, qv)
            ds = _ds(p, dp, delta[:, heads], scale, t)
            dv_g = dv_g + torch.matmul(p_drop.transpose(-1, -2),
                                       do[:, heads].float()).sum(1)
            if qv is not None:
                dv_g = dv_g + torch.matmul(ds.transpose(-1, -2),
                                           qv[:, heads].float()).sum(1)
            dk_g = dk_g + torch.matmul(ds.transpose(-1, -2),
                                       q[:, heads].float()).sum(1)
        dv[:, g] = dv_g.to(v.dtype)
        dk[:, g] = dk_g.to(k.dtype)
    return dk, dv


def _bwd_dq_ref(q, k, v, do, lse, *, softmax_scale=None, causal=False,
                window_size=(-1, -1), softcap=0.0, visible=None,
                features: Optional[Features] = None, qv=None):
    """Plain version of the dQ kernel: (dq in q's dtype, delta (b, h, sq)
    fp32 = sum_j P dP, dP times Z / (1 - p) with dropout), in fp32, and
    with `qv` a third value, dqv = dS V in qv's dtype. `visible`,
    `features` and `qv` as in `_bwd_dkv_ref`."""
    group, scale, visible = _setup(q, k, v, qv, softmax_scale, causal,
                                   window_size, visible, features)
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    dq = torch.empty_like(q)
    dqv = None if qv is None else torch.empty_like(qv)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    for g in range(k.shape[1]):
        for heads in head_passes(g, group, b, sq, sk, features):
            p, dp, t, _ = _p_dp(q, k, v, do, lse, g, heads, scale, softcap,
                                visible, features, qv)
            delta[:, heads] = (p * dp).sum(-1)
            ds = _ds(p, dp, delta[:, heads], scale, t)
            dq[:, heads] = torch.matmul(ds, k[:, g:g + 1].float()).to(q.dtype)
            if qv is not None:
                dqv[:, heads] = torch.matmul(
                    ds, v[:, g:g + 1].float()).to(qv.dtype)
    return (dq, delta) if qv is None else (dq, delta, dqv)


def _check_stats(q, **stats):
    b, h, sq = q.shape[:3]
    for name, t in stats.items():
        if (t.shape != (b, h, sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 (b, h, sq) on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)}")


def _stats_ready(t):
    """`stats_ready` counted in `flash_attention_bwd.tma_copies`."""
    return stats_ready(t, flash_attention_bwd)


def _prepare(q, k, v, do, stats, softmax_scale, causal, window_size,
             softcap):
    """(q, k, v, do, stats as the kernels take them, the C call's shape and
    option arguments)."""
    check_shapes(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"dout {tuple(do.shape)} must match q {tuple(q.shape)}")
    q, k, v, do = (tma_ready(x, flash_attention_bwd) for x in (q, k, v, do))
    b, h, sq, d = q.shape
    check_kernel_inputs(d, h, k.shape[1], q=q, k=k, v=v, dout=do)
    _check_stats(q, **stats)
    stats = {name: _stats_ready(t) for name, t in stats.items()}
    left, right = normalize_window(window_size, causal)
    return q, k, v, do, stats, (b, h, k.shape[1], sq, k.shape[2], d,
                                _scale(d, softmax_scale), left, right,
                                float(softcap))


def kernel_features(features: Optional[Features]) -> Optional[Features]:
    """The features the backward kernels need an instance of their own for:
    all but a learnable sink alone, which P = exp(S - LSE) carries."""
    if features is None or not (
            features.alibi_slopes is not None
            or features.q_segment_ids is not None
            or features.attention_chunk > 0 or features.sink_token_length > 0
            or features.dropout_p > 0):
        return None
    return features


def _launch_bwd(name, owner, args, strides, dims, q, features):
    """Launch `name` (flash_bwd_dkv or flash_bwd_dq), or its instance with
    `features` (flash_bwd_*_features), and count it in `owner`."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fp16 = int(q.dtype == torch.float16)
    features = kernel_features(features)
    if features is None:
        rc = getattr(_kernels(), name)(*args, strides, *dims, fp16, stream)
    else:
        tensors = feature_tensors(features, q, dims[4])
        rc = getattr(_feature_kernels(), name + "_features")(
            *args, strides, *dims, fp16,
            *feature_args(features, tensors, with_sink=False), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    owner.launches += 1
    owner.feature_launches += features is not None


def _mla_shaped(q, v, qv) -> bool:
    """Whether the call has MLA's shape (qv, or a v wider than q), which
    takes `csrc/mla_bwd.cu` on the card."""
    return qv is not None or v.shape[3] != q.shape[3]


def _mla_scale(q, v, qv, softmax_scale, window_size, softcap, features):
    """None unless `_mla_shaped`; then its softmax scale. Raises
    NotImplementedError for qv with a window, a softcap or features, on
    the CPU as on the card."""
    if not _mla_shaped(q, v, qv):
        return None
    check_qv(features, window_size, softcap)
    return _bwd_scale(q, v, qv, softmax_scale)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, softmax_scale=None,
                            causal=False, window_size=(-1, -1), softcap=0.0,
                            features: Optional[Features] = None, qv=None):
    """(dk, dv), each (b, hk, sk, d) in k's dtype, GQA groups summed; with
    `qv`, dv also takes dS^T Qv. CUDA tensors launch flash_bwd_dkv, or
    with features its instance in csrc/flash_bwd_features.cu (counted in
    `flash_attention_bwd_dkv.launches`, the latter also in
    `feature_launches`), or at MLA's widths csrc/mla_bwd.cu's (counted in
    `launches`, with qv also in `qv_launches`); CPU tensors take
    `_bwd_dkv_ref`."""
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap)
    mla = _mla_scale(q, v, qv, softmax_scale, window_size, softcap, features)
    if q.device.type == "cpu":
        return _bwd_dkv_ref(q, k, v, do, lse, delta, **kw, features=features,
                            qv=qv)
    if mla is not None:
        dk, dv = mla_attn.backward_dkv(q, qv, k, v, do, lse, delta, mla,
                                       causal)
        flash_attention_bwd_dkv.launches += 1
        flash_attention_bwd_dkv.qv_launches += qv is not None
        return dk, dv
    q, k, v, do, stats, dims = _prepare(q, k, v, do,
                                        dict(lse=lse, delta=delta), **kw)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", flash_attention_bwd_dkv,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 stats["lse"].data_ptr(), stats["delta"].data_ptr(),
                 dk.data_ptr(), dv.data_ptr()),
                strides_arg(q, k, v, do, dk, dv), dims, q, features)
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.qv_launches = 0
flash_attention_bwd_dkv.feature_launches = 0


def flash_attention_bwd_dq(q, k, v, do, lse, *, softmax_scale=None,
                           causal=False, window_size=(-1, -1), softcap=0.0,
                           features: Optional[Features] = None, qv=None):
    """(dq (b, h, sq, d) in q's dtype, delta (b, h, sq) fp32), and with
    `qv` a third value, dqv in qv's dtype. CUDA tensors launch
    flash_bwd_dq, or with features its instance in
    csrc/flash_bwd_features.cu, or at MLA's widths csrc/mla_bwd.cu's
    (counted as in `flash_attention_bwd_dkv`); CPU tensors take
    `_bwd_dq_ref`."""
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap)
    mla = _mla_scale(q, v, qv, softmax_scale, window_size, softcap, features)
    if q.device.type == "cpu":
        return _bwd_dq_ref(q, k, v, do, lse, **kw, features=features, qv=qv)
    if mla is not None:
        dq, delta, dqv = mla_attn.backward_dq(q, qv, k, v, do, lse, mla,
                                              causal)
        flash_attention_bwd_dq.launches += 1
        flash_attention_bwd_dq.qv_launches += qv is not None
        return (dq, delta) if qv is None else (dq, delta, dqv)
    q, k, v, do, stats, dims = _prepare(q, k, v, do, dict(lse=lse), **kw)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch_bwd("flash_bwd_dq", flash_attention_bwd_dq,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 stats["lse"].data_ptr(), delta.data_ptr(), dq.data_ptr()),
                strides_arg(q, k, v, do, dq), dims, q, features)
    return dq, delta


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.qv_launches = 0
flash_attention_bwd_dq.feature_launches = 0

_DIMS = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_float, ctypes.c_int]


@functools.lru_cache(maxsize=None)
def _kernels() -> ctypes.CDLL:
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library("flash_bwd")
    strides = ctypes.POINTER(ctypes.c_longlong)
    tail = _DIMS + [ctypes.c_void_p]
    lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + [strides] + tail
    lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + [strides] + tail
    lib.flash_bwd_dkv.restype = lib.flash_bwd_dq.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _feature_kernels() -> ctypes.CDLL:
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library("flash_bwd_features")
    strides = ctypes.POINTER(ctypes.c_longlong)
    # The backward's feature arguments take no sink.
    tail = _DIMS + FEATURE_ARGTYPES[:6] + FEATURE_ARGTYPES[7:] + [
        ctypes.c_void_p]
    lib.flash_bwd_dkv_features.argtypes = ([ctypes.c_void_p] * 8 + [strides]
                                           + tail)
    lib.flash_bwd_dq_features.argtypes = ([ctypes.c_void_p] * 7 + [strides]
                                          + tail)
    lib.flash_bwd_dkv_features.restype = ctypes.c_int
    lib.flash_bwd_dq_features.restype = ctypes.c_int
    return lib


def flash_attention_bwd(
    q: torch.Tensor,    # (b, h, sq, d)
    k: torch.Tensor,    # (b, hk, sk, d)
    v: torch.Tensor,    # (b, hk, sk, d)
    lse: torch.Tensor,  # (b, h, sq) fp32 natural log
    do: torch.Tensor,   # (b, h, sq, d)
    *,
    qv: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
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
) -> Tuple[torch.Tensor, ...]:
    """Flash-attention backward. Returns (dq, dk, dv), and with `qv` (dq,
    dk, dv, dqv) as the JAX function does; dk/dv come back per kv head
    (GQA groups summed), each in its input's dtype. Unlike the JAX
    function it takes no `out`: delta = sum_j P dP comes from the dQ
    kernel, not from rowsum(dO * O). `lse` is the forward's, which carries
    a learnable sink; the sink's own gradient is the caller's
    (flash_attn_interface)."""
    check_unported(
        bias=bias, score_mod=score_mod, mask_mod=mask_mod,
        aux_tensors=tuple(aux_tensors or ()),
        aux_scalars=tuple(aux_scalars or ()),
    )
    kw = dict(softmax_scale=softmax_scale, causal=causal,
              window_size=window_size, softcap=softcap,
              features=make_features(
                  alibi_slopes=alibi_slopes, sink=sink,
                  q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                  attention_chunk=attention_chunk,
                  sink_token_length=sink_token_length, dropout_p=dropout_p,
                  dropout_seed=dropout_seed))
    if q.device.type != "cpu" and not _mla_shaped(q, v, qv):
        # Copied (if at all) once for both kernels.
        q, k, v, do = (tma_ready(x, flash_attention_bwd) for x in (q, k, v, do))
    dq, delta, *dqv = flash_attention_bwd_dq(q, k, v, do, lse, **kw, qv=qv)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw, qv=qv)
    return (dq, dk, dv, *dqv)


flash_attention_bwd.tma_copies = 0
