"""Launchers of MLA's absorbed-qv kernels (csrc/mla_attn.cuh), the qv paths
of kernels 4 and 5 (`csrc/mla_decode.cu`), kernel 1's qv forward
(`csrc/flash_fwd_qv.cu`) and kernels 2 and 3's qv backward
(`csrc/mla_bwd.cu`, kernels of csrc/mla_attn_bwd.cuh), at MLA's widths: a
64-wide rope key beside a 512-wide latent, which is both the second score
operand and V:

    O = softmax(scale * (Q K^T + Qv C^T)) C.

The wrappers of kernels 1-5 (`kernels.flash_fwd`, `kernels.flash_bwd`,
`kernels.flash_decode_multipage`, `kernels.flash_decode`) call these on CUDA
tensors and count the launches; on CPU tensors they compute their plain
versions, which take the qv term at any widths. Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flash_attn_tpu_torch.kernels.common import check_rows_dense

# The widths the kernels take: d (q, rope key) and dv (qv, latent).
MLA_D, MLA_DV = 64, 512


def check_pair(d: int, dv: int, what: str) -> None:
    """Raise NotImplementedError unless the kernels take head dims (d, dv)."""
    if (d, dv) != (MLA_D, MLA_DV):
        raise NotImplementedError(
            f"{what}: head dims (d {d}, dv {dv}) on the card: the MLA kernels "
            f"take ({MLA_D}, {MLA_DV}), ROADMAP queue 2, kernels 1-5 "
            "(other (d, dv) pairs)")


def _check_dtypes(**tensors) -> None:
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"the MLA kernels run on cuda, not {first.device} "
                         "(the wrappers take CPU tensors to their plain "
                         "versions)")
    if first.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the MLA kernels take bf16/fp16, got {first.dtype}")
    for name, t in tensors.items():
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{first.dtype} on {first.device}")
        check_rows_dense(name, t)


@functools.lru_cache(maxsize=None)
def _decode_fn():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("mla_decode").mla_decode_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    from flash_attn_tpu_torch.kernels._build import load_library

    fn = load_library("flash_fwd_qv").flash_fwd_qv
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    from flash_attn_tpu_torch.kernels._build import load_library

    lib = load_library("mla_bwd")
    for fn in (lib.mla_bwd_dq, lib.mla_bwd_dkv):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    return lib


def decode(q, qv, k_view, v_view, cache_seqlens, block_table, num_splits,
           softmax_scale, causal=True):
    """One call of `csrc/mla_decode.cu`: q (b, sq, h, 64) and qv (b, sq, h,
    512) against a rope view k_view and a latent view v_view, page pools
    (npages, hk, page, .) under block_table (b, max_pages) int32, or
    contiguous caches (b, hk, smax, .) when block_table is None. The
    combine of a split call runs in the same C call, over a workspace from
    the caching allocator (inside a CUDA graph's capture, the graph's own
    pool, which lives as long as the graph). Returns (out (b, sq, h, 512)
    in q's dtype, lse (b, h, sq) fp32)."""
    b, sq, h, d = q.shape
    npages, hk, page, _ = k_view.shape
    dv = v_view.shape[-1]
    check_pair(d, dv, "qv decode")
    if qv.shape != (b, sq, h, dv) or v_view.shape[:3] != k_view.shape[:3]:
        raise ValueError(f"qv {tuple(qv.shape)} and the latent "
                         f"{tuple(v_view.shape)} do not match q "
                         f"{tuple(q.shape)} and the rope key "
                         f"{tuple(k_view.shape)}")
    if h % hk != 0:
        raise ValueError(f"{h} query heads do not group over {hk} kv heads")
    _check_dtypes(q=q, qv=qv, k_cache=k_view, v_cache=v_view)
    for name, t in (("q", q), ("qv", qv), ("cache_seqlens", cache_seqlens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cache_seqlens.dtype != torch.int32 or cache_seqlens.shape != (b,):
        raise ValueError("cache_seqlens must be (b,) int32")
    if block_table is not None:
        if (block_table.dtype != torch.int32 or block_table.dim() != 2
                or block_table.shape[0] != b
                or not block_table.is_contiguous()):
            raise ValueError("block_table must be (b, max_pages) int32, "
                             "contiguous")
        max_pages = block_table.shape[1]
    elif npages != b:
        raise ValueError(f"contiguous caches hold {npages} rows for a batch "
                         f"of {b}")
    else:
        max_pages = 1
    dev = q.device
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    parts = (None, None)
    if num_splits > 1:
        rows = num_splits * b * sq * h
        work = torch.empty(rows * (dv + 1), dtype=torch.float32, device=dev)
        parts = (work.data_ptr(), work.data_ptr() + rows * dv * 4)
    strides = [t.stride(i) for t in (k_view, v_view) for i in range(3)]
    rc = _decode_fn()(
        q.data_ptr(), qv.data_ptr(), k_view.data_ptr(), v_view.data_ptr(),
        out.data_ptr(), lse.data_ptr(), cache_seqlens.data_ptr(),
        None if block_table is None else block_table.data_ptr(),
        b, sq, h, hk, page, max_pages, npages,
        (ctypes.c_longlong * 6)(*strides), float(softmax_scale),
        int(bool(causal)), int(q.dtype == torch.float16), *parts,
        int(num_splits), torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"mla_decode launch failed: CUDA error {rc}")
    return out, lse


def forward(q, qv, k, v, softmax_scale, causal):
    """One call of `csrc/flash_fwd_qv.cu`: q (b, h, sq, 64), qv (b, h, sq,
    512) or None, k (b, hk, sk, 64), v (b, hk, sk, 512), each read through
    its strides. Returns (out (b, h, sq, 512) in q's dtype, a view of a
    (b, sq, h, 512) tensor, lse (b, h, sq) fp32)."""
    b, h, sq, d = q.shape
    hk, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    check_pair(d, dv, "qv forward" if qv is not None else "forward")
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3]
            or (qv is not None and qv.shape != (b, h, sq, dv))):
        raise ValueError(f"q {tuple(q.shape)}, qv "
                         f"{None if qv is None else tuple(qv.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         "match")
    if hk == 0 or h % hk != 0:
        raise ValueError(f"{h} query heads do not group over {hk} kv heads")
    tensors = dict(q=q, k=k, v=v, **({} if qv is None else dict(qv=qv)))
    _check_dtypes(**tensors)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    flat = [t.stride(i) for t in (q, q if qv is None else qv, k, v, out)
            for i in range(3)]
    rc = _fwd_fn()(
        q.data_ptr(), None if qv is None else qv.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        (ctypes.c_longlong * 15)(*flat), b, h, hk, sq, sk,
        float(softmax_scale), int(bool(causal)), int(q.dtype == torch.float16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_qv launch failed: CUDA error {rc}")
    return out, lse


def _check_bwd(q, qv, k, v, do, **stats):
    """What the backward kernels take: the forward's shapes, dout like the
    output, the statistics contiguous fp32 (b, h, sq)."""
    b, h, sq, d = q.shape
    hk, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    check_pair(d, dv, "qv backward" if qv is not None else "backward")
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3]
            or do.shape != (b, h, sq, dv)
            or (qv is not None and qv.shape != (b, h, sq, dv))):
        raise ValueError(f"q {tuple(q.shape)}, qv "
                         f"{None if qv is None else tuple(qv.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} and dout "
                         f"{tuple(do.shape)} do not match")
    if hk == 0 or h % hk != 0:
        raise ValueError(f"{h} query heads do not group over {hk} kv heads")
    _check_dtypes(q=q, k=k, v=v, dout=do,
                  **({} if qv is None else dict(qv=qv)))
    for name, t in stats.items():
        if (t.shape != (b, h, sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 (b, h, sq) on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)}")


def _bwd_call(name, q, qv, k, v, do, lse, delta, outs, softmax_scale,
              causal):
    b, h, sq, _ = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g1 = outs[1] if outs[1] is not None else outs[0]
    strides = [t.stride(i) for t in (q, q if qv is None else qv, k, v, do,
                                     outs[0], g1) for i in range(3)]
    rc = getattr(_bwd_lib(), name)(
        q.data_ptr(), None if qv is None else qv.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        outs[0].data_ptr(), None if outs[1] is None else outs[1].data_ptr(),
        (ctypes.c_longlong * 21)(*strides), b, h, hk, sq, sk,
        float(softmax_scale), int(bool(causal)),
        int(q.dtype == torch.float16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def backward_dq(q, qv, k, v, do, lse, softmax_scale, causal):
    """One call of `csrc/mla_bwd.cu`'s dQ kernel (kernel 3's qv instance):
    q (b, h, sq, 64), qv (b, h, sq, 512) or None, k (b, hk, sk, 64), v (b,
    hk, sk, 512), dout (b, h, sq, 512), each read through its strides, and
    the forward's lse (b, h, sq). Returns (dq like q, delta (b, h, sq) fp32
    = sum_j P dP, dqv like qv or None)."""
    _check_bwd(q, qv, k, v, do, lse=lse)
    dq = torch.empty_like(q)
    dqv = None if qv is None else torch.empty_like(qv)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _bwd_call("mla_bwd_dq", q, qv, k, v, do, lse, delta, (dq, dqv),
              softmax_scale, causal)
    return dq, delta, dqv


def backward_dkv(q, qv, k, v, do, lse, delta, softmax_scale, causal):
    """One call of `csrc/mla_bwd.cu`'s dK/dV kernel (kernel 2's qv
    instance) on `backward_dq`'s inputs and its delta. Returns (dk like k,
    dv like v), each kv head's group of query heads summed; with qv, dv
    holds dS^T Qv beside P^T dO."""
    _check_bwd(q, qv, k, v, do, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _bwd_call("mla_bwd_dkv", q, qv, k, v, do, lse, delta, (dk, dv),
              softmax_scale, causal)
    return dk, dv
