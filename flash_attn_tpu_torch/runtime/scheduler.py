"""Continuous-batching scheduler (counterpart of
flash_attn_tpu/runtime/scheduler.py, kept as this package's own copy): a
ctypes binding of the native C++ scheduler in the repository's
csrc/scheduler.cpp, plus `PyScheduler`, a pure-Python twin with the same
policy (the fallback, and the other side of the differential test).

Page allocation, admission, LPT-style prefill ordering, decode-batch
assembly. The native library builds with g++ into the port's build
directory (build/kernels/) at first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from flash_attn_tpu_torch.kernels._build import BUILD_DIR, REPO_ROOT

_SRC = os.path.join(REPO_ROOT, "csrc", "scheduler.cpp")
_GXX = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"]

WAITING, PREFILLING, RUNNING, DONE = 0, 1, 2, 3


def _build_native() -> str:
    """Compile csrc/scheduler.cpp once per content; returns the library."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_GXX).encode())
    so = os.path.join(BUILD_DIR, f"libscheduler-{digest.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([*_GXX, _SRC, "-o", tmp], check=True,
                           capture_output=True)
            os.replace(tmp, so)  # atomic: no concurrent build sees half a file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sched_create.restype = ctypes.c_void_p
    lib.sched_create.argtypes = [ctypes.c_int] * 5
    lib.sched_destroy.argtypes = [ctypes.c_void_p]
    lib.sched_add_request.restype = ctypes.c_int
    lib.sched_add_request.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.sched_add_request_shared.restype = ctypes.c_int
    lib.sched_add_request_shared.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 4
        + [np.ctypeslib.ndpointer(np.int32)]
    )
    for name in ("sched_pin_pages", "sched_unpin_pages"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                       np.ctypeslib.ndpointer(np.int32)]
    lib.sched_set_decode_depth.restype = None
    lib.sched_set_decode_depth.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sched_set_window.restype = None
    lib.sched_set_window.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sched_next_batch.restype = ctypes.c_int
    lib.sched_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    ] + [np.ctypeslib.ndpointer(np.int32)] * 5
    lib.sched_report.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
    ]
    lib.sched_num_free_pages.restype = ctypes.c_int
    lib.sched_num_free_pages.argtypes = [ctypes.c_void_p]
    lib.sched_request_state.restype = ctypes.c_int
    lib.sched_request_state.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.sched_num_active.restype = ctypes.c_int
    lib.sched_num_active.argtypes = [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    """The native scheduler, or None where it cannot build or load (no
    g++): `make_scheduler` then takes the Python twin."""
    try:
        return _bind(ctypes.CDLL(_build_native()))
    except (OSError, subprocess.CalledProcessError):
        return None


@dataclass
class Batch:
    kind: int  # 0 idle, 1 prefill, 2 decode
    request_ids: np.ndarray   # (n,)
    positions: np.ndarray     # (n,) start position of these tokens
    chunk_lens: np.ndarray    # (n,)
    cache_seqlens: np.ndarray  # (n,)
    block_tables: np.ndarray  # (n, max_pages_per_seq)


class NativeScheduler:
    """ctypes wrapper over the repository's csrc/scheduler.cpp."""

    def __init__(self, num_pages, page_size, max_batch, max_pages_per_seq,
                 chunk_size):
        self._lib = _lib()
        if self._lib is None:
            raise RuntimeError("native scheduler unavailable")
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        self._h = self._lib.sched_create(
            num_pages, page_size, max_batch, max_pages_per_seq, chunk_size
        )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sched_destroy(self._h)
            self._h = None

    def add_request(self, request_id: int, prompt_len: int,
                    max_new_tokens: int, shared_pages=()) -> int:
        ids = np.ascontiguousarray(list(shared_pages) or [0], np.int32)
        return self._lib.sched_add_request_shared(
            self._h, request_id, prompt_len, max_new_tokens,
            len(shared_pages), ids
        )

    def set_decode_depth(self, depth: int):
        self._lib.sched_set_decode_depth(self._h, int(depth))

    def set_window(self, window_tokens: int):
        self._lib.sched_set_window(self._h, int(window_tokens))

    def pin_pages(self, page_ids) -> int:
        ids = np.ascontiguousarray(list(page_ids) or [0], np.int32)
        return self._lib.sched_pin_pages(self._h, len(page_ids), ids)

    def unpin_pages(self, page_ids) -> int:
        ids = np.ascontiguousarray(list(page_ids) or [0], np.int32)
        return self._lib.sched_unpin_pages(self._h, len(page_ids), ids)

    def next_batch(self) -> Batch:
        mb, mp = self.max_batch, self.max_pages_per_seq
        kind = ctypes.c_int(0)
        ids = np.zeros(mb, np.int32)
        pos = np.zeros(mb, np.int32)
        lens = np.zeros(mb, np.int32)
        tables = np.zeros(mb * mp, np.int32)
        seql = np.zeros(mb, np.int32)
        n = self._lib.sched_next_batch(
            self._h, ctypes.byref(kind), ids, pos, lens, tables, seql
        )
        return Batch(kind.value, ids[:n], pos[:n], lens[:n], seql[:n],
                     tables.reshape(mb, mp)[:n])

    def report(self, request_ids, produced, done):
        ids = np.ascontiguousarray(request_ids, np.int32)
        self._lib.sched_report(
            self._h, len(ids), ids,
            np.ascontiguousarray(produced, np.int32),
            np.ascontiguousarray(done, np.int32),
        )

    def num_free_pages(self) -> int:
        return self._lib.sched_num_free_pages(self._h)

    def request_state(self, req_id: int) -> int:
        return self._lib.sched_request_state(self._h, req_id)

    def num_active(self) -> int:
        return self._lib.sched_num_active(self._h)


@dataclass
class _PyRequest:
    id: int
    prompt_len: int
    max_new_tokens: int
    prefilled: int = 0
    generated: int = 0
    state: int = WAITING
    pages: List[int] = field(default_factory=list)


class PyScheduler:
    """Pure-Python twin of the native scheduler — same policy, used as
    fallback and for differential tests."""

    def __init__(self, num_pages, page_size, max_batch, max_pages_per_seq,
                 chunk_size):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        self.chunk_size = chunk_size
        self.free_pages = list(range(num_pages - 1, -1, -1))
        self.ref = [0] * num_pages  # per-page refcount (0 = free)
        self.decode_depth = 1  # decode tokens planned per step
        self.window_tokens = 0  # sliding-window visible keys; 0 = off
        self.requests: Dict[int, _PyRequest] = {}
        self.waiting: deque = deque()
        self.active: List[int] = []

    def set_decode_depth(self, depth: int):
        self.decode_depth = max(1, int(depth))

    def set_window(self, window_tokens: int):
        self.window_tokens = max(0, int(window_tokens))

    def _evict_window(self, r: _PyRequest, next_pos: int):
        """Release pages wholly beneath the sliding-attention window
        (identical to the native twin): -1 placeholders keep the block
        table positional; the kernel's window mask never reads them."""
        if self.window_tokens <= 0:
            return
        keep_from = next_pos - (self.window_tokens - 1)
        for j, p in enumerate(r.pages):
            if p >= 0 and (j + 1) * self.page_size <= keep_from:
                self._decref(p)
                r.pages[j] = -1

    def _pages_needed(self, tokens):
        return -(-tokens // self.page_size)

    def _ensure(self, r: _PyRequest, upto):
        need = self._pages_needed(upto)
        if need > self.max_pages_per_seq:
            return False
        while len(r.pages) < need:
            if not self.free_pages:
                return False
            p = self.free_pages.pop()
            self.ref[p] = 1
            r.pages.append(p)
        return True

    def _decref(self, p):
        self.ref[p] -= 1
        if self.ref[p] == 0:
            self.free_pages.append(p)

    def add_request(self, request_id, prompt_len, max_new_tokens,
                    shared_pages=()) -> int:
        """Admission; `shared_pages` are live prefix-cache pages already
        holding the first len(shared_pages)*page_size prompt tokens — their
        refcounts rise and the prefill cursor starts after them."""
        if request_id in self.requests:
            return -1
        if self._pages_needed(prompt_len + max_new_tokens) > self.max_pages_per_seq:
            return -2
        ns = len(shared_pages)
        if ns * self.page_size > prompt_len or ns > self.max_pages_per_seq:
            return -3
        if any(p < 0 or p >= self.num_pages or self.ref[p] == 0
               for p in shared_pages):
            return -4
        r = _PyRequest(request_id, prompt_len, max_new_tokens)
        for p in shared_pages:
            self.ref[p] += 1
            r.pages.append(p)
        r.prefilled = ns * self.page_size
        self.requests[request_id] = r
        self.waiting.append(request_id)
        return 0

    def pin_pages(self, page_ids) -> int:
        done = 0
        for p in page_ids:
            if p < 0 or p >= self.num_pages or self.ref[p] == 0:
                continue
            self.ref[p] += 1
            done += 1
        return done

    def unpin_pages(self, page_ids) -> int:
        done = 0
        for p in page_ids:
            if p < 0 or p >= self.num_pages or self.ref[p] == 0:
                continue
            self._decref(p)
            done += 1
        return done

    def next_batch(self) -> Batch:
        while self.waiting:
            r = self.requests[self.waiting[0]]
            if not self._ensure(
                r, min(r.prompt_len, r.prefilled + self.chunk_size)
            ):
                break
            r.state = PREFILLING if r.prefilled < r.prompt_len else RUNNING
            self.active.append(r.id)
            self.waiting.popleft()

        def emit(entries):
            n = len(entries)
            ids = np.array([e[0].id for e in entries], np.int32)
            pos = np.array([e[1] for e in entries], np.int32)
            lens = np.array([e[2] for e in entries], np.int32)
            tables = np.full((n, self.max_pages_per_seq), -1, np.int32)
            for i, (r, _, _) in enumerate(entries):
                tables[i, : len(r.pages)] = r.pages
            return ids, pos, lens, tables

        prefilling = [
            self.requests[i] for i in self.active
            if self.requests[i].state == PREFILLING
        ]
        prefilling.sort(key=lambda r: (r.prompt_len - r.prefilled, r.id))
        entries = []
        for r in prefilling:
            if len(entries) >= self.max_batch:
                break
            ln = min(self.chunk_size, r.prompt_len - r.prefilled)
            self._evict_window(r, r.prefilled)
            if not self._ensure(r, r.prefilled + ln):
                continue
            entries.append((r, r.prefilled, ln))
            r.prefilled += ln
            if r.prefilled >= r.prompt_len:
                r.state = RUNNING
        if entries:
            ids, pos, lens, tables = emit(entries)
            return Batch(1, ids, pos, lens, pos.copy(), tables)

        entries = []
        for i in self.active:
            if len(entries) >= self.max_batch:
                break
            r = self.requests[i]
            if r.state != RUNNING:
                continue
            total = r.prompt_len + r.generated
            depth = max(1, min(self.decode_depth,
                               r.max_new_tokens - r.generated))
            self._evict_window(r, total)
            if not self._ensure(r, total + depth):
                continue
            entries.append((r, total, depth))
        if entries:
            ids, pos, lens, tables = emit(entries)
            return Batch(2, ids, pos, lens, pos.copy(), tables)
        return Batch(0, np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.zeros((0, self.max_pages_per_seq), np.int32))

    def report(self, request_ids, produced, done):
        for rid, p, d in zip(request_ids, produced, done):
            r = self.requests.get(int(rid))
            if r is None:
                continue
            r.generated += int(p)
            if (d or r.generated >= r.max_new_tokens) and r.state != DONE:
                r.state = DONE
                # Shared (prefix-cache) pages may outlive this request:
                # only refcount-zero pages return, in r.pages order
                # (identical to the native twin).
                for pg in r.pages:
                    if pg >= 0:
                        self._decref(pg)
                r.pages = []
                self.active.remove(r.id)

    def num_free_pages(self):
        return len(self.free_pages)

    def request_state(self, req_id):
        r = self.requests.get(req_id)
        return -1 if r is None else r.state

    def num_active(self):
        return len(self.active)


def make_scheduler(num_pages, page_size, max_batch, max_pages_per_seq,
                   chunk_size, prefer_native: bool = True):
    if prefer_native and _lib() is not None:
        return NativeScheduler(num_pages, page_size, max_batch,
                               max_pages_per_seq, chunk_size)
    return PyScheduler(num_pages, page_size, max_batch, max_pages_per_seq,
                       chunk_size)
