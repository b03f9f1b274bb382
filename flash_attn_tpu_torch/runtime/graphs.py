"""Compiled steps: a step function replayed from a CUDA graph (the port's
counterpart of `jax.jit` over a step of flash_attn_tpu/runtime/engine.py
and generation.py).

A jitted JAX step is traced once and then dispatched as one program. Its
counterpart here is `StepGraph`: a function that reads and writes only
tensors that live as long as the graph (its static inputs and outputs),
run eagerly once on a side stream, which warms every lazy state it touches
(the kernels' libraries loaded by ctypes, the SM count, the rotary tables,
cuBLAS's workspace on that stream), then captured by `torch.cuda.graph`
and replayed on every later call. The host feeds a step by writing into
its static inputs in place, never by handing it new tensors.

On the CPU, which a caller must ask for, the same function runs eagerly on
the same static buffers every call, so CPU tests run the code that is
captured on the card. A capture that fails raises: no step drops to eager
execution on its own.
"""

from __future__ import annotations

import gc
import inspect
import time
import weakref
from typing import Callable, Iterable, Optional, Tuple

import torch

from flash_attn_tpu_torch.kernels.flash_decode import (
    flash_attention_decode_general,
)
from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage,
)

# The wrappers' launch counters on the decode paths. A kernel launched
# inside a capture runs only when the graph is replayed, so StepGraph moves
# these counters by what a capture added on every replay instead.
LAUNCH_COUNTERS: Tuple[Tuple[object, str], ...] = (
    (flash_attention_decode_multipage, "launches"),
    (flash_attention_decode_multipage, "qv_launches"),
    (flash_attention_decode_multipage, "combine_launches"),
    (flash_attention_decode_general, "launches"),
    (flash_attention_decode_general, "qv_launches"),
    (flash_attention_decode_general, "combine_launches"),
)


def _read():
    return [getattr(obj, name) for obj, name in LAUNCH_COUNTERS]


class StepGraph:
    """`fn()` as one replayed CUDA graph on a CUDA `device`; eager on any
    other device, or with `capture=False` (the same code, for A/Bs).

    The first call runs `fn` eagerly on a side stream (the real step, whose
    effects on the static tensors stand) and then captures it, drawing its
    memory from `pool` (a `torch.cuda.graph_pool_handle()`; the graphs of
    one engine share one). Every later call replays the graph.
    `generators` are the explicit `torch.Generator`s that `fn` draws from:
    each is registered with the graph, so that every replay draws new
    numbers (the default CUDA generator is registered by PyTorch itself).
    The `LAUNCH_COUNTERS` stay true across replays. `capture_s` is the host
    time of the first call, warm-up and capture.

    A bound method `fn` is held weakly: an engine that keeps its graphs
    holds them with no reference cycle, so dropping the engine frees its
    pools and graphs at once."""

    def __init__(self, fn: Callable[[], None], device: torch.device, *,
                 capture: bool = True, pool=None,
                 generators: Iterable[Optional[torch.Generator]] = ()):
        self._fn = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
                    else lambda: fn)
        self.device = device
        self.captured = capture and device.type == "cuda"
        self.pool = pool
        self.generators = [g for g in generators if g is not None]
        self.graph = None
        self.capture_s = 0.0
        self._added = [0] * len(LAUNCH_COUNTERS)

    def fn(self) -> None:
        """One eager run of the step."""
        fn = self._fn()
        if fn is None:
            raise ReferenceError("the step's owner no longer exists")
        fn()

    def __call__(self) -> None:
        if not self.captured:
            self.fn()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            for (obj, name), n in zip(LAUNCH_COUNTERS, self._added):
                setattr(obj, name, getattr(obj, name) + n)

    def _warm_up_and_capture(self):
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.fn()
        graph = torch.cuda.CUDAGraph()
        defaults = torch.cuda.default_generators
        for gen in self.generators:
            if gen.device.type != "cuda":
                raise ValueError(f"a CUDA graph cannot draw from a generator "
                                 f"on {gen.device}")
            if gen is defaults[gen.device.index or 0]:
                continue  # registered by torch.cuda.graph
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "this torch cannot register an explicit generator with a "
                    "CUDA graph (CUDAGraph.register_generator_state); sample "
                    "with the default generator, greedily, or with cg=False")
            graph.register_generator_state(gen)
        before = _read()
        # Garbage collected during the capture could hold another graph,
        # whose destruction is not permitted while a stream captures and
        # would void this capture: no collection runs during it.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                self.fn()
        finally:
            if collecting:
                gc.enable()
        after = _read()
        # Nothing ran during the capture: put the counters back, and move
        # them by the capture's count on each replay.
        self._added = [a - b for a, b in zip(after, before)]
        for (obj, name), n in zip(LAUNCH_COUNTERS, before):
            setattr(obj, name, n)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
