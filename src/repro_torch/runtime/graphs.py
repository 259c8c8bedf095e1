"""CUDA graphs of the stream server's fixed-shape round.

The port's counterpart of the reference's jitted, donated
``_stream_step_pool``: the reference serves a device-staged round as one XLA
dispatch, and here the round's bodies (the step, and the cohort refresh of
each refresh phase) are captured once as CUDA graphs and replayed, so a
round costs a few control copies and one or two graph launches instead of
the ~250 launches the eager round issues from Python.

A body takes no arguments and reads and writes only tensors whose
addresses stay fixed between its replays (the server's state, its request
pool and its static control buffer).  The first call of each variant runs
the body eagerly and really serves: that call is the warm-up, so every
kernel's first load, every library's handles and autograd's threads come up
outside capture.  The second call captures the body, which executes
nothing, and replays it.  A capture or a replay that fails raises; nothing
falls back to the eager round.

``run_if`` is the round's ``lax.cond``: the rare, costly steps that the
reference gates on a device flag (the window mode's refactorization of the
slots whose downdate tripped the guard, the adaptive mode's anneal) become
a conditional node of the captured graph (``kernels/csrc/graph_cond.cu``),
whose body runs at a replay only when the flag is set on the device.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int


def run_if(flag: torch.Tensor, body: Callable[[], None],
           graphs: Optional["RoundGraphs"] = None,
           read: bool = False) -> None:
    """Run ``body``, which updates tensors in place, where the device
    scalar ``flag`` holds; ``body`` must change no bit where it does not.

    While ``graphs`` captures, ``body`` becomes the body of a conditional
    node: a replay runs it only when ``flag`` is set, and the flag never
    leaves the device.  Otherwise ``body`` runs unconditionally (the same
    bits, since it changes none where the flag is clear), or, with
    ``read``, only if ``flag`` reads true on the host: a blocking read on a
    CUDA device, which the eager round pays rather than a costly body."""
    if graphs is not None and graphs.capturing:
        graphs.conditional(flag, body)
    elif not read or bool(flag):
        body()


class _Graph:
    """One captured body: the graph, its static outputs and the kernel
    launches recorded into it."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs,
                 tally: Dict[_build.CudaKernel, int]):
        self.graph = graph
        self.outputs = outputs
        self.tally = tally

    def replay(self):
        self.graph.replay()
        for kernel, n in self.tally.items():
            kernel.launches += n
        return self.outputs


class RoundGraphs:
    """Lazily captured CUDA graphs of one server's round bodies, by variant.

    ``run(key, body)`` serves one call of the variant ``key``: eagerly the
    first time (the warm-up), then from a graph captured on the second call
    and replayed from then on.  The returned tensors are the body's outputs;
    a replay's are the graph's static outputs, valid until the next replay of
    any of the server's graphs, which share one memory pool.  So a tensor
    that must outlive that (the state, the pool, the predictions read back,
    the retirement snapshots) lives outside the graphs.

    ``capture=False`` runs every call eagerly: the same in-place bodies and
    control flow on a device that has no graphs, for tests on the CPU.
    """

    def __init__(self, capture: bool = True):
        self.capture = capture
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        # the conditional bodies' memory: the allocator takes one capture
        # per pool at a time, and a body is captured inside its graph's
        self.body_pool = torch.cuda.graph_pool_handle() if capture else None
        self._stream: Optional[torch.cuda.Stream] = None
        self._body_stream: Optional[torch.cuda.Stream] = None
        self.capturing = False   # a body is being captured (run_if)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._warm: set = set()
        self.replays = 0       # graph launches
        self.eager_calls = 0   # warm-up calls (and every call without capture)

    def reset(self) -> None:
        """Drop every graph: the tensors they captured were replaced (the
        request pool grew).  Each variant warms up and captures again, into
        a new memory pool: the old one goes with the last graph that held
        it, and a released pool cannot take a capture."""
        self._graphs.clear()
        self._warm.clear()
        if self.capture:
            self.pool = torch.cuda.graph_pool_handle()

    def run(self, key: Hashable, body: Callable[[], object]):
        graph = self._graphs.get(key)
        if graph is None:
            if not self.capture or key not in self._warm:
                self._warm.add(key)
                self.eager_calls += 1
                return body()
            graph = self._graphs[key] = self._capture(body)
        self.replays += 1
        return graph.replay()

    def _capture(self, body: Callable[[], object]) -> _Graph:
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream), _build.tally_launches() as tally:
            graph.capture_begin(pool=self.pool)
            self.capturing = True
            try:
                outputs = body()
            except BaseException:
                _end_failed_capture(graph)
                raise
            finally:
                self.capturing = False
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(self._stream)
        return _Graph(graph, outputs, dict(tally))

    def conditional(self, flag: torch.Tensor,
                    body: Callable[[], None]) -> None:
        """Capture ``body`` as a conditional node on ``flag`` into the graph
        being captured on the current stream (``run_if``)."""
        if self._body_stream is None:
            self._body_stream = torch.cuda.Stream()
        flag = flag.reshape(()).to(torch.bool).contiguous()
        dev = torch.cuda.current_device()
        begin = _cond_fn("dfr_graph_if_begin", [_P, _P, _P, _I])
        end = _cond_fn("dfr_graph_if_end", [_P])
        _check(begin, begin[0](torch.cuda.current_stream().cuda_stream,
                               flag.data_ptr(), self._body_stream.cuda_stream,
                               0))   # the global capture mode, as PyTorch's
        torch._C._cuda_beginAllocateCurrentThreadToPool(dev, self.body_pool)
        try:
            with torch.cuda.stream(self._body_stream):
                body()
        finally:
            # end the body's capture even when the body failed: its error
            # is then the one raised
            rc = end[0](self._body_stream.cuda_stream)
            torch._C._cuda_endAllocateToPool(dev, self.body_pool)
        _check(end, rc)


_COND: Dict[str, tuple] = {}


def _cond_fn(symbol: str, argtypes) -> tuple:
    """(``symbol`` of the conditional-node library, its error strings)."""
    if symbol not in _COND:
        _COND[symbol] = _build.c_function("graph_cond", symbol, argtypes)
    return _COND[symbol]


def _check(fn: tuple, rc: int) -> None:
    if rc:
        raise RuntimeError(f"conditional node: {fn[0].__name__} failed: "
                           f"{fn[1](rc).decode()} (error {rc})")


def _end_failed_capture(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture that its body broke off; the body's error is the one
    to report, and ending an invalidated capture raises its own."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass


class PinnedRing:
    """A ring of host buffers, pinned on a CUDA device, for the round's
    non-blocking copies: control vectors up, predictions down.

    The server takes buffer ``k % n`` for its k-th dispatch, with n =
    ``pipeline_depth + 1``: dispatch k's predictions are read (its copy
    waited on) before dispatch k + n begins, so a buffer is never written
    while a queued copy still reads it or before its contents were read.
    """

    def __init__(self, n: int, shape: Tuple[int, ...], dtype,
                 device: torch.device):
        pin = device.type == "cuda"
        self.bufs = [torch.zeros(shape, dtype=dtype, pin_memory=pin)
                     for _ in range(n)]

    def __getitem__(self, k: int) -> torch.Tensor:
        return self.bufs[k % len(self.bufs)]
