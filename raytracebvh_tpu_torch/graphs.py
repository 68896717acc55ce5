"""CUDA-graph capture and replay: the port's counterpart of ``jax.jit``.

The JAX package compiles the frame (``render_frame_jit``) and the
training step (``models/inverse.train_step``) into one program each.  The
port's frame is a few thousand small launches whose host overhead
dominates it, so on the card it records them once into a
``torch.cuda.CUDAGraph`` and replays the graph: the same kernels with the
same arguments, so the same bits, without the host between launches.
``torch.compile`` is not used: the kernels are ctypes calls it would break
on, and compiling the plain ops would change the code under test.

``Captured`` is one graph.  It keeps static copies of its inputs, warms
the function up once on a side stream (lazily allocated scratch, such as
the walks' counters and the tile permutations, is made there, outside the
capture), captures it on the same stream, and on each call copies the
caller's tensors into the static inputs (device to device), replays, and
returns the static output.  A failed capture raises: nothing here runs the
eager function in its place.  ``Cache`` keys captures as ``jax.jit`` keys
traces: the frozen config plus the shape, dtype and device of every input
tensor (``signature``).

Inside a capture every kernel wrapper launches on
``torch.cuda.current_stream()``, the capture stream, and the launch
counters of ``ops/*_cuda.py`` count the capture's launches once: a replay
runs the kernels again without passing through Python, so the counters do
not count replays.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch


def tensors(tree) -> list:
    """The tensor leaves of a tree of dataclasses, tuples, lists and
    tensors, in a fixed order (``None`` and other leaves hold none)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensors(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors(getattr(tree, f.name))]
    return []


def structure(tree):
    """A hashable description of ``tree``: its types and field names, and
    the shape, dtype and device of each tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(structure(x) for x in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__, tuple(
            (f.name, structure(getattr(tree, f.name)))
            for f in dataclasses.fields(tree)))
    return ("value", tree)


def signature(cfg, *inputs):
    """The cache key of a call: the frozen config and the structure of its
    inputs, as ``jax.jit`` keys a trace on static arguments and abstract
    values."""
    return (cfg, tuple(structure(x) for x in inputs))


def static_copy(tree):
    """A tree of the same structure with every tensor cloned (detached,
    contiguous, and a normal tensor even under inference mode)."""
    with torch.inference_mode(False):
        return _map(lambda t: t.detach().clone(
            memory_format=torch.contiguous_format), tree)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, x) for x in tree]
        if hasattr(tree, "_fields"):  # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def copy_into(static, tree) -> None:
    """Copy every tensor of ``tree`` into the matching tensor of
    ``static`` (same structure, checked by the caller's key)."""
    for dst, src in zip(tensors(static), tensors(tree)):
        dst.copy_(src)


def check_no_grad(tree, what: str) -> None:
    """Raise where grad mode is on and an input requires grad: a replayed
    graph returns no autograd graph, and the JAX package never
    differentiates its jitted frame."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors(tree)):
        raise ValueError(
            f"{what} does not differentiate: an input requires grad; call "
            "it under torch.no_grad() or differentiate the eager function")


class Captured:
    """One CUDA graph of ``fn(*inputs)``.

    ``inputs`` are copied into static tensors (``static_copy``).
    ``warmup`` (default ``fn``) runs once on ``stream`` with the static
    inputs, then ``prepare()`` where given, then ``fn`` is captured on
    ``stream`` into a graph whose memory comes from ``pool`` (a pool
    handle, to share one pool among graphs replayed in the order they
    were captured) or its own.  ``capture_ms`` is the capture's host time,
    ``pool_bytes`` the device memory the allocator reserved during it.
    ``debug`` keeps the graph for ``CUDAGraph.debug_dump`` (which prints
    it once).  ``capture_error_mode`` is ``torch.cuda.graph``'s: the
    collectives' captures take ``"thread_local"`` (``parallel/render.py``).
    ``__call__`` copies its arguments into the static inputs, replays, and
    returns the static output (the caller clones what it hands out)."""

    def __init__(self, fn, inputs: tuple, stream: torch.cuda.Stream,
                 pool=None, debug: bool = False, warmup=None, prepare=None,
                 capture_error_mode: str = "global"):
        self.inputs = static_copy(inputs)
        # the graph reads the tensors ``fn`` closes over (constants made
        # outside the capture) at their addresses: they live as long as it
        self.fn = fn
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            (warmup or fn)(*self.inputs)
        torch.cuda.current_stream().wait_stream(stream)
        if prepare is not None:
            prepare()
        # debug: keep the captured graph (not only its executable) so that
        # debug_dump can print its nodes
        self.graph = torch.cuda.CUDAGraph(keep_graph=debug)
        if debug:
            self.graph.enable_debug_mode()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode=capture_error_mode):
            self.output = fn(*self.inputs)
        if debug:
            self.graph.instantiate()
        torch.cuda.synchronize()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def __call__(self, *args):
        copy_into(self.inputs, args)
        self.graph.replay()
        return self.output


class Cache:
    """Captured calls by key (``signature``), the least recently used
    dropped beyond ``max_entries`` (a 1080p frame's graph holds about its
    eager peak memory, 1-1.4 GB on an H100).  ``debug`` and
    ``capture_error_mode`` are handed to the captures it makes
    (``options``)."""

    max_entries = 8

    def __init__(self, capture_error_mode: str = "global"):
        self.debug = False
        self.capture_error_mode = capture_error_mode
        self.entries = collections.OrderedDict()
        self._stream = {}

    def options(self) -> dict:
        """``Captured``'s keyword arguments for this cache's captures."""
        return dict(debug=self.debug,
                    capture_error_mode=self.capture_error_mode)

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        """The side stream this cache warms up and captures on."""
        if device not in self._stream:
            self._stream[device] = torch.cuda.Stream(device)
        return self._stream[device]

    def get(self, key, make):
        """The entry for ``key``, made by ``make()`` on a miss."""
        if key in self.entries:
            self.entries.move_to_end(key)
            return self.entries[key]
        entry = make()
        self.entries[key] = entry
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)
        return entry

    def clear(self) -> None:
        """Drop every entry (and with it its graphs and their memory)."""
        self.entries.clear()
