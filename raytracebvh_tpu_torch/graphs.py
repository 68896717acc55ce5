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

``cond`` is ``jax.lax.cond``: eagerly it runs one branch by the host's
value of the predicate; while capturing it records each branch into a
conditional node of the graph (CUDA 12.4 and later; the node is
``csrc/cond.cu``'s, since torch 2.11 has none), an IF node on a 0-d CUDA
bool that the graph reads at each replay, so the device decides which
branch runs and the host reads nothing.  It differentiates: its backward
is a ``cond`` on the same predicate (as JAX transposes ``lax.cond`` into a
``cond``), which recomputes the branch that ran with autograd and takes
its vector-Jacobian product.

``while_loop`` is the while loop that XLA compiles ``lax.map`` into: one
body run ``count`` times, the trip number a device index.  Eagerly it
loops in Python; while capturing it records the body once into a WHILE
node of ``csrc/cond.cu``, whose trip count the graph reads from a 0-d
device int at each replay.  ``pipeline.shade_rays`` runs its chunk loop
on it.

``Captured``'s warm-up runs both branches of every ``cond`` and every
loop's body at least once, so that the bodies the capture records have
run once eagerly (their lazily made constants made outside the capture).

While ``utils.profiling.spans()`` is open, ``signature`` keys a
spans-on graph apart (its capture holds the spans' marks), and the host's
work around a replay is spanned: ``graphs.key``, ``graphs.copy_in``,
``graphs.launch`` and ``graphs.copy_out``.  Spans off, each of those is
a no-op ``with`` and the key is what it was without spans.  Every
capture is logged (``profiling.captures``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import time
import weakref

import torch

from . import _kernels
from .utils import profiling


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
    values.  While ``profiling.spans()`` is open the key says so (a
    spans-on call replays a graph of its own, with the span marks), and
    the host span ``graphs.key`` records its making."""
    with profiling.host_span("graphs.key"):
        key = (cfg, tuple(structure(x) for x in inputs))
        return key if profiling.active is None else key + ("spans",)


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


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False without
    a card)."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


# Captured's warm-ups in progress (``warming``); a global, not a
# thread-local, since a warm-up's backward runs on autograd's threads
_warming = 0


@contextlib.contextmanager
def warming():
    """While open, ``cond`` runs both branches (and returns the one the
    predicate picks), and ``while_loop`` runs its body at least once."""
    global _warming
    _warming += 1
    try:
        yield
    finally:
        _warming -= 1


# the conditional nodes' bodies' stream on each device, and the bodies of
# the graph that ``Captured`` is capturing (None outside a capture: a
# captured cond or loop needs its warm-up)
_body_streams: dict = {}
_bodies = None


def _body_stream(device: torch.device):
    """The conditional nodes' bodies' stream on ``device``: one of their own
    (torch's streams come from a shared pool, where a body could meet the
    stream that captures it)."""
    if device not in _body_streams:
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            _kernels.check(_kernels.load().rtbvh_stream_create(
                ctypes.byref(handle)), "the conditional nodes' stream")
        _body_streams[device] = torch.cuda.ExternalStream(handle.value,
                                                          device=device)
    return _body_streams[device]


class _Bodies:
    """The memory pool of one graph's conditional-node bodies (the graph's
    own pool admits only its capture stream's allocations): made by the
    first body, held while the graph lives and released with it
    (``release``), after which the allocator frees it as it frees a
    graph's pool.  No other graph allocates from it, so graphs' replays
    may interleave as they may without conditional nodes.  ``trips`` are
    the graph's loops' trip counters (``while_loop``), in capture order."""

    def __init__(self, device: torch.device):
        self.index = device.index
        self.pool = torch.cuda.graph_pool_handle()
        self.held = False
        self.trips = []

    @contextlib.contextmanager
    def allocating(self):
        """The block's allocations on this thread from the pool (what
        ``torch.cuda.use_mem_pool`` does for a ``MemPool``)."""
        torch._C._cuda_beginAllocateCurrentThreadToPool(self.index,
                                                        self.pool)
        try:
            yield
        finally:
            torch._C._cuda_endAllocateToPool(self.index, self.pool)
            # each begin takes a use of the pool; the first one's is held
            if self.held:
                torch._C._cuda_releasePool(self.index, self.pool)
            self.held = True

    def release(self) -> None:
        """Give the pool back to the allocator (once)."""
        if self.held:
            self.held = False
            torch._C._cuda_releasePool(self.index, self.pool)


@contextlib.contextmanager
def _if_node(pred: torch.Tensor):
    """Capture the block into an IF node of the graph being captured: its
    body runs at a replay where ``pred`` (a 0-d CUDA bool, read by the
    graph) is true.  The node is ``csrc/cond.cu``'s; the block runs on the
    bodies' stream, its memory from their pool."""
    if pred.dtype != torch.bool or pred.dim() or pred.device.type != "cuda":
        raise ValueError(f"cond: the predicate of a captured cond must be a "
                         f"0-d CUDA bool; got {pred.dtype} "
                         f"{tuple(pred.shape)} on {pred.device}")
    bodies = _captured_bodies("cond: a captured cond")
    body = _body_stream(pred.device)
    _kernels.check(_kernels.load().rtbvh_if_begin(
        pred.data_ptr(), torch.cuda.current_stream().cuda_stream,
        body.cuda_stream), "cond: an IF node")
    try:
        with torch.cuda.stream(body), bodies.allocating():
            yield
    finally:
        _kernels.check(_kernels.load().rtbvh_if_end(body.cuda_stream),
                       "cond: an IF node's body")


def _captured_bodies(what: str) -> _Bodies:
    """The bodies of the graph being captured; raises outside
    ``Captured``, whose warm-up runs the bodies first."""
    if _bodies is None:
        raise RuntimeError(f"{what} needs graphs.Captured, whose warm-up "
                           "runs its bodies")
    return _bodies


def while_loop(count, body, device=None) -> torch.Tensor:
    """``body(j)`` for ``j`` in ``[0, count)``, in order: the while loop
    that XLA compiles ``lax.map`` into, one body for every trip.  ``j`` is
    a 0-d int32 tensor on the device, the trip number: the body reads it
    there (as an index: ``index_select`` and ``index_copy_``, XLA's
    ``dynamic_slice`` and ``dynamic_update_slice``), never as a Python
    value, and writes its results into tensors made before the loop.
    ``count`` is a Python int (a trip count known before the loop, on
    ``device``) or a 0-d integer tensor.

    While capturing, the loop is one WHILE node of the graph
    (``csrc/cond.cu``): the body is captured once, on the bodies' stream
    with the bodies' memory pool, and the graph reads ``count`` at each
    replay, so the device decides how many trips run.  Eagerly a tensor
    ``count`` is read on the host, once.  Under ``warming`` the body runs
    at least once, so that what it makes lazily is made before a capture.
    Returns the trip counter, a 0-d int32 device tensor: the trips run
    (after each replay, for a captured loop; ``Captured.trips`` keeps the
    graph's)."""
    if isinstance(count, torch.Tensor):
        if count.dim() or count.is_floating_point() or count.is_complex():
            raise ValueError(f"while_loop: count must be a 0-d integer "
                             f"tensor or an int; got {count.dtype} "
                             f"{tuple(count.shape)}")
        device = count.device
    elif device is None:
        raise ValueError("while_loop: an int count needs a device")
    if capturing():
        return _while_node(count, body, torch.device(device))
    n = int(count)
    trips = torch.arange(max(n, 1) if _warming else n, dtype=torch.int32,
                         device=device)
    for j in trips.unbind(0):
        body(j)
    return trips.new_full((), trips.shape[0])


def _while_node(count, body, device: torch.device) -> torch.Tensor:
    """``while_loop`` while capturing: one WHILE node, its trip counter
    kept with the graph's bodies."""
    bodies = _captured_bodies("while_loop: a captured loop")
    if isinstance(count, torch.Tensor):
        count = count.to(torch.int32)
    else:
        count = torch.full((), count, dtype=torch.int32, device=device)
    trip = torch.empty((), dtype=torch.int32, device=device)
    stream = _body_stream(device)
    handle = ctypes.c_ulonglong()
    lib = _kernels.load()
    _kernels.check(lib.rtbvh_while_begin(
        count.data_ptr(), trip.data_ptr(),
        torch.cuda.current_stream().cuda_stream, stream.cuda_stream,
        ctypes.byref(handle)), "while_loop: a WHILE node")
    try:
        with torch.cuda.stream(stream), bodies.allocating():
            body(trip)
    finally:
        _kernels.check(lib.rtbvh_while_end(
            handle.value, count.data_ptr(), trip.data_ptr(),
            stream.cuda_stream), "while_loop: a WHILE node's body")
    # the graph writes the counter at each replay: it lives as long as the
    # graph, so no later allocation of the capture reuses its memory
    bodies.trips.append(trip)
    return trip


def _select(pred, true_fn, false_fn):
    """``true_fn()`` if ``pred`` else ``false_fn()``: both return a tensor
    or a tuple of tensors of the same shapes and dtypes.  A tensor ``pred``
    while capturing makes two IF nodes, on ``pred`` and on its negation;
    the second copies ``false_fn()`` into the first's output, which it
    returns (torch's ``if_else_node``).  Else a tensor ``pred`` is read on
    the host."""
    if isinstance(pred, torch.Tensor) and capturing():
        not_pred = torch.logical_not(pred)
        with _if_node(pred):
            out = true_fn()
        with _if_node(not_pred):
            other = false_fn()
            for o, x in zip(tensors(out), tensors(other), strict=True):
                if o.shape != x.shape or o.dtype != x.dtype:
                    raise ValueError(
                        f"cond: the branches return {o.dtype} "
                        f"{tuple(o.shape)} and {x.dtype} {tuple(x.shape)}")
                o.copy_(x)
        return out
    pred = bool(pred)
    if _warming:  # the branch the predicate skips, for its warm-up
        (false_fn if pred else true_fn)()
    return true_fn() if pred else false_fn()


def cond(pred, true_fn, false_fn, operands: tuple = ()):
    """``jax.lax.cond(pred, true_fn, false_fn, *operands)``: the result of
    ``true_fn(*operands)`` where ``pred`` holds, else of
    ``false_fn(*operands)``, a tensor or a tuple of tensors, equal in shape
    and dtype.  ``pred`` is a bool (the host's value) or a 0-d bool
    tensor: while capturing, on the card, the graph's IF nodes decide at
    each replay; eagerly it is read.

    With grad mode on, the result is differentiable with respect to the
    tensors in ``operands`` (trees of tuples and dataclasses) that require
    grad; tensors the branches close over are constants.  The backward is
    a ``cond`` on the same predicate, as JAX transposes ``lax.cond``: the
    branch that ran, recomputed with autograd, and its vector-Jacobian
    product.  Recomputing costs the branch's forward once more and keeps
    no residual from the forward: autograd runs a node's backward on the
    stream that ran its forward, which for a branch captured into an IF
    node is the bodies' stream, whose capture has ended by the time the
    backward is captured."""
    leaves = [t for t in tensors(operands) if t.requires_grad] \
        if torch.is_grad_enabled() else []
    if not leaves:
        return _select(pred, lambda: true_fn(*operands),
                       lambda: false_fn(*operands))
    one = []
    out = _Cond.apply(pred, true_fn, false_fn, operands, one, *leaves)
    return out[0] if one[0] else out


class _Cond(torch.autograd.Function):
    """``cond`` under autograd: its outputs are a tuple of tensors (the
    false branch's cloned, so that none is a tensor the branch closes
    over, such as a constant); ``one`` gets whether the branch returned
    one tensor."""

    @staticmethod
    def forward(ctx, pred, true_fn, false_fn, operands, one, *leaves):
        ctx.pred, ctx.fns, ctx.operands = pred, (true_fn, false_fn), operands
        ctx.leaves = leaves
        out = _select(pred, lambda: true_fn(*operands),
                      lambda: _map(torch.clone, false_fn(*operands)))
        one.append(isinstance(out, torch.Tensor))
        return tuple(tensors(out))

    @staticmethod
    def backward(ctx, *grads):
        vjps = [functools.partial(_vjp, fn, ctx.operands, ctx.leaves, grads)
                for fn in ctx.fns]
        return (None,) * 5 + tuple(_select(ctx.pred, *vjps))


def _vjp(fn, operands, leaves, grads):
    """The gradients of ``fn(*operands)``'s outputs against ``grads`` with
    respect to ``leaves`` (tensors in ``operands``), ``fn`` recomputed with
    autograd: a tuple of tensors, zeros where an output does not depend on
    a leaf."""
    with torch.enable_grad():
        fresh = [t.detach().requires_grad_(True) for t in leaves]
        swap = {id(t): f for t, f in zip(leaves, fresh)}
        outs = tensors(fn(*_map(lambda t: swap.get(id(t), t), operands)))
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        got = torch.autograd.grad(
            [o for o, _ in pairs], fresh, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(fresh)
    return tuple(torch.zeros_like(f) if g is None else g
                 for f, g in zip(fresh, got))


class Captured:
    """One CUDA graph of ``fn(*inputs)``.

    ``inputs`` are copied into static tensors (``static_copy``).
    ``warmup`` (default ``fn``) runs once on ``stream`` with the static
    inputs, both branches of every ``cond`` and every loop's body included
    (``warming``), then ``prepare()`` where given, then ``fn`` is captured
    on ``stream`` into a graph with a memory pool of its own, and its
    conditional nodes' bodies with another (``_Bodies``), released with
    the graph.  A capture that fails raises, and leaves the allocator as
    it found it (``_abandon``).  ``capture_ms`` is the capture's host
    time, ``pool_bytes`` the device memory the allocator reserved during
    it, ``peak_bytes`` the most bytes its allocations held at once
    (``_held_peak``: the share of ``torch.cuda.max_memory_allocated``
    that the capture adds to what was allocated at its start), ``trips``
    the trip counters of its loops (``while_loop``), which each replay
    rewrites: a witness of the trips the device ran.  ``record`` is its
    entry in the capture log (``profiling.captures``, under ``name``),
    which holds those three and the warm-up's ms.
    ``debug`` keeps the graph for ``CUDAGraph.debug_dump`` (which prints
    it once).  ``capture_error_mode`` is ``torch.cuda.graph``'s: the
    collectives' captures take ``"thread_local"`` (``parallel/render.py``).
    ``__call__`` copies its arguments into the static inputs, replays, and
    returns the static output (the caller clones what it hands out)."""

    def __init__(self, fn, inputs: tuple, stream: torch.cuda.Stream,
                 debug: bool = False, warmup=None, prepare=None,
                 capture_error_mode: str = "global", name: str = "graph"):
        begin_ns = time.perf_counter_ns()
        self.inputs = static_copy(inputs)
        # the graph reads the tensors ``fn`` closes over (constants made
        # outside the capture) at their addresses: they live as long as it
        self.fn = fn
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), warming():
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
        warmup_ms = (time.perf_counter_ns() - begin_ns) / 1e6
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        pool = torch.cuda.graph_pool_handle()
        bodies = _Bodies(stream.device)
        global _bodies
        t0 = time.perf_counter()
        _bodies = bodies
        torch.cuda.memory._record_memory_history(
            context=None, stacks="python", clear_history=True)
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode=capture_error_mode):
                self.output = fn(*self.inputs)
        except BaseException:
            _abandon(stream.device, pool, bodies)
            raise
        finally:
            _bodies = None
            peak_bytes = _held_peak(stream.device)
        # the bodies' pool goes with the graph that replays them
        weakref.finalize(self.graph, bodies.release).atexit = False
        self.trips = bodies.trips
        if debug:
            self.graph.instantiate()
        torch.cuda.synchronize()
        self.record = profiling.log_capture(
            self, name=name, warmup_ms=warmup_ms,
            capture_ms=(time.perf_counter() - t0) * 1e3,
            pool_bytes=torch.cuda.memory_reserved() - reserved,
            peak_bytes=peak_bytes, spans=profiling.active is not None,
            begin_ns=begin_ns, end_ns=time.perf_counter_ns())

    @property
    def capture_ms(self) -> float:
        return self.record.capture_ms

    @property
    def pool_bytes(self) -> int:
        return self.record.pool_bytes

    @property
    def peak_bytes(self) -> int:
        return self.record.peak_bytes

    def __call__(self, *args):
        with profiling.host_span("graphs.copy_in"):
            copy_into(self.inputs, args)
        with profiling.host_span("graphs.launch"):
            self.graph.replay()
        return self.output


def _held_peak(device: torch.device) -> int:
    """The most bytes the allocations on ``device`` held at once since the
    allocator's history was turned on (``Captured``, at its capture), above
    what they held then: its allocs and frees summed in order.  Turns the
    history off (a caller's own recording of it too).  A replay allocates nothing, so this is all that
    ``torch.cuda.max_memory_allocated`` sees of a graph beyond its live
    outputs; the pool's reserved bytes (``pool_bytes``) also hold what the
    allocator could not reuse inside the capture."""
    try:
        trace = torch.cuda.memory._snapshot()["device_traces"][device.index]
    finally:
        torch.cuda.memory._record_memory_history(None)
    held = peak = 0
    for entry in trace:
        if entry["action"] == "alloc":
            held += entry["size"]
            peak = max(peak, held)
        elif entry["action"] == "free_requested":
            held -= entry["size"]
    return peak


def _abandon(device: torch.device, pool, bodies: _Bodies) -> None:
    """Undo a failed capture's hold on the allocator: where the capture was
    invalidated (a host read inside it), torch's ``capture_end`` raises
    before it stops sending the capture's allocations to ``pool``, and an
    allocator that still counts a capture fails an assert where it later
    frees its events; the bodies' pool goes too."""
    with contextlib.suppress(RuntimeError):  # capture_end had ended it
        torch._C._cuda_endAllocateToPool(device.index, pool)
    bodies.release()


# the side stream that every cache warms up and captures on, one a
# device: a stream that has run a cuBLAS call keeps its workspace (32 MiB
# on an H100) for the life of the process, so a stream a cache would keep
# one a cache, also after the cache and its graphs are gone
_capture_streams: dict = {}


class Cache:
    """Captured calls by key (``signature``), the least recently used
    dropped beyond ``max_entries`` (a 1080p frame's graph holds about its
    eager peak memory, 1-1.4 GB on an H100).  ``debug``,
    ``capture_error_mode`` and ``name`` (the capture log's) are handed to
    the captures it makes (``options``)."""

    max_entries = 8

    def __init__(self, capture_error_mode: str = "global",
                 name: str = "graph"):
        self.debug = False
        self.capture_error_mode = capture_error_mode
        self.name = name
        self.entries = collections.OrderedDict()

    def options(self) -> dict:
        """``Captured``'s keyword arguments for this cache's captures."""
        return dict(debug=self.debug,
                    capture_error_mode=self.capture_error_mode,
                    name=self.name)

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        """The side stream this cache warms up and captures on, every
        cache's on ``device`` (``_capture_streams``)."""
        if device not in _capture_streams:
            _capture_streams[device] = torch.cuda.Stream(device)
        return _capture_streams[device]

    def call(self, key, fn, inputs: tuple, name: str = None):
        """``fn(*inputs)`` replayed from the capture for ``key``, made on a
        miss (a ``Captured`` on the inputs' device, with ``options``, in
        the caller's grad mode, logged under ``name`` where given); its
        output cloned (the host span ``graphs.copy_out``), so the caller's
        result outlives the next replay."""
        device = tensors(inputs)[0].device

        def make():
            options = self.options()
            if name is not None:
                options["name"] = name
            return Captured(fn, inputs, self.stream(device), **options)

        with torch.inference_mode(False):
            entry = self.get(key, make)
        with torch.no_grad():
            out = entry(*inputs)
            with profiling.host_span("graphs.copy_out"):
                return _map(torch.clone, out)

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
