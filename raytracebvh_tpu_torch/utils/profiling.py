"""Tracing / profiling (the JAX package's ``utils/profiling.py``).

The same FPS meter, a per-stage breakdown of the frame pipeline with the
JAX function's stages and keys, and a context manager around
``torch.profiler.profile`` that writes a Chrome trace (in place of
``jax.profiler.trace``).  The JAX function jits each stage on its own;
on CUDA tensors each stage here is its own CUDA graph (``graphs.py``),
replayed between CUDA events, so a stage's time is its kernels' without
the host between them.  On the CPU the stages run eagerly, timed by the
host clock.

Spans, which the JAX package does not have.  While ``spans()`` is open
the program records a span at each layer boundary: the frame and the
step (its ``forward``, ``backward`` and ``optimizer``), the build and its
stages, each walk, each shading pass with its gathers, each bounce, and
the chunk loop (``chunks``, one ``chunk`` a trip).  On CUDA tensors a
span is two marks, one-thread kernels of ``csrc/mark.cu`` that append
(call, span, trip, ``%globaltimer`` ns) to a record buffer on the card:
captured into a CUDA graph they are nodes of it, and every replay
records, inside a WHILE node once a trip.  On CPU tensors the same spans
are recorded on the host clock (``time.perf_counter_ns``).  Around a
replay the host records its own spans, on that clock: ``graphs.key``
(``graphs.signature``), ``graphs.copy_in``, ``graphs.launch`` (the
replay) and ``graphs.copy_out``.  A compiled call (``render_frame_jit``,
``train_step_jit``) is one call id, which its host spans and the marks
of its replay share.  ``records()`` copies the buffers out and pairs the
marks into spans; ``clock_offset()`` maps a card's ``%globaltimer`` onto
the host clock.  Each walk inside a walk span (``walk.primary``,
``walk.bounce``, ``walk.shadow``) also counts its node steps: one record
(call, walk, the steps of all its rays, its rays) in a counter table on
the walk's device, written there by tensor ops that a capture takes into
the graph, so that every replay counts with nothing read back; ``counts()``
copies the tables out.  With ``spans()`` closed nothing is recorded, and a
compiled call finds the graph it would find without spans: a spans-on
call's key differs (``graphs.signature``), so it captures a graph of its
own, with the marks.

The capture log is always on: each ``graphs.Captured`` appends one
``CaptureRecord`` at its capture (``captures()``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
import weakref
from typing import Callable, Dict, NamedTuple, Optional

import torch


# --- spans ---------------------------------------------------------------

# the open recorder (``spans()``), None while spans are off: the program's
# call paths test it and do nothing more when it is None
active = None

# records a card's buffer holds (32 bytes each: 4 MiB a card)
CAPACITY = 1 << 17
_HEADER = 4
_NULL = contextlib.nullcontext()
# span names by id, and ids by name: a mark records the id
_NAMES: list = []
_IDS: dict = {}
# record buffers by device (made at the first mark on the device, outside
# any capture; a captured mark writes into its device's buffer for good)
_buffers: dict = {}
# call ids, unique in the process
_calls = 0
# the last recorder, whose records stay until the next ``spans()``
_last = None
# ``clock_offset``'s one-record buffers, by device
_probes: dict = {}
# walk counts a device's counter table holds (32 bytes each: 2 MiB)
COUNTS = 1 << 16
# counter tables by device (made at the first count on the device, outside
# any capture, as the record buffers are)
_counters: dict = {}


class Span(NamedTuple):
    """One span: ``name``; ``call``, the id of the compiled call (or of
    the outermost span) it belongs to; ``begin`` and ``end`` in ns on
    ``clock``; ``trip``, the loop's trip number (a ``chunk``), the trips
    run (``chunks``) or the pass's index (``bounce``), else None;
    ``parent``, the index in the list of the span it nests in, or None.
    ``clock`` is ``host`` for the host's spans around a replay, ``cpu``
    for spans of CPU tensors (both ``time.perf_counter_ns``), and
    ``cuda:N`` for the marks of that card (its ``%globaltimer``: add
    ``clock_offset(N).offset_ns`` for the host clock)."""

    name: str
    call: Optional[int]
    begin: int
    end: int
    trip: Optional[int]
    parent: Optional[int]
    clock: str


class WalkCount(NamedTuple):
    """One walk's count: ``name``, its walk span; ``call``, the id of the
    compiled call (or of the outermost span) it ran in; ``steps``, the node
    steps of all its rays; ``rays``, the rays it walked."""

    name: str
    call: Optional[int]
    steps: int
    rays: int


class ClockOffset(NamedTuple):
    """host ``perf_counter_ns`` = device ``%globaltimer`` + ``offset_ns``,
    within ``error_ns``: half the narrowest host bracket of a mark."""

    offset_ns: int
    error_ns: float


def _code(name: str) -> int:
    if name not in _IDS:
        _IDS[name] = len(_NAMES)
        _NAMES.append(name)
    return _IDS[name]


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _new_buffer(device, capacity: int) -> torch.Tensor:
    """A record buffer of ``capacity`` records on ``device``, empty (a
    normal tensor, also under inference mode: ``spans()`` empties it in
    place)."""
    with torch.inference_mode(False):
        buf = torch.zeros(_HEADER + 4 * capacity, dtype=torch.int64,
                          device=device)
        buf[3] = capacity
    return buf


def _buffer(device: torch.device) -> torch.Tensor:
    """The record buffer of ``device``, made at its first mark; a capture
    never makes it (its memset would be a node of the graph), and
    ``graphs.Captured``'s warm-up marks first."""
    if device not in _buffers:
        if _capturing():
            raise RuntimeError("spans: the record buffer is made eagerly, "
                               "before a capture (a warm-up marks first)")
        _buffers[device] = _new_buffer(device, CAPACITY)
    return _buffers[device]


def _counter(device: torch.device) -> torch.Tensor:
    """The counter table of ``device``, made at its first count, never in
    a capture: int64 [COUNTS + 2, 4], row 0 its header (the next slot, the
    counts that found no slot, 0, the capacity), then COUNTS records
    (call, walk's span id, steps, rays), then a row that the counts past
    the end write and nothing reads."""
    if device not in _counters:
        if _capturing():
            raise RuntimeError("spans: the counter table is made eagerly, "
                               "before a capture (a warm-up counts first)")
        with torch.inference_mode(False):
            table = torch.zeros((COUNTS + 2, 4), dtype=torch.int64,
                                device=device)
            table[0, 3].fill_(COUNTS)
        _counters[device] = table
    return _counters[device]


def _append(table: torch.Tensor, call: torch.Tensor, code: int,
            steps: torch.Tensor) -> None:
    """One record (call, code, the sum of ``steps``, its length) into
    ``table`` at its next slot, or into its last row when it is full, with
    tensor ops on its device: nothing read on the host, no tensor copied
    from it."""
    head = table[0, 0]
    full = head >= table[0, 3]
    slot = torch.clamp(head + 1, max=table.shape[0] - 1)
    row = torch.stack([call, table.new_full((), code),
                       steps.sum(dtype=torch.int64),
                       table.new_full((), steps.numel())])
    table.index_copy_(0, slot.reshape(1), row.reshape(1, 4))
    table[0, 1].add_(full.to(torch.int64))
    table[0, 0].add_(1)


def _launch(buf: torch.Tensor, code: int, trip, device) -> None:
    """One mark (``csrc/mark.cu``) on ``device``'s current stream: the
    trip from an int32 device tensor, or an int."""
    from .. import _kernels

    tensor = isinstance(trip, torch.Tensor)
    index = -1 if tensor or trip is None else int(trip)
    _kernels.check(_kernels.load().rtbvh_mark(
        buf.data_ptr(), code, trip.data_ptr() if tensor else None, index,
        torch.cuda.current_stream(device).cuda_stream), "a span mark")


class _Recorder:
    """What one ``spans()`` records: the host's marks (CPU tensors' spans
    and the host spans around a replay), and the call ids it gave."""

    def __init__(self):
        self.host = []  # (clock, call, code, trip, ns)
        self.call_id = None

    def _host_mark(self, clock: str, code: int, trip) -> None:
        self.host.append((clock, self.call_id, code, trip,
                          time.perf_counter_ns()))

    def _mark(self, ref: torch.Tensor, code: int, trip) -> None:
        device = ref.device
        if device.type == "cuda":
            _launch(_buffer(device), code, trip, device)
        else:
            self._host_mark(str(device), code, trip)

    @contextlib.contextmanager
    def call(self, ref: torch.Tensor):
        """A new call id for the block; on a card, set on the card too
        (but not inside a capture: the replay's caller sets it)."""
        global _calls
        outer = self.call_id
        _calls += 1
        self.call_id = _calls
        if ref.device.type == "cuda" and not _capturing():
            from .. import _kernels

            _kernels.check(_kernels.load().rtbvh_mark_call(
                _buffer(ref.device).data_ptr(), _calls,
                torch.cuda.current_stream(ref.device).cuda_stream),
                "a span call id")
        try:
            yield
        finally:
            self.call_id = outer

    @contextlib.contextmanager
    def span(self, name: str, ref: torch.Tensor, trip):
        code = 2 * _code(name)
        with (self.call(ref) if self.call_id is None else _NULL):
            self._mark(ref, code, trip)
            yield
            self._mark(ref, code + 1, trip)

    def count(self, name: str, steps: torch.Tensor) -> None:
        device = steps.device
        table = _counter(device)
        if device.type == "cuda":
            call = _buffer(device)[2]  # the id the card's marks copy
        else:
            call = table.new_full((), -1 if self.call_id is None
                                  else self.call_id)
        _append(table, call, _code(name), steps)

    @contextlib.contextmanager
    def host_span(self, name: str):
        code = 2 * _code(name)
        self._host_mark("host", code, None)
        yield
        self._host_mark("host", code + 1, None)


@contextlib.contextmanager
def spans():
    """Record spans while open (off by default); the records stay for
    ``records()`` until the next ``spans()`` opens, which empties every
    card's buffer."""
    global active, _last
    if active is not None:
        raise RuntimeError("spans() is already open")
    with torch.inference_mode(False):
        for buf in _buffers.values():
            buf[:2].zero_()
        for table in _counters.values():
            table[0, :2].zero_()
    recorder = _last = _Recorder()
    active = recorder
    try:
        yield recorder
    finally:
        active = None


def span(name: str, ref: torch.Tensor, trip=None):
    """The span ``name`` around the block, on ``ref``'s device: two marks
    on a card, two host stamps on the CPU.  ``trip`` is a 0-d int32 tensor
    on that device, read when the mark runs (a loop's trip number), or an
    int.  Outside any call, the span is a call of its own.  A no-op while
    spans are off."""
    if active is None:
        return _NULL
    return active.span(name, ref, trip)


def mark(name: str, ref: torch.Tensor, end: bool, trip=None) -> None:
    """One mark of span ``name`` (its begin, or its ``end``), for a span
    whose end reads what the block made (the trips a loop ran).  A no-op
    while spans are off."""
    if active is not None:
        active._mark(ref, 2 * _code(name) + int(end), trip)


def host_span(name: str):
    """A host span around the block, in the current call (the host's
    work around a replay).  A no-op while spans are off."""
    if active is None:
        return _NULL
    return active.host_span(name)


def call(ref: torch.Tensor):
    """A new call id for the block (a compiled call: its host spans and
    its replay's marks share it).  A no-op while spans are off."""
    if active is None:
        return _NULL
    return active.call(ref)


def count(name: str, steps: torch.Tensor) -> None:
    """Count one walk of walk span ``name``: ``steps`` are its [R] per-ray
    node steps (int32, on the walk's device), recorded as (call, ``name``,
    their sum, R) in the device's counter table by tensor ops there
    (captured into a graph, every replay counts).  A no-op while spans are
    off."""
    if active is not None:
        active.count(name, steps)


def dropped() -> int:
    """Marks and walk counts that found the cards' buffers and the
    counter tables full since ``spans()`` last opened (counted, not
    written)."""
    return (sum(int(buf[1]) for buf in _buffers.values())
            + sum(int(table[0, 1]) for table in _counters.values()))


def _pair(marks) -> list:
    """Spans from marks in the order they ran, ``(clock, call, code, trip,
    ns)``: an end closes the innermost open begin of its span, and a span
    nests in the one open at its begin."""
    out, open_ = [], []
    for clock, call_id, code, trip, ns in marks:
        if isinstance(trip, torch.Tensor):
            trip = int(trip)
        if code % 2 == 0:
            open_.append((len(out), code, trip))
            parent = open_[-2][0] if len(open_) > 1 else None
            out.append([_NAMES[code // 2], call_id, ns, None, trip, parent,
                        clock])
            continue
        while open_ and open_[-1][1] != code - 1:
            open_.pop()  # a begin whose end never ran
        if not open_:
            continue
        k, _, begin_trip = open_.pop()
        out[k][3] = ns
        out[k][4] = trip if trip is not None and trip >= 0 else (
            begin_trip if begin_trip is not None and begin_trip >= 0
            else None)
    # a span whose end never ran (its block raised) is left out, and what
    # nested in it nests in its parent
    kept = {k: i for i, k in enumerate(
        k for k, s in enumerate(out) if s[3] is not None)}

    def parent(k):
        while k is not None and k not in kept:
            k = out[k][5]
        return None if k is None else kept[k]

    return [Span(*s[:5], parent(s[5]), s[6])
            for s in out if s[3] is not None]


def records() -> list:
    """The spans of the open or the last ``spans()``: the host's, then
    each card's (its buffer copied out; the card synchronized first).  A
    span's ``parent`` indexes this list."""
    if _last is None:
        return []
    out = _pair(_last.host)
    for device, buf in _buffers.items():
        torch.cuda.synchronize(device)
        head = buf[:_HEADER].cpu()
        n = min(int(head[0]), int(head[3]))
        rows = buf[_HEADER:_HEADER + 4 * n].reshape(n, 4).cpu().tolist()
        clock = str(device)
        base = len(out)
        spans_ = _pair([(clock, c, k, t, ns) for c, k, t, ns in rows])
        out += [s._replace(parent=None if s.parent is None
                           else s.parent + base) for s in spans_]
    return out


def counts() -> list:
    """The walk counts (``WalkCount``) of the open or the last
    ``spans()``, each device's in the order its walks ran (a card
    synchronized first)."""
    if _last is None:
        return []
    out = []
    for device, table in _counters.items():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        head = table[0].tolist()
        n = min(head[0], head[3])
        out += [WalkCount(_NAMES[code], call if call >= 0 else None, steps,
                          rays)
                for call, code, steps, rays in table[1:1 + n].tolist()]
    return out


def clock_offset(device=None, rounds: int = 50) -> ClockOffset:
    """``%globaltimer`` of ``device`` (default: the current card) onto the
    host's ``perf_counter_ns``: an eager mark between two host stamps,
    each bracket closed by a synchronize, ``rounds`` times; the narrowest
    bracket's midpoint against the mark's time, and half its width as the
    error.  Calibrate at both ends of a window: the two offsets' difference
    is the clocks' drift."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    buf = _probes.get(device)
    if buf is None:
        buf = _probes[device] = _new_buffer(device, 1)
    best = None
    for _ in range(rounds):
        with torch.inference_mode(False):
            buf[:2].zero_()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter_ns()
        _launch(buf, 0, None, device)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        if best is None or t1 - t0 < best[0]:
            best = (t1 - t0, (t0 + t1) // 2 - int(buf[_HEADER + 3]))
    return ClockOffset(best[1], best[0] / 2)


# --- the capture log -------------------------------------------------------

@dataclasses.dataclass
class CaptureRecord:
    """One capture of ``graphs.Captured``: its ``name`` (``frame``,
    ``step``, a stage's), the eager warm-up's ms (every loop body
    included), the capture's ms, the device
    memory the allocator reserved during it (``pool_bytes``) and the most
    its allocations held at once (``peak_bytes``, what
    ``torch.cuda.max_memory_allocated`` sees of the capture), whether spans
    were on, and its host clock stamps (``perf_counter_ns``) at the
    warm-up's start and the capture's end.  ``live`` while its graph is."""

    name: str
    warmup_ms: float
    capture_ms: float
    pool_bytes: int
    peak_bytes: int
    spans: bool
    begin_ns: int
    end_ns: int
    owner: object = dataclasses.field(default=None, repr=False,
                                      compare=False)

    @property
    def live(self) -> bool:
        return self.owner is not None and self.owner() is not None


_captures: list = []


def log_capture(owner, **fields) -> CaptureRecord:
    """Append ``owner``'s capture to the log (``owner`` is held weakly)."""
    record = CaptureRecord(owner=weakref.ref(owner), **fields)
    _captures.append(record)
    return record


def captures(live: bool = False) -> list:
    """The capture log, oldest first: every capture of the process, or
    (``live``) those whose graph still exists."""
    return [r for r in _captures if r.live or not live]


class FpsMeter:
    """Once-a-second FPS print (reference: Graphics.cpp:65-92)."""

    def __init__(self, out=None):
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._frames = 0
        self._out = out

    def tick(self) -> float:
        """Count one frame; prints 'FPS: x' once per second. Returns the
        running average FPS."""
        self._frames += 1
        now = time.perf_counter()
        fps = self._frames / (now - self._t0)
        if now - self._last >= 1.0:
            print(f"FPS: {fps:.2f}", file=self._out)
            self._last = now
        return fps


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a card is visible), written as a Chrome trace
    ``rtbvh_trace_<time>_<pid>.json`` into ``log_dir``; yields that
    path.  The device is synchronized before the trace ends, so the
    block's kernels are in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir,
        f"rtbvh_trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json")
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _call_seconds(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn()``: CUDA events around it on a CUDA
    device, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _median_times(stages, iters: int,
                  device: torch.device) -> Dict[str, float]:
    """name -> seconds of one call of ``stages[name]()``: the median over
    ``iters`` rounds after one warm-up call each, every round calling
    every stage once in order.  The host's speed moves by tens of percent
    from one call to the next and drifts over seconds (eager stages are
    host-bound, and a replay's launch is the host's too): in rounds the
    drift hits every stage alike, and the median is not one lucky or
    unlucky call."""
    for fn in stages.values():
        fn()  # warm-up
    times = {name: [] for name in stages}
    for _ in range(iters):
        for name, fn in stages.items():
            times[name].append(_call_seconds(fn, device))
    return {name: statistics.median(t) for name, t in times.items()}


def _eager_stages(scene, camera, cfg):
    """(name -> call, (scene, bvh, rays)): the JAX function's stages, in
    its order, as eager calls on the scene's device (morton, sort
    (``cfg.sort_backend``: ``bitonic`` is kernel K8 on CUDA tensors),
    topology, fit, links, build_total, trace_shade and the whole frame),
    and the build and rays that trace_shade shades.  Each stage takes its
    inputs from one eager build made here."""
    from ..camera import camera_matrices, transform_points
    from ..config import resolve_sort_backend
    from ..ops import bvh as bvh_ops
    from ..ops import morton as morton_ops
    from ..pipeline import (build_bvh, make_rays, render_frame, shade_rays,
                            sort_codes)

    dtype = cfg.torch_dtype
    wvp, wv = camera_matrices(camera, cfg.width, cfg.height)
    sort_backend = resolve_sort_backend(cfg, scene.verts.device)

    def f_morton():
        verts_t = transform_points(scene.verts.to(dtype), wvp.to(dtype))
        smin, smax = morton_ops.scene_aabb(verts_t)
        return morton_ops.triangle_leaves(verts_t, scene.indices, smin, smax)

    codes, lmin, lmax, _ = f_morton()
    codes = codes.to(torch.int32)
    sorted_codes, _ = sort_codes(codes, sort_backend)
    topo = bvh_ops.build_topology(sorted_codes)
    bvh = build_bvh(scene, wvp, wv, cfg)
    rays = make_rays(camera, cfg)
    return {
        "morton": f_morton,
        "sort": lambda: sort_codes(codes, sort_backend),
        "topology": lambda: bvh_ops.build_topology(sorted_codes),
        "fit": lambda: bvh_ops.fit_aabbs(topo.node_lo, topo.node_hi,
                                         lmin, lmax),
        "links": lambda: bvh_ops.compute_links(topo, lmin.shape[0]),
        "build_total": lambda: build_bvh(scene, wvp, wv, cfg),
        "trace_shade": lambda: shade_rays(scene, bvh, rays, cfg),
        "frame_total": lambda: render_frame(scene, camera, cfg),
    }, (scene, bvh, rays)


def _graphed_stages(scene, camera, cfg) -> Dict[str, Callable]:
    """``_eager_stages`` with every stage captured alone into its own CUDA
    graph (each with its own memory pool), as the JAX function jits each
    stage alone: a replay a call (a chunk loop's in ``trace_shade`` as
    its WHILE node); ``frame_total`` is ``render_frame_jit``'s capture
    (its cache's).  A stage whose capture fails raises: none runs eagerly
    in its place."""
    from .. import graphs
    from ..pipeline import render_frame_jit

    eager, _ = _eager_stages(scene, camera, cfg)
    stream = graphs.Cache().stream(scene.device)
    stages = {name: graphs.Captured(eager[name], (), stream, name=name)
              for name in ("morton", "sort", "topology", "fit", "links",
                           "build_total", "trace_shade")}
    render_frame_jit(scene, camera, cfg)  # the capture, or a cached one
    return {**stages,
            "frame_total": lambda: render_frame_jit(scene, camera, cfg)}


def stage_times(scene, camera, cfg, iters: int = 5) -> Dict[str, float]:
    """Seconds per pipeline stage, each run on its own, on the scene's
    device.

    The JAX function's stages and keys, in its order (``_eager_stages``).
    On CUDA tensors each stage is its own CUDA graph, as the JAX function
    jits each alone (``_graphed_stages``), timed by CUDA events around a
    replay; on CPU tensors the stages run eagerly, timed by the host
    clock.  Each stage is timed alone, the median of ``iters`` rounds of
    all the stages (``_median_times``), so the stages do not add up to
    the build exactly.
    """
    device = scene.verts.device
    with torch.no_grad():
        if device.type == "cuda":
            with torch.inference_mode(False):
                stages = _graphed_stages(scene, camera, cfg)
        else:
            stages, _ = _eager_stages(scene, camera, cfg)
        return _median_times(stages, iters, device)


def print_stage_times(times: Dict[str, float], cfg, file=None) -> None:
    rays = cfg.width * cfg.height * (1 + cfg.bounces)
    print(f"{'stage':<12} {'ms':>10}", file=file)
    for k, v in times.items():
        print(f"{k:<12} {v * 1e3:>10.3f}", file=file)
    ft = times.get("frame_total")
    bt = times.get("build_total")
    if ft:
        print(f"rays/sec     {rays / ft:>10.3e}", file=file)
    if bt:
        print(f"builds/sec   {1.0 / bt:>10.1f}", file=file)
