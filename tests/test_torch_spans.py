"""The port's spans (``utils.profiling.spans``) and capture log.

On the CPU: the span tree of a bounced frame, a shadowed frame, a training
step and a culled, chunked frame (names, nesting, one call id, the chunk
loop's trips); nothing recorded and today's graph key with spans off; the
same bits with spans on and off; no host read or host literal with spans
on; the capture log's records.

Marked ``gpu`` (skip without a CUDA device; this file imports no JAX):
the marks inside a replayed frame, step and WHILE body (a culled frame's
and a culled step's two), once a replay or a trip; no mark node in a
spans-off graph; a capture's peak bytes against ``max_memory_allocated``;
an eager mark inside its host bracket after ``clock_offset()``; a full
buffer counting its overflow:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_spans.py
"""

import gc
import time

import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch import graphs
from raytracebvh_tpu_torch import pipeline as tp
from raytracebvh_tpu_torch.models import inverse
from raytracebvh_tpu_torch.models.procedural import random_triangles
from raytracebvh_tpu_torch.ops import traverse as t_traverse
from raytracebvh_tpu_torch.utils import profiling

LIGHT = (10.0, 80.0, -40.0)
BUILD = ("build", [("morton", []), ("sort", []), ("topology", []),
                   ("fit", []), ("links", []), ("pack", [])])
GATHERS = [("gather", []), ("gather", [])]  # the leaf rows, the texture
BOUNCE = ("bounce", [("walk.bounce", []), ("shade.bounce", GATHERS)])
CONFIGS = {
    "bounced": dict(width=48, height=32, bounces=1, ortho_scale=2.0,
                    ray_tile=16),
    "shadowed": dict(width=48, height=32, bounces=0, ortho_scale=2.0,
                     enable_shadows=True, light_pos=LIGHT),
    "culled": dict(width=48, height=32, bounces=1, ray_chunk=96,
                   ortho_scale=0.05),
}
FRAME_TREES = {
    "bounced": ("frame", [BUILD, ("walk.primary", []),
                          ("shade.primary", GATHERS), BOUNCE]),
    "shadowed": ("frame", [BUILD, ("walk.primary", []),
                           ("walk.shadow", []),
                           ("shade.primary", GATHERS)]),
}


def _scene(device="cpu"):
    return random_triangles(300, seed=6, device=device, with_texture=True)


def tree(spans, parent=None):
    """(name, children) of the spans under ``parent``, in order."""
    return [(s.name, tree(spans, k)) for k, s in enumerate(spans)
            if s.parent == parent]


def _hit_chunks(scene, cam, cfg) -> int:
    bvh, rays, _ = tp.frame_inputs(scene, cam, cfg)
    rays = tp.tile_frame_rays(rays, cfg, cfg.width, cfg.height)
    _, any_hit = tp.trace_chunks(tp.shade_setup(scene, bvh, cfg)[0], rays,
                                 cfg)
    return int(any_hit.sum())


@pytest.mark.parametrize("case", ["bounced", "shadowed"])
def test_frame_span_tree(case):
    scene, cam = _scene(), T.Camera.default("cpu")
    cfg = T.RenderConfig(**CONFIGS[case])
    with profiling.spans():
        T.render_frame_jit(scene, cam, cfg)
    spans = profiling.records()
    assert tree(spans) == [FRAME_TREES[case]]
    assert len({s.call for s in spans}) == 1
    assert all(s.clock == "cpu" for s in spans)
    assert all(s.begin <= s.end for s in spans)
    for k, s in enumerate(spans):  # a child inside its parent
        if s.parent is not None:
            p = spans[s.parent]
            assert p.begin <= s.begin and s.end <= p.end, (k, s.name)
    bounces = [s.trip for s in spans if s.name == "bounce"]
    assert bounces == list(range(cfg.bounces))


def test_step_span_tree():
    scene, cam = _scene(), T.Camera.default("cpu")
    cfg = T.RenderConfig(**CONFIGS["bounced"])
    params = inverse.init_params(scene)
    opt = inverse.make_optimizer(params)
    with profiling.spans():
        inverse.train_step_jit(params, opt, scene, cam,
                               torch.zeros(32, 48, 4), cfg, lr=1e-2)
    spans = profiling.records()
    assert tree(spans) == [("step", [("forward", [FRAME_TREES["bounced"]]),
                                     ("backward", []), ("optimizer", [])])]
    assert len({s.call for s in spans}) == 1


def test_culled_frame_span_tree_counts_its_trips():
    """The chunk loop is ``chunks`` with a ``chunk`` a trip, the trips
    numbered from 0 and ``chunks`` recording the hit chunks; every
    chunk's primary walk runs before the loop, in one walk on a kernel
    route (the default's, run by the plain walk on the CPU)."""
    scene, cam = _scene(), T.Camera.default("cpu")
    cfg = T.RenderConfig(**CONFIGS["culled"])
    hits = _hit_chunks(scene, cam, cfg)
    assert 0 < hits < cfg.width * cfg.height // cfg.ray_chunk
    with profiling.spans():
        T.render_frame_jit(scene, cam, cfg)
    spans = profiling.records()
    chunk = ("chunk", [("shade.primary", GATHERS), BOUNCE])
    assert tree(spans) == [("frame", [BUILD, ("walk.primary", []),
                                      ("chunks", [chunk] * hits)])]
    (loop,) = [s for s in spans if s.name == "chunks"]
    assert loop.trip == hits
    assert [s.trip for s in spans if s.name == "chunk"] == list(range(hits))
    assert len({s.call for s in spans}) == 1


def test_calls_get_ids_of_their_own():
    scene, cam = _scene(), T.Camera.default("cpu")
    cfg = T.RenderConfig(width=16, height=16, bounces=0, ortho_scale=2.0)
    with profiling.spans():
        for _ in range(3):
            T.render_frame_jit(scene, cam, cfg)
    frames = [s for s in profiling.records() if s.name == "frame"]
    assert len(frames) == 3 and len({s.call for s in frames}) == 3


def test_spans_off_record_nothing_and_keep_the_key():
    scene, cam = _scene(), T.Camera.default("cpu")
    cfg = T.RenderConfig(**CONFIGS["bounced"])
    today = (cfg, (graphs.structure(scene), graphs.structure(cam)))
    with profiling.spans():
        assert graphs.signature(cfg, scene, cam) == today + ("spans",)
    assert profiling.active is None
    assert graphs.signature(cfg, scene, cam) == today
    T.render_frame_jit(scene, cam, cfg)
    params = inverse.init_params(scene)
    inverse.train_step_jit(params, inverse.make_optimizer(params), scene,
                           cam, torch.zeros(32, 48, 4), cfg, lr=1e-2)
    # the last window's key span, and nothing of the calls made since
    assert [s.name for s in profiling.records()] == ["graphs.key"]
    with profiling.spans():
        pass
    assert profiling.records() == []
    with pytest.raises(RuntimeError, match="already open"):
        with profiling.spans(), profiling.spans():
            pass


@pytest.mark.parametrize("case", ["bounced", "shadowed", "culled", "step"])
def test_spans_leave_the_bits(case):
    scene, cam = _scene(), T.Camera.default("cpu")
    cfg = T.RenderConfig(**CONFIGS["bounced" if case == "step" else case])
    if case != "step":
        want = T.render_frame_jit(scene, cam, cfg)
        with profiling.spans():
            got = T.render_frame_jit(scene, cam, cfg)
        assert torch.equal(got, want)
        return
    target = torch.full((32, 48, 4), 0.25)
    out = []
    for on in (False, True):
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params)
        with profiling.spans() if on else torch.enable_grad():
            loss = inverse.train_step_jit(params, opt, scene, cam, target,
                                          cfg, lr=1e-2)
        out.append([loss, *params])
    assert all(torch.equal(a, b) for a, b in zip(*out))


class _NoHostReads(TorchDispatchMode):
    """Fails on a read of a tensor's value on the host and on a tensor
    literal copied from host memory (``test_torch_graphs.py``'s guard)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if "_local_scalar_dense" in name or "lift_fresh" in name:
            raise AssertionError(f"host read or tensor literal: {name}")
        return func(*args, **(kwargs or {}))


def _unguarded(walk):
    def run(*args, **kw):
        with _disable_current_modes():
            return walk(*args, **kw)
    return run


@pytest.mark.parametrize("stage", [
    "morton", "sort", "topology", "fit", "links", "build_total",
    "trace_shade", "frame_total", "culled"])
def test_graphed_bodies_read_nothing_back_with_spans_on(monkeypatch,
                                                        stage):
    """``test_torch_graphs.py::test_graphed_bodies_read_nothing_back``
    with spans on: the marks add no host read and no tensor literal, so a
    spans-on body can be captured as a spans-off one can.  The culled
    frame and step read their loops' counts on the host outside the guard
    (a captured loop's WHILE node reads it on the card)."""
    monkeypatch.setattr(t_traverse, "traverse",
                        _unguarded(t_traverse.traverse))
    monkeypatch.setattr(t_traverse, "traverse_any",
                        _unguarded(t_traverse.traverse_any))
    scene, cam = _scene(), T.Camera.default("cpu")
    if stage == "culled":
        loop = graphs.while_loop

        def counted(count, body, device=None):
            with _disable_current_modes():
                n = int(count)
            return loop(n, body, count.device)

        monkeypatch.setattr(graphs, "while_loop", counted)
        cfg = T.RenderConfig(**CONFIGS["culled"])
        params = inverse.init_params(scene)
        target = torch.zeros(32, 48, 4)

        def call():
            img = T.render_frame(scene, cam, cfg)
            loss = inverse.loss_fn(params, scene, cam, target, cfg)
            loss.backward()
            return img, loss.detach()
    else:
        cfg = T.RenderConfig(width=48, height=32, bounces=1,
                             ortho_scale=2.0, ray_tile=16,
                             sort_backend="bitonic")
        call = profiling._eager_stages(scene, cam, cfg)[0][stage]
    want = graphs.tensors(call())
    with profiling.spans(), _NoHostReads():
        got = graphs.tensors(call())
    assert len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    # a stage alone calls its ops, which hold no span
    assert bool(profiling.records()) == (stage in (
        "build_total", "trace_shade", "frame_total", "culled"))


class _Owner:
    """Stands for a graph in the capture log."""


def test_capture_log_records_and_liveness(monkeypatch):
    # a log of its own: the process's log is read by whoever runs next
    monkeypatch.setattr(profiling, "_captures", [])
    owner = _Owner()
    before = len(profiling.captures())
    rec = profiling.log_capture(owner, name="frame", warmup_ms=1.5,
                                capture_ms=2.5, pool_bytes=1 << 20,
                                peak_bytes=1 << 19, spans=False, begin_ns=10,
                                end_ns=20)
    assert profiling.captures()[before:] == [rec]
    assert {f for f in rec.__dataclass_fields__} == {
        "name", "warmup_ms", "capture_ms", "pool_bytes", "peak_bytes",
        "spans",
        "begin_ns", "end_ns", "owner"}
    assert rec.live and rec in profiling.captures(live=True)
    del owner
    gc.collect()
    assert not rec.live and rec not in profiling.captures(live=True)
    assert rec in profiling.captures()


# --- on the card -----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def call_tree(spans, call):
    """``tree`` of one call's marks (its host spans left out) in
    ``records()``'s list ``spans``."""
    mine = [k for k, s in enumerate(spans)
            if s.call == call and s.clock != "host"]
    at = {k: i for i, k in enumerate(mine)}
    return tree([spans[k]._replace(parent=at.get(spans[k].parent))
                 for k in mine])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bounced", "shadowed", "culled"])
def test_marks_in_a_replayed_frame(dev, case):
    """A spans-on replay records the eager frame's spans once, in the same
    tree, with its host spans under its call id; a culled frame's WHILE
    body once a trip, the trip counter on ``chunks``; the spans-off graph
    is found again."""
    scene, cam = _scene(dev), T.Camera.default(dev)
    cfg = T.RenderConfig(**CONFIGS[case])
    tp.FRAME_GRAPHS.clear()
    with torch.inference_mode():
        want = T.render_frame_jit(scene, cam, cfg)
        with profiling.spans():
            T.render_frame(scene, cam, cfg)
        eager = tree(profiling.records())
        n = len(profiling.captures())
        with profiling.spans():
            first = T.render_frame_jit(scene, cam, cfg)  # the capture
        assert len(profiling.captures()) == n + 1
        assert profiling.captures()[-1].spans
        with profiling.spans():
            got = [T.render_frame_jit(scene, cam, cfg) for _ in range(2)]
        spans = profiling.records()
        again = T.render_frame_jit(scene, cam, cfg)
    assert len(profiling.captures()) == n + 1  # nothing captured again
    assert len(tp.FRAME_GRAPHS.entries) == 2
    assert all(torch.equal(x, want) for x in (first, *got, again))
    marks = [s for s in spans if s.clock == str(dev)]
    calls = sorted({s.call for s in marks})
    assert len(calls) == 2
    for c in calls:
        assert call_tree(spans, c) == eager
        hosts = [s.name for s in spans if s.clock == "host" and s.call == c]
        assert hosts == ["graphs.key", "graphs.copy_in", "graphs.launch",
                         "graphs.copy_out"]
    if case == "culled":
        hits = _hit_chunks(scene, cam, cfg)
        loops = [s for s in marks if s.name == "chunks"]
        assert [s.trip for s in loops] == [hits, hits]
        trips = [s.trip for s in marks if s.name == "chunk"]
        assert trips == list(range(hits)) * 2
    assert profiling.dropped() == 0


@pytest.mark.gpu
def test_spans_off_graph_holds_no_mark(dev, tmp_path):
    """The spans-off frame graph's nodes hold no mark kernel; the spans-on
    graph's do (``CUDAGraph.debug_dump``, the kernels' names)."""
    scene, cam = _scene(dev), T.Camera.default(dev)
    cfg = T.RenderConfig(**CONFIGS["culled"])
    tp.FRAME_GRAPHS.clear()
    tp.FRAME_GRAPHS.debug = True
    try:
        with torch.inference_mode():
            T.render_frame_jit(scene, cam, cfg)
            with profiling.spans():
                T.render_frame_jit(scene, cam, cfg)
        dumps = []
        for k, entry in enumerate(tp.FRAME_GRAPHS.entries.values()):
            path = tmp_path / f"graph{k}.dot"
            entry.graph.debug_dump(str(path))
            dumps.append(path.read_text())
    finally:
        tp.FRAME_GRAPHS.debug = False
        tp.FRAME_GRAPHS.clear()
    off, on = dumps
    assert "KERNEL" in off and "rtbvh_mark" not in off
    assert "rtbvh_mark_kernel" in on and "rtbvh_mark_call" not in on


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bounced", "culled"])
def test_marks_in_a_replayed_step(dev, case):
    """The graphed step records ``step`` with ``forward`` (the frame in
    it), ``backward`` and ``optimizer`` once a replay, with the eager
    step's spans; a culled step's two chunk loops (the forward's and the
    backward's WHILE node, the latter launched from autograd's backward)
    record a ``chunk`` a trip and the hit chunks on ``chunks``; the
    spans-on step leaves the spans-off step's bits."""
    scene, cam = _scene(dev), T.Camera.default(dev)
    cfg = T.RenderConfig(**CONFIGS[case])
    target = torch.full((32, 48, 4), 0.25, device=dev)
    params = inverse.init_params(scene)
    with profiling.spans():
        inverse.train_step(params, inverse.make_optimizer(params), scene,
                           cam, target, cfg)
    eager = tree(profiling.records())
    assert eager[0][0] == "step"
    out = []
    for on in (False, True):
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params, 1e-2, capturable=True)
        with profiling.spans() if on else torch.enable_grad():
            for _ in range(3):
                loss = inverse.train_step_jit(params, opt, scene, cam,
                                              target, cfg, lr=1e-2)
        if on:
            spans = profiling.records()
        out.append([loss, *params])
    assert all(torch.equal(a, b) for a, b in zip(*out))
    marks = [s for s in spans if s.clock == str(dev)]
    calls = sorted({s.call for s in marks if s.name == "step"})
    # the first call's warm-up (an eager step) and its replay share its id
    steps = [s.call for s in marks if s.name == "step"]
    assert steps == [calls[0]] + calls
    replays = calls[1:]
    # the first replay's geometry is the eager step's (the warm-up's
    # update is undone); Adam's updates may move a culled step's hits
    assert call_tree(spans, replays[0]) == eager
    for c in replays:
        tops = call_tree(spans, c)
        assert [(n, [k for k, _ in kids]) for n, kids in tops] == [
            ("step", ["forward", "backward", "optimizer"])]
    if case == "culled":
        hits = [_hit_chunks(scene, cam, cfg)]
        assert hits[0] > 0
        for c in replays:
            loops = [s for s in marks if s.call == c and s.name == "chunks"]
            assert [spans[s.parent].name for s in loops] == ["frame",
                                                             "backward"]
            n = loops[0].trip
            assert [s.trip for s in loops] == [n, n] and n > 0
            trips = [s.trip for s in marks
                     if s.call == c and s.name == "chunk"]
            assert trips == list(range(n)) * 2
            hits.append(n)
        assert hits[1] == hits[0]
    assert profiling.dropped() == 0


@pytest.mark.gpu
def test_capture_peak_is_what_max_memory_allocated_sees(dev):
    """``peak_bytes`` of a capture is the growth of
    ``max_memory_allocated`` across it (reset before it; a warm-up that
    allocates nothing), to the allocator's 512-byte rounding: two 8 MiB
    temporaries and a small output at once."""
    stream = graphs.Cache().stream(dev)

    def fn():
        a = torch.ones(2 << 20, device=dev)
        b = a * 2.0
        return b[:16].clone()

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    cap = graphs.Captured(fn, (), stream, warmup=lambda: None, name="peak")
    growth = torch.cuda.max_memory_allocated(dev) - start
    assert cap.record.peak_bytes == cap.peak_bytes
    assert 16 << 20 <= cap.peak_bytes <= growth <= cap.peak_bytes + 3 * 512
    assert cap.pool_bytes >= cap.peak_bytes
    cap()
    torch.cuda.synchronize(dev)
    assert torch.equal(cap.output.cpu(), torch.full((16,), 2.0))


@pytest.mark.gpu
def test_clock_offset_puts_an_eager_mark_in_its_bracket(dev):
    off = profiling.clock_offset(dev)
    assert off.error_ns > 0
    buf = profiling._new_buffer(dev, 1)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter_ns()
    profiling._launch(buf, 0, None, dev)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter_ns()
    at = int(buf[7]) + off.offset_ns
    assert t0 - off.error_ns <= at <= t1 + off.error_ns
    again = profiling.clock_offset(dev)
    assert abs(again.offset_ns - off.offset_ns) < 1e6  # under 1 ms drift


@pytest.mark.gpu
def test_a_full_buffer_counts_and_does_not_write(dev):
    buf = torch.full((4 + 4 * 8,), -7, dtype=torch.int64, device=dev)
    buf[:4] = torch.tensor([0, 0, 5, 4])  # capacity 4, call 5
    trip = torch.tensor(3, dtype=torch.int32, device=dev)
    for k in range(10):
        profiling._launch(buf, 2 * k, trip if k % 2 else k, dev)
    head = buf[:4].tolist()
    assert head == [10, 6, 5, 4]
    rows = buf[4:].reshape(8, 4).tolist()
    assert [r[:3] for r in rows[:4]] == [[5, 0, 0], [5, 2, 3], [5, 4, 2],
                                         [5, 6, 3]]
    assert all(r == [-7] * 4 for r in rows[4:])


def test_a_span_whose_block_raised_is_left_out():
    x = torch.zeros(2)
    with profiling.spans():
        with profiling.span("frame", x):
            with pytest.raises(ValueError):
                with profiling.span("build", x):
                    raise ValueError("stop")
            with profiling.span("links", x):
                pass
    assert tree(profiling.records()) == [("frame", [("links", [])])]
