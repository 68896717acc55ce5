"""The port's walk counts (``utils.profiling.count`` / ``counts``): with
spans on, each walk of a frame records the node steps of all its rays and
the rays it walked, under its walk span's name and its call's id.

On the CPU: a frame's counts are the sums of the steps its plain walks
return, walk by walk, in a bounced, a shadowed and a culled chunked frame;
with spans off no walk is asked for its steps and nothing is counted; a
full counter table counts its overflow and writes past its records only.

Marked ``gpu`` (skip without a CUDA device; this file imports no JAX): a
replayed spans-on frame counts what the eager frame and the plain walk
count; K1 and K4 against the plain walk, step counts included, on the
1 048 576-triangle tree of the benchmark's ``tetra1m``; a spans-off frame
or step graph holds the spans-on graph's nodes less its marks and its
walk counts':

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_walk_counts.py
"""

import collections
import inspect
import re

import pytest
import torch

import raytracebvh_tpu_torch as T
from raytracebvh_tpu_torch import pipeline as tp
from raytracebvh_tpu_torch.models.procedural import random_triangles
from raytracebvh_tpu_torch.ops import traverse as t_traverse
from raytracebvh_tpu_torch.utils import profiling

LIGHT = (10.0, 80.0, -40.0)
CONFIGS = {
    "bounced": dict(width=48, height=32, bounces=1, ortho_scale=2.0,
                    ray_tile=16),
    "shadowed": dict(width=48, height=32, bounces=0, ortho_scale=2.0,
                     enable_shadows=True, light_pos=LIGHT),
    "culled": dict(width=48, height=32, bounces=1, ray_chunk=96,
                   ortho_scale=0.05, enable_shadows=True, light_pos=LIGHT),
}
WALKS = {"bounced": ["walk.primary", "walk.bounce"],
         "shadowed": ["walk.primary", "walk.shadow"]}


def _scene(device="cpu"):
    return random_triangles(300, seed=6, device=device, with_texture=True)


def _recording(monkeypatch):
    """The plain walks, wrapped: each call's (whether it was asked for its
    steps, the sum of its steps, its rays)."""
    seen = []

    def wrap(walk):
        sig = inspect.signature(walk)

        def run(*args, **kw):
            call = sig.bind(*args, **kw)
            asked = call.arguments.get("return_steps", False)
            call.arguments["return_steps"] = True
            out = walk(*call.args, **call.kwargs)
            seen.append((asked, int(out[1].sum()), int(out[1].numel())))
            return out if asked else out[0]
        return run

    for name in ("traverse", "traverse_any"):
        monkeypatch.setattr(t_traverse, name, wrap(getattr(t_traverse,
                                                            name)))
    return seen


@pytest.mark.parametrize("case", ["bounced", "shadowed", "culled"])
def test_counts_are_the_walks_steps(monkeypatch, case):
    seen = _recording(monkeypatch)
    scene, cam = _scene(), T.Camera.default("cpu")
    cfg = T.RenderConfig(**CONFIGS[case])
    with profiling.spans():
        T.render_frame_jit(scene, cam, cfg)
    counts = profiling.counts()
    frame = [s for s in profiling.records() if s.name == "frame"]
    assert len(frame) == 1
    assert seen and all(asked for asked, _, _ in seen)
    assert [(c.steps, c.rays) for c in counts] == [
        (steps, rays) for _, steps, rays in seen]
    assert {c.call for c in counts} == {frame[0].call}
    assert all(c.steps >= c.rays > 0 for c in counts)
    if case in WALKS:
        assert [c.name for c in counts] == WALKS[case]
    else:  # the chunks' primary walks, then a chunk's shadow and bounce
        names = {c.name for c in counts}
        assert names == {"walk.primary", "walk.shadow", "walk.bounce"}
    assert profiling.dropped() == 0


def test_spans_off_ask_no_steps_and_count_nothing(monkeypatch):
    seen = _recording(monkeypatch)
    scene, cam = _scene(), T.Camera.default("cpu")
    cfg = T.RenderConfig(**CONFIGS["shadowed"])
    with profiling.spans():
        pass
    want = T.render_frame_jit(scene, cam, cfg)
    assert len(seen) == 2 and not any(asked for asked, _, _ in seen)
    assert profiling.counts() == []
    with profiling.spans():
        got = T.render_frame_jit(scene, cam, cfg)
    assert torch.equal(got, want)
    assert [c.name for c in profiling.counts()] == WALKS["shadowed"]


def test_a_full_table_counts_and_writes_past_its_records():
    table = torch.zeros((4, 4), dtype=torch.int64)
    table[0, 3] = 2  # two records
    for k in range(5):
        profiling._append(table, torch.tensor(7), k,
                          torch.full((k + 1,), 3, dtype=torch.int32))
    assert table[0].tolist() == [5, 3, 0, 2]
    assert table[1:3].tolist() == [[7, 0, 3, 1], [7, 1, 6, 2]]
    assert table[3].tolist() == [7, 4, 15, 5]  # the last count past the end


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["shadowed", "culled"])
def test_replayed_frame_counts_what_the_eager_frame_counts(dev, case):
    """The spans-on graph's replays count as the eager frame does on K1/K4
    and as the plain walk does on the card (a chunked plain walk a chunk),
    walk span by walk span, under the replay's call ids."""
    scene, cam = _scene(dev), T.Camera.default(dev)
    cfg = T.RenderConfig(**CONFIGS[case])

    def by_walk(counts):
        out = {}
        for c in counts:
            steps, rays = out.get(c.name, (0, 0))
            out[c.name] = (steps + c.steps, rays + c.rays)
        return out

    def counted(fn, config):
        with profiling.spans():
            fn(scene, cam, config)
        return by_walk(profiling.counts())

    tp.FRAME_GRAPHS.clear()
    with torch.inference_mode():
        eager = counted(T.render_frame, cfg)
        plain = counted(T.render_frame, cfg.replace(traversal_backend="torch"))
        counted(T.render_frame_jit, cfg)  # the capture
        with profiling.spans():
            for _ in range(2):
                T.render_frame_jit(scene, cam, cfg)
        counts = profiling.counts()
        calls = sorted({s.call for s in profiling.records()
                        if s.name == "frame"})
    assert eager == plain and eager
    assert len(calls) == 2
    for call in calls:
        assert by_walk(c for c in counts if c.call == call) == eager
    assert profiling.dropped() == 0


@pytest.mark.gpu
def test_k1_k4_match_plain_on_the_tetra1m_tree(dev):
    """K1 and K4 on 65 536 seeded rays of a tetra1m frame (its primary rays
    and the shadow rays of their hits): hits, leaves, distances,
    occlusion and step counts exactly the plain walk's."""
    from raytracebvh_tpu_torch.core.types import Rays
    from raytracebvh_tpu_torch.ops import traverse_cuda
    from rtbench import harness, scenes, scenes_spd

    man = harness.manifest()
    conf = harness.config_of(man, harness.cell(man, "tetra1m-frame_shadows"))
    raw = scenes_spd.make_scene(conf, 2 ** 31 + 5, dev)
    assert raw["indices"].numel() == 3 * conf["triangles"] == 3 * 2 ** 20
    scene = scenes.port_scene(raw)
    cam = scenes.port_camera(scenes.camera(conf, dev))
    cfg = T.RenderConfig(width=conf["width"], height=conf["height"],
                         ortho_scale=conf["ortho_scale"], bounces=0,
                         enable_shadows=True)
    with torch.no_grad():
        bvh, rays, light = tp.frame_inputs(scene, cam, cfg)
        assert bvh.n_leaves == 2 ** 20
        gen = torch.Generator(device="cpu").manual_seed(22)
        pick = torch.randperm(rays.origin.shape[0], generator=gen)[:65536]
        rays = Rays(rays.origin[pick.to(dev)].contiguous(),
                    rays.direction[pick.to(dev)].contiguous())
        got, steps = traverse_cuda.traverse(bvh, rays, cfg.epsilon,
                                            return_steps=True)
        want, wsteps = t_traverse.traverse(bvh, rays, cfg.epsilon,
                                           return_steps=True)
        assert 0 < int(want.hit.sum()) < pick.numel()
        for f in ("hit", "leaf", "distance"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(steps, wsteps)
        live = want.hit
        hx = rays.origin + rays.direction * want.distance[:, None]
        to = torch.stack(light) - hx
        dist = torch.linalg.vector_norm(to, dim=-1)
        d = to / dist[:, None]
        o = torch.where(live[:, None], hx + d * cfg.ray_offset, 1.0e30)
        shadow = Rays(o.contiguous(), d.contiguous())
        max_t = (dist * (1.0 - 1e-4)).contiguous()
        occ, osteps = traverse_cuda.traverse_any(bvh, shadow, cfg.epsilon,
                                                 max_t, return_steps=True)
        wocc, wosteps = t_traverse.traverse_any(bvh, shadow, cfg.epsilon,
                                                max_t, return_steps=True)
        assert torch.equal(occ, wocc) and torch.equal(osteps, wosteps)
        assert 0 < int((wocc & live).sum()) < int(live.sum())
    assert traverse_cuda.truncated_rays() == 0


# the start of a node's statement in a graph's dump (``debug_dump``)
NODE = re.compile(r'^\s*"?graph_\d+_node_\d+"?\s*\[', re.M)
GRAPHED = {
    "bounced": CONFIGS["bounced"],
    "shadowed": CONFIGS["shadowed"],
    "shared": dict(CONFIGS["shadowed"], bounces=1,
                   traversal_backend="shared",
                   shade_gather_backend="shared"),
    "step": CONFIGS["bounced"],
}


def _nodes(graph, path) -> collections.Counter:
    """The nodes of a captured graph (``CUDAGraph.debug_dump``), each as
    its statement with what differs between two captures of one launch
    taken out (handles, addresses, node ids, launch sizes), by how often
    it occurs."""
    graph.debug_dump(str(path))
    text = path.read_text()
    out = collections.Counter()
    for piece in NODE.split(text)[1:]:
        body = re.sub(r"0x[0-9a-fA-F]+", "0x", piece.split('"];')[0])
        out[re.sub(r"\b\d+\b", "#", body)] += 1
    assert any("KERNEL" in k for k in out), text[:3000]
    return out


def _count_nodes(dev, name: str, rays: int, path) -> collections.Counter:
    """The nodes of a graph that holds one walk count alone (``name``,
    ``rays`` rays)."""
    steps = torch.ones(rays, dtype=torch.int32, device=dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with profiling.spans():
        profiling.count(name, steps)  # the tables, made eagerly
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            profiling.count(name, steps)
    graph.instantiate()
    return _nodes(graph, path)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GRAPHED))
def test_spans_off_graphs_keep_their_kernels(dev, case, tmp_path):
    """A spans-off graph of a frame (K1 and K4, the bounce walk, the
    shared-memory walks) or of a training step holds the nodes of the
    spans-on graph less its marks and less its walk counts' nodes (those
    of a graph of each count alone): with spans off, the instrumentation
    leaves nothing in the graph and the walks are the same launches."""
    from raytracebvh_tpu_torch.models import inverse

    scene, cam = _scene(dev), T.Camera.default(dev)
    cfg = T.RenderConfig(**GRAPHED[case])
    if case == "step":
        target = torch.full((cfg.height, cfg.width, 4), 0.25, device=dev)
        params = inverse.init_params(scene)
        opt = inverse.make_optimizer(params, 1e-2, capturable=True)
        cache = inverse.step_graphs(opt)

        def call():
            inverse.train_step_jit(params, opt, scene, cam, target, cfg)
    else:
        cache = tp.FRAME_GRAPHS
        cache.clear()

        def call():
            with torch.inference_mode():
                T.render_frame_jit(scene, cam, cfg)
    cache.debug = True
    try:
        call()  # the spans-off capture
        with profiling.spans():
            call()  # the spans-on capture
        with profiling.spans():
            call()  # one replay
        counts = profiling.counts()
        by_spans = {"spans" in key: getattr(e, "captured", e).graph
                    for key, e in cache.entries.items()}
        off = _nodes(by_spans[False], tmp_path / "off.dot")
        on = _nodes(by_spans[True], tmp_path / "on.dot")
    finally:
        cache.debug = False
        if case != "step":
            cache.clear()
    assert len(by_spans) == 2 and counts
    marks = collections.Counter({k: n for k, n in on.items()
                                 if "rtbvh_mark" in k})
    assert marks and not any("rtbvh_mark" in k for k in off)
    want = off + marks
    for k, c in enumerate(counts):
        want += _count_nodes(dev, c.name, c.rays, tmp_path / f"count{k}.dot")
    assert on == want
