"""build.stage_ms: the program's own timer of the build
(``utils.profiling.stage_times(scene, camera, cfg)["build_total"]``: the
build captured alone into a CUDA graph, CUDA events around a replay, the
median of its rounds), on the cell's scene, camera and config, in ms."""


def read(run):
    times = run.layer.get("stage_times")
    if times is None:
        return None
    return times()["build_total"] * 1e3
