"""graphs.kernels: kernels in one replay of the cell's graph, from the
device trace: the kernels whose launch is a graph launch of the traced
window, over the number of graph launches."""


def read(run):
    tr = run.traced
    if tr is None or not tr.graph_launches:
        return None
    n = tr.graph_kernels()
    return n / len(tr.graph_launches) if n else None
