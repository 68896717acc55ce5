"""The autograd nodes that take the shading's gathered leaf-row blocks,
for the training tests on the CPU (``test_torch_inverse.py``) and on the
GPU (``test_torch_cuda.py``).  torch only: the GPU machine has no JAX."""

LEAF_CHANNELS = 40  # leaf_attrs' width: a shading call gathers [40, R]


def block_takers(monkeypatch, make_loss):
    """Build a loss with ``make_loss()`` while recording every [40, R]
    block that ``pipeline._shade_hit_soa`` gathers (K2's route through
    ``gather_cuda.gather_for``, K7's through
    ``gather_cols_cuda.gather_cols``), then walk the loss's autograd graph
    from ``loss.grad_fn``.  Returns the loss and, for each block on that
    graph in the order gathered, the sorted class names of the nodes that
    take the block as an input."""
    from raytracebvh_tpu_torch.ops import gather_cols_cuda, gather_cuda

    blocks = []

    def recording(gather):
        def gather_and_record(tbl, idx):
            out = gather(tbl, idx)
            if out.shape[0] == LEAF_CHANNELS:
                blocks.append(out)
            return out
        return gather_and_record

    gather_for = gather_cuda.gather_for
    monkeypatch.setattr(gather_cuda, "gather_for",
                        lambda backend: recording(gather_for(backend)))
    monkeypatch.setattr(gather_cols_cuda, "gather_cols",
                        recording(gather_cols_cuda.gather_cols))
    loss = make_loss()
    takers, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None:
                takers.setdefault(nxt, []).append(type(node).__name__)
                todo.append(nxt)
    return loss, [sorted(takers[b.grad_fn]) for b in blocks
                  if b.grad_fn in seen]
