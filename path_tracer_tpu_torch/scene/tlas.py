"""Top-level acceleration structure over model instances (host side, NumPy).

Host copy of ``path_tracer_tpu/scene/tlas.py``. The reference TLAS is built by
greedy agglomerative clustering: repeatedly merge the pair of nodes whose
union box has the smallest surface area (``src/tlas/tlas_bvh.rs:56-138``),
here with a vectorized best-match search, then flattened to the BLAS's
dual-child record format (`scene.bvh.flatten`) with leaves holding instance
ids (count 1). The gather engine (`trace.twolevel`) walks it.
"""

from __future__ import annotations

import numpy as np

from path_tracer_tpu_torch.scene.bvh import _Node, flatten


def build_tlas(inst_min: np.ndarray, inst_max: np.ndarray):
    """Agglomerative-cluster a TLAS over instance AABBs ``[I, 3]``.

    Returns flat node arrays (see ``bvh.flatten``); leaf ``idx`` fields are
    instance ids with count 1.
    """
    n = inst_min.shape[0]
    nodes: list[_Node] = [
        _Node(inst_min[i].astype(np.float32), inst_max[i].astype(np.float32), True, i, 1)
        for i in range(n)
    ]
    if n == 1:
        return flatten(nodes, 0)

    active = list(range(n))  # indices into `nodes`

    def find_best(pos: int) -> int:
        """Vectorized ``find_best_match`` (tlas_bvh.rs:56-83): position in
        ``active`` whose union box with ``active[pos]`` has least area."""
        mins = np.stack([nodes[i].bb_min for i in active])
        maxs = np.stack([nodes[i].bb_max for i in active])
        lo = np.minimum(mins[pos], mins)
        hi = np.maximum(maxs[pos], maxs)
        v = hi - lo
        sa = 2.0 * (v[:, 0] * v[:, 2] + v[:, 1] * v[:, 0] + v[:, 2] * v[:, 1])
        sa[pos] = np.inf
        return int(np.argmin(sa))

    # Greedy pairing walk a->b->c; merge when a and b are mutual best matches
    # (tlas_bvh.rs:106-135), using swap-remove order like the reference.
    a = 0
    b = find_best(a)
    while len(active) > 1:
        c = find_best(b)
        if a == c:
            node_a, node_b = active[a], active[b]
            merged = _Node(
                np.minimum(nodes[node_a].bb_min, nodes[node_b].bb_min),
                np.maximum(nodes[node_a].bb_max, nodes[node_b].bb_max),
                False,
                node_a,
                node_b,
            )
            nodes.append(merged)
            for pos in sorted((a, b), reverse=True):  # swap_remove higher first
                active[pos] = active[-1]
                active.pop()
            a = len(active)
            active.append(len(nodes) - 1)
            if len(active) == 1:
                break
            b = find_best(a)
        else:
            a = b
            b = c

    return flatten(nodes, active[0])
