"""Binned-SAH BVH construction (host side, NumPy).

Host copy of ``path_tracer_tpu/scene/bvh.py``'s builder, behavior-compatible
with the reference BLAS builder (``src/tlas/tlas_bvh/blas/blas_bvh.rs:62-136``):

* split axis = longest axis of the node bounds,
* primitives stably sorted by AABB-min along that axis,
* equal-count candidate splits: ``bin_size = max(span / 64, 1)``, candidates at
  ``j = (i+1) * bin_size``,
* SAH = ``TRAVERSAL_COST + (j*SA(L) + (span-j)*SA(R)) * INTERSECTION_COST / SA(node)``,
* leaf collapse when ``no_split_sah = INTERSECTION_COST * span`` beats the best
  split, single-primitive fast-path leaves.

The port's dense engine brute-forces every triangle, so for it only the
builder's primitive permutation is used: it fixes the triangle order (SAH
leaf order), which fixes the lowest-index tie rule and keeps consecutive
triangles spatially clustered. The walk engine (``trace/walk.py``) cuts the
soup into chunks with `chunk_partition` and builds a tree over the chunk
boxes with `build_sah_tree`. The stack BVH engine (``trace/bvh_stack.py``,
light tables above 16,384 triangles and world soups above 2,000,000) walks
the tree itself, flattened by `flatten` into dual-child records (`build_bvh`).
The native C++ builder (`path_tracer_tpu_torch.native`) gives the same
output contract; `chunk_partition` and the scene's SAH build
(`scene.scene._sah_tree`) take it when g++ is there.

Flat node record i (arrays of length M):
  ``c0_min/c0_max/c1_min/c1_max`` [M,3]  child AABBs
  ``c0_idx/c1_idx``               [M]    child node index OR first-primitive offset
  ``c0_count/c1_count``           [M]    0 => internal child, >0 => leaf with
                                          that many primitives, -1 => no child
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DESIRED_BINS = 64
TRAVERSAL_COST = 1.0
INTERSECTION_COST = 2.0


@dataclass
class _Node:
    bb_min: np.ndarray
    bb_max: np.ndarray
    # leaf: (start, count) into the permutation; internal: (left, right) node ids
    is_leaf: bool
    a: int
    b: int


def _surface_area(bb_min: np.ndarray, bb_max: np.ndarray) -> np.ndarray:
    v = bb_max - bb_min
    # 2 * dot(v, v.zxy) (boundingbox.rs:90-95)
    return 2.0 * (v[..., 0] * v[..., 2] + v[..., 1] * v[..., 0] + v[..., 2] * v[..., 1])


def build_sah_tree(aabb_min: np.ndarray, aabb_max: np.ndarray, max_leaf: int = 4):
    """Build the SAH tree over primitives with the given AABBs.

    Returns ``(nodes: list[_Node], perm: int64[T])`` where leaves index into
    ``perm`` (the primitive reordering).

    ``max_leaf`` caps leaf size: the reference's no-split collapse
    (blas_bvh.rs:112-121) can emit arbitrarily large leaves, but the batched
    traversal kernels unroll leaf loops, so oversized would-be leaves are
    split regardless of SAH. Identical images, bounded unroll.
    """
    t = aabb_min.shape[0]
    if t == 0:
        raise ValueError("empty BVH")
    perm = np.arange(t)
    nodes: list[_Node] = []

    # Iterative DFS matching the recursive reference builder. Each job is
    # (start, end, placeholder_parent_slot); we allocate the node, then push
    # children jobs. Children are contiguous subranges of `perm`.
    # To wire child ids we process with an explicit stack of jobs carrying a
    # callback slot: simpler scheme — build recursively with sys-style stack
    # frames storing state.
    def build(start: int, end: int) -> int:
        span = end - start
        idx = perm[start:end]
        bmin = aabb_min[idx]
        bmax = aabb_max[idx]
        node_min = bmin.min(axis=0)
        node_max = bmax.max(axis=0)

        if span == 1:
            nodes.append(_Node(node_min, node_max, True, start, 1))
            return len(nodes) - 1

        bb_sa = _surface_area(node_min, node_max)
        extent = node_max - node_min
        axis = int(np.argmax(extent))

        order = np.argsort(bmin[:, axis], kind="stable")
        perm[start:end] = idx[order]
        bmin = bmin[order]
        bmax = bmax[order]

        # prefix/suffix accumulated boxes
        pre_min = np.minimum.accumulate(bmin, axis=0)
        pre_max = np.maximum.accumulate(bmax, axis=0)
        suf_min = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        suf_max = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]

        bin_size = max(span // DESIRED_BINS, 1)
        num_bins = span // bin_size - 1
        if num_bins <= 0:
            num_bins = 1 if span > 1 else 0
            js = np.array([max(span // 2, 1)]) if num_bins else np.array([], dtype=np.int64)
        else:
            js = (np.arange(num_bins) + 1) * bin_size
            js = js[js < span]

        l_sa = _surface_area(pre_min[js - 1], pre_max[js - 1])
        r_sa = _surface_area(suf_min[js], suf_max[js])
        sah = TRAVERSAL_COST + (js * l_sa + (span - js) * r_sa) * INTERSECTION_COST / max(bb_sa, 1e-30)

        best = int(np.argmin(sah))
        best_split = int(js[best])
        best_sah = float(sah[best])
        no_split_sah = INTERSECTION_COST * span

        if no_split_sah < best_sah and span <= max_leaf:
            nodes.append(_Node(node_min, node_max, True, start, span))
            return len(nodes) - 1

        left = build(start, start + best_split)
        right = build(start + best_split, end)
        nodes.append(_Node(node_min, node_max, False, left, right))
        return len(nodes) - 1

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        root = build(0, t)
    finally:
        sys.setrecursionlimit(old_limit)
    return nodes, perm, root


def chunk_partition(aabb_min: np.ndarray, aabb_max: np.ndarray, chunk: int):
    """`chunk_partition_py`'s partition, through the native builder when it
    is available (`path_tracer_tpu_torch.native`; bit-identical output,
    ``tests/test_torch_native.py``), as the JAX package's ``chunk_partition``
    dispatches."""
    from path_tracer_tpu_torch import native

    if native.available():
        return native.chunk_partition(aabb_min, aabb_max, chunk)
    return chunk_partition_py(aabb_min, aabb_max, chunk)


def chunk_partition_py(aabb_min: np.ndarray, aabb_max: np.ndarray, chunk: int):
    """Partition primitives into spatial chunks of <= ``chunk`` prims with the
    same binned-SAH splitter as ``build_sah_tree`` but NO leaf collapse: every
    node splits until its span fits one chunk. Used by the walk engine
    (trace/walk.py), whose dense leaf tests want full, spatially tight chunks
    rather than the reference's tiny SAH-optimal leaves (blas_bvh.rs:112-121).
    A copy of the JAX package's ``chunk_partition_py``.

    Returns ``(perm, starts, spans)`` — leaves in DFS (left-first) order;
    chunk ``i`` holds prims ``perm[starts[i] : starts[i] + spans[i]]``.
    """
    t = aabb_min.shape[0]
    if t == 0:
        raise ValueError("empty chunk partition")
    perm = np.arange(t)
    starts: list[int] = []
    spans: list[int] = []

    def build(start: int, end: int) -> None:
        span = end - start
        if span <= chunk:
            starts.append(start)
            spans.append(span)
            return
        idx = perm[start:end]
        bmin = aabb_min[idx]
        bmax = aabb_max[idx]
        node_min = bmin.min(axis=0)
        node_max = bmax.max(axis=0)
        axis = int(np.argmax(node_max - node_min))
        order = np.argsort(bmin[:, axis], kind="stable")
        perm[start:end] = idx[order]
        bmin = bmin[order]
        bmax = bmax[order]
        pre_min = np.minimum.accumulate(bmin, axis=0)
        pre_max = np.maximum.accumulate(bmax, axis=0)
        suf_min = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        suf_max = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
        bin_size = max(span // DESIRED_BINS, 1)
        num_bins = span // bin_size - 1
        if num_bins <= 0:
            js = np.array([max(span // 2, 1)])
        else:
            js = (np.arange(num_bins) + 1) * bin_size
            js = js[js < span]
        l_sa = _surface_area(pre_min[js - 1], pre_max[js - 1])
        r_sa = _surface_area(suf_min[js], suf_max[js])
        sah = js * l_sa + (span - js) * r_sa
        best_split = int(js[int(np.argmin(sah))])
        build(start, start + best_split)
        build(start + best_split, end)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        build(0, t)
    finally:
        sys.setrecursionlimit(old_limit)
    return perm, np.asarray(starts), np.asarray(spans)


# Sentinel for "no child" boxes (finite, as in the JAX package, whose node
# tables pass through one-hot matmul gathers): 3e37 never passes a slab test.
NO_CHILD_BOUND = np.float32(3.0e37)


def flatten(nodes: list[_Node], root: int) -> dict[str, np.ndarray]:
    """Flatten the tree into dual-child SoA records (see the module note).

    Node ids are renumbered in DFS order with the root at 0 so traversal can
    start at index 0. A root that is itself a leaf gets a synthetic parent with
    an empty second child. A copy of the JAX package's ``flatten``.
    """
    inf = NO_CHILD_BOUND

    recs: list[dict] = []

    def emit_placeholder() -> int:
        recs.append({})
        return len(recs) - 1

    def fill(slot: int, node: _Node):
        """Fill `slot` with the internal node `node` (must be internal)."""
        left = nodes[node.a]
        right = nodes[node.b]
        rec = {
            "c0_min": left.bb_min, "c0_max": left.bb_max,
            "c1_min": right.bb_min, "c1_max": right.bb_max,
        }
        if left.is_leaf:
            rec["c0_idx"], rec["c0_count"] = left.a, left.b
        else:
            child_slot = emit_placeholder()
            rec["c0_idx"], rec["c0_count"] = child_slot, 0
            fill(child_slot, left)
        if right.is_leaf:
            rec["c1_idx"], rec["c1_count"] = right.a, right.b
        else:
            child_slot = emit_placeholder()
            rec["c1_idx"], rec["c1_count"] = child_slot, 0
            fill(child_slot, right)
        recs[slot] = rec

    root_node = nodes[root]
    slot0 = emit_placeholder()
    if root_node.is_leaf:
        recs[slot0] = {
            "c0_min": root_node.bb_min, "c0_max": root_node.bb_max,
            "c1_min": np.full(3, inf), "c1_max": np.full(3, -inf),
            "c0_idx": root_node.a, "c0_count": root_node.b,
            "c1_idx": 0, "c1_count": -1,
        }
    else:
        import sys

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 100000))
        try:
            fill(slot0, root_node)
        finally:
            sys.setrecursionlimit(old_limit)

    out = {}
    for key in ("c0_min", "c0_max", "c1_min", "c1_max"):
        out[key] = np.stack([r[key] for r in recs]).astype(np.float32)
    for key in ("c0_idx", "c0_count", "c1_idx", "c1_count"):
        out[key] = np.array([r[key] for r in recs], dtype=np.int32)
    out["root_min"] = np.minimum(out["c0_min"][0], np.where(out["c1_count"][0] == -1, NO_CHILD_BOUND, out["c1_min"][0])).astype(np.float32)
    out["root_max"] = np.maximum(out["c0_max"][0], np.where(out["c1_count"][0] == -1, -NO_CHILD_BOUND, out["c1_max"][0])).astype(np.float32)
    return out


def tree_depth(nodes: list[_Node], root: int) -> int:
    """Max depth (edges) of the tree — bounds the traversal stack usage."""
    depth = 0
    stack = [(root, 0)]
    while stack:
        i, d = stack.pop()
        depth = max(depth, d)
        node = nodes[i]
        if not node.is_leaf:
            stack.append((node.a, d + 1))
            stack.append((node.b, d + 1))
    return depth


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray, max_leaf: int = 4):
    """Convenience: build + flatten. Returns ``(flat_nodes, perm, depth)``."""
    nodes, perm, root = build_sah_tree(aabb_min, aabb_max, max_leaf=max_leaf)
    return flatten(nodes, root), perm, tree_depth(nodes, root)
