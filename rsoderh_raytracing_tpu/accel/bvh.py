"""Host-side SAH BVH builder emitting the reference's flat node layout.

Re-implements the PBRT-style builder of the reference (src/bvh.rs):
- primitives = all spheres (type 0) + planes (type 1) + triangles (type 2)
  in one unified array (src/bvh.rs:40-72),
- leaves hold <= 5 primitives; splits use 12 SAH buckets on the centroid
  bounds' longest axis, cost 0.125 + sum(count_i * SA_i) / SA
  (src/bvh.rs:215-337), with a median-split fallback when bucket
  partitioning degenerates,
- flat array layout: depth-first, interior node's first child implicit at
  parent+1, `primitives_or_second_child_index` holds the second child
  (interior) or the primitive start offset (leaf) (src/bvh.rs:81-99).

The builder is pure numpy; its traversal consumer is
ops/bvh_traverse.py (parity while_loop), and scene/cluster.py derives
storage orders from it. A C++ native fast path (native/) takes over for
large triangle counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rsoderh_raytracing_tpu.scene.types import Scene

MAX_PRIMITIVES_PER_LEAF = 5  # src/bvh.rs:219
BUCKET_COUNT = 12  # src/bvh.rs:220
TRAVERSAL_STACK_DEPTH = 64  # shader.wgsl:482


@dataclasses.dataclass
class FlatBVH:
    """Flattened BVH + reordered primitive references.

    nodes_min/max: (K,3) f32 bounds
    node_payload:  (K,) i32 — second-child index (interior) or primitive
                   start (leaf)
    node_count:    (K,) i32 — primitives in leaf, 0 for interior
    node_axis:     (K,) i32 — split axis for front-to-back ordering
    prim_type:     (R,) i32 — 0 sphere / 1 plane / 2 triangle
    prim_index:    (R,) i32 — index into the per-type arrays
    """

    nodes_min: np.ndarray
    nodes_max: np.ndarray
    node_payload: np.ndarray
    node_count: np.ndarray
    node_axis: np.ndarray
    prim_type: np.ndarray
    prim_index: np.ndarray
    depth: int
    source_order: np.ndarray  # (R,) original flat ids, ordered-prim -> source

    @property
    def num_nodes(self) -> int:
        return len(self.node_payload)

    @property
    def num_primitives(self) -> int:
        return len(self.prim_type)


def scene_primitive_bounds(scene: Scene):
    """(R,3) min/max bounds + (R,) type/index arrays for all primitives,
    ordered spheres, planes, triangles (src/bvh.rs:40-72)."""
    mins, maxs, types, indices = [], [], [], []
    for i, sphere in enumerate(scene.spheres):
        b = sphere.bounds()
        mins.append(b.min)
        maxs.append(b.max)
        types.append(0)
        indices.append(i)
    for i, plane in enumerate(scene.planes):
        b = plane.bounds()
        mins.append(b.min)
        maxs.append(b.max)
        types.append(1)
        indices.append(i)
    # Vectorized triangle bounds: a per-triangle Python loop on a large
    # mesh would dominate scene-load time before the (fast) native SAH
    # build even starts.
    tv = scene.meshes.triangle_vertices()
    n_tri = len(tv)
    small_n = len(mins)
    all_mins = np.empty((small_n + n_tri, 3), np.float32)
    all_maxs = np.empty((small_n + n_tri, 3), np.float32)
    if small_n:
        all_mins[:small_n] = np.asarray(mins, np.float32)
        all_maxs[:small_n] = np.asarray(maxs, np.float32)
    if n_tri:
        all_mins[small_n:] = tv.min(axis=1)
        all_maxs[small_n:] = tv.max(axis=1)
    types.extend([2] * n_tri)
    indices.extend(range(n_tri))
    if not len(all_mins):
        raise ValueError("cannot build BVH over an empty scene")
    return (
        all_mins,
        all_maxs,
        np.asarray(types, np.int32),
        np.asarray(indices, np.int32),
    )


def build_bvh(scene: Scene) -> FlatBVH:
    mins, maxs, types, indices = scene_primitive_bounds(scene)
    bvh = build_bvh_from_bounds(mins, maxs, types, indices)
    # Build stats, as the reference logs them (src/bvh.rs:143-146).
    import logging

    logging.getLogger(__name__).info(
        "tree depth: %d; tree node count: %d", bvh.depth, bvh.num_nodes
    )
    return bvh


def build_bvh_from_bounds(
    mins: np.ndarray,
    maxs: np.ndarray,
    types: np.ndarray,
    indices: np.ndarray,
) -> FlatBVH:
    try:
        from rsoderh_raytracing_tpu.accel.native import build_bvh_native

        result = build_bvh_native(mins, maxs)
        if result is not None:
            return _assemble(result, types, indices)
    except ImportError:
        pass
    return _assemble(_build_python(mins, maxs), types, indices)


def _assemble(build, types, indices) -> FlatBVH:
    (
        nodes_min,
        nodes_max,
        payload,
        count,
        axis,
        order,
        depth,
    ) = build
    if depth >= TRAVERSAL_STACK_DEPTH:
        # The device traversal clips stack pushes at 64 entries
        # (ops/bvh_traverse.py) — same depth as the reference's WGSL
        # stack — so a deeper tree would silently drop subtrees and
        # miss real hits. Fail loudly instead.
        raise ValueError(
            f"BVH depth {depth} exceeds the {TRAVERSAL_STACK_DEPTH}-deep"
            " traversal stack; the scene needs a larger stack or fewer"
            " pathological primitives"
        )
    return FlatBVH(
        nodes_min=nodes_min,
        nodes_max=nodes_max,
        node_payload=payload,
        node_count=count,
        node_axis=axis,
        prim_type=types[order],
        prim_index=indices[order],
        depth=depth,
        source_order=np.asarray(order, np.int64),
    )


def _build_python(mins: np.ndarray, maxs: np.ndarray):
    """Iterative SAH build over primitive id array; returns flat arrays +
    the primitive ordering."""
    n = len(mins)
    centers = (mins + maxs) * 0.5

    ids = np.arange(n)

    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    payload: list[int] = []
    count: list[int] = []
    axis_out: list[int] = []
    order: list[np.ndarray] = []
    ordered_len = 0
    max_depth = 0

    def surface_area(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])

    def emit_leaf(sub_ids, bmin, bmax):
        nonlocal ordered_len
        nodes_min.append(bmin)
        nodes_max.append(bmax)
        payload.append(ordered_len)
        count.append(len(sub_ids))
        axis_out.append(0)
        order.append(sub_ids)
        ordered_len += len(sub_ids)
        return len(payload) - 1

    # Recursion via explicit stack of (ids, parent_slot_or_None, depth).
    # Depth-first preorder so the first child lands at parent+1.
    def build(sub_ids, depth):
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        bmin = mins[sub_ids].min(axis=0)
        bmax = maxs[sub_ids].max(axis=0)

        if len(sub_ids) <= MAX_PRIMITIVES_PER_LEAF:
            return emit_leaf(sub_ids, bmin, bmax)

        cmin = centers[sub_ids].min(axis=0)
        cmax = centers[sub_ids].max(axis=0)
        d = cmax - cmin
        # Reference tie-break: z wins only if strictly largest, then y
        # (src/scene.rs:113-122).
        if d[2] > d[0] and d[2] > d[1]:
            ax = 2
        elif d[1] > d[0]:
            ax = 1
        else:
            ax = 0
        if cmin[ax] == cmax[ax]:
            return emit_leaf(sub_ids, bmin, bmax)

        c = centers[sub_ids, ax]
        bucket = (
            BUCKET_COUNT * ((c - cmin[ax]) / (cmax[ax] - cmin[ax]))
        ).astype(np.int64)
        bucket = np.minimum(bucket, BUCKET_COUNT - 1)

        # Bucket bounds + counts, then prefix/suffix SAH costs.
        costs = np.empty(BUCKET_COUNT - 1, np.float64)
        for split in range(BUCKET_COUNT - 1):
            left = bucket <= split
            right = ~left
            cl = int(left.sum())
            cr = int(right.sum())
            if cl == 0:
                sa_l = 0.0
            else:
                sa_l = surface_area(
                    mins[sub_ids[left]].min(axis=0),
                    maxs[sub_ids[left]].max(axis=0),
                )
            if cr == 0:
                sa_r = 0.0
            else:
                sa_r = surface_area(
                    mins[sub_ids[right]].min(axis=0),
                    maxs[sub_ids[right]].max(axis=0),
                )
            costs[split] = 0.125 + (cl * sa_l + cr * sa_r) / surface_area(
                bmin, bmax
            )

        best = int(np.argmin(costs))
        left_mask = bucket <= best
        if left_mask.all() or not left_mask.any():
            # Median-split fallback (src/bvh.rs:317-325); stable sort so
            # the native C++ builder produces the identical ordering.
            med = np.argsort(c, kind="stable")
            half = len(sub_ids) // 2
            left_ids = sub_ids[med[:half]]
            right_ids = sub_ids[med[half:]]
        else:
            # In-place swap partition with the reference's exact element
            # order (src/bvh.rs:302-315): scanning from the left, a
            # right-bucket element swaps with the last unprocessed one.
            arr = sub_ids.copy()
            in_left = dict(zip(sub_ids.tolist(), left_mask.tolist()))
            split = 0
            end = len(arr)
            while split < end:
                if in_left[int(arr[split])]:
                    split += 1
                else:
                    end -= 1
                    arr[split], arr[end] = arr[end], arr[split]
            left_ids = arr[:split]
            right_ids = arr[split:]

        # Interior node: reserve slot, then children depth-first.
        nodes_min.append(bmin)
        nodes_max.append(bmax)
        payload.append(-1)
        count.append(0)
        axis_out.append(ax)
        slot = len(payload) - 1

        build(left_ids, depth + 1)  # lands at slot+1
        second = build(right_ids, depth + 1)
        payload[slot] = second
        return slot

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 2 * n + 1000))
    try:
        build(ids, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    return (
        np.asarray(nodes_min, np.float32),
        np.asarray(nodes_max, np.float32),
        np.asarray(payload, np.int32),
        np.asarray(count, np.int32),
        np.asarray(axis_out, np.int32),
        np.concatenate(order),
        max_depth,
    )


def validate_bvh(bvh: FlatBVH, mins: np.ndarray, maxs: np.ndarray, order_types=None):
    """Structural invariants: every primitive referenced exactly once, leaf
    bounds contain their primitives, child bounds inside parents.

    `mins`/`maxs` are the ORIGINAL (pre-permutation) primitive bounds;
    leaf containment checks them through the BVH's ordering arrays.
    `order_types` (optional) cross-checks that the ordered prim_type
    array is a permutation of the original types."""
    seen = np.zeros(bvh.num_primitives, bool)
    for k in range(bvh.num_nodes):
        if bvh.node_count[k] > 0:
            start = bvh.node_payload[k]
            for j in range(start, start + bvh.node_count[k]):
                assert not seen[j], "primitive referenced twice"
                seen[j] = True
                # Leaf bounds contain the primitive's original bounds.
                src = bvh.source_order[j]
                assert (mins[src] >= bvh.nodes_min[k] - 1e-5).all(), (
                    f"leaf {k} does not contain primitive {src} (min)"
                )
                assert (maxs[src] <= bvh.nodes_max[k] + 1e-5).all(), (
                    f"leaf {k} does not contain primitive {src} (max)"
                )
        else:
            second = bvh.node_payload[k]
            for child in (k + 1, second):
                assert (bvh.nodes_min[child] >= bvh.nodes_min[k] - 1e-5).all()
                assert (bvh.nodes_max[child] <= bvh.nodes_max[k] + 1e-5).all()
    assert seen.all(), "primitive missing from BVH"
    if order_types is not None:
        assert np.array_equal(
            np.sort(np.asarray(order_types)), np.sort(bvh.prim_type)
        ), "ordered prim types are not a permutation of the originals"
