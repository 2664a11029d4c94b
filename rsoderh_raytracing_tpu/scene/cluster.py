"""SAH-BVH-derived triangle chunk clustering.

Chunk-padded scenes (scene/device.py) store triangles in TRI_CHUNK-row
windows whose AABBs are tight when each window is spatially compact.
The default order is a Morton sort of centroids (scene/device.py
_morton_order); this module derives tighter orders from the same SAH
BVH the framework already builds for traversal parity (accel/bvh.py,
re-implementing the reference's src/bvh.rs builder):

- ``bvh_dfs_order``: triangles in the BVH's depth-first leaf order.
  A pure storage permutation (drop-in for the Morton sort): consecutive
  TRI_CHUNK windows follow the SAH partition instead of a fixed-grid
  space-filling curve. Measured on suzanne_hi/suzanne_xhi: total
  chunk-AABB surface area -9% / -18% vs Morton at identical chunk
  counts.

- ``treelet_pack``: cut the BVH into maximal subtrees of <= TRI_CHUNK
  triangles, greedily pack DFS-adjacent cuts into TRI_CHUNK-capacity
  chunks, and pad each chunk to exactly TRI_CHUNK rows so every chunk
  is a (union of few) SAH subtree(s). Per-chunk surface area drops
  2.2-3.1x vs Morton at the cost of ~40% more chunks (fill ~45/64).
  Pad rows collapse to the chunk's first real triangle's v0 vertex
  (a = b = c): every intersection constant cross product is exactly
  zero, so det == 0 and the |det| >= TRI_DET_EPS gate
  (ops/geometry.py:125) makes a pad row unhittable on every path —
  the same mechanism that masks the all-zero tail padding — while the
  collapsed vertex keeps the chunk AABB tight (the sphere-padding
  lesson from scene/device.py).

Selection: RT_CHUNK_CLUSTER=morton|bvh|treelet (scene/device.py).
Like the Morton sort, both are storage-order changes only: the closest
hit is a min over the same triangle set, so images are bit-identical
up to measure-zero exact-t ties (tests/test_cluster.py asserts it).
"""

from __future__ import annotations

import numpy as np


def _tri_bvh(vertices: np.ndarray, tris: np.ndarray):
    """SAH BVH over the triangles alone (bounds from the three corners)."""
    from rsoderh_raytracing_tpu.accel.bvh import build_bvh_from_bounds

    pts = np.stack(
        [vertices[tris[:, 0]], vertices[tris[:, 1]], vertices[tris[:, 2]]],
        axis=1,
    )
    mins = pts.min(axis=1).astype(np.float32)
    maxs = pts.max(axis=1).astype(np.float32)
    n = len(tris)
    return build_bvh_from_bounds(
        mins,
        maxs,
        np.full(n, 2, np.int32),
        np.arange(n, dtype=np.int32),
    )


def bvh_dfs_order(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Permutation putting triangles in SAH-BVH depth-first leaf order."""
    return _tri_bvh(vertices, tris).source_order


def _subtree_counts(payload: np.ndarray, count: np.ndarray) -> np.ndarray:
    """Per-node primitive counts for the flat DFS-preorder BVH. Children
    always follow their parent in preorder, so a reverse sweep sees both
    children before the parent."""
    n = len(payload)
    out = np.zeros(n, np.int64)
    for k in range(n - 1, -1, -1):
        if count[k] > 0:
            out[k] = count[k]
        else:
            out[k] = out[k + 1] + out[payload[k]]
    return out


def _leaf_ranges(payload: np.ndarray, count: np.ndarray):
    """Per-node ordered-primitive range [lo, hi): leaves emit consecutive
    runs in DFS preorder, so every subtree's range is contiguous."""
    n = len(payload)
    lo = np.full(n, np.iinfo(np.int64).max)
    hi = np.zeros(n, np.int64)
    for k in range(n - 1, -1, -1):
        if count[k] > 0:
            lo[k] = payload[k]
            hi[k] = payload[k] + count[k]
        else:
            lo[k] = min(lo[k + 1], lo[payload[k]])
            hi[k] = max(hi[k + 1], hi[payload[k]])
    return lo, hi


def treelet_cuts(payload: np.ndarray, count: np.ndarray, cap: int):
    """Maximal subtree cuts with <= cap primitives, in DFS order."""
    counts = _subtree_counts(payload, count)
    cuts = []
    stack = [0]
    while stack:
        k = stack.pop()
        if count[k] > 0 or counts[k] <= cap:
            cuts.append(k)
        else:
            # push right then left so the left child pops first
            stack.append(int(payload[k]))
            stack.append(k + 1)
    return cuts, counts


def treelet_pack(
    vertices: np.ndarray, tris: np.ndarray, chunk: int
) -> "tuple[np.ndarray, np.ndarray]":
    """Reorder + pad `tris` so every `chunk`-row window is a union of
    few DFS-adjacent SAH subtrees. Returns (tris_out, valid) where
    tris_out has a multiple-of-`chunk` row count and valid marks the
    real (non-pad) rows."""
    bvh = _tri_bvh(vertices, tris)
    cuts, counts = treelet_cuts(bvh.node_payload, bvh.node_count, chunk)
    lo, hi = _leaf_ranges(bvh.node_payload, bvh.node_count)
    order = bvh.source_order

    # Greedy sequential pack of DFS-adjacent cuts into chunk-capacity
    # groups (DFS adjacency == spatial adjacency under the SAH
    # partition, so merged cuts stay compact).
    groups: "list[list[int]]" = [[]]
    fill = 0
    for k in cuts:
        c = int(counts[k])
        if fill + c > chunk and fill:
            groups.append([])
            fill = 0
        groups[-1].append(k)
        fill += c

    rows = []
    valid = []
    for g in groups:
        n = 0
        for k in g:
            rows.append(tris[order[lo[k]: hi[k]]])
            n += int(hi[k] - lo[k])
        pad = chunk - n
        if pad:
            first = tris[order[lo[g[0]]]]
            padrow = np.array(
                [first[0]] * 3 + [first[3]] * 3 + [first[6]],
                dtype=tris.dtype,
            )
            rows.append(np.tile(padrow, (pad, 1)))
        valid.append(np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]))
    return np.concatenate(rows, axis=0), np.concatenate(valid)
