"""Vectorized BVH traversal in pure JAX.

Replicates cast_ray_bvh (shader.wgsl:469-564): per-ray explicit stack of
node indices (depth 64), front-to-back child ordering by ray direction
sign on the node's split axis, leaf = linear primitive loop.

It runs as a lockstep `lax.while_loop` whose body advances EVERY ray one
node per iteration with (N,)-wide gathers. It serves (a) as the semantic
reference for traversal, (b) to validate the flat BVH arrays against
brute force, and (c) for scenes past the backend's dense-sweep crossover
(routing.py). The dense path for the reference's scene sizes is
ops/intersect.py.

Unlike the WGSL megakernel, the leaf primitive test here is fused: leaf
primitives are tested via the same batched geometry kernels, bounded by
the BVH's max leaf size (static).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


from rsoderh_raytracing_tpu import routing
from rsoderh_raytracing_tpu.accel.bvh import FlatBVH, TRAVERSAL_STACK_DEPTH
from rsoderh_raytracing_tpu.ops import geometry as geo
from rsoderh_raytracing_tpu.ops.geometry import INF
from rsoderh_raytracing_tpu.scene.device import DeviceScene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceBVH:
    nodes_min: Any  # (K,3)
    nodes_max: Any  # (K,3)
    node_payload: Any  # (K,)
    node_count: Any  # (K,)
    node_axis: Any  # (K,)
    prim_type: Any  # (R,) 0/1/2
    prim_index: Any  # (R,)
    max_leaf: int = dataclasses.field(metadata={"static": True})
    # Static per-type presence: lets _leaf_test skip whole primitive-test
    # branches (and their gathers) for types the tree doesn't contain —
    # a pure-mesh scene pays only the Moller-Trumbore lane. True defaults
    # keep hand-built instances semantically identical (test all types).
    has_spheres: bool = dataclasses.field(
        default=True, metadata={"static": True}
    )
    has_planes: bool = dataclasses.field(
        default=True, metadata={"static": True}
    )
    has_triangles: bool = dataclasses.field(
        default=True, metadata={"static": True}
    )


def device_bvh(bvh: FlatBVH) -> DeviceBVH:
    """Upload a FlatBVH. Leaf primitive indices refer to the HOST
    scene's primitive order — pair only with a DeviceScene built with
    with_bvh=True (build_device_scene Morton-reorders chunked-path
    scenes' triangles otherwise)."""
    import numpy as np

    ptypes = np.asarray(bvh.prim_type)
    return DeviceBVH(
        nodes_min=jnp.asarray(bvh.nodes_min),
        nodes_max=jnp.asarray(bvh.nodes_max),
        node_payload=jnp.asarray(bvh.node_payload),
        node_count=jnp.asarray(bvh.node_count),
        node_axis=jnp.asarray(bvh.node_axis),
        prim_type=jnp.asarray(bvh.prim_type),
        prim_index=jnp.asarray(bvh.prim_index),
        max_leaf=int(bvh.node_count.max()),
        has_spheres=bool((ptypes == 0).any()),
        has_planes=bool((ptypes == 1).any()),
        has_triangles=bool((ptypes == 2).any()),
    )


def _bitcast_f32(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.float32)


def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _node_table(bvh: DeviceBVH):
    """(K, 9) f32: [box min xyz, box max xyz, payload, count, axis] with
    the three i32s BITCAST into f32 lanes (reinterpreted, never
    arithmetic) — ONE gather row per node visit instead of five separate
    takes. Loop-invariant: under jit XLA hoists it out of the traversal
    while_loop. Chosen per backend by routing.bvh_packed."""
    return jnp.concatenate(
        [
            bvh.nodes_min,
            bvh.nodes_max,
            _bitcast_f32(bvh.node_payload)[:, None],
            _bitcast_f32(bvh.node_count)[:, None],
            _bitcast_f32(bvh.node_axis)[:, None],
        ],
        axis=1,
    )


def _prim_table(scene: DeviceScene, bvh: DeviceBVH):
    """(R, 16) f32 leaf-primitive constants in bvh.prim slot order, ONE
    gather row per leaf slot. Column meaning is TYPE-SELECTED (col 15 is
    the bitcast type tag): triangles [a, e0, e1], spheres [center,
    radius], planes [pos, normal, bcm rows]. Rows for types the tree
    lacks are zeros (statically skipped in _leaf_test anyway).
    Loop-invariant like _node_table."""
    ptype = bvh.prim_type
    pidx = bvh.prim_index
    r = ptype.shape[0]
    zeros15 = jnp.zeros((r, 15), jnp.float32)

    def take(tbl):
        return jnp.take(tbl, pidx, axis=0, mode="clip")

    tri_m = (
        jnp.concatenate(
            [
                take(scene.tri_a),
                take(scene.tri_edge0),
                take(scene.tri_edge1),
                jnp.zeros((r, 6), jnp.float32),
            ],
            axis=1,
        )
        if bvh.has_triangles
        else zeros15
    )
    sph_m = (
        jnp.concatenate(
            [
                take(scene.sph_pos),
                take(scene.sph_radius)[:, None],
                jnp.zeros((r, 11), jnp.float32),
            ],
            axis=1,
        )
        if bvh.has_spheres
        else zeros15
    )
    pln_m = (
        jnp.concatenate(
            [
                take(scene.pln_pos),
                take(scene.pln_normal),
                take(scene.pln_bcm).reshape(r, 9),
            ],
            axis=1,
        )
        if bvh.has_planes
        else zeros15
    )
    sel = ptype[:, None]
    table15 = jnp.where(
        sel == 0, sph_m, jnp.where(sel == 1, pln_m, tri_m)
    )
    return jnp.concatenate(
        [table15, _bitcast_f32(ptype)[:, None]], axis=1
    )


def _leaf_test(scene, bvh: DeviceBVH, prim_table, ro, rd, start, count):
    """Test up to max_leaf primitives starting at `start` for each ray.

    Returns (t, prim_slot) where prim_slot indexes bvh.prim_* arrays,
    or (INF, -1). With prim_table (routing.bvh_packed) each slot costs
    ONE (N, 16) gather; otherwise type/index takes + per-type constant
    takes, which XLA:CPU compiles measurably faster.
    Both forms feed IDENTICAL float values into identical tests, so
    results are bitwise equal (tested)."""
    n = ro.shape[0]
    best_t = jnp.full((n,), INF)
    best_slot = jnp.full((n,), -1, jnp.int32)
    num_prims = bvh.prim_type.shape[0]

    for j in range(bvh.max_leaf):
        slot = jnp.minimum(start + j, num_prims - 1)
        in_leaf = j < count
        if prim_table is not None:
            row = jnp.take(prim_table, slot, axis=0)  # (N, 16)
            ptype = _bitcast_i32(row[:, 15])
            tri_args = (row[:, 0:3], row[:, 3:6], row[:, 6:9])
            pln_args = (
                row[:, 0:3], row[:, 3:6], row[:, 6:15].reshape(n, 3, 3)
            )
            sph_args = (row[:, 0:3], row[:, 3])
        else:
            ptype = jnp.take(bvh.prim_type, slot)
            pidx = jnp.take(bvh.prim_index, slot)
            if bvh.has_triangles:
                tri_args = (
                    jnp.take(scene.tri_a, pidx, axis=0),
                    jnp.take(scene.tri_edge0, pidx, axis=0),
                    jnp.take(scene.tri_edge1, pidx, axis=0),
                )
            if bvh.has_planes:
                pln_args = (
                    jnp.take(scene.pln_pos, pidx, axis=0),
                    jnp.take(scene.pln_normal, pidx, axis=0),
                    jnp.take(scene.pln_bcm, pidx, axis=0),
                )
            if bvh.has_spheres:
                sph_args = (
                    jnp.take(scene.sph_pos, pidx, axis=0),
                    jnp.take(scene.sph_radius, pidx, axis=0),
                )

        # Evaluate the primitive tests for each type the tree CONTAINS
        # (static — a pure-mesh BVH compiles only the triangle lane);
        # select by the slot's type tag. Wrong-type slots feed garbage
        # (finite) into the untaken branches — every test is guarded.
        t = jnp.full((n,), INF)
        if bvh.has_triangles:
            t = jnp.where(ptype == 2, _triangle_t(ro, rd, *tri_args), t)
        if bvh.has_planes:
            t = jnp.where(ptype == 1, _plane_t(ro, rd, *pln_args), t)
        if bvh.has_spheres:
            t = jnp.where(ptype == 0, _sphere_t(ro, rd, *sph_args), t)
        t = jnp.where(in_leaf, t, INF)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_slot = jnp.where(better, slot.astype(jnp.int32), best_slot)
    return best_t, best_slot


def _sphere_t(ro, rd, center, radius):
    l = ro - center  # noqa: E741
    a = jnp.sum(rd * rd, axis=-1)
    b = 2.0 * jnp.sum(rd * l, axis=-1)
    c = jnp.sum(l * l, axis=-1) - radius * radius
    disc = b * b - 4 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
    t0 = q / a
    t1 = c / jnp.where(q == 0, 1.0, q)
    t = jnp.where(
        t0 < geo.SPHERE_EPS,
        t1,
        jnp.where(t1 < geo.SPHERE_EPS, t0, jnp.minimum(t0, t1)),
    )
    t = jnp.where(disc == 0.0, -0.5 * b / a, t)
    hit = (disc >= 0.0) & (t >= geo.SPHERE_EPS)
    return jnp.where(hit, t, INF)


def _plane_t(ro, rd, pos, normal, bcm):
    denom = jnp.sum(normal * rd, axis=-1)
    ok = jnp.abs(denom) >= geo.PLANE_DENOM_EPS
    t = jnp.sum(normal * (pos - ro), axis=-1) / jnp.where(ok, denom, 1.0)
    inter = ro + rd * t[..., None] - pos
    local = jnp.einsum(
        "nij,nj->ni", bcm, inter, precision=jax.lax.Precision.HIGHEST
    )
    in_bounds = (
        (local[..., 0] >= 0)
        & (local[..., 0] <= 1)
        & (local[..., 2] >= 0)
        & (local[..., 2] <= 1)
    )
    hit = ok & (t >= geo.PLANE_T_EPS) & in_bounds
    return jnp.where(hit, t, INF)


def _triangle_t(ro, rd, a, e0, e1):
    rel = ro - a
    p0 = jnp.cross(rel, e0)
    p1 = jnp.cross(rd, e1)
    det = jnp.sum(e0 * p1, axis=-1)
    ok = jnp.abs(det) >= geo.TRI_DET_EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    u = jnp.sum(rel * p1, axis=-1) * inv
    v = jnp.sum(rd * p0, axis=-1) * inv
    t = jnp.sum(e1 * p0, axis=-1) * inv
    hit = (
        ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= geo.TRI_T_EPS)
    )
    return jnp.where(hit, t, INF)


def traverse_closest(scene: DeviceScene, bvh: DeviceBVH, ro, rd):
    """Closest (t, prim_slot) per ray via stack traversal.

    Returns (t (N,), slot (N,) into bvh.prim_* or -1). Visits a subset
    of the reference's node order (shader.wgsl:487-557): boxes whose
    slab entry time exceeds the lane's running best-t are skipped — the
    reference re-tests them (its slab test has no t_max, SURVEY quirk
    note), but a skipped box can only hold hits at t >= entry > best_t,
    which the strict `<` winner update would discard anyway, so (t,
    slot) results are bitwise identical while lockstep iterations drop
    with every early hit.

    Child boxes are tested AT THE PARENT (both at once), so a node
    whose box misses is never visited — a measured 46% of the naive
    walk's visits on camera-like suzanne_hi rays were such box-miss
    steps. `current` always carries the slab ENTRY time observed when
    it was reached (`cur_entry`); a node whose stored entry has fallen
    beyond the now-tighter best-t is skipped at processing time, which
    is exactly the naive walk's per-visit prune (entry times are
    time-invariant, best-t only shrinks), so the set of leaf tests —
    and hence (t, slot) — stays bitwise identical to both the naive
    walk and the reference order argument above."""
    n = ro.shape[0]
    rd_inv = 1.0 / rd
    packed = routing.bvh_packed()
    node_table = _node_table(bvh) if packed else None
    prim_table = _prim_table(scene, bvh) if packed else None

    stack = jnp.zeros((n, TRAVERSAL_STACK_DEPTH), jnp.int32)
    tstack = jnp.zeros((n, TRAVERSAL_STACK_DEPTH), jnp.float32)
    stack_len = jnp.zeros((n,), jnp.int32)
    current = jnp.zeros((n,), jnp.int32)
    cur_entry = jnp.zeros((n,), jnp.float32)
    # the root's box is tested up front (the one box test the
    # parent-side scheme cannot cover)
    root_hit, _ = geo.ray_bounds_entry(
        ro, rd_inv,
        jnp.broadcast_to(bvh.nodes_min[0], (n, 3)),
        jnp.broadcast_to(bvh.nodes_max[0], (n, 3)),
    )
    running = root_hit
    best_t = jnp.full((n,), INF)
    best_slot = jnp.full((n,), -1, jnp.int32)

    def cond(state):
        return jnp.any(state[5])

    def fetch_meta(current):
        if packed:
            row = jnp.take(node_table, current, axis=0)  # (N, 9)
            return (
                _bitcast_i32(row[:, 6]),
                _bitcast_i32(row[:, 7]),
                _bitcast_i32(row[:, 8]),
            )
        return (
            jnp.take(bvh.node_payload, current),
            jnp.take(bvh.node_count, current),
            jnp.take(bvh.node_axis, current),
        )

    def fetch_box(idx):
        if packed:
            row = jnp.take(node_table, idx, axis=0)
            return row[:, 0:3], row[:, 3:6]
        return (
            jnp.take(bvh.nodes_min, idx, axis=0),
            jnp.take(bvh.nodes_max, idx, axis=0),
        )

    def body(state):
        (stack, tstack, stack_len, current, cur_entry, running,
         best_t, best_slot) = state

        # the naive walk's per-visit prune, from the stored entry time
        alive = running & (cur_entry <= best_t)
        payload, count, axis = fetch_meta(current)
        is_leaf = alive & (count > 0)
        is_interior = alive & (count == 0)

        # Leaf: test primitives — gated on ANY lane being at a leaf
        # this trip (lax.cond): the lockstep walk is TAIL-bound, and
        # late trips frequently have no leaf lanes at all, so skipping
        # the whole max_leaf gather+test block is a measured 1.12x.
        def do_leaf(args):
            best_t, best_slot = args
            t, slot = _leaf_test(
                scene,
                bvh,
                prim_table,
                ro,
                rd,
                jnp.where(is_leaf, payload, 0),
                jnp.where(is_leaf, count, 0),
            )
            better = is_leaf & (t < best_t)
            return (
                jnp.where(better, t, best_t),
                jnp.where(better, slot, best_slot),
            )

        best_t, best_slot = jax.lax.cond(
            jnp.any(is_leaf), do_leaf, lambda a: a, (best_t, best_slot)
        )

        # Interior: test BOTH children here (front-to-back by direction
        # sign on the split axis — shader.wgsl:536-547); only hit
        # children are ever visited.
        neg = (
            jnp.take_along_axis(rd_inv, axis[:, None], axis=1).squeeze(1) < 0.0
        )
        near = jnp.where(neg, payload, current + 1)
        far = jnp.where(neg, current + 1, payload)
        nmin, nmax = fetch_box(jnp.where(is_interior, near, 0))
        fmin, fmax = fetch_box(jnp.where(is_interior, far, 0))
        n_box, n_entry = geo.ray_bounds_entry(ro, rd_inv, nmin, nmax)
        f_box, f_entry = geo.ray_bounds_entry(ro, rd_inv, fmin, fmax)
        hit_n = is_interior & n_box & (n_entry <= best_t)
        hit_f = is_interior & f_box & (f_entry <= best_t)

        # push far (with its entry time) when BOTH children are live
        push = hit_n & hit_f
        idx = jnp.clip(stack_len, 0, TRAVERSAL_STACK_DEPTH - 1)
        one_hot = (
            jnp.arange(TRAVERSAL_STACK_DEPTH)[None, :] == idx[:, None]
        )
        stack = jnp.where(push[:, None] & one_hot, far[:, None], stack)
        tstack = jnp.where(
            push[:, None] & one_hot, f_entry[:, None], tstack
        )
        stack_len = jnp.where(push, stack_len + 1, stack_len)

        has_child = hit_n | hit_f
        descend = jnp.where(hit_n, near, far)
        descend_entry = jnp.where(hit_n, n_entry, f_entry)

        # Pop for lanes with no live child (finished leaf, pruned node,
        # or both children culled).
        need_pop = running & ~has_child
        can_pop = need_pop & (stack_len > 0)
        new_len = jnp.where(can_pop, stack_len - 1, stack_len)
        at = jnp.clip(new_len, 0, TRAVERSAL_STACK_DEPTH - 1)[:, None]
        popped = jnp.take_along_axis(stack, at, axis=1).squeeze(1)
        popped_t = jnp.take_along_axis(tstack, at, axis=1).squeeze(1)

        current = jnp.where(
            has_child, descend, jnp.where(can_pop, popped, current)
        )
        cur_entry = jnp.where(
            has_child, descend_entry,
            jnp.where(can_pop, popped_t, cur_entry),
        )
        running = running & (has_child | can_pop)
        stack_len = new_len

        return (stack, tstack, stack_len, current, cur_entry, running,
                best_t, best_slot)

    state = (stack, tstack, stack_len, current, cur_entry, running,
             best_t, best_slot)
    state = jax.lax.while_loop(cond, body, state)
    return state[6], state[7]


def traverse_any(scene: DeviceScene, bvh: DeviceBVH, ro, rd):
    """Occlusion walk: True where ANY primitive hits along the ray.

    Same hit-predicate set as traverse_closest (so `traverse_any(...)
    == traverse_closest(...)[1] >= 0`, tested), but a lane RETIRES at
    its first hit instead of walking on for the closest winner — the
    while_loop is lockstep (trip count = the slowest lane), and shadow
    rays in lit regions typically hit within a few nodes, so early
    retirement shortens the whole batch. Mirrors NEE's cast_ray_bvh-only
    occlusion (shader.wgsl:1249): no linear fallback.
    """
    n = ro.shape[0]
    rd_inv = 1.0 / rd
    packed = routing.bvh_packed()
    node_table = _node_table(bvh) if packed else None
    prim_table = _prim_table(scene, bvh) if packed else None

    stack = jnp.zeros((n, TRAVERSAL_STACK_DEPTH), jnp.int32)
    stack_len = jnp.zeros((n,), jnp.int32)
    current = jnp.zeros((n,), jnp.int32)
    root_hit = geo.ray_intersects_bounds(
        ro, rd_inv,
        jnp.broadcast_to(bvh.nodes_min[0], (n, 3)),
        jnp.broadcast_to(bvh.nodes_max[0], (n, 3)),
    )
    running = root_hit
    occluded = jnp.zeros((n,), bool)

    def cond(state):
        return jnp.any(state[3])

    def fetch_meta(current):
        if packed:
            row = jnp.take(node_table, current, axis=0)  # (N, 9)
            return (
                _bitcast_i32(row[:, 6]),
                _bitcast_i32(row[:, 7]),
                _bitcast_i32(row[:, 8]),
            )
        return (
            jnp.take(bvh.node_payload, current),
            jnp.take(bvh.node_count, current),
            jnp.take(bvh.node_axis, current),
        )

    def fetch_box(idx):
        if packed:
            row = jnp.take(node_table, idx, axis=0)
            return row[:, 0:3], row[:, 3:6]
        return (
            jnp.take(bvh.nodes_min, idx, axis=0),
            jnp.take(bvh.nodes_max, idx, axis=0),
        )

    def body(state):
        stack, stack_len, current, running, occluded = state

        # `current` boxes were tested by their parent (see
        # traverse_closest) — occlusion has no best-t, so no re-prune.
        payload, count, axis = fetch_meta(current)
        is_leaf = running & (count > 0)
        is_interior = running & (count == 0)

        # leaf test gated like traverse_closest's (measured 1.12x)
        def do_leaf(occluded):
            t, _ = _leaf_test(
                scene,
                bvh,
                prim_table,
                ro,
                rd,
                jnp.where(is_leaf, payload, 0),
                jnp.where(is_leaf, count, 0),
            )
            return occluded | (is_leaf & (t < INF))

        occluded = jax.lax.cond(
            jnp.any(is_leaf), do_leaf, lambda o: o, occluded
        )
        found = is_leaf & occluded

        neg = (
            jnp.take_along_axis(rd_inv, axis[:, None], axis=1).squeeze(1) < 0.0
        )
        near = jnp.where(neg, payload, current + 1)
        far = jnp.where(neg, current + 1, payload)
        nmin, nmax = fetch_box(jnp.where(is_interior, near, 0))
        fmin, fmax = fetch_box(jnp.where(is_interior, far, 0))
        hit_n = is_interior & geo.ray_intersects_bounds(
            ro, rd_inv, nmin, nmax
        )
        hit_f = is_interior & geo.ray_intersects_bounds(
            ro, rd_inv, fmin, fmax
        )

        push = hit_n & hit_f
        idx = jnp.clip(stack_len, 0, TRAVERSAL_STACK_DEPTH - 1)
        stack = jnp.where(
            push[:, None]
            & (
                jnp.arange(TRAVERSAL_STACK_DEPTH)[None, :] == idx[:, None]
            ),
            far[:, None],
            stack,
        )
        stack_len = jnp.where(push, stack_len + 1, stack_len)

        has_child = hit_n | hit_f
        descend = jnp.where(hit_n, near, far)

        # found lanes retire outright (no pop — their stack is abandoned);
        # everyone else follows traverse_closest's pop discipline.
        need_pop = running & ~found & ~has_child
        can_pop = need_pop & (stack_len > 0)
        new_len = jnp.where(can_pop, stack_len - 1, stack_len)
        popped = jnp.take_along_axis(
            stack, jnp.clip(new_len, 0, TRAVERSAL_STACK_DEPTH - 1)[:, None], axis=1
        ).squeeze(1)

        current = jnp.where(
            has_child, descend, jnp.where(can_pop, popped, current)
        )
        running = running & ~found & (has_child | can_pop)
        stack_len = new_len

        return stack, stack_len, current, running, occluded

    state = (stack, stack_len, current, running, occluded)
    state = jax.lax.while_loop(cond, body, state)
    return state[4]
