"""Scene-level closest-hit / any-hit queries over ray batches.

The vectorised counterpart of the reference's per-thread ``cast_ray``
(shader.wgsl:566-601): a batch of N rays tests all padded primitives as
dense sweeps (ops/geometry.py::*_fast, broadcast arithmetic that XLA
fuses into the min/argmin reductions) and reduces to the closest winner.
Winner attributes (normals, materials) are reconstructed afterwards from
(type, index) with small-table gathers.

Scenes with a BVH attached (scene/device.py, routing.py) route through
ops/bvh_traverse.py instead (BVH-guided, parity semantics with the
reference's traversal).

Semantics notes vs the reference:
- `closest_hit` is mathematically what cast_ray computes (BVH walk plus
  the sphere/plane linear fallback): exact geometry tests over every
  primitive. The only divergence is measure-zero: rays exactly parallel
  to a zero-thickness *triangle* AABB, which the reference BVH can miss
  with no triangle fallback (shader.wgsl:576-598).
- `any_hit` mirrors NEE occlusion which uses cast_ray_bvh only
  (shader.wgsl:1249), i.e. all primitive types occlude.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp

from rsoderh_raytracing_tpu import routing
from rsoderh_raytracing_tpu.ops import geometry as geo
from rsoderh_raytracing_tpu.ops.geometry import INF, HitRecord
from rsoderh_raytracing_tpu.scene.device import DeviceScene


def _take(arr, idx):
    return jnp.take(arr, idx, axis=0)


# A type with at most this many padded lanes is reduced in one fusion on
# every backend. On the H100 at 2048^2 such 8-lane reductions compile in
# seconds, while one fusion over 56 or more lanes did not compile within
# 180 s (PERF.md "Routing").
ONE_REDUCTION_LANES = 8

# Per primitive type: its distance function and the scene fields it reads.
_SWEEPS = {
    "sph": (geo.sphere_distances_fast, ("sph_pos", "sph_c2", "sph_valid")),
    "pln": (
        geo.plane_distances_fast,
        ("pln_normal", "pln_ndotp", "pln_r0", "pln_r2", "pln_r0dotp",
         "pln_r2dotp", "pln_valid"),
    ),
    "tri": (
        geo.triangle_distances_fast,
        ("tri_cdet", "tri_edge0", "tri_edge1", "tri_cu", "tri_cv", "tri_n",
         "tri_adotn", "tri_valid"),
    ),
}


def _windows(scene: DeviceScene, kind: str):
    """This type's fields as (steps, width, ...) stacks for a windowed
    sweep, or None when it is reduced in one fusion: always where
    routing.sweep_window is None, and for a type of at most
    ONE_REDUCTION_LANES lanes. The width is the routing window, or half
    the lanes for a type with fewer than two windows' worth, so a scan
    always has at least two steps; the last window is padded with
    invalid rows, which never hit."""
    window = routing.sweep_window()
    fields = _SWEEPS[kind][1]
    lanes = getattr(scene, fields[-1]).shape[0]
    if window is None or lanes <= ONE_REDUCTION_LANES:
        return None
    width = window if lanes >= 2 * window else -(-lanes // 2)
    steps = -(-lanes // width)
    out = {}
    for f in fields:
        x = getattr(scene, f)
        pad = jnp.zeros((steps * width - lanes,) + x.shape[1:], x.dtype)
        out[f] = jnp.concatenate([x, pad]).reshape(
            (steps, width) + x.shape[1:]
        )
    return out


def _closest(scene: DeviceScene, kind: str, ro, rd):
    """(min t, argmin) over one primitive type. Windowed, it scans the
    lanes one window at a time and returns the same values and the same
    lowest-index tie-break as one argmin over all lanes: a later window
    wins only on a strictly smaller t."""
    dist = _SWEEPS[kind][0]
    windows = _windows(scene, kind)
    if windows is None:
        t = dist(ro, rd, scene)
        return jnp.min(t, axis=1), jnp.argmin(t, axis=1).astype(jnp.int32)
    n = ro.shape[0]
    width = next(iter(windows.values())).shape[1]

    def body(carry, w):
        best_t, best_i, base = carry
        t = dist(ro, rd, types.SimpleNamespace(**w))
        d = jnp.min(t, axis=1)
        i = jnp.argmin(t, axis=1).astype(jnp.int32) + base
        better = d < best_t
        return (
            jnp.where(better, d, best_t),
            jnp.where(better, i, best_i),
            base + width,
        ), None

    init = (jnp.full((n,), INF), jnp.zeros((n,), jnp.int32), jnp.int32(0))
    (d, i, _), _ = jax.lax.scan(body, init, windows)
    return d, i


def _any(scene: DeviceScene, kind: str, ro, rd):
    """True where any primitive of one type blocks the ray."""
    dist = _SWEEPS[kind][0]
    windows = _windows(scene, kind)
    if windows is None:
        return jnp.any(dist(ro, rd, scene) < INF, axis=1)

    def body(hit, w):
        t = dist(ro, rd, types.SimpleNamespace(**w))
        return hit | jnp.any(t < INF, axis=1), None

    hit, _ = jax.lax.scan(body, jnp.zeros((ro.shape[0],), bool), windows)
    return hit


def _sweep_xla(scene: DeviceScene, ro, rd):
    """(t, type, index) closest winner via the XLA broadcast sweep."""
    d_sph, i_sph = _closest(scene, "sph", ro, rd)
    d_pln, i_pln = _closest(scene, "pln", ro, rd)
    d_tri, i_tri = _closest(scene, "tri", ro, rd)

    dists = jnp.stack([d_sph, d_pln, d_tri], axis=1)
    which = jnp.argmin(dists, axis=1).astype(jnp.int32)
    t = jnp.min(dists, axis=1)
    ptype = jnp.where(t < INF, which, -1)
    pidx = jnp.where(
        which == 0, i_sph, jnp.where(which == 1, i_pln, i_tri)
    )
    return t, ptype, pidx


def _sweep_bvh(scene: DeviceScene, ro, rd):
    """(t, type, index) via the flat-BVH traversal (parity path with the
    reference's cast_ray_bvh node ordering), plus the reference's linear
    sphere+plane fallback when the BVH reports a miss
    (shader.wgsl:576-598 cast_ray) — this covers rays the conservative
    AABB test rejects (flat boxes hit edge-on produce NaN slab times
    which WGSL comparisons treat as a miss; see
    ops/geometry.py:ray_intersects_bounds)."""
    from rsoderh_raytracing_tpu.ops.bvh_traverse import traverse_closest

    t, slot = traverse_closest(scene, scene.bvh, ro, rd)
    hit = slot >= 0
    slot_safe = jnp.where(hit, slot, 0)
    ptype = jnp.where(
        hit, jnp.take(scene.bvh.prim_type, slot_safe), -1
    )
    pidx = jnp.take(scene.bvh.prim_index, slot_safe)
    t = jnp.where(hit, t, INF)

    # Linear fallback on BVH miss: spheres + planes only, like cast_ray.
    d_sph, i_sph = _closest(scene, "sph", ro, rd)
    d_pln, i_pln = _closest(scene, "pln", ro, rd)
    fb_t = jnp.minimum(d_sph, d_pln)
    fb_type = jnp.where(
        fb_t < INF, jnp.where(d_sph <= d_pln, 0, 1), -1
    )
    fb_idx = jnp.where(d_sph <= d_pln, i_sph, i_pln)

    use_fb = ~hit
    return (
        jnp.where(use_fb, fb_t, t),
        jnp.where(use_fb, fb_type, ptype),
        jnp.where(use_fb, fb_idx, pidx),
    )


def _sweep(scene: DeviceScene, ro, rd):
    if scene.bvh is not None:
        return _sweep_bvh(scene, ro, rd)
    return _sweep_xla(scene, ro, rd)


def _hit_attributes(scene: DeviceScene, ro, rd, t, ptype, pidx) -> HitRecord:
    """Reconstruct point/normal/material for the winning primitive."""
    did_hit = ptype >= 0
    t_safe = jnp.where(did_hit, t, 0.0)
    point = ro + rd * t_safe[:, None]

    idx_s = jnp.where(ptype == 0, pidx, 0)
    idx_p = jnp.where(ptype == 1, pidx, 0)
    idx_t = jnp.where(ptype == 2, pidx, 0)

    sph_normal = geo.sphere_normal(
        ro, point, _take(scene.sph_pos, idx_s), _take(scene.sph_radius, idx_s)
    )
    pln_normal = geo.plane_normal_for_ray(ro, _take(scene.pln_normal, idx_p))
    tri_normal = geo.triangle_hit_attributes(
        ro,
        rd,
        _take(scene.tri_a, idx_t),
        _take(scene.tri_edge0, idx_t),
        _take(scene.tri_edge1, idx_t),
        _take(scene.tri_n0, idx_t),
        _take(scene.tri_n1, idx_t),
        _take(scene.tri_n2, idx_t),
    )
    normal = jnp.where(
        (ptype == 0)[:, None],
        sph_normal,
        jnp.where((ptype == 1)[:, None], pln_normal, tri_normal),
    )
    material_id = jnp.where(
        ptype == 0,
        _take(scene.sph_material, idx_s),
        jnp.where(
            ptype == 1,
            _take(scene.pln_material, idx_p),
            _take(scene.tri_material, idx_t),
        ),
    )
    return HitRecord(
        did_hit=did_hit,
        distance=t_safe,
        point=point,
        normal=normal,
        material_id=material_id,
    )


def closest_hit(scene: DeviceScene, ro, rd) -> HitRecord:
    """Closest intersection along each ray. ro, rd: (N,3)."""
    t, ptype, pidx = _sweep(scene, ro, rd)
    return _hit_attributes(scene, ro, rd, t, ptype, pidx)


def trace_nee(scene: DeviceScene, ro, rd, nee_dir):
    """Per-segment trace for the wavefront integrator: closest hit,
    shading attributes + material values, and NEE occlusion from the hit
    point along `nee_dir`, composed from closest_hit / material takes /
    any_hit.

    Returns (did_hit (N,), point (N,3), normal (N,3), color (N,3),
    roughness (N,), metallic (N,), emission (N,3), occluded (N,))."""
    hit = closest_hit(scene, ro, rd)
    color = _take(scene.mat_color, hit.material_id)
    rough = _take(scene.mat_roughness, hit.material_id)
    metal = _take(scene.mat_metallic, hit.material_id)
    emission = _take(scene.mat_emission, hit.material_id)
    occ = any_hit(scene, hit.point, nee_dir)
    return (
        hit.did_hit,
        hit.point,
        hit.normal,
        color,
        rough,
        metal,
        emission,
        occ,
    )


def any_hit(scene: DeviceScene, ro, rd):
    """True where any primitive blocks the ray. ro, rd: (N,3) -> (N,) bool."""
    if scene.bvh is not None:
        # Occlusion uses cast_ray_bvh ONLY — no linear fallback
        # (shader.wgsl:1249), unlike closest-hit's cast_ray. The
        # early-exit walk returns the same boolean as
        # traverse_closest(...)[1] >= 0 (tested) in fewer lockstep
        # iterations.
        from rsoderh_raytracing_tpu.ops.bvh_traverse import traverse_any

        return traverse_any(scene, scene.bvh, ro, rd)
    return (
        _any(scene, "sph", ro, rd)
        | _any(scene, "pln", ro, rd)
        | _any(scene, "tri", ro, rd)
    )
