"""Batched ray-primitive intersection math.

All functions take a ray batch (origins (N,3), unit directions (N,3)) and
a padded primitive SoA, and return dense (N, P) hit matrices — the
vectorised formulation of the reference's per-thread primitive switch
(shader.wgsl:295-466): instead of one ray walking primitives with
branches, N rays test P primitives as one regular elementwise block that
XLA fuses.

Epsilon constants and tie-break/flip semantics are kept identical to the
reference so images agree at equal sample counts:
- sphere: EPS=1e-4 shadow-acne cutoff, robust quadratic, inside-sphere
  normal flip when |center-origin|^2 - r^2 < 1e-6 (shader.wgsl:295-360)
- plane: parallel cutoff |denom|<1e-4, t>=1e-3, unit-square bounds in
  plane space, normal flip by dot(origin, normal) < 0 — reproducing the
  reference's quirk of using the origin *position* (shader.wgsl:362-406)
- triangle: Moller-Trumbore with |det|<1e-8 parallel cutoff, t>=1e-5,
  barycentric normal interpolation, backface flip (shader.wgsl:409-466)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

INF = jnp.float32(3.0e38)

SPHERE_EPS = 1.0e-4
PLANE_DENOM_EPS = 1.0e-4
PLANE_T_EPS = 1.0e-3
TRI_DET_EPS = 1.0e-8
TRI_T_EPS = 1.0e-5


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Closest-hit result for a ray batch. All fields have leading dim N."""

    did_hit: Any  # (N,) bool
    distance: Any  # (N,) f32
    point: Any  # (N,3) f32
    normal: Any  # (N,3) f32
    material_id: Any  # (N,) i32


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def sphere_distances(ro, rd, sph_pos, sph_radius, sph_valid):
    """Hit distances (N,S); INF where missed. Matches shader.wgsl:295-333."""
    # l = o - c per (ray, sphere) pair
    l = ro[:, None, :] - sph_pos[None, :, :]  # noqa: E741
    a = _dot(rd, rd)[:, None]  # (N,1); directions are unit but keep the term
    b = 2.0 * _dot(rd[:, None, :], l)  # (N,S)
    c = _dot(l, l) - (sph_radius * sph_radius)[None, :]

    disc = b * b - 4.0 * a * c
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b > 0, -0.5 * (b + sqrt_disc), -0.5 * (b - sqrt_disc))
    safe_q = jnp.where(q == 0.0, 1.0, q)
    t0 = q / a
    t1 = c / safe_q
    t = jnp.where(
        t0 < SPHERE_EPS, t1, jnp.where(t1 < SPHERE_EPS, t0, jnp.minimum(t0, t1))
    )
    # disc == 0 -> single root (shader.wgsl:308-309)
    t = jnp.where(disc == 0.0, -0.5 * b / a, t)

    hit = (disc >= 0.0) & (t >= SPHERE_EPS) & sph_valid[None, :]
    return jnp.where(hit, t, INF)


def sphere_normal(ro, point, center, radius):
    """Outward normal, flipped when the origin is (nearly) inside.

    Per-ray gathered variant: all args are (N,3) / (N,).
    """
    normal = point - center
    normal = normal / jnp.linalg.norm(normal, axis=-1, keepdims=True)
    inside = _dot(center - ro, center - ro) - radius * radius < 1.0e-6
    return jnp.where(inside[..., None], -normal, normal)


def plane_distances(ro, rd, pln_pos, pln_normal, pln_bcm, pln_valid):
    """Hit distances (N,P); INF where missed. Matches shader.wgsl:362-391."""
    denom = _dot(pln_normal[None, :, :], rd[:, None, :])  # (N,P)
    not_parallel = jnp.abs(denom) >= PLANE_DENOM_EPS
    safe_denom = jnp.where(not_parallel, denom, 1.0)
    t = _dot(pln_normal[None, :, :], pln_pos[None, :, :] - ro[:, None, :])
    t = t / safe_denom
    inter = ro[:, None, :] + rd[:, None, :] * t[..., None]  # (N,P,3)
    local = inter - pln_pos[None, :, :]
    # plane-space coords: bcm (P,3,3) @ local (N,P,3)
    plane_space = jnp.einsum(
        "pij,npj->npi", pln_bcm, local, precision=jax.lax.Precision.HIGHEST
    )
    in_bounds = (
        (plane_space[..., 0] >= 0.0)
        & (plane_space[..., 0] <= 1.0)
        & (plane_space[..., 2] >= 0.0)
        & (plane_space[..., 2] <= 1.0)
    )
    hit = not_parallel & (t >= PLANE_T_EPS) & in_bounds & pln_valid[None, :]
    return jnp.where(hit, t, INF)


def plane_normal_for_ray(ro, normal):
    """Reference quirk: flip when dot(origin, normal) < 0
    (shader.wgsl:393-397 — uses the origin position, not the direction)."""
    flip = _dot(ro, normal) < 0.0
    return jnp.where(flip[..., None], -normal, normal)


def triangle_distances(ro, rd, tri_a, tri_edge0, tri_edge1, tri_valid):
    """Hit distances (N,T); INF where missed. Moller-Trumbore
    (shader.wgsl:409-444). Returns only t; barycentrics are recomputed
    for the winning triangle by `triangle_hit_attributes`."""
    rel = ro[:, None, :] - tri_a[None, :, :]  # (N,T,3) o - a
    p0 = jnp.cross(rel, tri_edge0[None, :, :])  # cross(o-a, e0)
    p1 = jnp.cross(rd[:, None, :], jnp.broadcast_to(tri_edge1[None, :, :], rel.shape))
    det = _dot(tri_edge0[None, :, :], p1)
    ok = jnp.abs(det) >= TRI_DET_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    u = _dot(rel, p1) * inv_det
    v = _dot(rd[:, None, :], p0) * inv_det
    t = _dot(tri_edge1[None, :, :], p0) * inv_det
    hit = (
        ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= TRI_T_EPS)
        & tri_valid[None, :]
    )
    return jnp.where(hit, t, INF)


def triangle_hit_attributes(ro, rd, a, e0, e1, n0, n1, n2):
    """Recompute barycentrics + interpolated normal for gathered winners.

    All args are per-ray (N,3). Returns the shading normal with backface
    flip (shader.wgsl:447-457).
    """
    rel = ro - a
    p0 = jnp.cross(rel, e0)
    p1 = jnp.cross(rd, e1)
    det = _dot(e0, p1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < TRI_DET_EPS, 1.0, det)
    u = _dot(rel, p1) * inv_det
    v = _dot(rd, p0) * inv_det
    normal = (1.0 - u - v)[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1.0e-20
    )
    backface = _dot(normal, rd) > 0.0
    return jnp.where(backface[..., None], -normal, normal)


# -- fast sweep formulation ---------------------------------------------------
#
# The naive formulations above broadcast (N,P,3) vectors; for the hot
# loop we expand every triple product into sums of PER-RAY features
# (o, d, m = o x d, |o|^2, d.o, d.d) times PER-PRIMITIVE constants
# precomputed in scene/device.py. The sweep is then pure
# (N,1) * (1,K) broadcast arithmetic that XLA fuses into the closest-hit
# reduction with no 3-vector intermediates. Derivations:
#   det    = d . (e1 x e0)
#   u*det  = (o x d) . e1 + d . (a x e1)
#   v*det  = -((o x d) . e0 + d . (a x e0))
#   t*det  = o . n - a . n,   n = e0 x e1


def _bdot(a, b_cols):
    """(N,3) x (K,3) -> (N,K) as three fused broadcast FMAs."""
    return (
        a[:, 0:1] * b_cols[None, :, 0]
        + a[:, 1:2] * b_cols[None, :, 1]
        + a[:, 2:3] * b_cols[None, :, 2]
    )


def sphere_distances_fast(ro, rd, scene):
    """Same result as sphere_distances, via the expanded formulation."""
    a = jnp.sum(rd * rd, axis=-1, keepdims=True)  # (N,1)
    d_dot_o = jnp.sum(rd * ro, axis=-1, keepdims=True)
    o_dot_o = jnp.sum(ro * ro, axis=-1, keepdims=True)
    b = 2.0 * (d_dot_o - _bdot(rd, scene.sph_pos))  # (N,S)
    c = o_dot_o - 2.0 * _bdot(ro, scene.sph_pos) + scene.sph_c2[None, :]

    disc = b * b - 4.0 * a * c
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b > 0, -0.5 * (b + sqrt_disc), -0.5 * (b - sqrt_disc))
    t0 = q / a
    t1 = c / jnp.where(q == 0.0, 1.0, q)
    t = jnp.where(
        t0 < SPHERE_EPS, t1, jnp.where(t1 < SPHERE_EPS, t0, jnp.minimum(t0, t1))
    )
    t = jnp.where(disc == 0.0, -0.5 * b / a, t)
    hit = (disc >= 0.0) & (t >= SPHERE_EPS) & scene.sph_valid[None, :]
    return jnp.where(hit, t, INF)


def plane_distances_fast(ro, rd, scene):
    """Same result as plane_distances, via the expanded formulation."""
    denom = _bdot(rd, scene.pln_normal)  # (N,P)
    ok = jnp.abs(denom) >= PLANE_DENOM_EPS
    t = (scene.pln_ndotp[None, :] - _bdot(ro, scene.pln_normal)) / jnp.where(
        ok, denom, 1.0
    )
    # plane-space x and z of (o + t d - p) via precomputed bcm rows
    px = (
        _bdot(ro, scene.pln_r0)
        + t * _bdot(rd, scene.pln_r0)
        - scene.pln_r0dotp[None, :]
    )
    pz = (
        _bdot(ro, scene.pln_r2)
        + t * _bdot(rd, scene.pln_r2)
        - scene.pln_r2dotp[None, :]
    )
    in_bounds = (px >= 0.0) & (px <= 1.0) & (pz >= 0.0) & (pz <= 1.0)
    hit = ok & (t >= PLANE_T_EPS) & in_bounds & scene.pln_valid[None, :]
    return jnp.where(hit, t, INF)


def triangle_distances_fast(ro, rd, scene):
    """Same result as triangle_distances, via the expanded formulation."""
    m = jnp.cross(ro, rd)  # (N,3)
    det = _bdot(rd, scene.tri_cdet)  # (N,T)
    ok = jnp.abs(det) >= TRI_DET_EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    u = (_bdot(m, scene.tri_edge1) + _bdot(rd, scene.tri_cu)) * inv
    v = -(_bdot(m, scene.tri_edge0) + _bdot(rd, scene.tri_cv)) * inv
    t = (_bdot(ro, scene.tri_n) - scene.tri_adotn[None, :]) * inv
    hit = (
        ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= TRI_T_EPS)
        & scene.tri_valid[None, :]
    )
    return jnp.where(hit, t, INF)


def ray_intersects_bounds(ro, rd_inv, bounds_min, bounds_max):
    """Slab AABB test with t in [0, inf), no t_max pruning
    (shader.wgsl:262-293), with one DELIBERATE deviation on NaN axes:

    A slab time goes NaN only when the origin sits exactly on a slab
    plane with a +-0.0 direction component (0 * inf). WGSL's min/max
    return the non-NaN operand, so when the OTHER slab time is -inf the
    reference REJECTS the box — dropping hits on primitives lying in
    that boundary plane (its linear fallback then recovers spheres and
    planes but not triangles). Here a NaN axis is ignored entirely
    (neutral elements for the max/min reductions), a CONSERVATIVE
    accept: the chunk-cull users require never skipping a chunk the
    dense sweep would hit, and in BVH mode this finds boundary-plane
    hits the reference misses — a measure-zero divergence (exact
    face-coincident origins only) outside the documented fma class.

    ro, rd_inv: (..., 3); bounds_*: (..., 3) broadcastable. Returns bool.
    """
    hit, _ = ray_bounds_entry(ro, rd_inv, bounds_min, bounds_max)
    return hit


def ray_bounds_entry(ro, rd_inv, bounds_min, bounds_max):
    """ray_intersects_bounds plus the slab ENTRY time t0 (max over axes,
    clamped at 0; NaN axes ignored — identical semantics). t0 lower-
    bounds the t of every hit inside the box, so a traversal holding a
    best-t may skip boxes with t0 > best_t without changing its result
    (strict `<` winner updates: a tied-at-entry box can only produce
    non-winning ties). Returns (hit bool, t0)."""
    t_near = (bounds_min - ro) * rd_inv
    t_far = (bounds_max - ro) * rd_inv
    lo = jnp.minimum(t_near, t_far)
    hi = jnp.maximum(t_near, t_far)
    # NaN handling: WGSL comparisons with NaN are false, so an axis whose
    # slab times are NaN (0 * inf) never updates t0/t1 — i.e. the axis is
    # ignored. jnp.minimum/maximum propagate NaN, so replace NaN with the
    # neutral elements of the max/min reductions.
    t0 = jnp.max(jnp.where(jnp.isnan(lo), 0.0, jnp.maximum(lo, 0.0)), axis=-1)
    t1 = jnp.min(jnp.where(jnp.isnan(hi), INF, hi), axis=-1)
    return t0 <= t1, t0
