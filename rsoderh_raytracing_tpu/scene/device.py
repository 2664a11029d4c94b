"""DeviceScene: the scene as a pytree of padded SoA device arrays.

This is the device-side counterpart of the reference's GPU storage
buffers (src/state.rs:394-458): materials / spheres / planes / triangle
data, plus the flattened BVH arrays. Unlike the reference (which keeps
triangles as index triplets into vertex/normal pools and gathers in the
kernel), we dereference indices on the host into dense per-triangle SoA
arrays — gather-free and static-shape.

Every primitive array is padded to a multiple of `pad_to` lanes with a
boolean valid mask so shapes stay static under jit regardless of scene
size.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from rsoderh_raytracing_tpu import routing
from rsoderh_raytracing_tpu.scene.types import Scene

# Padding layout. Scenes whose padded sphere + plane + triangle lanes
# exceed MAX_UNROLL_PRIMS pad triangles (and, when spheres alone would
# overflow, spheres) to whole TRI_CHUNK windows, and their triangles are
# stored in a spatially clustered order. The values are fixed: they
# decide the device arrays' shapes and storage order, and the CPU goldens
# are pinned to exactly these arrays.
TRI_CHUNK = 64
MAX_UNROLL_PRIMS = 192


def _pad_rows(arr: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    """Pad axis 0 of `arr` to length n with `fill`."""
    if arr.shape[0] == n:
        return arr
    pad_shape = (n - arr.shape[0],) + arr.shape[1:]
    return np.concatenate(
        [arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0
    )


def _round_up(x: int, multiple: int) -> int:
    return max(multiple, -(-x // multiple) * multiple)


def _morton_order(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Stable argsort of triangles along a 30-bit 3D Morton curve of
    their centroids (10 bits/axis over the mesh bounds)."""
    cent = (
        vertices[tris[:, 0]] + vertices[tris[:, 1]] + vertices[tris[:, 2]]
    ) / 3.0
    lo = cent.min(axis=0)
    span = cent.max(axis=0) - lo
    span[span == 0] = 1.0
    q = np.clip((cent - lo) / span * 1023.0, 0, 1023).astype(np.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceScene:
    # materials (M, ...)
    mat_color: Any
    mat_roughness: Any
    mat_metallic: Any
    mat_emission: Any
    # spheres (S, ...)
    sph_pos: Any
    sph_radius: Any
    sph_material: Any
    sph_valid: Any
    # planes (P, ...)
    pln_pos: Any
    pln_normal: Any
    pln_bcm: Any  # (P, 3, 3) inverse change-of-basis matrix
    pln_material: Any
    pln_valid: Any
    # triangles (T, ...), fully dereferenced
    tri_a: Any  # corner 0 position
    tri_edge0: Any  # b - a
    tri_edge1: Any  # c - a
    tri_n0: Any
    tri_n1: Any
    tri_n2: Any
    tri_material: Any
    tri_valid: Any
    # --- precomputed intersection constants (see ops/geometry.py) -------
    # The Moller-Trumbore triple products expand into sums of per-ray
    # features (o, d, o x d) times these per-primitive constants, so the
    # hot sweep is pure (N,1)x(1,K) broadcast math with no (N,K,3)
    # intermediates.
    sph_c2: Any  # (S,) |c|^2 - r^2
    pln_ndotp: Any  # (P,) n . pos
    pln_r0: Any  # (P,3) bcm row 0 (plane-space x)
    pln_r2: Any  # (P,3) bcm row 2 (plane-space z)
    pln_r0dotp: Any  # (P,)
    pln_r2dotp: Any  # (P,)
    tri_cdet: Any  # (T,3) e1 x e0        (det = d . cdet)
    tri_cu: Any  # (T,3) a x e1           (u*det = m.e1 + d.cu)
    tri_cv: Any  # (T,3) a x e0           (v*det = -(m.e0 + d.cv))
    tri_n: Any  # (T,3) e0 x e1           (t*det = o.n - adotn)
    tri_adotn: Any  # (T,)
    # Optional flattened BVH (ops/bvh_traverse.DeviceBVH) — present when
    # built with with_bvh=True; selects the BVH-guided intersector.
    bvh: Any = None

    @property
    def num_sphere_lanes(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def num_plane_lanes(self) -> int:
        return self.pln_valid.shape[0]

    @property
    def num_triangle_lanes(self) -> int:
        return self.tri_valid.shape[0]


def build_device_scene(
    scene: Scene, pad_to: int = 8, with_bvh: "bool | str" = False
) -> DeviceScene:
    """Flatten + pad a host Scene into a DeviceScene of jnp arrays.

    with_bvh=True additionally builds the flat SAH BVH (accel/bvh.py)
    and attaches it, selecting the BVH-guided traversal intersector
    (ops/bvh_traverse.py) instead of the dense sweep. with_bvh="auto"
    attaches it when the padded triangle lane count passes the
    backend's measured crossover (routing.attach_bvh): the dense sweep
    is O(P) per ray, while the reference is O(log P) at any scene size
    through its per-thread BVH (shader.wgsl:469-564)."""
    materials = scene.materials or []
    m = max(1, len(materials))
    mat_color = np.zeros((m, 3), np.float32)
    mat_roughness = np.zeros((m,), np.float32)
    mat_metallic = np.zeros((m,), np.float32)
    mat_emission = np.zeros((m, 3), np.float32)
    for i, mat in enumerate(materials):
        mat_color[i] = mat.color
        mat_roughness[i] = mat.roughness
        mat_metallic[i] = mat.metallic
        mat_emission[i] = mat.emission

    # Spheres. Mirror the triangle chunk-padding rule below: when the
    # sphere+plane lanes would overflow MAX_UNROLL_PRIMS, pad spheres to
    # whole TRI_CHUNK windows.
    s_n = _round_up(len(scene.spheres), pad_to)
    p_n_probe = _round_up(len(scene.planes), pad_to)
    if (
        len(scene.spheres) > 0
        and s_n + p_n_probe + TRI_CHUNK > MAX_UNROLL_PRIMS
        and p_n_probe + TRI_CHUNK <= MAX_UNROLL_PRIMS
    ):
        s_n = _round_up(len(scene.spheres), TRI_CHUNK)
    sph_pos = np.zeros((s_n, 3), np.float32)
    sph_radius = np.zeros((s_n,), np.float32)
    sph_material = np.zeros((s_n,), np.int32)
    sph_valid = np.zeros((s_n,), bool)
    for i, sph in enumerate(scene.spheres):
        sph_pos[i] = sph.pos
        sph_radius[i] = sph.radius
        sph_material[i] = sph.material_id
        sph_valid[i] = True
    if len(scene.spheres):
        # Park trailing invalid (padded) spheres AT the last real
        # sphere's center (radius 0) rather than the origin, so a padded
        # row never stretches a spatial bound of the sphere arrays.
        # Correctness is unaffected either way — sph_valid masks padded
        # rows out of every sweep.
        sph_pos[len(scene.spheres):] = sph_pos[len(scene.spheres) - 1]

    # Planes
    p_n = _round_up(len(scene.planes), pad_to)
    pln_pos = np.zeros((p_n, 3), np.float32)
    pln_normal = np.zeros((p_n, 3), np.float32)
    pln_bcm = np.zeros((p_n, 3, 3), np.float32)
    pln_material = np.zeros((p_n,), np.int32)
    pln_valid = np.zeros((p_n,), bool)
    for i, pln in enumerate(scene.planes):
        pln_pos[i] = pln.pos
        pln_normal[i] = pln.normal()
        pln_bcm[i] = pln.base_change_matrix()
        pln_material[i] = pln.material_id
        pln_valid[i] = True

    # Triangles: dereference vertex/normal indices into dense SoA.
    # Pad to TRI_CHUNK whenever the TOTAL padded lane count exceeds
    # MAX_UNROLL_PRIMS; the clustered storage order below uses the same
    # gate.
    tris = scene.meshes.triangles
    import os as _os

    total_small = s_n + p_n + _round_up(len(tris), pad_to)

    if with_bvh == "auto":
        # Probe the final triangle lane count under the tri_pad rule
        # below, then ask the backend's routing entry.
        t_probe = _round_up(
            len(tris),
            pad_to if total_small <= MAX_UNROLL_PRIMS else TRI_CHUNK,
        )
        with_bvh = routing.attach_bvh(t_probe)
    tri_explicit_valid = None
    if (
        total_small > MAX_UNROLL_PRIMS
        and len(tris) > 0
        and not with_bvh
        and _os.environ.get("RT_DISABLE_MORTON") != "1"
    ):
        # (Skipped when a BVH is attached: accel/bvh.py's leaf primitive
        # indices refer to the host scene's triangle order — the BVH
        # traversal validation path must keep slot i == host triangle i.)
        # Chunk-padded scenes: cluster triangles so each TRI_CHUNK window
        # is spatially compact. Pure storage-order changes: the closest
        # hit is a min over the same set; only exact-tie winners
        # (measure-zero) can differ.
        # RT_CHUNK_CLUSTER picks the order (scene/cluster.py):
        #   morton  - centroid Morton curve (default)
        #   bvh     - SAH-BVH depth-first leaf order (chunk sumSA -9%
        #             on suzanne_hi, -18% on suzanne_xhi, free)
        #   treelet - SAH subtree cuts padded to whole chunks (per-chunk
        #             sumSA 2.2-3.1x tighter, ~40% more chunks; pad rows
        #             are unhittable det==0 degenerates)
        cluster = _os.environ.get("RT_CHUNK_CLUSTER", "morton")
        if cluster == "morton":
            tris = tris[_morton_order(scene.meshes.vertices, tris)]
        elif cluster == "bvh":
            from rsoderh_raytracing_tpu.scene.cluster import bvh_dfs_order

            tris = tris[bvh_dfs_order(scene.meshes.vertices, tris)]
        elif cluster == "treelet":
            from rsoderh_raytracing_tpu.scene.cluster import treelet_pack

            tris, tri_explicit_valid = treelet_pack(
                scene.meshes.vertices, tris, TRI_CHUNK
            )
        else:
            raise ValueError(
                f"RT_CHUNK_CLUSTER={cluster!r}: expected morton|bvh|treelet"
            )

    tri_pad = pad_to if total_small <= MAX_UNROLL_PRIMS else TRI_CHUNK
    t_n = _round_up(len(tris), tri_pad)
    tri_a = np.zeros((t_n, 3), np.float32)
    tri_edge0 = np.zeros((t_n, 3), np.float32)
    tri_edge1 = np.zeros((t_n, 3), np.float32)
    tri_n0 = np.zeros((t_n, 3), np.float32)
    tri_n1 = np.zeros((t_n, 3), np.float32)
    tri_n2 = np.zeros((t_n, 3), np.float32)
    tri_material = np.zeros((t_n,), np.int32)
    tri_valid = np.zeros((t_n,), bool)
    if len(tris):
        v = scene.meshes.vertices
        n = scene.meshes.normals
        a = v[tris[:, 0]]
        b = v[tris[:, 1]]
        c = v[tris[:, 2]]
        tri_a[: len(tris)] = a
        tri_edge0[: len(tris)] = b - a
        tri_edge1[: len(tris)] = c - a
        tri_n0[: len(tris)] = n[tris[:, 3]]
        tri_n1[: len(tris)] = n[tris[:, 4]]
        tri_n2[: len(tris)] = n[tris[:, 5]]
        tri_material[: len(tris)] = tris[:, 6]
        # treelet_pack emits in-chunk pad rows (collapsed to a single
        # vertex, det == 0, unhittable) interleaved with real triangles;
        # its explicit mask replaces the tail-only True fill.
        if tri_explicit_valid is not None:
            tri_valid[: len(tris)] = tri_explicit_valid
        else:
            tri_valid[: len(tris)] = True

    # Precompute intersection constants. sph_c2 uses float64 (the
    # |c|^2 - r^2 cancellation is precision-sensitive); the triangle
    # cross products stay in f32 — every sweep consumes the same f32
    # constants, so the sweep is self-consistent.
    sph_c2 = (sph_pos.astype(np.float64) ** 2).sum(-1) - (
        sph_radius.astype(np.float64) ** 2
    )
    pln_ndotp = (pln_normal * pln_pos).sum(-1)
    pln_r0 = pln_bcm[:, 0, :]
    pln_r2 = pln_bcm[:, 2, :]
    pln_r0dotp = (pln_r0 * pln_pos).sum(-1)
    pln_r2dotp = (pln_r2 * pln_pos).sum(-1)
    tri_cdet = np.cross(tri_edge1, tri_edge0)
    tri_cu = np.cross(tri_a, tri_edge1)
    tri_cv = np.cross(tri_a, tri_edge0)
    tri_n = np.cross(tri_edge0, tri_edge1)
    tri_adotn = (tri_a * tri_n).sum(-1)

    device_bvh = None
    if with_bvh:
        from rsoderh_raytracing_tpu.accel.bvh import build_bvh
        from rsoderh_raytracing_tpu.ops import bvh_traverse

        device_bvh = bvh_traverse.device_bvh(build_bvh(scene))

    as_jnp = lambda x: jnp.asarray(x)  # noqa: E731
    return DeviceScene(
        bvh=device_bvh,
        sph_c2=as_jnp(sph_c2.astype(np.float32)),
        pln_ndotp=as_jnp(pln_ndotp.astype(np.float32)),
        pln_r0=as_jnp(pln_r0.astype(np.float32)),
        pln_r2=as_jnp(pln_r2.astype(np.float32)),
        pln_r0dotp=as_jnp(pln_r0dotp.astype(np.float32)),
        pln_r2dotp=as_jnp(pln_r2dotp.astype(np.float32)),
        tri_cdet=as_jnp(tri_cdet.astype(np.float32)),
        tri_cu=as_jnp(tri_cu.astype(np.float32)),
        tri_cv=as_jnp(tri_cv.astype(np.float32)),
        tri_n=as_jnp(tri_n.astype(np.float32)),
        tri_adotn=as_jnp(tri_adotn.astype(np.float32)),
        mat_color=as_jnp(mat_color),
        mat_roughness=as_jnp(mat_roughness),
        mat_metallic=as_jnp(mat_metallic),
        mat_emission=as_jnp(mat_emission),
        sph_pos=as_jnp(sph_pos),
        sph_radius=as_jnp(sph_radius),
        sph_material=as_jnp(sph_material),
        sph_valid=as_jnp(sph_valid),
        pln_pos=as_jnp(pln_pos),
        pln_normal=as_jnp(pln_normal),
        pln_bcm=as_jnp(pln_bcm),
        pln_material=as_jnp(pln_material),
        pln_valid=as_jnp(pln_valid),
        tri_a=as_jnp(tri_a),
        tri_edge0=as_jnp(tri_edge0),
        tri_edge1=as_jnp(tri_edge1),
        tri_n0=as_jnp(tri_n0),
        tri_n1=as_jnp(tri_n1),
        tri_n2=as_jnp(tri_n2),
        tri_material=as_jnp(tri_material),
        tri_valid=as_jnp(tri_valid),
    )
