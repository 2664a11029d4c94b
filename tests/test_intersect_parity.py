"""Intersection parity: the composed dense sweep, the flat-BVH walk and
an independent numpy brute force agree, for closest hit and any hit.

The brute force is the numpy transcription of the reference shader's
per-primitive tests (scripts/reference_estimator.cast_ray), which
shares no code with ops/. The three use different f32 formulations
(expanded triple products, per-primitive naive forms), so a ray that
grazes an edge may round differently: agreement is held per ray to
a fraction, and exactly wherever the predicates are clear of their
thresholds (the adversarial occlusion tests)."""

import os
import sys

import numpy as np
import pytest

from rsoderh_raytracing_tpu.ops import geometry as geo
from rsoderh_raytracing_tpu.ops import intersect
from rsoderh_raytracing_tpu.ops.bvh_traverse import traverse_any
from rsoderh_raytracing_tpu.scene.camera import Camera
from rsoderh_raytracing_tpu.scene.device import build_device_scene
from rsoderh_raytracing_tpu.scene.types import (
    Material,
    PackedMeshes,
    Plane,
    Scene,
    Sphere,
)
from tests.conftest import ASSETS

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scripts.reference_estimator import cast_ray  # noqa: E402

F = np.float32
N_RAYS = 384
MATS = [
    Material((0.7, 0.3, 0.2), 0.5, 0.0, (0, 0, 0)),
    Material((0.9, 0.9, 0.9), 0.05, 1.0, (0, 0, 0)),
]


def oracle_scene(scene: Scene) -> dict:
    """scripts/reference_estimator.build_scene for an in-memory Scene."""
    spheres = [(np.asarray(s.pos, F), F(s.radius), s.material_id)
               for s in scene.spheres]
    planes = [(np.asarray(p.pos, F), np.asarray(p.normal(), F),
               np.asarray(p.base_change_matrix(), F), p.material_id)
              for p in scene.planes]
    tris = []
    v, nrm = scene.meshes.vertices, scene.meshes.normals
    for row in scene.meshes.triangles:
        a = v[row[0]].astype(F)
        tris.append((a, v[row[1]].astype(F) - a, v[row[2]].astype(F) - a,
                     nrm[row[3]].astype(F), nrm[row[4]].astype(F),
                     nrm[row[5]].astype(F), int(row[6])))
    return {"spheres": spheres, "planes": planes, "triangles": tris}


def _cloud_camera():
    return Camera(pos=[0, 0, 20], yaw=0, pitch=0, fov_y=1.2)


def plane_cloud():
    """Axis-aligned rectangles: the reference bounds a plane by its
    first and opposite corner only (src/scene.rs), which covers the
    whole rectangle only when it is axis-aligned, so the BVH route
    matches the dense brute force exactly on these."""
    rng = np.random.default_rng(21)
    axes = np.eye(3)
    planes = []
    for _ in range(60):
        i, k = rng.choice(3, size=2, replace=False)
        right = axes[i] * rng.uniform(2.0, 8.0) * rng.choice([-1, 1])
        fwd = axes[k] * rng.uniform(2.0, 8.0) * rng.choice([-1, 1])
        planes.append(Plane(pos=rng.uniform(-8, 8, 3), right=right,
                            forward=fwd, material_id=int(rng.integers(2))))
    return Scene(materials=MATS, spheres=[], planes=planes,
                 meshes=PackedMeshes.empty(), camera=_cloud_camera())


def sphere_cloud():
    rng = np.random.default_rng(7)
    spheres = [Sphere(pos=rng.uniform(-6.0, 6.0, 3),
                      radius=float(rng.uniform(0.3, 1.2)),
                      material_id=int(rng.integers(2)))
               for _ in range(200)]
    return Scene(materials=MATS, spheres=spheres, planes=[],
                 meshes=PackedMeshes.empty(), camera=_cloud_camera())


def _load(name):
    from rsoderh_raytracing_tpu import load_scene

    return load_scene(os.path.join(ASSETS, "scenes", f"{name}.toml"))


def mixed_scene():
    """suzanne's mesh plus a 200-sphere cloud around it."""
    suz = _load("suzanne")
    rng = np.random.default_rng(5)
    extra = [Sphere(pos=rng.uniform(-4.0, 4.0, 3),
                    radius=float(rng.uniform(0.1, 0.4)),
                    material_id=int(rng.integers(len(suz.materials))))
             for _ in range(200)]
    return Scene(materials=suz.materials, spheres=list(suz.spheres) + extra,
                 planes=suz.planes, meshes=suz.meshes, camera=suz.camera)


SCENES = {
    "house": lambda bt: _load("house"),
    "default": lambda bt: _load("default"),
    "suzanne": lambda bt: _load("suzanne"),
    "spheres": lambda bt: _load("spheres"),
    "big_tri": lambda bt: bt,
    "plane_cloud": lambda bt: plane_cloud(),
    "sphere_cloud": lambda bt: sphere_cloud(),
    "mixed": lambda bt: mixed_scene(),
}


def _rays(scene: Scene, seed: int):
    """Half camera rays into the view, half random rays from random
    origins in a box around the camera's target."""
    rng = np.random.default_rng(seed)
    cam = scene.camera
    half = N_RAYS // 2
    rot = cam.rot_transform()
    local = np.stack(
        [rng.uniform(-0.8, 0.8, half), rng.uniform(-0.8, 0.8, half),
         -np.ones(half)], axis=-1,
    )
    d_cam = local @ rot.T
    o_cam = np.broadcast_to(np.asarray(cam.pos, F), (half, 3))
    center = np.asarray(cam.pos) + rot @ np.array([0.0, 0.0, -5.0])
    o_rnd = center + rng.uniform(-4, 4, (N_RAYS - half, 3))
    d_rnd = rng.normal(size=(N_RAYS - half, 3))
    ro = np.concatenate([o_cam, o_rnd]).astype(F)
    rd = np.concatenate([d_cam, d_rnd]).astype(F)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


@pytest.fixture(scope="module")
def built(big_tri_scene):
    cache = {}

    def get(name):
        if name not in cache:
            scene = SCENES[name](big_tri_scene)
            cache[name] = (
                scene,
                build_device_scene(scene, with_bvh=False),
                build_device_scene(scene, with_bvh=True),
                oracle_scene(scene),
            )
        return cache[name]

    return get


def _tri_a(ds, ptype, pidx):
    """World position of each winner triangle's first corner (storage
    order differs between sweep and BVH scenes; corners do not)."""
    a = np.asarray(ds.tri_a)[np.where(ptype == 2, pidx, 0)]
    return np.where((ptype == 2)[:, None], a, 0.0)


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_sweep_bvh_oracle_agree(name, query, built):
    scene, ds_sweep, ds_bvh, oracle = built(name)
    assert ds_sweep.bvh is None and ds_bvh.bvh is not None
    ro, rd = _rays(scene, seed=sum(map(ord, name)))
    did, best_t, _, _, mat = cast_ray(oracle, ro, rd)
    assert 0.1 < did.mean() < 1.0, f"{did.mean():.3f} of rays hit"

    if query == "any":
        occ_sweep = np.asarray(intersect.any_hit(ds_sweep, ro, rd))
        occ_bvh = np.asarray(intersect.any_hit(ds_bvh, ro, rd))
        assert (occ_sweep == did).mean() >= 0.995
        assert (occ_bvh == did).mean() >= 0.995
        assert (occ_sweep == occ_bvh).mean() >= 0.995
        return

    t_s, ty_s, ix_s = map(np.asarray, intersect._sweep_xla(ds_sweep, ro, rd))
    t_b, ty_b, ix_b = map(np.asarray, intersect._sweep_bvh(ds_bvh, ro, rd))
    hit_s, hit_b = ty_s >= 0, ty_b >= 0
    assert (hit_s == did).mean() >= 0.995
    assert (hit_b == did).mean() >= 0.995
    both = hit_s & hit_b & did
    assert both.sum() >= 0.1 * N_RAYS
    # the same distance, primitive type and material on agreeing rays
    for t in (t_s, t_b):
        close = np.isclose(t[both], best_t[both], rtol=1e-4, atol=1e-5)
        assert close.mean() >= 0.99
    assert (ty_s[both] == ty_b[both]).mean() >= 0.995
    hs = intersect._hit_attributes(ds_sweep, ro, rd, t_s, ty_s, ix_s)
    hb = intersect._hit_attributes(ds_bvh, ro, rd, t_b, ty_b, ix_b)
    assert (np.asarray(hs.material_id)[both] == mat[both]).mean() >= 0.995
    assert (np.asarray(hb.material_id)[both] == mat[both]).mean() >= 0.995
    tri = both & (ty_s == 2) & (ty_b == 2)
    same_tri = np.all(
        _tri_a(ds_sweep, ty_s, ix_s)[tri] == _tri_a(ds_bvh, ty_b, ix_b)[tri],
        axis=-1,
    )
    assert same_tri.mean() >= 0.995 if tri.any() else True


# -- adversarial occlusion -------------------------------------------------


def _adversarial():
    """Triangles with dets straddling TRI_DET_EPS, exactly degenerate
    rows, and rays aimed at barycentric boundaries, t near TRI_T_EPS and
    along the axes. Returns (scene, ro, rd, a, e0, e1)."""
    rng = np.random.default_rng(11)
    n_tri, n_rays = 60, 256
    a = rng.normal(size=(n_tri, 3)).astype(F)
    e0 = rng.normal(size=(n_tri, 3)).astype(F)
    e1 = rng.normal(size=(n_tri, 3)).astype(F)
    e1[:8] = e0[:8] * (1.0 + rng.normal(size=(8, 3)).astype(F) * 1e-4)
    e1[8:12] = e0[8:12] * 2.0

    bu = rng.choice([0.0, 1.0, 0.5, -1e-4, 1e-4, 0.999, 1.001],
                    size=(n_rays, 1)) + rng.normal(size=(n_rays, 1)) * 1e-3
    bv = rng.choice([0.0, 0.5, -1e-4, 1e-4, 0.999],
                    size=(n_rays, 1)) + rng.normal(size=(n_rays, 1)) * 1e-3
    pick = rng.integers(0, n_tri, size=n_rays)
    target = (a[pick] + bu * e0[pick] + bv * e1[pick]).astype(F)
    o = rng.normal(size=(n_rays, 3)).astype(F) * 3.0
    o[:32] = target[:32] - np.array([0.0, 0.0, 1.0], F)
    d = (target - o).astype(F)
    d[-16:, 0] = 0.0
    d[-8:, 1] = 0.0
    d = (d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9))
    d = d.astype(F)
    o[32:64] = (target[32:64] - d[32:64] * F(geo.TRI_T_EPS) * rng.choice(
        [0.5, 0.99, 1.01, 2.0], size=(32, 1)).astype(F)).astype(F)

    vertices = np.concatenate([a, a + e0, a + e1]).astype(F)
    idx = np.arange(n_tri)
    tris = np.stack([idx, idx + n_tri, idx + 2 * n_tri]
                    + [np.zeros(n_tri, np.int64)] * 4, axis=-1)
    scene = Scene(
        materials=MATS[:1], spheres=[], planes=[],
        meshes=PackedMeshes(vertices=vertices,
                            normals=np.array([[0.0, 0.0, 1.0]], F),
                            triangles=tris.astype(np.int32)),
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.0),
    )
    # the edges as stored after the vertex round trip
    a_s, e0_s, e1_s = vertices[:n_tri], vertices[n_tri:2 * n_tri] - a, (
        vertices[2 * n_tri:] - a)
    return scene, o, d, a_s, e0_s, e1_s


def _occlusion_reference(o, d, a, e0, e1):
    """float64 Moller-Trumbore occlusion. Returns (occluded, decidable):
    a ray is decidable when it has a hit whose every predicate is
    clear of its threshold, or when no triangle could hit it even with
    each near-threshold predicate flipped. Within a narrow relative band
    of a threshold two f32 rounding routes may legally disagree, and so
    may the predicates of a near-degenerate triangle (|det| < 1e-3,
    where f32 cancellation leaves u, v and t few correct digits: their
    band is 0.5 wide)."""
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    a64, e064, e164 = (x.astype(np.float64) for x in (a, e0, e1))
    rel = o64[:, None, :] - a64[None]
    p0 = np.cross(rel, e064[None])
    p1 = np.cross(d64[:, None, :], e164[None])
    det = (e064[None] * p1).sum(-1)
    safe = np.where(np.abs(det) < 1e-300, 1.0, det)
    u = (rel * p1).sum(-1) / safe
    v = (d64[:, None, :] * p0).sum(-1) / safe
    t = (e164[None] * p0).sum(-1) / safe
    band = 1e-4
    ill = np.abs(det) < 1e-3

    def near(x, thresh, scale):
        gap = np.abs(x - thresh)
        return (gap <= band * scale) | (ill & (gap <= 0.5 * scale))

    preds = [
        (np.abs(det) >= geo.TRI_DET_EPS, ill),
        (u >= 0, near(u, 0.0, 1.0)),
        (u <= 1, near(u, 1.0, 1.0)),
        (v >= 0, near(v, 0.0, 1.0)),
        (u + v <= 1, near(u + v, 1.0, 1.0)),
        (t >= geo.TRI_T_EPS,
         near(t, geo.TRI_T_EPS, np.maximum(geo.TRI_T_EPS, np.abs(t)))),
    ]
    sure = np.logical_and.reduce([c & ~n for c, n in preds])
    possible = np.logical_and.reduce([c | n for c, n in preds])
    sure_hit, possible_hit = sure.any(axis=1), possible.any(axis=1)
    return sure_hit, sure_hit | ~possible_hit


@pytest.mark.parametrize("route", ["any_hit", "traverse_any"])
def test_adversarial_occlusion(route):
    scene, o, d, a, e0, e1 = _adversarial()
    ref, decidable = _occlusion_reference(o, d, a, e0, e1)
    if route == "any_hit":
        ds = build_device_scene(scene, with_bvh=False)
        got = np.asarray(intersect.any_hit(ds, o, d))
    else:
        ds = build_device_scene(scene, with_bvh=True)
        got = np.asarray(traverse_any(ds, ds.bvh, o, d))
    assert got.dtype == bool and got.shape == ref.shape
    assert ref.any() and not ref.all()
    assert decidable.mean() > 0.5  # the band must not swallow the test
    assert ref[decidable].any() and not ref[decidable].all()
    np.testing.assert_array_equal(got[decidable], ref[decidable])
