"""BVH builder invariants + traversal parity against brute force."""

import numpy as np
import pytest

from rsoderh_raytracing_tpu.accel.bvh import (
    MAX_PRIMITIVES_PER_LEAF,
    build_bvh,
    scene_primitive_bounds,
    validate_bvh,
)
from rsoderh_raytracing_tpu.ops import intersect
from rsoderh_raytracing_tpu.ops.bvh_traverse import device_bvh, traverse_closest
from rsoderh_raytracing_tpu.scene.device import build_device_scene


def test_build_default_scene(default_scene):
    bvh = build_bvh(default_scene)
    mins, maxs, types, indices = scene_primitive_bounds(default_scene)
    assert bvh.num_primitives == 23  # 10 spheres + 1 plane + 12 tris
    validate_bvh(bvh, mins, maxs)
    assert (bvh.node_count <= MAX_PRIMITIVES_PER_LEAF).all()
    # Interior second-child links point forward in the flat array.
    interior = bvh.node_count == 0
    assert (bvh.node_payload[interior] > np.nonzero(interior)[0]).all()


def test_build_house_scene(house_scene):
    bvh = build_bvh(house_scene)
    mins, maxs, _, _ = scene_primitive_bounds(house_scene)
    assert bvh.num_primitives == 56  # 2 spheres + 2 planes + 52 tris
    validate_bvh(bvh, mins, maxs)


def test_traversal_matches_brute_force(house_scene):
    ds = build_device_scene(house_scene)
    bvh = device_bvh(build_bvh(house_scene))

    rng = np.random.default_rng(0)
    n = 512
    ro = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    ro[:, 1] = rng.uniform(0.2, 5, size=n)  # above ground
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    brute = intersect.closest_hit(ds, ro, rd)
    t_bvh, slot = traverse_closest(ds, bvh, ro, rd)

    t_bvh = np.asarray(t_bvh)
    brute_t = np.asarray(brute.distance)
    brute_hit = np.asarray(brute.did_hit)
    bvh_hit = np.asarray(slot) >= 0

    # Rays whose direction is exactly axis-parallel can differ (the
    # reference's flat-AABB quirk); random directions avoid that.
    np.testing.assert_array_equal(bvh_hit, brute_hit)
    np.testing.assert_allclose(
        t_bvh[bvh_hit], brute_t[brute_hit], rtol=1e-4, atol=1e-4
    )


def test_traversal_random_sphere_cloud():
    """Random sphere-only scene: BVH closest-hit == brute force."""
    from rsoderh_raytracing_tpu.scene.camera import Camera
    from rsoderh_raytracing_tpu.scene.types import (
        Material,
        PackedMeshes,
        Scene,
        Sphere,
    )

    rng = np.random.default_rng(1)
    spheres = [
        Sphere(
            pos=rng.uniform(-10, 10, 3),
            radius=float(rng.uniform(0.1, 1.0)),
            material_id=0,
        )
        for _ in range(100)
    ]
    scene = Scene(
        materials=[Material((1, 1, 1), 1, 0, (0, 0, 0))],
        spheres=spheres,
        planes=[],
        meshes=PackedMeshes.empty(),
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.0),
    )
    ds = build_device_scene(scene)
    bvh = device_bvh(build_bvh(scene))

    n = 256
    ro = rng.uniform(-12, 12, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    brute = intersect.closest_hit(ds, ro, rd)
    t_bvh, slot = traverse_closest(ds, bvh, ro, rd)
    np.testing.assert_array_equal(
        np.asarray(slot) >= 0, np.asarray(brute.did_hit)
    )
    hit = np.asarray(brute.did_hit)
    np.testing.assert_allclose(
        np.asarray(t_bvh)[hit], np.asarray(brute.distance)[hit],
        rtol=1e-4, atol=1e-4,
    )


def test_traverse_any_equals_closest_hit_bool(house_scene, assets_dir):
    """The early-exit occlusion walk returns exactly
    traverse_closest(...)[1] >= 0 on mixed scenes (house: spheres +
    planes + triangles in one tree) and pure-mesh trees (suzanne —
    which also exercises the static leaf-type specialization: its BVH
    compiles only the triangle test lane)."""
    import os

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.ops.bvh_traverse import traverse_any

    suz = load_scene(os.path.join(assets_dir, "scenes", "suzanne.toml"))
    for scene in (house_scene, suz):
        ds = build_device_scene(scene)
        bvh = device_bvh(build_bvh(scene))
        rng = np.random.default_rng(11)
        n = 512
        ro = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
        rd = rng.normal(size=(n, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        # axis-parallel + from-inside rays too
        rd[:16] = 0.0
        rd[0:8, 0] = 1.0
        rd[8:16, 1] = -1.0
        ro[16:24] = 0.0

        _, slot = traverse_closest(ds, bvh, ro, rd)
        occ = traverse_any(ds, bvh, ro, rd)
        np.testing.assert_array_equal(
            np.asarray(occ), np.asarray(slot) >= 0
        )


def test_deep_bvh_many_primitives(assets_dir):
    """Suzanne (968 tris): build + validate + spot-check traversal."""
    import os

    from rsoderh_raytracing_tpu.scene.camera import Camera
    from rsoderh_raytracing_tpu.scene.mesh import load_obj
    from rsoderh_raytracing_tpu.scene.types import Material, Scene

    with open(os.path.join(assets_dir, "suzanne.obj")) as f:
        mesh = load_obj(f.read(), 0)
    scene = Scene(
        materials=[Material((1, 1, 1), 1, 0, (0, 0, 0))],
        spheres=[],
        planes=[],
        meshes=mesh,
        camera=Camera(pos=[0, 0, 3], yaw=0, pitch=0, fov_y=1.0),
    )
    bvh = build_bvh(scene)
    mins, maxs, _, _ = scene_primitive_bounds(scene)
    assert bvh.num_primitives == 968
    validate_bvh(bvh, mins, maxs)
    assert bvh.depth < 64  # must fit the traversal stack

    # with_bvh keeps device triangle slots in host order (the leaf
    # primitive indices refer to it); without it, chunked-path scenes
    # are Morton-reordered and an externally built BVH would mismatch.
    ds = build_device_scene(scene, with_bvh=True)
    dbvh = ds.bvh
    rng = np.random.default_rng(2)
    n = 128
    ro = np.tile(np.float32([0, 0, 3]), (n, 1))
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 2] -= 1.5  # bias toward the mesh
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    brute = intersect.closest_hit(ds, ro, rd)
    t_bvh, slot = traverse_closest(ds, dbvh, ro, rd)
    np.testing.assert_array_equal(
        np.asarray(slot) >= 0, np.asarray(brute.did_hit)
    )
    hit = np.asarray(brute.did_hit)
    assert hit.sum() > 10
    np.testing.assert_allclose(
        np.asarray(t_bvh)[hit], np.asarray(brute.distance)[hit],
        rtol=1e-4, atol=1e-4,
    )


def test_bvh_intersector_end_to_end(house_scene, tiny_env):
    """Renders via the BVH backend match the dense-sweep backend."""
    import numpy as np

    from rsoderh_raytracing_tpu.render.integrator import (
        camera_pytree,
        render_sample,
    )

    ds_sweep = build_device_scene(house_scene)
    ds_bvh = build_device_scene(house_scene, with_bvh=True)
    assert ds_bvh.bvh is not None
    cam = camera_pytree(house_scene.camera)

    a = np.asarray(
        render_sample(ds_sweep, tiny_env, cam, np.uint32(0), (24, 18), 4)
    )
    b = np.asarray(
        render_sample(ds_bvh, tiny_env, cam, np.uint32(0), (24, 18), 4)
    )
    # Same RNG streams, same estimator; only intersection backend differs.
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_renderer_bvh_intersector(house_scene):
    from rsoderh_raytracing_tpu.env.environment import (
        Environment,
        EnvironmentMaps,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    tex = np.ones((8, 16, 3), dtype=np.float32)
    envs = EnvironmentMaps([Environment.from_texture("u", tex)])
    r = Renderer(
        house_scene, width=16, height=12, environments=envs,
        intersector="bvh",
    )
    r.step()
    img = r.film.mean_radiance()
    assert np.isfinite(img).all()
    with pytest.raises(ValueError, match="unknown intersector"):
        Renderer(house_scene, intersector="nope")


def test_bvh_packed_tables_bit_identical(house_scene, monkeypatch):
    """RT_BVH_PACKED=1 (one wide gather row per node visit / leaf slot,
    int fields bitcast through f32 lanes) must return bitwise-identical
    results to the default narrow takes: identical float values feed
    identical tests. House exercises all three primitive-type lanes."""
    from rsoderh_raytracing_tpu.ops.bvh_traverse import (
        traverse_any,
        traverse_closest,
    )

    ds = build_device_scene(house_scene, with_bvh=True)
    rng = np.random.default_rng(3)
    n = 512
    ro = rng.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    t0, s0 = map(np.asarray, traverse_closest(ds, ds.bvh, ro, rd))
    o0 = np.asarray(traverse_any(ds, ds.bvh, ro, rd))
    monkeypatch.setenv("RT_BVH_PACKED", "1")
    t1, s1 = map(np.asarray, traverse_closest(ds, ds.bvh, ro, rd))
    o1 = np.asarray(traverse_any(ds, ds.bvh, ro, rd))
    np.testing.assert_array_equal(t1, t0)
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(o1, o0)


def test_bvh_above_tris_knob_lowers_auto_crossover(
    house_scene, monkeypatch
):
    """RT_BVH_ABOVE_TRIS=N retunes the auto route: scenes with more than
    N padded triangle lanes attach the flat BVH even below the backend's
    routing crossover (routing.py)."""
    from rsoderh_raytracing_tpu.scene.device import build_device_scene

    assert build_device_scene(house_scene, with_bvh="auto").bvh is None
    monkeypatch.setenv("RT_BVH_ABOVE_TRIS", "1")
    assert build_device_scene(house_scene, with_bvh="auto").bvh is not None
    # explicit intersector choices are not second-guessed by the knob
    assert build_device_scene(house_scene, with_bvh=False).bvh is None


def test_bvh_miss_linear_fallback_adversarial():
    """cast_ray's sphere+plane fallback after a BVH miss
    (shader.wgsl:576-598): axis-parallel rays against an axis-aligned
    plane (a FLAT AABB) produce NaN slab times that reject the node in
    the reference AABB semantics — the linear fallback must still hit.
    Property: the BVH intersector equals the dense sweep for
    sphere/plane scenes even on these adversarial rays."""
    import numpy as np

    from rsoderh_raytracing_tpu.ops import intersect
    from rsoderh_raytracing_tpu.scene.camera import Camera
    from rsoderh_raytracing_tpu.scene.device import build_device_scene
    from rsoderh_raytracing_tpu.scene.types import (
        Material,
        PackedMeshes,
        Plane,
        Scene,
        Sphere,
    )

    scene = Scene(
        materials=[Material((1, 1, 1), 1, 0, (0, 0, 0))],
        spheres=[Sphere(pos=(3.0, 0.0, 0.0), radius=0.5, material_id=0)],
        planes=[
            # Horizontal unit square at y=0: a zero-thickness AABB.
            Plane(
                pos=(-0.5, 0.0, -0.5),
                right=(1.0, 0.0, 0.0),
                forward=(0.0, 0.0, 1.0),
                material_id=0,
            )
        ],
        meshes=PackedMeshes.empty(),
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.0),
    )
    ds_bvh = build_device_scene(scene, with_bvh=True)
    ds_sweep = build_device_scene(scene)

    rng = np.random.default_rng(0)
    n = 256
    ro = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    # Adversarial block: rays EXACTLY parallel to the flat plane's AABB,
    # passing through it (origin y inside the slab).
    ro[:64, 1] = 0.0
    rd[:64, 1] = 0.0
    # Adversarial block: straight down onto the plane (single-axis rays).
    ro[64:128] = np.array([0.1, 1.0, 0.1], np.float32)
    rd[64:128] = np.array([0.0, -1.0, 0.0], np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    t_b, ty_b, ix_b = map(np.asarray, intersect._sweep_bvh(ds_bvh, ro, rd))
    t_s, ty_s, ix_s = map(np.asarray, intersect._sweep_xla(ds_sweep, ro, rd))
    np.testing.assert_array_equal(ty_b, ty_s)
    hit = ty_s >= 0
    assert hit[64:128].all(), "downward rays must hit the flat plane"
    np.testing.assert_array_equal(ix_b[hit], ix_s[hit])
    np.testing.assert_allclose(t_b[hit], t_s[hit], rtol=1e-6)


def test_bvh_past_chunked_ceiling_scale():
    """BVH traversal parity at past-the-old-65,536 scale (the round-4
    crossover measurement's correctness prerequisite): a 70,000-triangle
    jittered shell builds, validates, stays within the 64-deep lockstep
    stack (suzanne_xhi's 247,809 primitives measure depth 22), and
    matches the brute-force dense sweep on mixed hit/miss rays."""
    rng = np.random.default_rng(7)
    n_tri = 70_000
    # Triangles tangent to a radius-5 shell: dense spatial overlap at
    # the poles exercises SAH splits harder than a uniform box fill.
    u = rng.normal(size=(n_tri, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    centers = (5.0 * u).astype(np.float32)
    e1 = np.cross(u, [0.0, 1.0, 0.001]).astype(np.float32) * 0.15
    e2 = np.cross(u, e1).astype(np.float32) * 0.15
    vertices = np.concatenate(
        [centers, centers + e1, centers + e2], axis=0
    ).astype(np.float32)
    normals = np.array([[0.0, 0.0, 1.0]], np.float32)
    idx = np.arange(n_tri)
    tris = np.stack(
        [idx, idx + n_tri, idx + 2 * n_tri] + [np.zeros(n_tri, np.int64)] * 4,
        axis=-1,
    ).astype(np.int32)

    from rsoderh_raytracing_tpu.scene.camera import Camera
    from rsoderh_raytracing_tpu.scene.types import Material, PackedMeshes, Scene

    scene = Scene(
        materials=[Material((1, 1, 1), 1, 0, (0, 0, 0))],
        spheres=[],
        planes=[],
        meshes=PackedMeshes(vertices=vertices, normals=normals, triangles=tris),
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=1.0),
    )
    bvh = build_bvh(scene)
    mins, maxs, _, _ = scene_primitive_bounds(scene)
    assert bvh.num_primitives == n_tri
    validate_bvh(bvh, mins, maxs)
    assert bvh.depth < 64

    ds = build_device_scene(scene, with_bvh=True)
    n = 256
    # Half from the center outward (guaranteed hits), half from outside
    # pointing away (misses + grazers).
    ro = np.zeros((n, 3), np.float32)
    ro[n // 2 :] = rng.uniform(8, 12, (n // 2, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    brute = intersect.closest_hit(ds, ro, rd)
    t_bvh, slot = traverse_closest(ds, ds.bvh, ro, rd)
    bvh_hit = np.asarray(slot) >= 0
    brute_hit = np.asarray(brute.did_hit)
    np.testing.assert_array_equal(bvh_hit, brute_hit)
    assert bvh_hit[: n // 2].sum() > 16  # the shell really is hit
    np.testing.assert_allclose(
        np.asarray(t_bvh)[bvh_hit],
        np.asarray(brute.distance)[brute_hit],
        rtol=1e-4,
        atol=1e-4,
    )
