"""Sharded rendering on the 8-device virtual CPU mesh.

Key property: sharded output EQUALS the sequential single-chip renders
summed, because lanes are seeded by global (pixel, sample) indices."""

import jax
import numpy as np
import pytest

from rsoderh_raytracing_tpu.parallel.sharding import (
    ShardedRenderer,
    make_mesh,
    render_spp_sharded,
)
from rsoderh_raytracing_tpu.render.integrator import camera_pytree, render_sample
from rsoderh_raytracing_tpu.scene.camera import Camera
from rsoderh_raytracing_tpu.scene.device import build_device_scene
from rsoderh_raytracing_tpu.scene.types import (
    Material,
    PackedMeshes,
    Scene,
    Sphere,
)


@pytest.fixture(scope="module")
def small_scene():
    return Scene(
        materials=[
            Material((0.8, 0.7, 0.6), 0.5, 0.0, (0, 0, 0)),
            Material((1, 1, 1), 1.0, 0.0, (2, 2, 2)),
        ],
        spheres=[
            Sphere(pos=[0, 0, -3], radius=1.0, material_id=0),
            Sphere(pos=[2, 1, -4], radius=0.8, material_id=1),
        ],
        planes=[],
        meshes=PackedMeshes.empty(),
        camera=Camera(pos=[0, 0, 0], yaw=0, pitch=0, fov_y=np.radians(90)),
    )


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sample_sharded_equals_sequential(small_scene, uniform_env):
    ds = build_device_scene(small_scene)
    cam = camera_pytree(small_scene.camera)
    res = (16, 16)

    mesh = make_mesh(n_devices=8, tile=1)
    summed = np.asarray(
        render_spp_sharded(ds, uniform_env, cam, 0, mesh, res, 4)
    )

    seq = np.zeros_like(summed)
    for s in range(8):
        seq += np.asarray(
            render_sample(ds, uniform_env, cam, np.uint32(s), res, 4)
        )
    np.testing.assert_allclose(summed, seq, rtol=1e-4, atol=1e-4)


def test_tile_sharded_equals_sequential(small_scene, uniform_env):
    ds = build_device_scene(small_scene)
    cam = camera_pytree(small_scene.camera)
    res = (16, 16)

    mesh = make_mesh(n_devices=8, tile=4)  # 4 tiles x 2 samples
    summed = np.asarray(
        render_spp_sharded(ds, uniform_env, cam, 0, mesh, res, 4)
    )
    seq = sum(
        np.asarray(render_sample(ds, uniform_env, cam, np.uint32(s), res, 4))
        for s in range(2)
    )
    np.testing.assert_allclose(summed, seq, rtol=1e-4, atol=1e-4)


def test_sharded_renderer_wrapper(small_scene, uniform_env):
    from rsoderh_raytracing_tpu.env.environment import (
        Environment,
        EnvironmentMaps,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    tex = np.ones((8, 16, 3), dtype=np.float32)
    envs = EnvironmentMaps([Environment.from_texture("u", tex)])
    inner = Renderer(small_scene, width=16, height=16, environments=envs)
    sharded = ShardedRenderer.wrap(inner, "dp:8")
    sharded.step()
    assert inner.film.sample_count == 8
    img = sharded.film.mean_radiance()
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()


def test_mesh_validation():
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(n_devices=8, tile=3)


def test_freerun_sharded_exact_cover(small_scene, uniform_env):
    """With max_bounces=1 every path is exactly one iteration, so a
    free-run budget of B on an S-wide sample axis completes exactly the
    global samples 0..B*S-1 for every pixel — equal to the exact-spp
    render of B*S samples."""
    import numpy as np

    from rsoderh_raytracing_tpu.parallel.sharding import (
        render_freerun_sharded,
    )
    from rsoderh_raytracing_tpu.render.wavefront import render_wavefront

    ds = build_device_scene(small_scene)
    cam = camera_pytree(small_scene.camera)
    res = (16, 16)
    mesh = make_mesh(n_devices=8, tile=2)  # 2 tiles x 4 samples

    base = np.zeros((16, 16), np.uint32)
    budget = 3
    summed, counts, _ = render_freerun_sharded(
        ds, uniform_env, cam, base, mesh, res, np.uint32(budget), 1
    )
    counts = np.asarray(counts)
    np.testing.assert_array_equal(counts, budget * 4)  # 4 sample shards

    expected = np.asarray(
        render_wavefront(
            ds, uniform_env, cam, np.uint32(0), res, np.uint32(budget * 4), 1
        )
    )
    np.testing.assert_allclose(np.asarray(summed), expected, rtol=2e-5, atol=2e-5)


def test_freerun_sharded_resume(small_scene, uniform_env):
    """Resuming from the returned counts continues disjoint streams."""
    import numpy as np

    from rsoderh_raytracing_tpu.parallel.sharding import (
        render_freerun_sharded,
    )
    from rsoderh_raytracing_tpu.render.wavefront import render_wavefront

    ds = build_device_scene(small_scene)
    cam = camera_pytree(small_scene.camera)
    res = (16, 16)
    mesh = make_mesh(n_devices=4, tile=1)

    base = np.zeros((16, 16), np.uint32)
    img1, c1, sc1 = render_freerun_sharded(
        ds, uniform_env, cam, base, mesh, res, np.uint32(2), 1
    )
    img2, c2, _ = render_freerun_sharded(
        ds, uniform_env, cam, np.asarray(c1), mesh, res, np.uint32(2), 1
    )
    total = np.asarray(img1) + np.asarray(img2)
    counts = np.asarray(c1) + np.asarray(c2)
    np.testing.assert_array_equal(counts, 16)

    expected = np.asarray(
        render_wavefront(
            ds, uniform_env, cam, np.uint32(0), res, np.uint32(16), 1
        )
    )
    np.testing.assert_allclose(total, expected, rtol=2e-5, atol=2e-5)

    # Per-shard resume (the EXACT path — required after any sharded
    # freerun whose devices complete unequal counts): at max_bounces=1
    # counts are balanced, so it must match the totals resume bitwise.
    img2b, c2b, _ = render_freerun_sharded(
        ds, uniform_env, cam, sc1, mesh, res, np.uint32(2), 1
    )
    np.testing.assert_array_equal(np.asarray(c2b), np.asarray(c2))
    np.testing.assert_array_equal(np.asarray(img2b), np.asarray(img2))


def test_freerun_sharded_resume_unbalanced(small_scene, uniform_env):
    """With max_bounces > 1 devices complete UNEQUAL per-pixel counts;
    chaining through shard_counts is the stream-exact resume: each
    device's local position advances monotonically and the reported
    total is exactly the sum of per-device increments (no sample index
    double-counted or skipped — the ceil-division totals split is NOT
    valid here, which is why shard_counts exists)."""
    import numpy as np

    from rsoderh_raytracing_tpu.parallel.sharding import (
        render_freerun_sharded,
    )

    ds = build_device_scene(small_scene)
    cam = camera_pytree(small_scene.camera)
    res = (16, 16)
    mesh = make_mesh(n_devices=4, tile=1)

    base = np.zeros((16, 16), np.uint32)
    _img1, c1, sc1 = render_freerun_sharded(
        ds, uniform_env, cam, base, mesh, res, np.uint32(5), 3
    )
    sc1 = np.asarray(sc1)
    c1 = np.asarray(c1)
    assert sc1.shape == (4, 16, 16)
    np.testing.assert_array_equal(sc1.sum(axis=0), c1)
    # The premise of the test: the budgeted free-run leaves the devices
    # genuinely unbalanced on at least some pixels.
    assert (sc1.max(axis=0) != sc1.min(axis=0)).any()

    _img2, c2, sc2 = render_freerun_sharded(
        ds, uniform_env, cam, sc1, mesh, res, np.uint32(5), 3
    )
    sc2 = np.asarray(sc2)
    assert (sc2 >= sc1).all()
    np.testing.assert_array_equal(sc2.sum(axis=0), c1 + np.asarray(c2))


def test_sharded_freerun_checkpoint_roundtrip(
    tmp_path, small_scene, uniform_env
):
    """Sharded-freerun checkpoints carry per-shard stream positions:
    save -> load into a fresh ShardedRenderer (same mesh) -> continue
    must equal the uninterrupted run bitwise; loading on a different
    sample-axis width is rejected."""
    import numpy as np
    import pytest

    from rsoderh_raytracing_tpu.parallel.sharding import ShardedRenderer
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    def fresh():
        r = Renderer(small_scene, width=16, height=16, max_bounces=3)
        r.environments = [None]
        r._device_env_cache = {0: uniform_env}
        return r

    path = str(tmp_path / "shard_ckpt.npz")

    a = ShardedRenderer(fresh(), make_mesh(n_devices=4, tile=1))
    a.step_freerun(5)
    a.save_checkpoint(path)
    a.step_freerun(5)

    b = ShardedRenderer(fresh(), make_mesh(n_devices=4, tile=1))
    b.inner._last_state_hash = b.inner._state_hash()
    b.load_checkpoint(path)
    b.step_freerun(5)

    np.testing.assert_array_equal(
        np.asarray(a.film.counts), np.asarray(b.film.counts)
    )
    np.testing.assert_array_equal(
        np.asarray(a.film.cumulative), np.asarray(b.film.cumulative)
    )

    c = ShardedRenderer(fresh(), make_mesh(n_devices=2, tile=1))
    c.inner._last_state_hash = c.inner._state_hash()
    with pytest.raises(ValueError, match="sample axis"):
        c.load_checkpoint(path)


def test_sharded_block_lane_order_bitwise(
    monkeypatch, small_scene, uniform_env
):
    """At a block-eligible per-shard size (width 128, shard rows 64) the
    sharded free-run engages the block-major lane order inside each
    shard. Per-pixel streams are lane-order independent, so the
    block-ordered run must equal the row-ordered run of the SAME
    program shape bitwise (cross-PROGRAM comparisons — sharded vs
    unsharded — carry compile-variant ulps from shape-dependent matmul
    vectorization and are held to allclose, like the other tests
    here)."""
    import numpy as np

    from rsoderh_raytracing_tpu.parallel.sharding import (
        make_mesh,
        render_freerun_sharded,
    )
    from rsoderh_raytracing_tpu.render import wavefront as wf
    from rsoderh_raytracing_tpu.render.wavefront import render_freerun

    ds = build_device_scene(small_scene)
    cam = camera_pytree(small_scene.camera)
    res = (128, 128)  # tile=2 -> 64-row shards: block mode per shard
    # the per-shard order really is block-major, not a fallback
    _, _, to_lanes, _ = wf._lane_order(128, 64)
    probe = np.arange(64 * 128).reshape(64, 128)
    assert np.asarray(to_lanes(probe))[128] == probe[1, 0]

    mesh = make_mesh(n_devices=2, tile=2)
    base = np.zeros((128, 128), np.uint32)
    img_s, cnt_s, _ = render_freerun_sharded(
        ds, uniform_env, cam, base, mesh, res, np.uint32(4), 3
    )
    img_s, cnt_s = np.asarray(img_s), np.asarray(cnt_s)

    monkeypatch.setenv("RT_DISABLE_BLOCK_REMAP", "1")
    render_freerun_sharded.clear_cache()
    img_r, cnt_r, _ = render_freerun_sharded(
        ds, uniform_env, cam, base, mesh, res, np.uint32(4), 3
    )
    render_freerun_sharded.clear_cache()
    monkeypatch.delenv("RT_DISABLE_BLOCK_REMAP")
    np.testing.assert_array_equal(img_s, np.asarray(img_r))
    np.testing.assert_array_equal(cnt_s, np.asarray(cnt_r))

    img_u, cnt_u = render_freerun(
        ds, uniform_env, cam, base, res, np.uint32(4), 3
    )
    np.testing.assert_array_equal(cnt_s, np.asarray(cnt_u))
    np.testing.assert_allclose(
        img_s, np.asarray(img_u), rtol=2e-5, atol=2e-5
    )


def _sphere_cloud_scene():
    from rsoderh_raytracing_tpu.scene.types import Plane

    rng = np.random.default_rng(7)
    return Scene(
        materials=[Material((0.7, 0.6, 0.5), 0.5, 0.0, (0, 0, 0))],
        spheres=[
            Sphere(
                pos=rng.uniform(-8.0, 8.0, 3),
                radius=float(rng.uniform(0.1, 0.6)),
                material_id=0,
            )
            for _ in range(200)
        ],
        planes=[
            Plane(
                pos=[-20.0, -9.0, -20.0],
                forward=[0.0, 0.0, 40.0],
                right=[40.0, 0.0, 0.0],
                material_id=0,
            )
        ],
        meshes=PackedMeshes.empty(),
        camera=Camera(pos=[0, 0, 20], yaw=0, pitch=0, fov_y=1.2),
    )


@pytest.mark.parametrize("name", ["big_tri", "sphere_cloud"])
def test_chunk_padded_scene_sharded_equals_unsharded(
    name, big_tri_scene, tiny_env
):
    """Chunk-padded scenes (a 200-triangle wall; a 200-sphere cloud)
    shard like everything else on the composed path: a tiled +
    sample-sharded free-run equals the sequential render of the same
    global samples (max_bounces=1 makes the budget exact). Per-shard
    lane counts change the compiled program shape, and the sphere
    quadratic can amplify a contraction ulp into a whole-path flip on a
    few pixels; non-flipped pixels agree tightly."""
    from rsoderh_raytracing_tpu.parallel.sharding import (
        render_freerun_sharded,
    )
    from rsoderh_raytracing_tpu.render.wavefront import render_wavefront

    scene = big_tri_scene if name == "big_tri" else _sphere_cloud_scene()
    ds = build_device_scene(scene, pad_to=1 if name == "big_tri" else 8)
    assert ds.num_triangle_lanes % 64 == 0 and (
        name == "big_tri" or ds.num_sphere_lanes % 64 == 0
    )
    cam = camera_pytree(scene.camera)
    res = (16, 16)
    mesh = make_mesh(n_devices=8, tile=2)  # 2 tiles x 4 samples

    budget = 2
    summed, counts, _ = render_freerun_sharded(
        ds, tiny_env, cam, np.zeros(res, np.uint32), mesh, res,
        np.uint32(budget), 1,
    )
    np.testing.assert_array_equal(np.asarray(counts), budget * 4)
    expected = np.asarray(
        render_wavefront(
            ds, tiny_env, cam, np.uint32(0), res, np.uint32(budget * 4), 1
        )
    )
    got = np.asarray(summed)
    flip = np.abs(got - expected).max(-1) > 1e-2
    assert flip.mean() < 0.10, f"{int(flip.sum())} whole-path flips"
    np.testing.assert_allclose(
        got[~flip], expected[~flip], rtol=1e-3, atol=1e-4
    )
