"""Wavefront (ray-regeneration) integrator: exact parity with the scan
integrator, since both consume identical per-(pixel,sample) RNG streams
and identical fetch arithmetic."""

import numpy as np
import pytest

from rsoderh_raytracing_tpu.render.integrator import camera_pytree, render_sample
from rsoderh_raytracing_tpu.render.wavefront import render_wavefront
from rsoderh_raytracing_tpu.scene.camera import Camera
from rsoderh_raytracing_tpu.scene.device import build_device_scene
from rsoderh_raytracing_tpu.scene.types import (
    Material,
    PackedMeshes,
    Plane,
    Scene,
    Sphere,
)


@pytest.fixture(scope="module")
def test_scene():
    return Scene(
        materials=[
            Material((0.8, 0.7, 0.6), 0.6, 0.0, (0, 0, 0)),
            Material((0.9, 0.9, 0.9), 0.1, 1.0, (0, 0, 0)),
            Material((1, 1, 1), 1.0, 0.0, (3, 1, 0.5)),
        ],
        spheres=[
            Sphere(pos=[0, 1, -3], radius=1.0, material_id=0),
            Sphere(pos=[2, 1, -4], radius=0.8, material_id=1),
            Sphere(pos=[-2, 0.5, -2], radius=0.5, material_id=2),
        ],
        planes=[
            Plane(
                pos=[-10, 0, -10],
                forward=[0, 0, 20],
                right=[20, 0, 0],
                material_id=0,
            )
        ],
        meshes=PackedMeshes.empty(),
        camera=Camera(pos=[0, 1, 1], yaw=0, pitch=-0.1, fov_y=np.radians(80)),
    )


def test_wavefront_matches_scan_sum(test_scene, tiny_env):
    ds = build_device_scene(test_scene)
    cam = camera_pytree(test_scene.camera)
    res = (24, 16)
    spp = 5

    wf = np.asarray(
        render_wavefront(ds, tiny_env, cam, np.uint32(0), res, spp, 6)
    )
    seq = np.zeros_like(wf)
    for s in range(spp):
        seq += np.asarray(
            render_sample(ds, tiny_env, cam, np.uint32(s), res, 6)
        )
    np.testing.assert_allclose(wf, seq, rtol=2e-5, atol=2e-5)


def test_wavefront_base_sample_offset(test_scene, tiny_env):
    """base_sample shifts which samples are rendered."""
    ds = build_device_scene(test_scene)
    cam = camera_pytree(test_scene.camera)
    res = (8, 8)
    a = np.asarray(render_wavefront(ds, tiny_env, cam, np.uint32(3), res, 2, 4))
    b = np.asarray(render_sample(ds, tiny_env, cam, np.uint32(3), res, 4))
    c = np.asarray(render_sample(ds, tiny_env, cam, np.uint32(4), res, 4))
    np.testing.assert_allclose(a, b + c, rtol=2e-5, atol=2e-5)


def test_wavefront_stats(test_scene, tiny_env):
    ds = build_device_scene(test_scene)
    cam = camera_pytree(test_scene.camera)
    img, stats = render_wavefront(
        ds, tiny_env, cam, np.uint32(0), (8, 8), 4, 6, with_stats=True
    )
    closest = float(stats["closest_rays"])
    shadow = float(stats["shadow_rays"])
    assert closest >= 8 * 8 * 4  # at least one segment per path
    assert 0 < shadow <= closest


def test_renderer_step_batch_equals_steps(test_scene):
    from rsoderh_raytracing_tpu.env.environment import (
        Environment,
        EnvironmentMaps,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    tex = np.ones((8, 16, 3), dtype=np.float32) * 0.7
    envs = EnvironmentMaps([Environment.from_texture("u", tex)])

    a = Renderer(test_scene, width=12, height=8, environments=envs)
    for _ in range(4):
        a.step()
    b = Renderer(test_scene, width=12, height=8, environments=envs)
    b.step_batch(4)

    assert a.film.sample_count == b.film.sample_count == 4
    np.testing.assert_allclose(
        np.asarray(a.film.cumulative),
        np.asarray(b.film.cumulative),
        rtol=2e-5,
        atol=2e-5,
    )


def test_lane_order_block_roundtrip():
    """Block-major lane order is a bijection: to/from_lanes invert each
    other and the emitted pixel coordinates name each lane's true pixel."""
    import numpy as np

    from rsoderh_raytracing_tpu.render.wavefront import _lane_order

    w, h = 256, 128
    px, py, to_lanes, from_lanes = _lane_order(w, h)
    img = np.arange(h * w, dtype=np.int32).reshape(h, w)
    flat = np.asarray(to_lanes(img))
    assert flat.shape == (h * w,)
    np.testing.assert_array_equal(np.asarray(from_lanes(flat)), img)
    # block-major really engaged (not row-major): first block is 64x128
    assert flat[128] == img[1, 0]
    # pixel coords are consistent with the mapping
    np.testing.assert_array_equal(
        np.asarray(from_lanes(np.asarray(px))),
        np.broadcast_to(np.arange(w, dtype=np.int32), (h, w)),
    )
    np.testing.assert_array_equal(
        np.asarray(from_lanes(np.asarray(py))),
        np.broadcast_to(np.arange(h, dtype=np.int32)[:, None], (h, w)),
    )
    # vector tails (film (n,3)) roundtrip too
    img3 = np.stack([img, img + 1, img + 2], axis=-1)
    np.testing.assert_array_equal(
        np.asarray(from_lanes(to_lanes(img3))), img3
    )


def test_wavefront_block_order_matches_scan(test_scene, tiny_env):
    """A block-remapped resolution (W%128==0, H%64==0) produces the same
    per-pixel image as the scan integrator — the lane->pixel remap
    preserves every pixel's RNG stream and camera ray."""
    ds = build_device_scene(test_scene)
    cam = camera_pytree(test_scene.camera)
    res = (128, 64)
    wf = np.asarray(
        render_wavefront(ds, tiny_env, cam, np.uint32(0), res, 1, 4)
    )
    seq = np.asarray(render_sample(ds, tiny_env, cam, np.uint32(0), res, 4))
    np.testing.assert_allclose(wf, seq, rtol=2e-5, atol=2e-5)


def test_wavefront_flat_base_sample_is_pixel_order(test_scene, tiny_env):
    """A flat (H*W,) base_sample means row-major PIXEL order — at a
    block-remapped resolution it must be reshuffled into lane order like
    an (H, W) base, not consumed as-is (which would resume each pixel
    from a different pixel's sample count)."""
    ds = build_device_scene(test_scene)
    cam = camera_pytree(test_scene.camera)
    res = (128, 64)
    base2d = (np.arange(64 * 128, dtype=np.uint32) % 7).reshape(64, 128)
    a = np.asarray(
        render_wavefront(ds, tiny_env, cam, base2d, res, 1, 4)
    )
    b = np.asarray(
        render_wavefront(ds, tiny_env, cam, base2d.reshape(-1), res, 1, 4)
    )
    np.testing.assert_array_equal(a, b)


def test_spp_sync_matches_wavefront(test_scene, tiny_env):
    """Bounce-synchronized rounds accumulate the same samples in the
    same per-lane order as the regeneration wavefront: bitwise equal
    image and counts on a given backend path."""
    from rsoderh_raytracing_tpu.render.wavefront import render_spp_sync

    ds = build_device_scene(test_scene)
    cam = camera_pytree(test_scene.camera)
    res = (24, 16)
    rounds = 3
    sync_img, sync_counts = render_spp_sync(
        ds, tiny_env, cam, np.uint32(0), res, np.uint32(rounds), 6
    )
    wf = render_wavefront(ds, tiny_env, cam, np.uint32(0), res, rounds, 6)
    np.testing.assert_array_equal(np.asarray(sync_img), np.asarray(wf))
    np.testing.assert_array_equal(
        np.asarray(sync_counts), np.full((16, 24), rounds, np.uint32)
    )


def test_spp_sync_resumes_from_counts(test_scene, tiny_env):
    """base_counts offsets every pixel's stream: sync rounds 0..1 then
    2..3 equal one 4-sample render."""
    from rsoderh_raytracing_tpu.render.wavefront import render_spp_sync

    ds = build_device_scene(test_scene)
    cam = camera_pytree(test_scene.camera)
    res = (16, 16)
    a_img, a_counts = render_spp_sync(
        ds, tiny_env, cam, np.uint32(0), res, np.uint32(2), 5
    )
    b_img, b_counts = render_spp_sync(
        ds, tiny_env, cam, a_counts, res, np.uint32(2), 5
    )
    full = render_wavefront(ds, tiny_env, cam, np.uint32(0), res, 4, 5)
    np.testing.assert_allclose(
        np.asarray(a_img) + np.asarray(b_img),
        np.asarray(full),
        rtol=2e-5,
        atol=2e-5,
    )
    # counts are per-call completions (render_freerun semantics)
    np.testing.assert_array_equal(np.asarray(b_counts), 2)




@pytest.mark.parametrize("name", ["house", "suzanne", "big_tri"])
def test_wavefront_sweep_vs_bvh_route(name, tiny_env, big_tri_scene):
    """The free-run wavefront renders the same image on either
    intersection route: same RNG streams and estimator, only the
    primitive tests differ (expanded vs per-primitive f32 forms), so a
    rare ray may take another branch — bounded like any cross-program
    comparison."""
    import os

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.render.wavefront import render_freerun

    if name == "big_tri":
        scene = big_tri_scene
    else:
        scene = load_scene(
            os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "assets", "scenes", f"{name}.toml")
        )
    cam = camera_pytree(scene.camera)
    res = (16, 16)
    out = {}
    for route, with_bvh in (("sweep", False), ("bvh", True)):
        ds = build_device_scene(scene, with_bvh=with_bvh)
        img, counts = render_freerun(
            ds, tiny_env, cam, np.zeros(res, np.uint32), res,
            np.uint32(6), 4,
        )
        out[route] = (np.asarray(img), np.asarray(counts))
    (img_s, cnt_s), (img_b, cnt_b) = out["sweep"], out["bvh"]
    assert (cnt_s == cnt_b).mean() > 0.97
    same = cnt_s == cnt_b
    close = np.isclose(img_s[same], img_b[same], rtol=1e-4, atol=1e-5)
    assert close.mean() > 0.97, f"{(~close).sum()} values diverge"
    np.testing.assert_allclose(img_s.mean(), img_b.mean(), rtol=2e-2)
