"""The backend routing table (routing.py): route and BVH layout per
backend and scene scale, and a raise for a backend with no entry."""

import os

import numpy as np
import pytest

from rsoderh_raytracing_tpu import routing
from rsoderh_raytracing_tpu.scene.device import (
    MAX_UNROLL_PRIMS,
    TRI_CHUNK,
    build_device_scene,
)
from tests.conftest import ASSETS


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    monkeypatch.delenv("RT_BVH_ABOVE_TRIS", raising=False)
    monkeypatch.delenv("RT_BVH_PACKED", raising=False)


@pytest.mark.parametrize(
    "backend,lanes,bvh",
    [
        ("cpu", 1024, False),  # suzanne
        ("cpu", 15488, False),  # suzanne_hi
        ("cpu", 262144, False),  # at the crossover: still the sweep
        ("cpu", 262208, True),
        ("gpu", 1024, False),
        ("gpu", routing.ROUTES["gpu"].bvh_above_lanes, False),
        ("gpu", routing.ROUTES["gpu"].bvh_above_lanes + TRI_CHUNK, True),
        ("gpu", 15488, True),  # suzanne_hi
        ("gpu", 991232, True),  # suzanne_xxhi
    ],
)
def test_attach_bvh_by_backend_and_scale(backend, lanes, bvh):
    assert routing.attach_bvh(lanes, backend) is bvh


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_packed_default_by_backend(backend):
    assert routing.bvh_packed(backend) is routing.ROUTES[backend].bvh_packed


@pytest.mark.parametrize("backend", ["rocm", "metal"])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="no routing entry"):
        routing.route(backend)
    with pytest.raises(ValueError, match="no routing entry"):
        routing.attach_bvh(1024, backend)


def test_env_overrides(monkeypatch):
    monkeypatch.setenv("RT_BVH_PACKED", "1")
    assert routing.bvh_packed("cpu") is True
    monkeypatch.setenv("RT_BVH_PACKED", "0")
    assert routing.bvh_packed("gpu") is False
    monkeypatch.setenv("RT_BVH_ABOVE_TRIS", "512")
    assert routing.attach_bvh(1024, "cpu") is True
    assert routing.attach_bvh(512, "cpu") is False


def test_auto_routes_through_the_table(monkeypatch):
    """build_device_scene(with_bvh="auto") asks routing.attach_bvh with
    the padded triangle lane count; the CPU test backend keeps
    suzanne_hi (15,488 lanes) on the dense sweep in chunk-padded,
    clustered storage."""
    from rsoderh_raytracing_tpu import load_scene

    seen = []
    real = routing.attach_bvh

    def spy(lanes, backend=None):
        seen.append(lanes)
        return real(lanes, backend)

    monkeypatch.setattr(routing, "attach_bvh", spy)
    scene = load_scene(os.path.join(ASSETS, "scenes", "suzanne_hi.toml"))
    ds = build_device_scene(scene, with_bvh="auto")
    assert seen == [15488]
    assert ds.bvh is None
    assert ds.num_triangle_lanes % TRI_CHUNK == 0
    # clustered storage: not the host order
    tri_a = np.asarray(ds.tri_a)[:64]
    v = scene.meshes.vertices[scene.meshes.triangles[:64, 0]]
    assert not np.array_equal(tri_a, v)


@pytest.mark.parametrize(
    "name,lanes",
    [("house", 56), ("default", 16), ("suzanne", 1024), ("spheres", 1024)],
)
def test_padding_layout(name, lanes):
    """The padding constants decide the device arrays' shapes, which
    the CPU goldens are pinned to: small scenes pad to 8 lanes, scenes
    past MAX_UNROLL_PRIMS pad to whole TRI_CHUNK windows."""
    from rsoderh_raytracing_tpu import load_scene

    ds = build_device_scene(
        load_scene(os.path.join(ASSETS, "scenes", f"{name}.toml"))
    )
    total = (ds.num_sphere_lanes + ds.num_plane_lanes
             + ds.num_triangle_lanes)
    big = ds.num_triangle_lanes if name != "spheres" else ds.num_sphere_lanes
    assert big == lanes
    if total > MAX_UNROLL_PRIMS:
        assert big % TRI_CHUNK == 0
    else:
        assert total % 8 == 0


@pytest.mark.parametrize("name", ["house", "suzanne", "spheres"])
def test_windowed_sweep_matches_one_reduction(name, monkeypatch):
    """The windowed dense sweep (routing.sweep_window, the GPU route)
    finds the same winners and occlusion as one reduction over all
    lanes; distances agree to the rounding of a different fusion, which
    the sphere quadratic's b^2-4ac cancellation amplifies to ~1e-5
    relative on far hits."""
    import dataclasses

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.ops import intersect

    scene = load_scene(os.path.join(ASSETS, "scenes", f"{name}.toml"))
    ds = build_device_scene(scene)
    rng = np.random.default_rng(4)
    n = 512
    ro = np.asarray(scene.camera.pos, np.float32) + rng.normal(
        size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) * 3.0
    rd = (rd @ scene.camera.rot_transform().T).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    t0, ty0, ix0 = map(np.asarray, intersect._sweep_xla(ds, ro, rd))
    occ0 = np.asarray(intersect.any_hit(ds, ro, rd))
    cpu = routing.ROUTES["cpu"]
    monkeypatch.setitem(routing.ROUTES, "cpu",
                        dataclasses.replace(cpu, sweep_window=TRI_CHUNK))
    for kind in ("sph", "pln", "tri"):
        windows = intersect._windows(ds, kind)
        lanes = {"sph": ds.num_sphere_lanes, "pln": ds.num_plane_lanes,
                 "tri": ds.num_triangle_lanes}[kind]
        if lanes <= intersect.ONE_REDUCTION_LANES:
            assert windows is None
        else:
            assert len(next(iter(windows.values()))) >= 2
    assert intersect._windows(ds, "sph" if name == "spheres" else "tri")
    t1, ty1, ix1 = map(np.asarray, intersect._sweep_xla(ds, ro, rd))
    occ1 = np.asarray(intersect.any_hit(ds, ro, rd))
    assert (ty0 >= 0).sum() > 20
    np.testing.assert_array_equal(ty1, ty0)
    np.testing.assert_array_equal(ix1, ix0)
    np.testing.assert_allclose(t1, t0, rtol=1e-4)
    np.testing.assert_array_equal(occ1, occ0)
