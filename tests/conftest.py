"""Test configuration: force CPU with 8 virtual devices so sharding tests
run without several accelerators (the standard JAX fake-backend analog).
Tests that need the card carry the `gpu` marker and skip here."""

import os

# jax may already be imported (by a sitecustomize or a plugin) when this
# runs, so the environment variable alone can be too late — jax.config
# works any time before backend init.
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
# Tests compile many small programs; a persistent cache shared by the
# xdist workers would only add disk traffic.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


@pytest.fixture(scope="session")
def assets_dir():
    return ASSETS


@pytest.fixture(scope="session")
def default_scene():
    from rsoderh_raytracing_tpu import load_scene

    return load_scene(os.path.join(ASSETS, "scenes", "default.toml"))


@pytest.fixture(scope="session")
def house_scene():
    from rsoderh_raytracing_tpu import load_scene

    return load_scene(os.path.join(ASSETS, "scenes", "house.toml"))


@pytest.fixture(scope="session")
def tiny_env():
    """A small deterministic environment for fast device tests."""
    from rsoderh_raytracing_tpu.env.environment import (
        Environment,
        device_environment,
    )
    from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky

    # Sun radius must be a few texels wide at 64x32 or the disk falls
    # between texel centers and the map has no bright pixels at all.
    tex = procedural_sky(64, 32, sun_intensity=50.0, sun_radius=0.15)
    return device_environment(Environment.from_texture("tiny", tex))


@pytest.fixture(scope="session")
def uniform_env():
    """Constant radiance-1 environment (furnace configurations)."""
    from rsoderh_raytracing_tpu.env.environment import (
        Environment,
        device_environment,
    )

    tex = np.ones((16, 32, 3), dtype=np.float32)
    return device_environment(Environment.from_texture("uniform", tex))


@pytest.fixture(scope="session")
def big_tri_scene():
    """A 200-triangle wall (pads to 256 = 4 chunks of 64) plus a sphere
    and a plane: past the unroll budget, so the big-scene chunked kernel
    path applies, with every winner type reachable."""
    from rsoderh_raytracing_tpu.scene.camera import Camera
    from rsoderh_raytracing_tpu.scene.types import (
        Material,
        PackedMeshes,
        Plane,
        Scene,
        Sphere,
    )

    g = 10
    xs = np.linspace(-2.0, 2.0, g + 1)
    ys = np.linspace(-1.0, 3.0, g + 1)
    vx, vy = np.meshgrid(xs, ys, indexing="ij")
    vz = -3.0 + 0.05 * np.sin(vx * 3.0) * np.cos(vy * 2.0)
    vertices = np.stack([vx, vy, vz], axis=-1).reshape(-1, 3)
    vertices = vertices.astype(np.float32)
    normals = np.array([[0.0, 0.0, 1.0]], dtype=np.float32)
    tris = []
    for i in range(g):
        for k in range(g):
            v00 = i * (g + 1) + k
            v10 = (i + 1) * (g + 1) + k
            tris.append([v00, v10, v00 + 1, 0, 0, 0, 1])
            tris.append([v10, v10 + 1, v00 + 1, 0, 0, 0, 0])
    meshes = PackedMeshes(
        vertices=vertices,
        normals=normals,
        triangles=np.asarray(tris, np.int32),
    )
    return Scene(
        materials=[
            Material((0.7, 0.3, 0.2), 0.5, 0.0, (0, 0, 0)),
            Material((0.9, 0.9, 0.9), 0.05, 1.0, (0, 0, 0)),
        ],
        spheres=[Sphere(pos=(0.0, 0.5, -1.5), radius=0.4, material_id=1)],
        planes=[
            Plane(
                pos=(-4.0, -1.2, -8.0),
                right=(8.0, 0.0, 0.0),
                forward=(0.0, 0.0, 8.0),
                material_id=0,
            )
        ],
        meshes=meshes,
        camera=Camera(pos=[0, 0.5, 1], yaw=0, pitch=0, fov_y=1.2),
    )
