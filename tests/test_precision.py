"""Every f32 dot on the render path runs at Precision.HIGHEST.

At default precision XLA:GPU may run an f32 dot in TF32 (about three
decimal digits), which would move camera rays by ~1e-3 relative — about
a pixel at 2048^2 — and break parity with the oracle. Each call site
pins its own precision; these tests walk the jaxprs for dot_general."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.extend.core import ClosedJaxpr, Jaxpr

HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _sub_jaxprs(v)


def dot_precisions(jaxpr):
    """Precision of every dot_general in `jaxpr` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                out.extend(dot_precisions(sub))
    return out


def _camera():
    from rsoderh_raytracing_tpu.render.integrator import camera_pytree
    from rsoderh_raytracing_tpu.scene.camera import Camera

    return camera_pytree(Camera(pos=[0, 1, 2], yaw=0.3, pitch=-0.2,
                                fov_y=1.0))


def _case(name, house_scene, tiny_env):
    from rsoderh_raytracing_tpu.ops import bvh_traverse, geometry, rng
    from rsoderh_raytracing_tpu.ops.tonemap import aces_tonemap
    from rsoderh_raytracing_tpu.render import integrator, wavefront
    from rsoderh_raytracing_tpu.scene.device import build_device_scene

    n = 16
    px = jnp.arange(n, dtype=jnp.int32) % 4
    py = jnp.arange(n, dtype=jnp.int32) // 4
    state = rng.seed(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0))
    ro = jnp.ones((n, 3), jnp.float32)
    rd = jnp.ones((n, 3), jnp.float32) / np.sqrt(3.0)
    if name == "wavefront._camera_rays":
        return lambda: wavefront._camera_rays(state, px, py, _camera(),
                                              (4, 4))
    if name == "integrator.generate_camera_rays":
        return lambda: integrator.generate_camera_rays(
            state, px, py, _camera(), (4, 4))
    if name == "tonemap.aces_tonemap":
        return lambda: aces_tonemap(jnp.ones((4, 4, 3), jnp.float32))
    if name == "geometry.plane_distances":
        ds = build_device_scene(house_scene)
        return lambda: geometry.plane_distances(
            ro, rd, ds.pln_pos, ds.pln_normal, ds.pln_bcm, ds.pln_valid)
    if name == "bvh_traverse._plane_t":
        bcm = jnp.tile(jnp.eye(3, dtype=jnp.float32), (n, 1, 1))
        return lambda: bvh_traverse._plane_t(ro, rd, ro * 0.5, rd, bcm)
    ds = build_device_scene(house_scene)
    return lambda: wavefront.render_freerun(
        ds, tiny_env, _camera(), np.zeros((4, 4), np.uint32), (4, 4),
        np.uint32(2), 3,
    )


@pytest.mark.parametrize(
    "name",
    [
        "wavefront._camera_rays",
        "integrator.generate_camera_rays",
        "tonemap.aces_tonemap",
        "geometry.plane_distances",
        "bvh_traverse._plane_t",
        "wavefront.render_freerun",
    ],
)
def test_every_dot_is_highest(name, house_scene, tiny_env):
    fn = _case(name, house_scene, tiny_env)
    precisions = dot_precisions(jax.make_jaxpr(fn)().jaxpr)
    assert precisions, f"{name}: no dot_general traced"
    assert all(p == HIGHEST for p in precisions), precisions
