"""The light-transport integrator: one path-traced sample per pixel.

Vectorised re-design of the reference megakernel (shader.wgsl:1206-1373).
The per-thread bounce loop becomes a ``lax.scan`` over MAX_BOUNCES
carrying a flat wavefront of N = H*W rays; terminated lanes are masked,
not compacted (the regenerating variant lives in render/wavefront.py).
Each bounce performs two intersection queries (closest-hit + NEE
shadow) over the padded primitive arrays.

The estimator is identical to the reference: unidirectional path tracing
with next-event estimation against the HDRI and power-heuristic MIS,
surface emission added with pre-bounce throughput, RGB throughput cutoff
at ||throughput|| < 0.001, and the reference's debug-color error
sentinels from BSDF sampling.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rsoderh_raytracing_tpu.env.environment import DeviceEnvironment
from rsoderh_raytracing_tpu.ops import bsdf as bsdf_ops
from rsoderh_raytracing_tpu.ops import envmap, rng
from rsoderh_raytracing_tpu.ops.intersect import any_hit, closest_hit
from rsoderh_raytracing_tpu.scene.device import DeviceScene

MAX_BOUNCES = 10  # shader.wgsl:232
THROUGHPUT_CUTOFF = 0.001  # shader.wgsl:1289


def generate_camera_rays(state, pixel_x, pixel_y, camera, resolution):
    """Jittered pinhole ray generation (shader.wgsl:1340-1362).

    camera: dict with 'pos' (3,), 'rot' (3,3), 'fov_y' () — traced values,
    so camera motion never recompiles. resolution: static (width, height).
    Returns (state, origins (N,3), directions (N,3)).
    """
    width, height = resolution
    state, jitter = rng.next_in_circle(state)
    jx = pixel_x.astype(jnp.float32) + jitter[..., 0]
    jy = pixel_y.astype(jnp.float32) + jitter[..., 1]

    sx = (jx / width * 2.0 - 1.0)
    sy = -(jy / height * 2.0 - 1.0)

    max_y = jnp.sin(camera["fov_y"] / 2.0)
    aspect = width / height
    ray_cam = jnp.stack(
        [sx * max_y * aspect, sy * max_y, -jnp.ones_like(sx)], axis=-1
    )
    direction = jnp.dot(
        ray_cam, camera["rot"].T, precision=jax.lax.Precision.HIGHEST
    )
    direction = direction / jnp.linalg.norm(direction, axis=-1, keepdims=True)
    origin = jnp.broadcast_to(camera["pos"], direction.shape)
    return state, origin, direction


def trace_rays(
    scene: DeviceScene,
    env: DeviceEnvironment,
    state,
    ray_origin,
    ray_direction,
    max_bounces: int = MAX_BOUNCES,
    with_stats: bool = False,
):
    """Trace a wavefront of rays to completion. Returns (state, light (N,3)),
    or (state, light, stats) when with_stats — stats = dict with the
    number of closest-hit rays and NEE shadow rays actually alive, for
    Mrays/s accounting (SURVEY.md section 5: rays = pixels x spp x mean
    path length).

    Mirrors trace_ray (shader.wgsl:1212-1303) with alive-masking.
    """

    def bounce(carry, _):
        state, ro, rd, throughput, incoming, last_pdf, alive = carry
        n_primary = jnp.sum(alive.astype(jnp.float32))

        hit = closest_hit(scene, ro, rd)
        active_hit = alive & hit.did_hit
        active_miss = alive & ~hit.did_hit

        # Ray escaped: environment radiance with MIS against the last
        # BSDF pdf (shader.wgsl:1222-1231). One fused quad fetch serves
        # both the radiance and the pdf's pmf (sky_light +
        # direction_pdf would gather the same 16-byte row twice).
        miss_uv = envmap.direction_to_equirect_uv(rd)
        env_light, miss_pmf = envmap.radiance_and_pmf(env, miss_uv)
        miss_pdf = miss_pmf / envmap.pixel_solid_angle(
            miss_uv[..., 1], env.texture_shape[1], env.texture_shape[0]
        )
        miss_weight = bsdf_ops.power_heuristic(last_pdf, miss_pdf)
        incoming = incoming + jnp.where(
            active_miss[..., None],
            throughput * env_light * miss_weight[..., None],
            0.0,
        )

        # Surface emission with pre-bounce throughput (shader.wgsl:1236).
        material = bsdf_ops.make_bsdf_material(
            jnp.take(scene.mat_color, hit.material_id, axis=0),
            jnp.take(scene.mat_roughness, hit.material_id, axis=0),
            jnp.take(scene.mat_metallic, hit.material_id, axis=0),
            jnp.take(scene.mat_emission, hit.material_id, axis=0),
        )
        incoming = incoming + jnp.where(
            active_hit[..., None], throughput * material.emission, 0.0
        )

        # Next-event estimation + MIS (shader.wgsl:1239-1266).
        state, nee_dir, nee_radiance, nee_pdf = envmap.sample_environment(
            state, env
        )
        cos_theta = jnp.maximum(
            0.0, jnp.sum(hit.normal * nee_dir, axis=-1)
        )
        occluded = any_hit(scene, hit.point, nee_dir)
        frame = bsdf_ops.make_frame(hit.normal)
        wo = bsdf_ops.to_frame_local(frame, -rd)
        wi = bsdf_ops.to_frame_local(frame, nee_dir)
        nee_scatter = bsdf_ops.bsdf_eval_local(wo, wi, material)
        nee_bsdf_pdf = bsdf_ops.bsdf_pdf_local(wo, wi, material)
        nee_weight = bsdf_ops.power_heuristic(nee_pdf, nee_bsdf_pdf)
        nee_valid = (
            active_hit & (cos_theta > 0.0) & (nee_pdf > 0.0) & ~occluded
        )
        nee_contrib = (
            throughput
            * nee_weight[..., None]
            * nee_radiance
            * nee_scatter
            * (cos_theta / jnp.maximum(nee_pdf, 1.0e-30))[..., None]
        )
        incoming = incoming + jnp.where(nee_valid[..., None], nee_contrib, 0.0)

        # BSDF bounce (shader.wgsl:1268-1299).
        state, sample = bsdf_ops.bsdf_sample(state, rd, hit.normal, material)

        # Error sentinel: zero direction REPLACES the collected light with
        # the debug color and terminates (shader.wgsl:1271-1275).
        error_lane = active_hit & sample.zero_direction
        incoming = jnp.where(
            error_lane[..., None], sample.scattering, incoming
        )

        cos_bounce = jnp.maximum(
            0.0, jnp.sum(hit.normal * sample.direction, axis=-1)
        )
        new_throughput = throughput * sample.scattering * (
            cos_bounce / jnp.maximum(sample.pdf, 1.0e-30)
        )[..., None]
        continue_path = (
            active_hit
            & ~sample.zero_direction
            & (sample.pdf > 0.0)
            & (jnp.linalg.norm(new_throughput, axis=-1) >= THROUGHPUT_CUTOFF)
        )

        throughput = jnp.where(
            continue_path[..., None], new_throughput, throughput
        )
        last_pdf = jnp.where(continue_path, sample.pdf, last_pdf)
        ro = jnp.where(continue_path[..., None], hit.point, ro)
        rd = jnp.where(continue_path[..., None], sample.direction, rd)
        alive = continue_path

        n_shadow = jnp.sum(active_hit.astype(jnp.float32))
        return (state, ro, rd, throughput, incoming, last_pdf, alive), (
            (n_primary, n_shadow) if with_stats else None
        )

    n = ray_origin.shape[0]
    init = (
        state,
        ray_origin,
        ray_direction,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), jnp.float32),
        jnp.ones((n,), bool),
    )
    (state, _, _, _, incoming, _, _), per_bounce = jax.lax.scan(
        bounce, init, None, length=max_bounces
    )
    if with_stats:
        stats = {
            "closest_rays": jnp.sum(per_bounce[0]),
            "shadow_rays": jnp.sum(per_bounce[1]),
        }
        return state, incoming, stats
    return state, incoming


@partial(jax.jit, static_argnames=("resolution", "max_bounces"))
def render_sample(
    scene: DeviceScene,
    env: DeviceEnvironment,
    camera,
    sample_index,
    resolution,
    max_bounces: int = MAX_BOUNCES,
):
    """Render ONE progressive sample for every pixel.

    Returns (H, W, 3) radiance. Accumulation (cumulative += sample;
    display = cumulative / (n+1)) is film.py's job, mirroring the
    reference split between shader.wgsl:1364-1372 and hdr.rs.
    """
    width, height = resolution
    y, x = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.int32),
        jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )
    x = x.reshape(-1)
    y = y.reshape(-1)
    pixel_index = (y * width + x).astype(jnp.uint32)

    state = rng.seed(pixel_index, jnp.uint32(sample_index))
    state, ro, rd = generate_camera_rays(state, x, y, camera, resolution)
    state, light = trace_rays(scene, env, state, ro, rd, max_bounces)
    return light.reshape(height, width, 3)


def camera_pytree(camera) -> dict:
    """Host Camera -> traced camera dict for render_sample."""
    return {
        "pos": jnp.asarray(camera.pos, jnp.float32),
        "rot": jnp.asarray(camera.rot_transform(), jnp.float32),
        "fov_y": jnp.asarray(camera.fov_y, jnp.float32),
    }
