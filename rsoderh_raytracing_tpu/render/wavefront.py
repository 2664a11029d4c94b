"""Ray-regeneration wavefront integrator — the production render path.

The scan integrator (integrator.py) mirrors the reference megakernel:
every pixel's path steps through MAX_BOUNCES with dead lanes masked, so
late bounces waste most of the wavefront and every bounce pays the
(gather-bound) environment fetches for every lane. This module keeps
every lane busy instead:

- **lane == pixel, paths regenerate in place**: when a lane's path
  terminates (miss / pdf 0 / cutoff / depth), the finished radiance is
  accumulated into the lane's own film slot (no scatter — lane IS the
  pixel) and the lane immediately reseeds the next progressive sample of
  the same pixel. Every iteration, every lane does useful work; the only
  idle lanes are those whose pixel finished all its samples near the end.

- **fused environment fetch**: per iteration a lane needs exactly one
  radiance fetch + one pmf fetch — at the NEE sample's uv when it hit, or
  at the escape direction's uv when it missed. Both flow through ONE
  quad-packed bilinear gather and ONE pmf gather (see
  DeviceEnvironment).

- identical estimator and RNG streams: each (pixel, sample) path draws
  the same sequence as the scan integrator / reference shader, so the
  rendered image is exactly the sum of the same per-sample images.

Returns the SUM of `spp` samples per pixel in one jitted while_loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rsoderh_raytracing_tpu.env.environment import DeviceEnvironment
from rsoderh_raytracing_tpu.ops import bsdf as bsdf_ops
from rsoderh_raytracing_tpu.ops import envmap, rng
from rsoderh_raytracing_tpu.ops.intersect import trace_nee
from rsoderh_raytracing_tpu.render.integrator import MAX_BOUNCES, THROUGHPUT_CUTOFF
from rsoderh_raytracing_tpu.scene.device import DeviceScene


def _camera_rays(state, pixel_x, pixel_y, camera, resolution):
    """Jittered pinhole rays for given pixel coords (shader.wgsl:1340-62)."""
    width, height = resolution
    state, jitter = rng.next_in_circle(state)
    jx = pixel_x.astype(jnp.float32) + jitter[..., 0]
    jy = pixel_y.astype(jnp.float32) + jitter[..., 1]
    sx = jx / width * 2.0 - 1.0
    sy = -(jy / height * 2.0 - 1.0)
    max_y = jnp.sin(camera["fov_y"] / 2.0)
    aspect = width / height
    ray_cam = jnp.stack(
        [sx * max_y * aspect, sy * max_y, -jnp.ones_like(sx)], axis=-1
    )
    d = jnp.dot(
        ray_cam, camera["rot"].T, precision=jax.lax.Precision.HIGHEST
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(camera["pos"], d.shape)
    return state, o, d


@partial(
    jax.jit,
    static_argnames=("resolution", "max_bounces", "with_stats"),
)
def render_wavefront(
    scene: DeviceScene,
    env: DeviceEnvironment,
    camera,
    base_sample,
    resolution,
    spp,
    max_bounces: int = MAX_BOUNCES,
    with_stats: bool = False,
):
    """Render `spp` progressive samples (indices base_sample..+spp-1) for
    every pixel. Returns the (H, W, 3) SUM of sample radiances — divide
    by spp (the film does) for the mean. With with_stats, returns
    (image, stats) where stats counts closest/shadow rays traced."""
    image, _counts, stats = _wavefront_loop(
        scene,
        env,
        camera,
        base_sample,
        resolution,
        spp,
        jnp.uint32(0xFFFFFFFF),  # no iteration budget: run to exact spp
        max_bounces,
    )
    if with_stats:
        return image, stats
    return image


@partial(
    jax.jit,
    static_argnames=("resolution", "max_bounces", "with_stats"),
)
def render_freerun(
    scene: DeviceScene,
    env: DeviceEnvironment,
    camera,
    base_counts,
    resolution,
    iterations,
    max_bounces: int = MAX_BOUNCES,
    with_stats: bool = False,
):
    """Iteration-budget rendering: every lane stays busy for `iterations`
    path segments, completing a VARIABLE number of samples per pixel
    (cheap sky pixels render many, deep mirror pixels few — ~100% lane
    utilization vs the exact-spp mode whose wavefront drains while the
    deepest pixel finishes). After the budget, in-flight paths drain to
    completion (<= max_bounces extra iterations), so no work is wasted.

    base_counts: per-pixel starting sample index, (H, W) uint32 or scalar.
    Returns (sum_image (H,W,3), counts (H,W) uint32[, stats]). Sample
    (pixel, s) is identical to the exact-spp mode's — resuming from the
    returned counts continues the same deterministic streams.
    """
    image, counts, stats = _wavefront_loop(
        scene,
        env,
        camera,
        base_counts,
        resolution,
        jnp.uint32(0xFFFFFFFF),  # no sample quota
        iterations,
        max_bounces,
    )
    if with_stats:
        return image, counts, stats
    return image, counts


@partial(
    jax.jit,
    static_argnames=("resolution", "max_bounces", "with_stats"),
)
def render_spp_sync(
    scene: DeviceScene,
    env: DeviceEnvironment,
    camera,
    base_counts,
    resolution,
    rounds,
    max_bounces: int = MAX_BOUNCES,
    with_stats: bool = False,
):
    """Bounce-synchronized progressive rendering: each round renders ONE
    sample for every pixel — all lanes launch the round's primary rays
    together and the wavefront drains completely (no mid-flight
    regeneration) before the next round starts. Per-(pixel, sample)
    paths and RNG streams are identical to render_wavefront /
    render_freerun, and per-lane film accumulation happens in the same
    sample order, so the image equals render_wavefront(spp=rounds)
    bitwise (CPU tests assert it: both modes compute every camera ray
    in _camera_rays).

    The trade vs free-run: lane utilization is LOWER (lanes idle while
    the round's deepest path finishes) but every lane of a round is at
    the same bounce depth.

    base_counts: per-pixel starting sample index, (H, W) uint32 or
    scalar. Returns (sum image (H,W,3), counts (H,W) uint32[, stats]);
    counts are the samples completed THIS call (== rounds everywhere),
    matching render_freerun's per-call semantics.
    """
    width, height = resolution
    n = width * height
    pixel_x, pixel_y, to_lanes, from_lanes = _lane_order(width, height)
    pixel_index = (
        pixel_y.astype(jnp.uint32) * jnp.uint32(width)
        + pixel_x.astype(jnp.uint32)
    )
    base = jnp.asarray(base_counts, jnp.uint32)
    if base.ndim >= 2:
        base = to_lanes(base)
    elif base.size == n:
        # flat (H*W,) is row-major PIXEL order — remap it like (H, W)
        # (under block lane order, passing it through unshuffled would
        # resume each pixel from a different pixel's sample count)
        base = to_lanes(base.reshape(height, width))
    else:
        base = jnp.broadcast_to(base.reshape(-1), (n,))

    def body(r, acc):
        film, counts, closest, shadow, iters = acc
        f, c, st = wavefront_loop_custom(
            scene,
            env,
            camera,
            pixel_index,
            pixel_x,
            pixel_y,
            resolution,
            base + jnp.uint32(r),
            lambda local: local,
            jnp.uint32(1),
            jnp.uint32(0xFFFFFFFF),
            max_bounces,
        )
        return (
            film + f,
            counts + c,
            closest + st["closest_rays"],
            shadow + st["shadow_rays"],
            iters + st["iterations"],
        )

    film, counts, closest, shadow, iters = jax.lax.fori_loop(
        0,
        jnp.asarray(rounds, jnp.int32),
        body,
        (
            jnp.zeros((n, 3), jnp.float32),
            jnp.zeros((n,), jnp.uint32),
            jnp.float32(0.0),
            jnp.float32(0.0),
            jnp.uint32(0),
        ),
    )
    image = from_lanes(film)
    counts = from_lanes(counts)
    if with_stats:
        stats = {
            "closest_rays": closest,
            "shadow_rays": shadow,
            "iterations": iters,
        }
        return image, counts, stats
    return image, counts


# Block-major lane order: each run of BLOCK_H x BLOCK_W consecutive
# lanes covers a pixel RECTANGLE instead of a few full-width rows, so
# neighbouring lanes hold rays with a narrow shared frustum. Pure layout
# transform: each lane still owns exactly one pixel's RNG stream, so
# per-pixel results are bitwise identical to the row-major order.
BLOCK_H = 64
BLOCK_W = 128


def _lane_order(width, height):
    """(pixel_x, pixel_y, to_lanes, from_lanes) for the lane->pixel
    mapping: block-major when the resolution tiles exactly, else
    row-major. to_lanes maps (H, W, ...) pixel arrays to flat (n, ...)
    lane arrays; from_lanes is its inverse."""
    import os

    n = width * height
    if (
        width % BLOCK_W == 0
        and height % BLOCK_H == 0
        and os.environ.get("RT_DISABLE_BLOCK_REMAP") != "1"
    ):
        bh, bw = BLOCK_H, BLOCK_W

        def to_lanes(img):
            tail = img.shape[2:]
            return img.reshape(
                height // bh, bh, width // bw, bw, *tail
            ).swapaxes(1, 2).reshape(n, *tail)

        def from_lanes(flat):
            tail = flat.shape[1:]
            return flat.reshape(
                height // bh, width // bw, bh, bw, *tail
            ).swapaxes(1, 2).reshape(height, width, *tail)

        xx = jnp.broadcast_to(
            jnp.arange(width, dtype=jnp.int32)[None, :], (height, width)
        )
        yy = jnp.broadcast_to(
            jnp.arange(height, dtype=jnp.int32)[:, None], (height, width)
        )
        return to_lanes(xx), to_lanes(yy), to_lanes, from_lanes

    lane = jnp.arange(n, dtype=jnp.uint32)
    pixel_x = (lane % width).astype(jnp.int32)
    pixel_y = (lane // width).astype(jnp.int32)

    def to_lanes(img):
        return img.reshape(n, *img.shape[2:])

    def from_lanes(flat):
        return flat.reshape(height, width, *flat.shape[1:])

    return pixel_x, pixel_y, to_lanes, from_lanes


def _wavefront_loop(
    scene: DeviceScene,
    env: DeviceEnvironment,
    camera,
    base_sample,
    resolution,
    spp,
    iteration_budget,
    max_bounces: int = MAX_BOUNCES,
):
    width, height = resolution
    n = width * height
    pixel_x, pixel_y, to_lanes, from_lanes = _lane_order(width, height)
    pixel_index = (
        pixel_y.astype(jnp.uint32) * jnp.uint32(width)
        + pixel_x.astype(jnp.uint32)
    )
    base_sample = jnp.asarray(base_sample, jnp.uint32)
    if base_sample.ndim >= 2:
        base_sample = to_lanes(base_sample)
    elif base_sample.size == n:
        # flat (H*W,) is row-major PIXEL order — remap it like (H, W)
        base_sample = to_lanes(base_sample.reshape(height, width))
    else:
        base_sample = jnp.broadcast_to(base_sample.reshape(-1), (n,))
    img, counts, stats = wavefront_loop_custom(
        scene,
        env,
        camera,
        pixel_index,
        pixel_x,
        pixel_y,
        resolution,
        base_sample,
        lambda local: local,
        spp,
        iteration_budget,
        max_bounces,
    )
    return from_lanes(img), from_lanes(counts), stats


def wavefront_loop_custom(
    scene: DeviceScene,
    env: DeviceEnvironment,
    camera,
    pixel_index,
    pixel_x,
    pixel_y,
    resolution,
    base_sample,
    sample_map,
    spp,
    iteration_budget,
    max_bounces: int = MAX_BOUNCES,
):
    """Core regeneration loop over an explicit lane set.

    pixel_index/pixel_x/pixel_y: (n,) lane -> pixel mapping (lanes may
    cover a row block of a sharded image; pixel_index seeds the RNG with
    GLOBAL pixel ids so sharded renders equal unsharded ones).
    base_sample: (n,) per-lane starting LOCAL sample index.
    sample_map: local index -> global progressive sample index (identity
    for single-device; `local * stride + offset` for sample-sharding).
    Returns flat (film (n,3), counts (n,), stats).
    """
    width, height = resolution
    n = pixel_index.shape[0]
    spp = jnp.asarray(spp, jnp.uint32)
    iteration_budget = jnp.asarray(iteration_budget, jnp.uint32)

    env_h, env_w = env.texture_shape[0], env.texture_shape[1]

    def start_path(sample_idx):
        state = rng.seed(pixel_index, sample_map(base_sample + sample_idx))
        state, o, d = _camera_rays(
            state, pixel_x, pixel_y, camera, resolution
        )
        return state, o, d

    state0, o0, d0 = start_path(jnp.zeros((n,), jnp.uint32))

    carry0 = dict(
        state=state0,
        ro=o0,
        rd=d0,
        throughput=jnp.ones((n, 3), jnp.float32),
        incoming=jnp.zeros((n, 3), jnp.float32),
        last_pdf=jnp.ones((n,), jnp.float32),
        bounce=jnp.zeros((n,), jnp.int32),
        sample=jnp.zeros((n,), jnp.uint32),  # completed samples per lane
        in_path=jnp.ones((n,), bool),
        it=jnp.zeros((), jnp.uint32),
        film=jnp.zeros((n, 3), jnp.float32),
        closest_rays=jnp.zeros((), jnp.float32),
        shadow_rays=jnp.zeros((), jnp.float32),
    )

    def cond(c):
        return jnp.any(c["in_path"])

    def body(c):
        state = c["state"]
        ro, rd = c["ro"], c["rd"]
        throughput, incoming = c["throughput"], c["incoming"]
        active = c["in_path"]

        # ---- NEE draw first (RNG order per path is unchanged — these
        # are the same four draws in the same sequence) so the alias
        # gather and the trace have no false dependency.
        # NEE draws advance every lane, matching the scan/reference
        # stream for live lanes; dead lanes' draws are never observed.
        with jax.named_scope("env"):
            state, _, nee_uv, nee_pmf = envmap.sample_alias_index(state, env)
            nee_dir = envmap.equirect_uv_to_direction(nee_uv)

        # ---- trace: closest hit + attributes + material values + NEE
        # occlusion from the hit point. The scope names the fusions in a
        # device trace (scripts/trace_profile.py reads it).
        with jax.named_scope("trace"):
            (
                did_hit,
                hit_point,
                hit_normal,
                mat_color,
                mat_rough,
                mat_metal,
                mat_emission,
                occluded,
            ) = trace_nee(scene, ro, rd, nee_dir)
        is_hit = active & did_hit
        is_miss = active & ~did_hit

        # ---- fused environment fetch --------------------------------
        # Exactly TWO gathers per iteration: the packed alias row (NEE
        # index + its pmf) and the quad row (bilinear radiance + the pmf
        # of the MIS pdf's pixel) at either the NEE uv or the escape uv.
        with jax.named_scope("env"):
            miss_uv = envmap.direction_to_equirect_uv(rd)
            fetch_uv = jnp.where(is_hit[:, None], nee_uv, miss_uv)
            radiance, quad_pmf = envmap.radiance_and_pmf(env, fetch_uv)
        pmf = jnp.where(is_hit, nee_pmf, quad_pmf)
        solid = envmap.pixel_solid_angle(fetch_uv[..., 1], env_w, env_h)
        pdf_env = pmf / solid

        # ---- miss: environment light with MIS ------------------------
        miss_weight = bsdf_ops.power_heuristic(c["last_pdf"], pdf_env)
        incoming = incoming + jnp.where(
            is_miss[:, None], throughput * radiance * miss_weight[:, None], 0.0
        )

        # ---- hit: emission + NEE + bounce ----------------------------
        material = bsdf_ops.make_bsdf_material(
            mat_color, mat_rough, mat_metal, mat_emission
        )
        incoming = incoming + jnp.where(
            is_hit[:, None], throughput * material.emission, 0.0
        )

        cos_theta = jnp.maximum(0.0, jnp.sum(hit_normal * nee_dir, axis=-1))
        frame = bsdf_ops.make_frame(hit_normal)
        wo = bsdf_ops.to_frame_local(frame, -rd)
        wi = bsdf_ops.to_frame_local(frame, nee_dir)
        nee_scatter = bsdf_ops.bsdf_eval_local(wo, wi, material)
        nee_bsdf_pdf = bsdf_ops.bsdf_pdf_local(wo, wi, material)
        nee_weight = bsdf_ops.power_heuristic(pdf_env, nee_bsdf_pdf)
        nee_ok = is_hit & (cos_theta > 0.0) & (pdf_env > 0.0) & ~occluded
        incoming = incoming + jnp.where(
            nee_ok[:, None],
            throughput
            * nee_weight[:, None]
            * radiance
            * nee_scatter
            * (cos_theta / jnp.maximum(pdf_env, 1.0e-30))[:, None],
            0.0,
        )

        state, sample = bsdf_ops.bsdf_sample(state, rd, hit_normal, material)
        error_lane = is_hit & sample.zero_direction
        incoming = jnp.where(error_lane[:, None], sample.scattering, incoming)

        cos_bounce = jnp.maximum(
            0.0, jnp.sum(hit_normal * sample.direction, axis=-1)
        )
        new_throughput = throughput * sample.scattering * (
            cos_bounce / jnp.maximum(sample.pdf, 1.0e-30)
        )[:, None]
        bounce = c["bounce"] + 1
        continues = (
            is_hit
            & ~sample.zero_direction
            & (sample.pdf > 0.0)
            & (jnp.linalg.norm(new_throughput, axis=-1) >= THROUGHPUT_CUTOFF)
            & (bounce < max_bounces)
        )
        path_done = active & ~continues

        # ---- terminate + regenerate ----------------------------------
        film = c["film"] + jnp.where(path_done[:, None], incoming, 0.0)
        next_sample = jnp.where(path_done, c["sample"] + 1, c["sample"])

        # Reseed lanes that start a new path (their fresh stream replaces
        # whatever the fused draws above did to the old one).
        fresh_state, fresh_o, fresh_d = start_path(next_sample)
        it = c["it"] + 1
        regen = path_done & (next_sample < spp) & (it < iteration_budget)
        in_path = (active & continues) | regen

        state = jnp.where(regen, fresh_state, state)
        ro = jnp.where(
            regen[:, None],
            fresh_o,
            jnp.where(continues[:, None], hit_point, ro),
        )
        rd = jnp.where(
            regen[:, None],
            fresh_d,
            jnp.where(continues[:, None], sample.direction, rd),
        )
        throughput = jnp.where(
            regen[:, None],
            1.0,
            jnp.where(continues[:, None], new_throughput, throughput),
        )
        incoming = jnp.where((regen | path_done)[:, None], 0.0, incoming)
        last_pdf = jnp.where(
            regen, 1.0, jnp.where(continues, sample.pdf, c["last_pdf"])
        )
        bounce = jnp.where(regen, 0, bounce)

        out = dict(
            state=state,
            ro=ro,
            rd=rd,
            throughput=throughput,
            incoming=incoming,
            last_pdf=last_pdf,
            bounce=bounce,
            sample=next_sample,
            in_path=in_path,
            it=it,
            film=film,
            closest_rays=c["closest_rays"]
            + jnp.sum(active.astype(jnp.float32)),
            shadow_rays=c["shadow_rays"] + jnp.sum(is_hit.astype(jnp.float32)),
        )
        return out

    final = jax.lax.while_loop(cond, body, carry0)
    stats = {
        "closest_rays": final["closest_rays"],
        "shadow_rays": final["shadow_rays"],
        "iterations": final["it"],
    }
    return final["film"], final["sample"], stats

