"""Multi-device scaling: tile x sample sharding over a jax.sharding.Mesh.

The reference is strictly single-GPU; its two axes of parallelism are
SIMT pixels and progressive samples (SURVEY.md section 2). Across
devices those become mesh axes:

- ``tile``:   image rows sharded across devices (no halos — rays are
              independent), like sequence/context parallelism for images.
- ``sample``: different progressive sample indices per device, reduced
              with ``psum`` (an NCCL all-reduce over NVLink between
              GPUs) — sample-parallel rendering. One step over an (T, S)
              mesh yields S samples at once.

The mesh is a plain reshape of the device list: the cards of one host
are joined all to all, so no axis order is preferred. The scene is
KB-sized and replicated on every device. RNG determinism is
preserved: lanes are seeded by (global pixel index, global sample index),
so an (8,1) render equals eight sequential single-device samples summed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from rsoderh_raytracing_tpu.render.integrator import (
    MAX_BOUNCES,
    generate_camera_rays,
    trace_rays,
)
from rsoderh_raytracing_tpu.ops import rng


def make_mesh(
    n_devices: int | None = None,
    tile: int | None = None,
    devices=None,
) -> Mesh:
    """Build a (tile, sample) mesh over the available devices.

    With no arguments uses every device on one sample axis (pure
    sample-parallel — the best default: zero inter-device traffic until
    the final psum)."""
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only"
                f" {len(devices)} are available"
            )
        devices = devices[:n_devices]
    n = len(devices)
    if tile is None:
        tile = 1
    if n % tile != 0:
        raise ValueError(f"tile={tile} does not divide device count {n}")
    grid = np.array(devices).reshape(tile, n // tile)
    return Mesh(grid, axis_names=("tile", "sample"))


@partial(
    jax.jit, static_argnames=("mesh", "resolution", "max_bounces")
)
def render_spp_sharded(
    scene,
    env,
    camera,
    base_sample,
    mesh: Mesh,
    resolution,
    max_bounces: int = MAX_BOUNCES,
):
    """One sharded render step.

    Renders `sample_axis_size` progressive samples (indices base_sample +
    0..S-1), pixel rows sharded over the `tile` axis, and returns the
    SUM of the samples as a full (H, W, 3) array (add to the film with
    weight S). Height must be divisible by the tile axis size.
    """
    width, height = resolution
    tile_n = mesh.shape["tile"]
    if height % tile_n != 0:
        raise ValueError(f"height {height} not divisible by tile={tile_n}")

    y, x = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.int32),
        jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )

    def shard_fn(scene, env, camera, base_sample, x_blk, y_blk):
        sample_offset = jax.lax.axis_index("sample").astype(jnp.uint32)
        xs = x_blk.reshape(-1)
        ys = y_blk.reshape(-1)
        pixel_index = (ys * width + xs).astype(jnp.uint32)
        state = rng.seed(pixel_index, base_sample + sample_offset)
        state, ro, rd = generate_camera_rays(
            state, xs, ys, camera, (width, height)
        )
        state, light = trace_rays(scene, env, state, ro, rd, max_bounces)
        light = light.reshape(x_blk.shape + (3,))
        # Reduce the sample axis so every tile-row block is the sum of
        # all S samples: one all-reduce per step.
        return jax.lax.psum(light, axis_name="sample")

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(),  # scene replicated
            P(),  # env replicated
            P(),  # camera replicated
            P(),  # base sample replicated
            P("tile", None),  # pixel x rows sharded
            P("tile", None),
        ),
        out_specs=P("tile", None, None),
        check_vma=False,
    )
    return fn(scene, env, camera, jnp.uint32(base_sample), x, y)


@partial(
    jax.jit, static_argnames=("mesh", "resolution", "max_bounces")
)
def render_freerun_sharded(
    scene,
    env,
    camera,
    base_counts,
    mesh: Mesh,
    resolution,
    iterations,
    max_bounces: int = MAX_BOUNCES,
):
    """Free-run wavefront across the mesh.

    Pixel rows shard over `tile`; the `sample` axis splits each pixel's
    progressive sample STREAM by striding: device s of S works samples
    s, s+S, s+2S, ... — disjoint deterministic streams with no
    coordination, exactly the sample-parallel analog of the reference's
    one-spp-per-frame accumulation. Returns (summed (H,W,3),
    counts (H,W), shard_counts (S,H,W)): the radiance sum and TOTAL new
    samples this call (one all-reduce each), plus every device's
    cumulative LOCAL stream position — the exact state to pass back as
    `base_counts` on the next call.

    base_counts: either (S, H, W) per-shard local counts (the
    `shard_counts` from the previous call — exact resume), or (H, W)
    TOTAL per-pixel samples completed so far. Totals are only valid
    when the completed set is a PREFIX of every pixel's global stream
    (fresh start, exact-spp accumulation, or an UNSHARDED freerun);
    the ceil-division split below is exact for prefixes. A previous
    SHARDED freerun completes non-prefix sets (devices finish unequal
    counts per pixel), so resuming one from totals would re-render
    some sample indices and skip others — always feed its
    shard_counts back instead.
    """

    width, height = resolution
    tile_n = mesh.shape["tile"]
    if height % tile_n != 0:
        raise ValueError(f"height {height} not divisible by tile={tile_n}")
    rows = height // tile_n
    per_shard = base_counts.ndim == 3

    def shard_fn(scene, env, camera, base_counts):
        s_idx = jax.lax.axis_index("sample").astype(jnp.uint32)
        s_n = jnp.uint32(mesh.shape["sample"])
        t_idx = jax.lax.axis_index("tile").astype(jnp.int32)

        if per_shard:
            local_base = base_counts.reshape(-1)
        else:
            # Prefix-complete totals: this device owns global sample
            # indices k*s_n + s_idx, so its next local index is
            # ceil((base - s_idx) / s_n).
            base = base_counts.reshape(-1)
            local_base = (base + s_n - jnp.uint32(1) - s_idx) // s_n

        img, local_counts = _freerun_rows(
            scene,
            env,
            camera,
            local_base,
            s_idx,
            s_n,
            t_idx,
            (width, height),
            rows,
            iterations,
            max_bounces,
        )
        shard_counts = (local_base + local_counts.reshape(-1)).reshape(
            1, rows, width
        )
        img = jax.lax.psum(img, axis_name="sample")
        counts = jax.lax.psum(local_counts, axis_name="sample")
        return img, counts, shard_counts

    base_spec = (
        P("sample", "tile", None) if per_shard else P("tile", None)
    )
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), base_spec),
        out_specs=(
            P("tile", None, None),
            P("tile", None),
            P("sample", "tile", None),
        ),
        check_vma=False,
    )
    return fn(scene, env, camera, base_counts)


def _freerun_rows(
    scene,
    env,
    camera,
    local_base,
    sample_stride_offset,
    sample_stride,
    tile_index,
    resolution,
    rows,
    iterations,
    max_bounces,
):
    """Free-run over this device's row block with strided sample indices.

    Wraps render/wavefront.py's loop via its seeding hook: global sample
    index = local_index * stride + offset.
    """
    from rsoderh_raytracing_tpu.render import wavefront as wf

    width, height = resolution
    # Same block-major lane order as the unsharded loop (render/
    # wavefront._lane_order), applied within this device's row block;
    # falls back to row-major when the block doesn't tile. Per-pixel
    # streams are lane-order independent, so sharded == unsharded holds.
    pixel_x, local_y, to_lanes, from_lanes = wf._lane_order(width, rows)
    pixel_y = local_y + tile_index * rows
    pixel_index = (
        pixel_y.astype(jnp.uint32) * jnp.uint32(width)
        + pixel_x.astype(jnp.uint32)
    )

    img, counts, _ = wf.wavefront_loop_custom(
        scene,
        env,
        camera,
        pixel_index,
        pixel_x,
        pixel_y,
        (width, height),
        to_lanes(local_base.reshape(rows, width)),
        lambda local: local * sample_stride + sample_stride_offset,
        jnp.uint32(0xFFFFFFFF),
        iterations,
        max_bounces,
    )
    return from_lanes(img), from_lanes(counts)


class ShardedRenderer:
    """Wraps a Renderer to execute steps across a device mesh.

    Each .step() renders S samples (S = sample-axis size) and adds them
    to the film in one go. Free-run steps carry per-shard stream
    positions (`_shard_counts`) between calls so every device resumes
    its own strided sample stream exactly (see render_freerun_sharded's
    prefix discussion)."""

    def __init__(self, renderer, mesh: Mesh):
        self.inner = renderer
        self.mesh = mesh
        self._shard_counts = None  # (S, H, W) device array after freerun

    @staticmethod
    def wrap(renderer, spec: str) -> "ShardedRenderer":
        """spec: 'dp:N' (sample-parallel over N devices) or
        'tile:T,dp:S' (T x S mesh)."""
        try:
            parts = dict(
                p.split(":", 1) for p in spec.replace(" ", "").split(",")
            )
            n = int(parts.get("dp", len(jax.devices())))
            tile = int(parts.get("tile", 1))
        except (ValueError, TypeError) as exc:
            raise ValueError(
                f"bad --devices spec '{spec}': expected 'dp:N' or"
                " 'tile:T,dp:S'"
            ) from exc
        mesh = make_mesh(n_devices=tile * n, tile=tile)
        return ShardedRenderer(renderer, mesh)

    # Renderer API surface -------------------------------------------------
    @property
    def film(self):
        return self.inner.film

    @property
    def camera(self):
        return self.inner.camera

    def save_png(self, path):
        self.inner.save_png(path)

    def save_checkpoint(self, path) -> None:
        """Film checkpoint plus this mesh's per-shard stream positions:
        a sharded freerun completes a NON-prefix global sample set, so
        resuming it exactly needs the per-device counts, not the film's
        totals (see render_freerun_sharded)."""
        extra = {"state_stamp": self.inner._state_stamp()}
        if self._shard_counts is not None:
            extra["shard_counts"] = np.asarray(self._shard_counts)
        self.inner.film.save_checkpoint(path, **extra)

    def load_checkpoint(self, path) -> None:
        self.inner._check_state_stamp(path)
        self.inner.film.load_checkpoint(path)
        self._shard_counts = None
        with np.load(path) as z:
            if "shard_counts" in z.files:
                sc = z["shard_counts"]
                s = self.mesh.shape["sample"]
                if sc.shape[0] != s:
                    raise ValueError(
                        f"checkpoint was produced on a {sc.shape[0]}-wide"
                        f" sample axis but this mesh has {s}: the"
                        " completed sample set cannot be re-split"
                        " exactly — resume with the original mesh shape"
                    )
                self._shard_counts = jnp.asarray(sc.astype(np.uint32))
            # else: totals-only checkpoint (fresh/exact/unsharded
            # freerun) — prefix-complete, so the ceil split is exact.

    def step(self) -> int:
        inner = self.inner
        state_hash = inner._state_hash()
        if state_hash != inner._last_state_hash:
            inner.film.reset()
            inner._last_state_hash = state_hash

        from rsoderh_raytracing_tpu.render.integrator import camera_pytree

        s = self.mesh.shape["sample"]
        summed = render_spp_sharded(
            inner.device_scene,
            inner._device_env(),
            camera_pytree(inner.camera),
            np.uint32(inner.film.sample_count),
            self.mesh,
            (inner.width, inner.height),
            inner.max_bounces,
        )
        # S samples at once: add the sum and bump the counter by S.
        inner.film.add_samples(summed, s)
        return inner.film.sample_count

    def step_freerun(self, iterations: int) -> int:
        """Sharded free-run step (see render_freerun_sharded)."""
        inner = self.inner
        state_hash = inner._state_hash()
        if state_hash != inner._last_state_hash:
            inner.film.reset()
            self._shard_counts = None
            inner._last_state_hash = state_hash

        from rsoderh_raytracing_tpu.render.integrator import camera_pytree

        # Per-shard stream positions when we have them (exact resume);
        # otherwise the film's totals, valid as a prefix split (fresh
        # start / exact-spp / unsharded-freerun history). Device arrays
        # pass straight through — jit reshards without a host hop.
        base = (
            self._shard_counts
            if self._shard_counts is not None
            else inner.film.counts
        )
        summed, counts, shard_counts = render_freerun_sharded(
            inner.device_scene,
            inner._device_env(),
            camera_pytree(inner.camera),
            base,
            self.mesh,
            (inner.width, inner.height),
            np.uint32(iterations),
            inner.max_bounces,
        )
        self._shard_counts = shard_counts
        inner.film.add_freerun(summed, counts)
        return inner.film.sample_count

    def render(
        self,
        spp: int = 16,
        progress: bool = False,
        batch: int | None = None,
        mode: str = "exact",
    ):
        import time

        start = time.perf_counter()
        if mode == "freerun":
            # Same per-call iteration cap as Renderer.render (progress
            # granularity).
            while self.film.sample_count < spp:
                remaining = spp - self.film.sample_count
                self.step_freerun(min(max(16, remaining * 4), 256))
                if progress:
                    done = self.film.sample_count
                    elapsed = time.perf_counter() - start
                    print(
                        f"  min spp {done}/{spp}"
                        f"  ({done / max(elapsed, 1e-9):.2f} spp/s)"
                    )
            return self.film.tonemapped()
        if self.film.sample_count and not self.film.is_uniform:
            raise ValueError(
                "exact mode cannot extend a non-uniform (free-run)"
                " accumulation: sample indices above the per-pixel"
                " minimum would be re-rendered. Use mode='freerun'."
            )
        s = self.mesh.shape["sample"]
        # spp is the TOTAL target (matches Renderer.render / freerun).
        base = self.film.sample_count
        steps = max(0, -(-(spp - base) // s))
        for i in range(steps):
            self.step()
            if progress:
                elapsed = time.perf_counter() - start
                done = base + (i + 1) * s
                print(
                    f"  sample {done}/{base + steps * s}"
                    f"  ({(done - base) / max(elapsed, 1e-9):.2f} spp/s)"
                )
        return self.film.tonemapped()
