"""Renderer: the engine core that owns device state and the render loop.

The counterpart of the reference's State (src/state.rs:29-833): owns
the device scene arrays, active environment, film, and camera; exposes
per-sample stepping with the reference's scene-hash-triggered progressive
reset (moving camera -> 1-spp noise; holding still -> convergence).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from rsoderh_raytracing_tpu.env.environment import (
    EnvironmentMaps,
    device_environment,
    load_default_environments,
)
from rsoderh_raytracing_tpu.render.film import Film
from rsoderh_raytracing_tpu.render.integrator import (
    MAX_BOUNCES,
    camera_pytree,
    render_sample,
)
from rsoderh_raytracing_tpu.scene.device import build_device_scene
from rsoderh_raytracing_tpu.scene.types import Scene
from rsoderh_raytracing_tpu.utils.png import write_png


class Renderer:
    def __init__(
        self,
        scene: Scene,
        width: int = 512,
        height: int = 512,
        environments: Optional[EnvironmentMaps] = None,
        max_bounces: int = MAX_BOUNCES,
        intersector: str = "auto",
    ):
        """intersector: 'auto' (the backend's measured route: dense
        sweep below its crossover, flat-BVH traversal above — see
        routing.py), 'sweep' (dense vectorized tests — fastest for the
        reference's scene sizes), or 'bvh' (flat-BVH traversal with the
        reference's node ordering)."""
        self.scene = scene
        self.width = width
        self.height = height
        self.max_bounces = max_bounces
        if intersector not in ("auto", "sweep", "bvh"):
            raise ValueError(f"unknown intersector '{intersector}'")
        self.device_scene = build_device_scene(
            scene,
            with_bvh={"auto": "auto", "bvh": True, "sweep": False}[
                intersector
            ],
        )
        #: the routing decision actually taken ('sweep' or 'bvh')
        self.intersector = (
            "bvh" if self.device_scene.bvh is not None else "sweep"
        )
        self.environments = environments or load_default_environments()
        self.environment_index = 0
        self._device_env_cache: dict[int, object] = {}
        self.camera = scene.camera
        self.film = Film(width, height)
        self._last_state_hash: Optional[tuple] = None
        self.last_stats: Optional[dict] = None

    # -- state hash / progressive reset (src/state.rs:774-789) -------------

    def _state_hash(self) -> tuple:
        return (
            self.camera.state_hash(),
            self.environment_index,
            self.width,
            self.height,
        )

    def _device_env(self):
        idx = self.environment_index
        if idx not in self._device_env_cache:
            self._device_env_cache[idx] = device_environment(
                self.environments[idx]
            )
        return self._device_env_cache[idx]

    def next_environment(self) -> int:
        self.environment_index = self.environments.next_index(
            self.environment_index
        )
        return self.environment_index

    def resize(self, width: int, height: int) -> None:
        self.width = width
        self.height = height
        self.film.resize(width, height)
        self._last_state_hash = None

    # -- stepping -----------------------------------------------------------

    def step(self) -> int:
        """Render one progressive sample; resets accumulation if the
        camera/environment/resolution changed. Returns the sample count."""
        state_hash = self._state_hash()
        if state_hash != self._last_state_hash:
            self.film.reset()
            self._last_state_hash = state_hash

        sample = render_sample(
            self.device_scene,
            self._device_env(),
            camera_pytree(self.camera),
            np.uint32(self.film.sample_count),
            (self.width, self.height),
            self.max_bounces,
        )
        self.film.add_sample(sample)
        return self.film.sample_count

    def step_batch(self, spp: int) -> int:
        """Render `spp` progressive samples in ONE device dispatch via the
        ray-regeneration wavefront (render/wavefront.py). Produces exactly
        the same accumulation as `spp` sequential step() calls."""
        from rsoderh_raytracing_tpu.render.wavefront import render_wavefront

        state_hash = self._state_hash()
        if state_hash != self._last_state_hash:
            self.film.reset()
            self._last_state_hash = state_hash

        summed = render_wavefront(
            self.device_scene,
            self._device_env(),
            camera_pytree(self.camera),
            np.uint32(self.film.sample_count),
            (self.width, self.height),
            np.uint32(spp),
            self.max_bounces,
        )
        self.film.add_samples(summed, spp)
        return self.film.sample_count

    def step_freerun(self, iterations: int) -> int:
        """Run the iteration-budget wavefront: every lane stays busy for
        `iterations` path segments, yielding a variable per-pixel sample
        count (best throughput; see render/wavefront.py:render_freerun).
        Returns the minimum per-pixel sample count."""
        from rsoderh_raytracing_tpu.render.wavefront import render_freerun

        state_hash = self._state_hash()
        if state_hash != self._last_state_hash:
            self.film.reset()
            self._last_state_hash = state_hash

        summed, counts, stats = render_freerun(
            self.device_scene,
            self._device_env(),
            camera_pytree(self.camera),
            self.film.counts,  # device array: no host round trip
            (self.width, self.height),
            np.uint32(iterations),
            self.max_bounces,
            with_stats=True,
        )
        self.film.add_freerun(summed, counts)
        # Observability: rays traced in this step (SURVEY.md section 5's
        # Mrays accounting), exposed for profiling/progress reporting.
        self.last_stats = {
            "closest_rays": float(stats["closest_rays"]),
            "shadow_rays": float(stats["shadow_rays"]),
            "iterations": int(stats["iterations"]),
        }
        return self.film.sample_count

    def render(
        self,
        spp: int = 16,
        progress: bool = False,
        batch: int | None = None,
        mode: str = "exact",
    ) -> np.ndarray:
        """Render until every pixel has >= `spp` samples; returns the
        tonemapped image (H,W,3) in linear [0,1].

        mode="exact": every pixel gets exactly `spp` samples (wavefront
        batches; batch=1 forces the per-sample scan path).
        mode="freerun": iteration-budget wavefront — fastest; cheap
        pixels exceed `spp`, loops until the minimum count reaches it.
        """
        start = time.perf_counter()
        if mode == "freerun":
            # ~3.5 segments per sample on typical scenes; budget rounds.
            # Per-call budget capped at 256 iterations so progress is
            # reported at a useful granularity on slow scenes; the
            # streams are identical regardless of the split.
            while self.film.sample_count < spp:
                remaining = spp - self.film.sample_count
                self.step_freerun(min(max(16, remaining * 4), 256))
                if progress:
                    elapsed = time.perf_counter() - start
                    done = self.film.sample_count
                    print(
                        f"  min spp {done}/{spp}"
                        f"  ({done / max(elapsed, 1e-9):.2f} spp/s)"
                    )
            return self.film.tonemapped()

        if self.film.sample_count and not self.film.is_uniform:
            raise ValueError(
                "exact mode cannot extend a non-uniform (free-run)"
                " accumulation: pixels above the per-pixel minimum would"
                " have sample indices re-rendered (their deterministic"
                " radiance added twice). Use mode='freerun'."
            )
        if batch is None:
            # 64-sample sub-batches bound one device call (2048^2 x 1024
            # spp is ~3600 wavefront iterations in one call otherwise)
            # so progress is reported at a useful granularity; the
            # per-(pixel,sample) streams are identical for any split.
            batch = min(spp, 64)
        # `spp` is the TOTAL target (the docstring's "until every pixel
        # has >= spp"): resuming a 64-spp checkpoint with spp=64 is a
        # no-op, same as freerun mode — not 64 more samples.
        done = self.film.sample_count
        while done < spp:
            n = min(batch, spp - done)
            if n == 1 and batch == 1:
                self.step()
            else:
                self.step_batch(n)
            done += n
            if progress:
                elapsed = time.perf_counter() - start
                print(
                    f"  sample {done}/{spp}"
                    f"  ({done / max(elapsed, 1e-9):.2f} spp/s)"
                )
        return self.film.tonemapped()

    def save_png(self, path: str) -> None:
        write_png(path, self.film.srgb8())

    def save_hdr(self, path: str) -> None:
        """Write the LINEAR mean radiance as a Radiance .hdr file —
        the un-tonemapped HDR counterpart of save_png, through the same
        RGBE codec that loads environments (env/hdr_io.py). An output
        the reference cannot produce (it only presents tonemapped
        frames to a window surface, src/hdr.rs:162-181); the file
        round-trips through load_image/read_hdr to RGBE-quantized
        radiance, so renders can feed pipelines or even serve as
        emissive environment maps."""
        from rsoderh_raytracing_tpu.env.hdr_io import write_hdr

        write_hdr(
            path, np.asarray(self.film.mean_radiance(), np.float32)
        )

    def _state_stamp(self) -> np.ndarray:
        """Deterministic cross-process render-state identity: the
        camera's raw f32 bit pattern (via its serialization codec) plus
        environment index and resolution. (The in-process _state_hash
        uses Python's hash(), which is randomized per process.)"""
        cam_bits = np.frombuffer(
            np.concatenate(
                [
                    np.asarray(self.camera.pos, np.float32),
                    np.asarray(
                        [self.camera.yaw, self.camera.pitch,
                         self.camera.fov_y],
                        np.float32,
                    ),
                ]
            ).tobytes(),
            dtype=np.uint32,
        )
        return np.concatenate(
            [
                cam_bits.astype(np.int64),
                np.asarray(
                    [self.environment_index, self.width, self.height],
                    np.int64,
                ),
            ]
        )

    def save_checkpoint(self, path: str) -> None:
        """Accumulation checkpoint stamped with the render state
        (camera bits/environment/resolution) it was produced under."""
        self.film.save_checkpoint(path, state_stamp=self._state_stamp())

    def load_checkpoint(self, path: str) -> None:
        """Load an accumulation checkpoint. Refuses a checkpoint whose
        recorded state stamp differs from the CURRENT camera/
        environment/resolution: blending accumulations from two states
        produces a silent double-exposure (restore the matching camera
        with --state, or render fresh). Stampless legacy checkpoints
        load as before."""
        self._check_state_stamp(path)
        self.film.load_checkpoint(path)

    def _check_state_stamp(self, path: str) -> None:
        with np.load(path) as z:
            if "state_stamp" not in z.files:
                return
            saved = z["state_stamp"]
        if not np.array_equal(saved, self._state_stamp()):
            raise ValueError(
                f"checkpoint {path} was accumulated under a different"
                " camera/environment/resolution state; pass the matching"
                " --state (the camera string printed when it was saved)"
                " or render fresh — blending states would double-expose"
            )

    # -- dev debug views (reference shader.wgsl:1314-1338) ------------------

    def debug_alias_scatter(
        self, draws_per_pixel: int = 20, sample_index: int = 0
    ) -> np.ndarray:
        """dev_index == 2: scatter-plot the alias-table distribution ON
        DEVICE with the device RNG, exactly like the reference's dev view
        (shader.wgsl:1314-1332): each screen pixel seeds its (pixel,
        sample) stream and draws `draws_per_pixel` alias samples; every
        draw adds 0.1/n at the drawn environment pixel. The result is
        static for given inputs, so it is cached — the viewer redraws it
        at full fps without re-reading an env-sized histogram from the
        device."""
        import jax
        import jax.numpy as jnp

        key = (self.environment_index, draws_per_pixel, sample_index,
               self.width, self.height)
        cached = getattr(self, "_alias_scatter_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]

        from rsoderh_raytracing_tpu.ops import rng

        denv = self._device_env()
        env = self.environments[self.environment_index]
        length = env.width * env.height
        pix = jnp.arange(self.width * self.height, dtype=jnp.uint32)
        state = rng.seed(pix, jnp.uint32(sample_index))
        hist = jnp.zeros((length,), jnp.float32)
        add = jnp.float32(0.1 / draws_per_pixel)
        # random_index_in_environment draws exactly TWO uniforms per
        # sample (no jitter draws — shader.wgsl:689-706), so this view
        # consumes the same stream positions as the reference's.
        for _ in range(draws_per_pixel):
            state, u_index = rng.next_uniform(state)
            index = jnp.minimum(
                (u_index * jnp.float32(length)).astype(jnp.int32),
                length - 1,
            )
            state, u_accept = rng.next_uniform(state)
            pair = jnp.take(denv.alias_pair, index, axis=0)
            final = jnp.where(
                u_accept < pair[..., 0],
                index,
                # int32 bits in the f32 row — see DeviceEnvironment
                jax.lax.bitcast_convert_type(pair[..., 1], jnp.int32),
            )
            hist = hist.at[final].add(add)
        img = np.asarray(hist).reshape(env.height, env.width)
        out = np.clip(img[..., None].repeat(3, axis=-1), 0.0, 1.0)
        self._alias_scatter_cache = (key, out)
        return out

    def debug_hdri_view(self) -> np.ndarray:
        """dev_index == 3: the active environment's raw HDRI, clamped."""
        env = self.environments[self.environment_index]
        return np.clip(env.texture, 0.0, 1.0)
