"""Environment map set: HDRI textures + alias tables, host and device side.

Parallels the reference's EnvironmentMaps (src/environments.rs:8-85): N
equirect HDRIs with per-pixel luminance*sin(theta) alias tables. The
reference concatenates all alias tables into one buffer with per-env
metadata {width, height, start_index}; here each environment is its own
pytree of static-shape arrays and the *active* environment is selected
host-side (switching environments resets progressive accumulation anyway,
so it is a recompile-free array swap, not traced control flow).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Any, List

import jax
import jax.numpy as jnp
import numpy as np

from rsoderh_raytracing_tpu.env.alias_table import (
    AliasTable,
    build_alias_table,
    build_weights_by_luminance,
)
from rsoderh_raytracing_tpu.env import hdr_io

# Names of the two HDRIs the reference embeds (src/state.rs:119-122).
DEFAULT_ENVIRONMENT_NAMES = ("winter_lake_01_2k", "passendorf_snow_2k")


@dataclasses.dataclass
class Environment:
    """One HDRI + its importance-sampling table (host side).

    The texture is RGBE-quantized at construction (hdr_io.rgbe_quantize):
    the device radiance tables store RGBE words, and building the alias
    table from the quantized values keeps stored pmfs, in-kernel pmf
    recomputes, and quad radiance mutually consistent. Real ``.hdr``
    sources are RGBE on disk already, so this matches the reference's
    effective texel values (src/state.rs:119-122)."""

    name: str
    texture: np.ndarray  # (H, W, 3) float32, lat-long (RGBE-quantized)
    alias: AliasTable
    weight_sum: float = 0.0  # f32(sum of luminance*sin(theta) weights)

    @property
    def width(self) -> int:
        return self.texture.shape[1]

    @property
    def height(self) -> int:
        return self.texture.shape[0]

    @staticmethod
    def from_texture(name: str, texture: np.ndarray) -> "Environment":
        texture = hdr_io.rgbe_quantize(np.asarray(texture, np.float32))
        weights = build_weights_by_luminance(texture)
        return Environment(
            name=name,
            texture=texture,
            alias=build_alias_table(weights),
            weight_sum=float(
                np.float32(weights.sum(dtype=np.float64))
            ),
        )


@dataclasses.dataclass(frozen=True)
class DeviceEnvironment:
    """The active environment on device. Consumed by ops/envmap.py.

    The sampling arrays are packed to minimize gathered rows per path
    segment, each row 16 bytes:
    - `quad`: (H*W, 4) uint32 — RGBE-encoded neighbor-packed texels
      [c00 c10 c01 c11]: ONE 16-byte gather serves a full bilinear fetch
      AND (via in-register pmf recompute) the MIS pdf of its texel.
      Legacy modes keep the round-1 (H*W, 16) bf16/f32 layout
      (12 radiance + 4 per-texel pmf columns).
    - `alias_pair`: (H*W, 4) f32 [probability, alias_index_bits,
      pmf_self, pmf_alias]: the alias decision AND the final index's pmf
      are one 16-byte gather. The alias index travels as the f32 BIT
      PATTERN of its int32 (bitcast on read): a value cast would round
      indices above 2^24, silently corrupting tables larger than 16.7M
      texels (an 8k HDRI is 33.5M).
    `texture_shape` is STATIC (H, W) metadata — device code needs only
    the shape; the f32 image stays host-side on the Environment.
    `pmf_norm` carries (length, weight_sum) f32 scalars for the
    in-register pmf recompute (see ops/envmap.py:radiance_and_pmf).
    """

    texture_shape: tuple  # (H, W) static metadata
    quad: Any  # (H*W, 4) u32 RGBE quad, or legacy (H*W, 16) bf16/f32
    alias_pair: Any  # (H*W, 4) [probability, index_bits, pmf_self, pmf_alias]
    pmf_norm: Any  # (2,) f32 [table length, weight sum]


jax.tree_util.register_dataclass(
    DeviceEnvironment,
    data_fields=["quad", "alias_pair", "pmf_norm"],
    meta_fields=["texture_shape"],
)


def device_environment(env: Environment, radiance_dtype="rgbe") -> DeviceEnvironment:
    """Upload an environment. `radiance_dtype` sets quad storage:
    - "rgbe" (default): 16-byte u32 rows — the measured gather-rate
      optimum; radiance values are exactly the (already RGBE-quantized)
      texture, the MIS pmf is recomputed in-register.
    - "bfloat16"/float32: legacy 32/64-byte rows with stored per-texel
      pmf columns. RGBE-quantized RADIANCE is exact in both dtypes, but
      bfloat16 rounds the pmf columns ~0.4%, so the BSDF-hit MIS pdf
      diverges slightly from the f32 NEE pdf — acceptable for the
      legacy/experimental mode only; the default RGBE mode recomputes
      the pmf in f32 and stays consistent.
    The alias table and the NEE pdf stay f32 in every mode."""
    tex = np.asarray(env.texture, np.float32)
    height, width = tex.shape[:2]
    xp = np.minimum(np.arange(width) + 1, width - 1)
    yp = np.minimum(np.arange(height) + 1, height - 1)
    if radiance_dtype == "rgbe":
        rgbe = hdr_io.float_to_rgbe(tex).astype(np.uint32)
        word = (
            rgbe[..., 0]
            | (rgbe[..., 1] << 8)
            | (rgbe[..., 2] << 16)
            | (rgbe[..., 3] << 24)
        )
        quad = np.stack(
            [word, word[:, xp], word[yp], word[yp][:, xp]], axis=-1
        ).reshape(height * width, 4)
        quad_dev = jnp.asarray(quad, dtype=jnp.uint32)
    else:
        pmf = np.asarray(env.alias.pmf, np.float32).reshape(height, width)
        quad = np.concatenate(
            [
                tex,
                tex[:, xp],
                tex[yp],
                tex[yp][:, xp],
                pmf[..., None],
                pmf[:, xp][..., None],
                pmf[yp][..., None],
                pmf[yp][:, xp][..., None],
            ],
            axis=-1,
        ).reshape(height * width, 16)
        quad_dev = jnp.asarray(quad, dtype=radiance_dtype)
    # NEE needs pmf of the FINAL index (self or alias) — pack both so the
    # alias decision and its pmf are one 16-byte gather. Indices ride as
    # raw int32 bit patterns (see DeviceEnvironment docstring).
    alias_pair = np.stack(
        [
            env.alias.probability,
            env.alias.alias_index.astype(np.int32).view(np.float32),
            env.alias.pmf,
            env.alias.pmf[env.alias.alias_index],
        ],
        axis=-1,
    )
    weight_sum = env.weight_sum
    if weight_sum <= 0.0:
        # Environments built without from_texture (direct construction)
        # leave weight_sum at the 0.0 default, which would silently make
        # every recomputed MIS pdf uniform; derive it from the texture
        # with the exact builder formula instead.
        weight_sum = float(
            np.float32(
                build_weights_by_luminance(tex).sum(dtype=np.float64)
            )
        )
    return DeviceEnvironment(
        texture_shape=(height, width),
        quad=quad_dev,
        alias_pair=jnp.asarray(alias_pair),
        pmf_norm=jnp.asarray(
            [np.float32(height * width), np.float32(weight_sum)],
            dtype=jnp.float32,
        ),
    )


class EnvironmentMaps:
    """Ordered set of environments; index cycling matches the reference's
    'e' key behavior (src/camera.rs:271-278)."""

    def __init__(self, environments: List[Environment]):
        if not environments:
            raise ValueError("need at least one environment")
        self.environments = environments

    def __len__(self) -> int:
        return len(self.environments)

    def __getitem__(self, index: int) -> Environment:
        return self.environments[index]

    def next_index(self, index: int) -> int:
        index += 1
        return 0 if index >= len(self.environments) else index


def load_default_environments(
    hdri_dir: str | None = None, resolution: int = 1024
) -> EnvironmentMaps:
    """Load HDRIs from `hdri_dir` (any .hdr/.npy files), or synthesize the
    two default procedural skies if the directory has none.

    The reference's HDRI assets are stripped from its repository mount, so
    the procedural skies are the default stand-ins; drop real 2k files
    into assets/hdri/ to use them instead.
    """
    if hdri_dir is None:
        hdri_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
            "assets",
            "hdri",
        )
    def _order(path: str):
        # The reference loads winter_lake first, passendorf second
        # (src/state.rs:119-122); keep that order for the known names,
        # extras after, alphabetically.
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            return (DEFAULT_ENVIRONMENT_NAMES.index(name), name)
        except ValueError:
            return (len(DEFAULT_ENVIRONMENT_NAMES), name)

    paths = sorted(
        glob.glob(os.path.join(hdri_dir, "*.hdr"))
        + glob.glob(os.path.join(hdri_dir, "*.npy")),
        key=_order,
    )
    environments = []
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            texture = hdr_io.load_image(path)
        except (ValueError, OSError) as err:
            import logging

            logging.getLogger(__name__).warning(
                "Skipping HDRI %s: %s", path, err
            )
            continue
        environments.append(Environment.from_texture(name, texture))

    if not environments:
        width, height = resolution, resolution // 2
        # Stand-in for winter_lake_01_2k: bright cold sky, high sun.
        environments.append(
            Environment.from_texture(
                DEFAULT_ENVIRONMENT_NAMES[0],
                hdr_io.procedural_sky(
                    width,
                    height,
                    sun_direction=(0.35, 0.45, -0.82),
                    sun_intensity=220.0,
                    zenith_color=(0.22, 0.45, 0.95),
                ),
            )
        )
        # Stand-in for passendorf_snow_2k: overcast warm low sun.
        environments.append(
            Environment.from_texture(
                DEFAULT_ENVIRONMENT_NAMES[1],
                hdr_io.procedural_sky(
                    width,
                    height,
                    sun_direction=(-0.6, 0.18, 0.78),
                    sun_intensity=90.0,
                    sun_radius=0.035,
                    zenith_color=(0.45, 0.52, 0.62),
                    horizon_color=(0.8, 0.78, 0.75),
                ),
            )
        )
    return EnvironmentMaps(environments)
