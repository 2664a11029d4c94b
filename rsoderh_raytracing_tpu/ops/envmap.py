"""Device-side HDRI environment sampling (equirect + alias table).

Vectorised re-design of shader.wgsl:663-831: alias-table lookups become
jnp gathers over SoA arrays; the wgpu Linear/ClampToEdge sampler becomes
an explicit 4-tap bilinear gather. Texture width/height are static
Python ints under jit (baked from the array shape), so all the index
math compiles to pure integer ops.

Device constant PI = 3.14159 matches the shader (shader.wgsl:239).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rsoderh_raytracing_tpu.env.environment import DeviceEnvironment
from rsoderh_raytracing_tpu.ops import rng

PI = rng.PI_DEVICE
INV_PI = 1.0 / PI


def decode_rgbe(word):
    """(...,) uint32 RGBE words -> (..., 3) f32 radiance.

    Inverse of hdr_io.float_to_rgbe packing (value = byte * 2^(e-136),
    e == 0 -> black). The 2^(e-136) scale is built by bit-constructing
    the f32 exponent field — pure integer VPU ops, no transcendental.
    float_to_rgbe only emits e == 0 or e >= 22, so the biased exponent
    (e - 136 + 127) never leaves the normal range for non-black texels.
    """
    word = word.astype(jnp.uint32)
    r = (word & jnp.uint32(0xFF)).astype(jnp.float32)
    g = ((word >> 8) & jnp.uint32(0xFF)).astype(jnp.float32)
    b = ((word >> 16) & jnp.uint32(0xFF)).astype(jnp.float32)
    e = (word >> 24).astype(jnp.int32)
    bits = jnp.clip(e - 136 + 127, 1, 254).astype(jnp.int32) << 23
    scale = jnp.where(
        e == 0,
        0.0,
        jax.lax.bitcast_convert_type(bits, jnp.float32),
    )
    return jnp.stack([r, g, b], axis=-1) * scale[..., None]


def _texel_pmf(env: DeviceEnvironment, rgb, py, height: int):
    """Recompute the alias-table pmf of a texel from its (decoded) f32
    radiance, replicating alias_table.build_weights_by_luminance /
    build_alias_table f32 op order: w = lum * sin((y+0.5) * (pi/H));
    pmf = ((w * L) / Z) / L. The texture is RGBE-quantized at build time
    so `rgb` here equals the values the alias table was built from.

    The STORED pmf (alias_pair row, used by NEE) equals this recompute
    for EVERY entry — including Vose-pairing leftovers, which store
    their true weight-proportional pmf rather than the reference's
    identity 1/L (env/alias_table.py explains why: a bright texel
    stranded in the large worklist would otherwise pair a ~1/L NEE pdf
    with a weight-proportional BSDF-hit pdf, and the two MIS arms would
    no longer partition unity). Residual difference is the f32
    rounding-order of (w*L/Z)/L vs the builder's w/Z normalization —
    ulp-scale."""
    lum = (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )
    import numpy as np

    # np.pi, NOT the shader's truncated PI_DEVICE: the alias builder
    # (build_weights_by_luminance) uses np.pi for sin(theta_row).
    sin_theta = jnp.sin(
        (py.astype(jnp.float32) + 0.5) * jnp.float32(np.pi / height)
    )
    w = lum * sin_theta
    length = env.pmf_norm[0]
    total = env.pmf_norm[1]
    return jnp.where(
        total > 0.0,
        ((w * length) / total) / length,
        1.0 / length,
    )


def direction_to_equirect_uv(direction):
    """(N,3) unit directions -> (N,2) uv. (shader.wgsl:710-714)"""
    u = jnp.arctan2(direction[..., 2], direction[..., 0]) * (INV_PI * 0.5) + 0.5
    v = 0.5 - jnp.arcsin(jnp.clip(direction[..., 1], -1.0, 1.0)) * INV_PI
    return jnp.stack([u, v], axis=-1)


def equirect_uv_to_direction(uv):
    """(N,2) uv -> (N,3) direction. (shader.wgsl:718-732)"""
    phi = (2.0 * uv[..., 0] - 1.0) * PI
    theta = PI * uv[..., 1]
    sin_theta = jnp.sin(theta)
    return jnp.stack(
        [
            sin_theta * jnp.cos(phi),
            jnp.cos(theta),
            sin_theta * jnp.sin(phi),
        ],
        axis=-1,
    )


def pixel_solid_angle(v, width: int, height: int):
    """Approximate solid angle of the lat-long pixel at vertical coord v.
    (shader.wgsl:739-749)"""
    theta = PI * v
    sin_t = jnp.maximum(1.0e-6, jnp.sin(theta))
    d_phi = 2.0 * PI / width
    d_theta = PI / height
    return d_phi * d_theta * sin_t


def _uv_to_pixel_index(uv, width: int, height: int):
    x = jnp.minimum((uv[..., 0] * width).astype(jnp.int32), width - 1)
    y = jnp.minimum((uv[..., 1] * height).astype(jnp.int32), height - 1)
    return x + y * width


def bilinear_sample(texture, uv):
    """4-tap bilinear fetch with clamp-to-edge, texel centers at +0.5.

    texture: (H, W, 3); uv: (N, 2) -> (N, 3). Reference formulation (four
    separate gathers); the hot path uses `bilinear_sample_quad`.
    """
    height, width = texture.shape[0], texture.shape[1]
    x = uv[..., 0] * width - 0.5
    y = uv[..., 1] * height - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    x0i = jnp.clip(x0.astype(jnp.int32), 0, width - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, width - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, height - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, height - 1)

    flat = texture.reshape(-1, texture.shape[-1])
    c00 = jnp.take(flat, y0i * width + x0i, axis=0)
    c10 = jnp.take(flat, y0i * width + x1i, axis=0)
    c01 = jnp.take(flat, y1i * width + x0i, axis=0)
    c11 = jnp.take(flat, y1i * width + x1i, axis=0)

    top = c00 * (1.0 - fx) + c10 * fx
    bottom = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bottom * fy


def _quad_fetch(env: DeviceEnvironment, uv):
    """Shared quad-row gather: returns (row f32, four texels (N,3) each,
    fx, fy, x0i, y0i). `row` is None in RGBE mode (no pmf columns)."""
    height, width = env.texture_shape[0], env.texture_shape[1]
    x = uv[..., 0] * width - 0.5
    y = uv[..., 1] * height - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = jnp.where(x0 < 0, 0.0, x - x0)[..., None]
    fy = jnp.where(y0 < 0, 0.0, y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, width - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, height - 1)

    if env.quad.dtype == jnp.uint32:  # RGBE: (L, 4) u32, 16-byte rows
        words = jnp.take(env.quad, y0i * width + x0i, axis=0)
        texels = decode_rgbe(words)  # (N, 4, 3)
        c00, c10, c01, c11 = (
            texels[..., 0, :],
            texels[..., 1, :],
            texels[..., 2, :],
            texels[..., 3, :],
        )
        row = None
    else:  # legacy (L, 16) bf16/f32: 12 radiance + 4 pmf columns
        row = jnp.take(env.quad, y0i * width + x0i, axis=0).astype(
            jnp.float32
        )
        c00, c10, c01, c11 = (
            row[..., 0:3],
            row[..., 3:6],
            row[..., 6:9],
            row[..., 9:12],
        )
    return row, c00, c10, c01, c11, fx, fy, x0i, y0i


def bilinear_sample_quad(env: DeviceEnvironment, uv):
    """Bilinear fetch as ONE gather from the neighbor-packed quad array.

    Identical result to `bilinear_sample` on env.texture: the packed row
    at (y0, x0) holds [c00 c10 c01 c11]; left/top clamped taps are
    handled by zeroing the fraction (the packed row's +1 neighbors are
    clamped at build time for the right/bottom edges).
    """
    _, c00, c10, c01, c11, fx, fy, _, _ = _quad_fetch(env, uv)
    top = c00 * (1.0 - fx) + c10 * fx
    bottom = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bottom * fy


def radiance_and_pmf(env: DeviceEnvironment, uv):
    """ONE gather -> (bilinear radiance (N,3), pmf at uv's pixel (N,)).

    The pixel that `_uv_to_pixel_index(uv)` addresses is always one of
    the row's four texels, selected by comparing floor(u*W) with the
    row's x0 (same for y). In RGBE mode its pmf is recomputed in-register
    from the selected texel's radiance (see _texel_pmf); legacy rows
    carry stored per-texel pmf columns.
    """
    height, width = env.texture_shape[0], env.texture_shape[1]
    row, c00, c10, c01, c11, fx, fy, x0i, y0i = _quad_fetch(env, uv)
    top = c00 * (1.0 - fx) + c10 * fx
    bottom = c01 * (1.0 - fx) + c11 * fx
    radiance = top * (1.0 - fy) + bottom * fy

    px = jnp.minimum((uv[..., 0] * width).astype(jnp.int32), width - 1)
    py = jnp.minimum((uv[..., 1] * height).astype(jnp.int32), height - 1)
    sel_x = px != x0i
    sel_y = py != y0i
    if row is None:
        sel = jnp.where(
            sel_y[..., None],
            jnp.where(sel_x[..., None], c11, c01),
            jnp.where(sel_x[..., None], c10, c00),
        )
        pmf = _texel_pmf(env, sel, py, height)
    else:
        pmf = jnp.where(
            sel_y,
            jnp.where(sel_x, row[..., 15], row[..., 14]),
            jnp.where(sel_x, row[..., 13], row[..., 12]),
        )
    return radiance, pmf


def sky_light(env: DeviceEnvironment, direction):
    """Environment radiance along escaped rays (shader.wgsl:822-831)."""
    return bilinear_sample_quad(env, direction_to_equirect_uv(direction))


def direction_pdf(env: DeviceEnvironment, direction):
    """PDF (per steradian) of sampling `direction` from the alias table.
    (shader.wgsl:753-769)

    Reads the pmf from the quad's packed pmf columns (same storage the
    wavefront's fused fetch uses) so both integrators compute identical
    MIS weights regardless of the quad dtype."""
    height, width = env.texture_shape[0], env.texture_shape[1]
    uv = direction_to_equirect_uv(direction)
    _, pmf = radiance_and_pmf(env, uv)
    return pmf / pixel_solid_angle(uv[..., 1], width, height)


def sample_alias_index(state, env: DeviceEnvironment):
    """Alias-table index draw + jittered uv (shader.wgsl:689-706,793-803).

    Returns (state, final_index, uv, pmf) — pmf of the final index comes
    from the packed alias row, so NEE costs this single gather. Split
    from sample_environment so the wavefront integrator can fuse the
    radiance fetch with the miss path. RNG draw order matches the
    reference: index draw, alias-accept draw, jitter x, jitter y.
    """
    height, width = env.texture_shape[0], env.texture_shape[1]
    length = width * height

    state, u_index = rng.next_uniform(state)
    index = jnp.minimum(
        (u_index * jnp.float32(length)).astype(jnp.int32), length - 1
    )
    state, u_accept = rng.next_uniform(state)
    pair = jnp.take(env.alias_pair, index, axis=0)
    keep = u_accept < pair[..., 0]
    # The alias index travels as int32 BITS in the f32 row (a value cast
    # would round indices above 2^24 — see DeviceEnvironment).
    alias_idx = jax.lax.bitcast_convert_type(pair[..., 1], jnp.int32)
    index = jnp.where(keep, index, alias_idx)
    pmf = jnp.where(keep, pair[..., 2], pair[..., 3])

    x = index % width
    y = index // width
    state, jitter_x = rng.next_uniform(state)
    state, jitter_y = rng.next_uniform(state)
    uv = jnp.stack(
        [
            (x.astype(jnp.float32) + jitter_x) / width,
            (y.astype(jnp.float32) + jitter_y) / height,
        ],
        axis=-1,
    )
    return state, index, uv, pmf


def sample_environment(state, env: DeviceEnvironment):
    """Alias-table importance sample (shader.wgsl:782-820).

    Returns (new_rng_state, direction (N,3), radiance (N,3), pdf (N,)).
    """
    height, width = env.texture_shape[0], env.texture_shape[1]
    state, index, uv, pmf = sample_alias_index(state, env)
    direction = equirect_uv_to_direction(uv)
    radiance = bilinear_sample_quad(env, uv)
    pdf = pmf / pixel_solid_angle(uv[..., 1], width, height)
    return state, direction, radiance, pdf
