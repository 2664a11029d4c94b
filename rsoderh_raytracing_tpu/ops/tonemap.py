"""ACES-fitted tonemapping (reference: src/shaders/hdr.wgsl:3-22).

The reference runs this as a fullscreen fragment pass over an
Rgba16Float texture; here it is a jitted elementwise function over the
(H, W, 3) mean-radiance image — XLA fuses it with the accumulation
divide. Negative inputs are highlighted magenta, as in the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# WGSL mat3x3 constructors are column-major; rows here are transposed
# accordingly so that (M @ v) matches (m * v) in the shader.
_M1 = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    dtype=np.float32,
)
_M2 = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    dtype=np.float32,
)


def _matvec(x, m):
    """x @ m.T in full f32 (a default-precision dot may run in TF32)."""
    return jnp.dot(x, m.T, precision=jax.lax.Precision.HIGHEST)


def aces_tonemap(hdr):
    """(..., 3) linear HDR -> (..., 3) tonemapped in [0,1]."""
    negative = jnp.any(hdr < 0.0, axis=-1, keepdims=True)
    v = _matvec(hdr, _M1)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    mapped = jnp.clip(_matvec(a / b, _M2), 0.0, 1.0)
    magenta = jnp.array([1.0, 0.0, 1.0], dtype=mapped.dtype)
    return jnp.where(negative, magenta, mapped)


def linear_to_srgb(linear):
    """IEC 61966-2-1 transfer, used when writing PNGs (the reference
    relies on the surface's sRGB view format for this conversion)."""
    linear = jnp.clip(linear, 0.0, 1.0)
    return jnp.where(
        linear <= 0.0031308,
        linear * 12.92,
        1.055 * jnp.power(linear, 1.0 / 2.4) - 0.055,
    )
