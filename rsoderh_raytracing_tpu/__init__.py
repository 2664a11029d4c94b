"""rsoderh_raytracing_tpu — a progressive Monte Carlo path tracer on JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
renderer INDA25PlusPlus/rsoderh-raytracing (Rust + WGSL + wgpu):

- TOML scene descriptions (same schema: ``[[material]]``, ``[[object]]``
  tagged ``Sphere``/``Plane``/``Mesh`` entries, ``[camera]``), OBJ meshes,
  HDRI environment lighting with alias-table importance sampling.
- Physically based GGX + Lambert BSDF with VNDF sampling, next-event
  estimation and power-heuristic MIS, progressive per-sample accumulation,
  ACES tonemapping.
- The render inner loop is a wavefront of rays batched across
  pixels x samples, jitted for the GPU; intersection runs as dense
  vectorized primitive tests or a flat-BVH walk, chosen per backend
  (routing.py); scaling across devices uses ``jax.sharding.Mesh`` +
  ``shard_map`` with ``psum`` sample reduction.

Host-side scene building (TOML/OBJ parsing, SAH BVH build, alias tables)
lives in numpy with an optional C++ native fast path.
"""

__version__ = "0.1.0"

import os as _os

if _os.environ.get("RT_DEBUG_NANS") == "1":
    # Opt-in NaN sanitizer (SURVEY.md section 5: the reference has no
    # sanitizers; pure-functional JAX needs none, but jax_debug_nans is
    # the cheap win available). Re-runs any op producing a NaN
    # un-jitted and raises FloatingPointError at the source op.
    import jax as _jax

    _jax.config.update("jax_debug_nans", True)

from rsoderh_raytracing_tpu.scene.toml_loader import load_scene  # noqa: F401
from rsoderh_raytracing_tpu.scene.camera import Camera  # noqa: F401

# The `render` SUBPACKAGE shares its name with the `render()` function
# below. Import it eagerly so Python binds the package attribute NOW
# and the `def render` below wins permanently — otherwise the first
# deep import (e.g. rsoderh_raytracing_tpu.render.renderer, which
# render() itself performs) rebinds the attribute to the module and a
# second `rt.render(...)` raises TypeError: 'module' is not callable.
import rsoderh_raytracing_tpu.render  # noqa: E402,F401


def render(scene, width=512, height=512, spp=16, **kwargs):
    """Convenience one-shot render. See render/renderer.py:Renderer."""
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    renderer = Renderer(scene, width=width, height=height, **kwargs)
    return renderer.render(spp=spp)


def view(
    scene,
    width: int = 256,
    height: int = 144,
    movement_keys: str = "wasdqe",
    other_keys: str = "cpe",
    **kwargs,
):
    """Open the interactive terminal viewer on `scene` (the reference's
    run() entry, src/lib.rs:19-39, maps to this + `render` above).
    Key strings follow the reference layout config (6 movement + 3
    other); extra kwargs pass to viewer/terminal.py:run_viewer
    (environments, max_bounces, max_fps). Requires a TTY."""
    from rsoderh_raytracing_tpu.scene.camera import KeyboardLayout
    from rsoderh_raytracing_tpu.viewer.terminal import run_viewer

    layout = KeyboardLayout.parse_config(movement_keys, other_keys)
    return run_viewer(scene, layout, width=width, height=height, **kwargs)
