#!/usr/bin/env python
"""Measure interactive-viewer frame rate at the default viewer config.

The terminal viewer steps the free-run wavefront once per frame
(viewer/terminal.py run_viewer); this measures that step + tonemap +
host readback — the full per-frame device work — without a PTY, at the
viewer's default 256x144 resolution .

Two scenarios:
- converge: camera still, film accumulating (the common case)
- moving: camera moves every frame -> film reset + fresh sample counts
  (the worst case: every frame re-traces from spp 0)

Usage: python scripts/viewer_fps.py [scene] [width height] [frames]
Prints one JSON line per scenario.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.render.renderer import Renderer
    from rsoderh_raytracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from rsoderh_raytracing_tpu.viewer import terminal as term

    enable_compile_cache()

    scene_name = sys.argv[1] if len(sys.argv) > 1 else "default"
    width = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    height = int(sys.argv[3]) if len(sys.argv) > 3 else 144
    frames = int(sys.argv[4]) if len(sys.argv) > 4 else 60
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = load_scene(
        os.path.join(root, "assets", "scenes", f"{scene_name}.toml")
    )

    r = Renderer(scene, width=width, height=height)
    iters = 12  # run_viewer's freerun_iters default

    def frame(move: bool):
        if move:
            # nudge the camera like a held movement key would
            cam = r.camera
            cam = type(cam)(
                pos=(cam.pos[0] + 1e-3, cam.pos[1], cam.pos[2]),
                yaw=cam.yaw, pitch=cam.pitch, fov_y=cam.fov_y,
            )
            r.camera = cam
        count = r.step_freerun(iters)
        img = r.film.tonemapped()
        # the viewer converts to host for the ANSI frame
        _ = term._render_ansi(np.asarray(img), 100, 40)
        return count

    for scenario, move in (("converge", False), ("moving", True)):
        frame(move)  # warm up / compile
        start = time.perf_counter()
        for _ in range(frames):
            frame(move)
        dt = time.perf_counter() - start
        import jax

        print(json.dumps({
            "metric": f"viewer_fps_{scenario}",
            "scene": scene_name,
            "resolution": f"{width}x{height}",
            "platform": jax.devices()[0].platform,
            "value": round(frames / dt, 2),
            "unit": "frames/s",
            "ms_per_frame": round(1000 * dt / frames, 2),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
