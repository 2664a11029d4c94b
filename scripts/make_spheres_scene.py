"""Generate assets/scenes/spheres.toml: a 1000-sphere benchmark scene.

The reference renders arbitrary sphere counts through its BVH
(src/bvh.rs:13-28 of the reference); this scene exercises the
framework with many spheres (padded to whole TRI_CHUNK windows,
scene/device.py). Deterministic (fixed seed): a
10x10x10 jittered grid of mixed plastic/metal spheres over a ground
plane, camera looking into the cloud.

Run from the repo root:  python scripts/make_spheres_scene.py
"""

from __future__ import annotations

import os

import numpy as np


def main() -> None:
    rng = np.random.default_rng(2024)
    lines = []
    mats = [
        ("plastic_warm", [1.0, 0.63, 0.41], 0.8, 0.0),
        ("plastic_cool", [0.45, 0.62, 1.0], 0.5, 0.0),
        ("metal_rough", [0.85, 0.85, 0.9], 0.35, 1.0),
        ("mirror", [0.9, 0.9, 0.9], 0.02, 1.0),
        ("ground", [0.95, 0.95, 0.95], 1.0, 0.0),
    ]
    for name, color, rough, metal in mats:
        lines += [
            "[[material]]",
            f'name = "{name}"',
            f"color = [ {color[0]}, {color[1]}, {color[2]} ]",
            f"roughness = {rough}",
            f"metallic = {metal}",
            "emission = [ 0, 0, 0 ]",
            "",
        ]

    # 10x10x10 jittered grid, spacing 2, centered, floating above ground
    picks = ["plastic_warm", "plastic_cool", "metal_rough", "mirror"]
    for ix in range(10):
        for iy in range(10):
            for iz in range(10):
                p = (
                    np.array([ix, iy, iz], np.float64) * 2.0
                    - np.array([9.0, -1.0, 9.0])
                    + rng.uniform(-0.55, 0.55, 3)
                )
                r = rng.uniform(0.18, 0.5)
                m = picks[int(rng.integers(0, len(picks)))]
                lines += [
                    "[[object]]",
                    "[object.Sphere]",
                    f'material = "{m}"',
                    f"pos = [ {p[0]:.4f}, {p[1]:.4f}, {p[2]:.4f} ]",
                    f"radius = {r:.4f}",
                    "",
                ]

    lines += [
        "[[object]]",
        "[object.Plane]",
        'material = "ground"',
        "pos = [ -40, 0, -40 ]",
        "forward = [ 0, 0, 80 ]",
        "right = [ 80, 0, 0 ]",
        "",
        "[camera]",
        "pos = [ 0.0, 10.0, 32.0 ]",
        "pitch = -0.25",
        "yaw = 0.0",
        "fov_y = 60.0",
        "",
    ]
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets",
        "scenes",
        "spheres.toml",
    )
    with open(out, "w") as f:
        f.write("\n".join(lines))
    print("wrote", out, f"({len(lines)} lines, 1000 spheres)")


if __name__ == "__main__":
    main()
