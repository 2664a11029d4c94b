"""Pixel-matched comparison against the independent numpy transcription
of the reference shader (scripts/reference_estimator.py).

This is the BASELINE "RMSE vs reference at equal spp" check with the
numpy WGSL transcription standing in for the unrunnable Rust/wgpu
binary: both consume the same per-(pixel, sample) RNG streams, so
Monte-Carlo noise cancels and RMSE measures estimator divergence only.
Measured at 64x64 x 8spp on the house scene: 0.025% relative RMSE
(docs/ACCEPTANCE.md); the threshold here is loose against fp-level
path divergence flukes on other platforms."""

import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)))
)


def test_pixel_matched_rmse_vs_numpy_reference(assets_dir):
    from scripts.reference_estimator import render as np_render

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    size, spp = 32, 2
    scene_path = os.path.join(assets_dir, "scenes", "house.toml")
    envs = load_default_environments()
    ref = np_render(scene_path, envs[0], size, size, spp)

    renderer = Renderer(
        load_scene(scene_path), width=size, height=size, environments=envs
    )
    renderer.step_batch(spp)
    ours = renderer.film.mean_radiance()

    diff = ours - ref
    rmse = float(np.sqrt((diff**2).mean()))
    rel = rmse / float(np.sqrt((ref**2).mean()))
    # Equal-stream comparison: noise cancels; only estimator divergence
    # (or rare fp-flipped path decisions) remains.
    assert rel < 0.005, f"pixel-matched relative RMSE {rel:.4%}"
    assert (np.abs(diff) < 1e-3).mean() > 0.98


def test_pixel_matched_rmse_vs_numpy_reference_suzanne(assets_dir):
    """Same pixel-matched anchor on the 968-triangle suzanne scene: the
    triangle intersection sweep, winner attributes, and mesh estimator
    path agree with the independent WGSL transcription."""
    from scripts.reference_estimator import render as np_render

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    size, spp = 24, 2
    scene_path = os.path.join(assets_dir, "scenes", "suzanne.toml")
    envs = load_default_environments()
    ref = np_render(scene_path, envs[0], size, size, spp)

    renderer = Renderer(
        load_scene(scene_path), width=size, height=size, environments=envs
    )
    renderer.step_batch(spp)
    ours = np.asarray(renderer.film.mean_radiance())

    # 968 triangle edges per ray make whole-path fp flips far likelier
    # than on house (measured: 2/576 pixels flip at 24^2 x 2spp, the
    # rest agree to 1e-6). Flipped paths are legitimate (both sides
    # integrate the same estimator); assert the contract directly:
    # almost every pixel pixel-matches, flips stay rare, and RMSE over
    # the non-flipped set is estimator-level small.
    diff = np.abs(ours - ref).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() < 0.01, f"{flipped.sum()} flipped pixels"
    assert (diff < 1e-4).mean() > 0.98
    keep = ~flipped
    rmse = float(np.sqrt(((ours - ref)[keep] ** 2).mean()))
    rel = rmse / float(np.sqrt((ref[keep] ** 2).mean()))
    assert rel < 0.005, f"non-flipped relative RMSE {rel:.4%}"


def test_suzanne_hi_anchor_golden(assets_dir):
    """Oracle-derived golden ABOVE 968 triangles:
    tests/goldens/suzanne_hi_anchor_24_2spp.npy is the INDEPENDENT
    numpy transcription's mean radiance for suzanne_hi (15,488
    triangles) at 24x24 x 2spp, equal streams — the scale where the
    Morton chunk reorder and TRI_CHUNK padding engage. Same contract as
    the suzanne anchor: dense
    triangle sweeps make whole-path fp flips likelier than house, so
    flips are bounded and RMSE is taken over the non-flipped set.

    Regenerate ONLY via `python scripts/reference_estimator.py --scene
    assets/scenes/suzanne_hi.toml --size 24 --spp 2 --out
    tests/goldens/suzanne_hi_anchor_24_2spp.npy` after an INTENTIONAL
    estimator change. Matches /root/reference/src/shaders/shader.wgsl
    :1213-1303 over mesh-heavy content."""
    import os as _os

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    ref = np.load(
        _os.path.join(
            _os.path.dirname(__file__), "goldens",
            "suzanne_hi_anchor_24_2spp.npy",
        )
    )
    size, spp = 24, 2
    envs = load_default_environments()
    renderer = Renderer(
        load_scene(_os.path.join(assets_dir, "scenes", "suzanne_hi.toml")),
        width=size,
        height=size,
        environments=envs,
    )
    renderer.step_batch(spp)
    ours = np.asarray(renderer.film.mean_radiance())

    diff = np.abs(ours - ref).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() < 0.03, f"{flipped.sum()} flipped pixels"
    assert (diff < 1e-4).mean() > 0.95
    keep = ~flipped
    rmse = float(np.sqrt(((ours - ref)[keep] ** 2).mean()))
    rel = rmse / float(np.sqrt((ref[keep] ** 2).mean()))
    assert rel < 0.005, f"non-flipped relative RMSE {rel:.4%}"


def test_per_cast_anchor_spheres(assets_dir):
    """Deterministic per-cast anchor for the 1000-sphere benchmark
    scene: closest-hit identity, winner priority, and
    normals against the independent WGSL transcription on identical
    rays. Image-level pixel matching on this scene is fp-chaotic (see
    test_spheres_anchor_golden below), so the sphere-specific estimator
    pieces — the quadratic, the inside flip, winner order — are anchored
    HERE, where the comparison is single-cast and deterministic.

    Measured (round 4): hit/material identity 100%, t rel diff median 0
    / q99 1.6e-4 (the quadratic's b^2-4ac cancellation amplifies one
    rounding ulp to ~sqrt(ulp) in t), winner-identity flips 0.16%,
    normal flips 0.098%."""
    import scripts.reference_estimator as ref_est

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.ops.intersect import closest_hit
    from rsoderh_raytracing_tpu.scene.device import build_device_scene

    scene_path = os.path.join(assets_dir, "scenes", "spheres.toml")
    ds = build_device_scene(load_scene(scene_path))
    _, rscene = ref_est.build_scene(scene_path)

    rng = np.random.default_rng(0)
    o = rng.uniform(-2, 12, (8192, 3)).astype(np.float32)
    d = rng.normal(0, 1, (8192, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True).astype(np.float32)

    did_ref, t_ref, _p, n_ref, m_ref = ref_est.cast_ray(rscene, o, d)
    hr = closest_hit(ds, o, d)
    did = np.asarray(hr.did_hit)
    assert (did == did_ref).mean() == 1.0, "hit identity must be exact"
    both = did & did_ref
    assert (
        np.asarray(hr.material_id)[both] == m_ref[both]
    ).mean() > 0.995, "winner identity (via material)"
    dt = np.abs(np.asarray(hr.distance)[both] - t_ref[both]) / np.maximum(
        t_ref[both], 1e-6
    )
    assert np.quantile(dt, 0.5) < 1e-6
    assert (dt > 1e-3).mean() < 0.01, "winner-identity-scale t flips"
    dn = np.abs(np.asarray(hr.normal)[both] - n_ref[both]).max(-1)
    assert (dn > 1e-3).mean() < 0.005, "normal flips (incl. inside flip)"


def test_spheres_anchor_golden(assets_dir):
    """Oracle-derived golden for spheres.toml.

    tests/goldens/spheres_anchor_32_4spp.npy is the INDEPENDENT numpy
    transcription's mean radiance at 32x32 x 4spp, equal streams.
    Unlike house (0.025% pixel-matched), a 1000-sphere scene is
    fp-CHAOTIC across implementations: each cast runs ~1000 sphere
    quadratics whose b^2-4ac cancellation amplifies any rounding-order
    difference (our expanded precomputed-c2 form vs the WGSL's oc
    form), so whole-path trajectories flip on ~40% of 4-spp pixels.
    Both sides remain the same estimator: where trajectories coincide
    the values pixel-match at estimator level (measured 0.091% rel
    RMSE over the ~60% non-flipped set), and a float64 run of the SAME
    transcription brackets both f32 renders — ours lands CLOSER to the
    f64 truth than the f32 transcription itself (-2.5% vs -5.2% image
    mean; the deficit is spurious f32 sphere self-intersection past
    the reference's t >= 1e-4 defense, measured: raising SPHERE_EPS to
    1.5e-3 moves our mean onto the f64 value — docs/ACCEPTANCE.md).

    Regenerate ONLY via `python scripts/reference_estimator.py --scene
    assets/scenes/spheres.toml --size 32 --spp 4 --out
    tests/goldens/spheres_anchor_32_4spp.npy` after an INTENTIONAL
    estimator change."""
    import os as _os

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    ref = np.load(
        _os.path.join(
            _os.path.dirname(__file__), "goldens",
            "spheres_anchor_32_4spp.npy",
        )
    )
    size, spp = 32, 4
    envs = load_default_environments()
    renderer = Renderer(
        load_scene(_os.path.join(assets_dir, "scenes", "spheres.toml")),
        width=size,
        height=size,
        environments=envs,
    )
    renderer.step_batch(spp)
    ours = np.asarray(renderer.film.mean_radiance())

    diff = ours - ref
    ad = np.abs(diff).max(-1)
    flipped = ad > 1e-2
    # Where fp trajectories coincide, values must pixel-match.
    assert (ad < 1e-4).mean() > 0.45, "bit-matched pixel share collapsed"
    keep = ~flipped
    rel = float(
        np.sqrt((diff[keep] ** 2).mean()) / np.sqrt((ref[keep] ** 2).mean())
    )
    assert rel < 0.005, f"non-flipped relative RMSE {rel:.4%}"
    # Flipped trajectories are the same estimator re-rolled; the image
    # mean must stay inside the measured fp band around the oracle
    # (ours sits ~+2.3% of it, BETWEEN the f32 oracle and f64 truth).
    mrel = abs(float(ours.mean()) - float(ref.mean())) / float(ref.mean())
    assert mrel < 0.05, f"image-mean divergence {mrel:.4%}"


def test_anchor_derived_golden(assets_dir):
    """Golden cross-link: one committed golden that
    was generated by the INDEPENDENT numpy transcription, not the
    framework. tests/goldens/house_anchor_32_4spp.npy holds the
    transcription's mean radiance for house @ 32x32 x 4spp; the
    framework must reproduce it within estimator-level tolerance
    (stated: 0.5% relative RMSE on the equal-stream comparison, with
    >=98% of values matching to 1e-3 absolute). Regenerate ONLY via
    `python scripts/reference_estimator.py --scene
    assets/scenes/house.toml --size 32 --spp 4 --out
    tests/goldens/house_anchor_32_4spp.npy` after an INTENTIONAL
    estimator change."""
    import os as _os

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    golden_path = _os.path.join(
        _os.path.dirname(__file__), "goldens", "house_anchor_32_4spp.npy"
    )
    ref = np.load(golden_path)

    size, spp = 32, 4
    envs = load_default_environments()
    renderer = Renderer(
        load_scene(_os.path.join(assets_dir, "scenes", "house.toml")),
        width=size,
        height=size,
        environments=envs,
    )
    renderer.step_batch(spp)
    ours = np.asarray(renderer.film.mean_radiance())

    diff = ours - ref
    rmse = float(np.sqrt((diff**2).mean()))
    rel = rmse / float(np.sqrt((ref**2).mean()))
    assert rel < 0.005, f"anchored-golden relative RMSE {rel:.4%}"
    assert (np.abs(diff) < 1e-3).mean() > 0.98
