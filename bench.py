"""Benchmark: path-tracing throughput on the benchmark scene.

Renders assets/scenes/house.toml (BASELINE.md stress config) on the
GPU and reports Mrays/s, where rays = closest-hit rays actually alive
per bounce + NEE shadow rays for lanes that hit — the "pixels x spp x
mean path length" accounting from SURVEY.md section 5.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": "Mrays/s", "device_kind": ...,
   "device_count": N, "power_limit": ...}
With no GPU present it prints a JSON line with an "error" field and
exits nonzero; it never falls back to the CPU.

The parent process (this file run directly) stays off JAX, so exactly
one process holds the card: it runs the benchmark as a child subprocess
(RT_BENCH_CHILD=1) and retries a bounded number of times with backoff
when the child dies. If every attempt fails, the parent still prints
ONE machine-readable JSON line with an "error" field — never a raw
traceback as the perf record.

Knobs: RT_BENCH_ATTEMPTS (default 3), RT_BENCH_BACKOFF_S (default 45),
RT_BENCH_CHILD=1 runs the benchmark in-process (no retry wrapper).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "not measured" when nvidia-smi is unavailable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    return out or "not measured"


def run_bench() -> int:
    import jax

    from rsoderh_raytracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(json.dumps({
            "metric": "bench requires a GPU",
            "value": 0.0,
            "unit": "Mrays/s",
            "error": f"JAX found no GPU (platform {platform!r})",
        }))
        return 1

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        Environment,
        device_environment,
    )
    from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky
    from rsoderh_raytracing_tpu.render.integrator import camera_pytree
    from rsoderh_raytracing_tpu.scene.device import build_device_scene

    root = os.path.dirname(os.path.abspath(__file__))
    scene_name = os.environ.get("BENCH_SCENE", "house")  # house | suzanne | default
    # Subdivided meshes are generated deterministically, not committed
    # (17 MB / 70 MB) — see scripts/subdivide_obj.py.
    _gen_levels = {"suzanne_xhi": "4", "suzanne_xxhi": "5"}
    if scene_name in _gen_levels and not os.path.exists(
        os.path.join(root, "assets", f"{scene_name}.obj")
    ):
        import subprocess as _sp

        _sp.run(
            [sys.executable, os.path.join(root, "scripts", "subdivide_obj.py"),
             _gen_levels[scene_name],
             os.path.join(root, "assets", f"{scene_name}.obj")],
            check=True,
        )
    scene = load_scene(
        os.path.join(root, "assets", "scenes", f"{scene_name}.toml")
    )
    # BENCH_INTERSECTOR=bvh|auto: flat-BVH lockstep traversal
    # (ops/bvh_traverse.py) or the backend's routing (routing.py)
    # instead of the dense sweep.
    intersector = os.environ.get("BENCH_INTERSECTOR", "sweep")
    ds = build_device_scene(
        scene,
        with_bvh="auto" if intersector == "auto" else intersector == "bvh",
    )
    env = device_environment(
        Environment.from_texture("bench_sky", procedural_sky(2048, 1024))
    )
    cam = camera_pytree(scene.camera)

    size = int(os.environ.get("BENCH_SIZE", "2048"))
    max_bounces = int(os.environ.get("BENCH_BOUNCES", "8"))
    resolution = (size, size)
    n_pixels = size * size

    from rsoderh_raytracing_tpu.render.wavefront import (
        render_freerun,
        render_spp_sync,
    )

    spp = int(os.environ.get("BENCH_SPP", "16"))
    # BENCH_MODE=sync renders bounce-synchronized exact-spp rounds
    # (render_spp_sync) instead of the free-run budgeted wavefront; in
    # that mode BENCH_ITERS means SAMPLES per timed call.
    mode = os.environ.get("BENCH_MODE", "freerun")
    # Iteration budget per call: longer budgets amortize the wavefront
    # drain tail and the per-call sync; mesh scenes run far slower per
    # iteration, so they take a smaller per-call budget to keep the run
    # short.
    default_iters = {
        "house": "1024",
        "default": "1024",
        "suzanne": "128",
        "spheres": "128",  # 1000 spheres = 16 sphere chunks (suzanne-class)
        "suzanne_hi": "16",
        "suzanne_xhi": "2",
        "suzanne_xxhi": "1",
    }.get(scene_name, "64")
    if mode == "sync":
        default_iters = {"suzanne_hi": "4"}.get(scene_name, "32")
    iterations = int(os.environ.get("BENCH_ITERS", default_iters))

    def render_step(base_counts):
        if mode == "sync":
            return render_spp_sync(
                ds, env, cam, base_counts, resolution,
                np.uint32(iterations), max_bounces, with_stats=True,
            )
        return render_freerun(
            ds, env, cam, base_counts, resolution,
            np.uint32(iterations), max_bounces, with_stats=True,
        )

    # --- timed free-run wavefront renders ---------------------------------
    # Every traced ray lands in the film (free-run keeps all lanes busy,
    # with per-pixel sample counts), so throughput is measured directly
    # from the kernel's own ray counters.
    # Array-typed base counts from the start so the timed calls reuse the
    # same compiled executable (a scalar base would be a separate shape).
    warmup_img, warmup_counts, _ = render_step(
        np.zeros((size, size), np.uint32)
    )
    jax.block_until_ready(warmup_img)
    import jax.numpy as jnp

    counts = warmup_counts  # device array: no host round trips in the loop

    timed = int(os.environ.get("BENCH_STEPS", "3"))
    total_rays = 0.0
    total_spp = 0.0
    start = time.perf_counter()
    out = None
    for s in range(timed):
        # counts holds the PREVIOUS call's per-pixel sample tally; feeding
        # it back as base keeps every pixel's RNG stream advancing.
        out, counts_dev, stats = render_step(counts)
        counts = counts + counts_dev
        # stats are O(1) scalars — reading them is the step sync point.
        total_rays += float(stats["closest_rays"] + stats["shadow_rays"])
        total_spp += float(jnp.mean(counts_dev.astype(jnp.float32)))
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - start

    rays_per_pixel_sample = total_rays / (n_pixels * max(total_spp, 1e-9))
    mrays = total_rays / elapsed / 1e6

    result = {
        "metric": f"{scene_name}_{size}"
        f"{'_sync' if mode == 'sync' else ''} Mrays/s ({platform},"
        f" {max_bounces} bounces, {rays_per_pixel_sample:.2f} rays/px/spp)",
        "value": mrays,
        "unit": "Mrays/s",
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "power_limit": power_limit(),
    }
    print(json.dumps(result))
    return 0


def run_with_retry(child_cmd, attempts, backoff_s, *, log=None):
    """Run ``child_cmd`` until it emits a parseable result JSON line.

    Returns (result_dict, exit_code). A successful attempt is one whose
    last stdout line parses as a JSON object carrying a numeric "value";
    the parent relays that line verbatim. After ``attempts`` failures the
    returned dict is a structured failure record ({"error": ...}) so the
    driver's BENCH_r*.json always parses. Tested by
    tests/test_bench_retry.py with fake child commands.
    """
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    # Bound each attempt so a hung child is just another retryable
    # failure, and bound the WHOLE retry budget so the wrapper always
    # emits its JSON before an outer deadline would kill it silently.
    attempt_timeout = float(os.environ.get("RT_BENCH_TIMEOUT_S", "2400"))
    total_budget = float(os.environ.get("RT_BENCH_TOTAL_S", "3600"))
    deadline = time.monotonic() + total_budget
    errors = []
    for attempt in range(1, attempts + 1):
        remaining = deadline - time.monotonic()
        if attempt > 1 and remaining < 60:
            errors.append(
                f"total budget ({total_budget:.0f}s) exhausted before "
                f"attempt {attempt}"
            )
            log(errors[-1])
            break
        attempt_timeout = min(attempt_timeout, max(remaining, 60))
        try:
            proc = subprocess.run(
                child_cmd, capture_output=True, text=True,
                env={**os.environ, "RT_BENCH_CHILD": "1"},
                timeout=attempt_timeout,
            )
        except subprocess.TimeoutExpired:
            proc = None
        result = None
        if proc is not None and proc.returncode == 0:
            lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
            try:
                parsed = json.loads(lines[-1]) if lines else None
            except ValueError:
                parsed = None
            if isinstance(parsed, dict) and isinstance(
                parsed.get("value"), (int, float)
            ):
                result = parsed
        if result is not None:
            if attempt > 1:
                result["attempts"] = attempt
            return result, 0
        if proc is None:
            summary = f"attempt timed out after {attempt_timeout:.0f}s"
        else:
            # Keep only the informative tail of stderr: the last line that
            # looks like an exception ("pkg.SomeError: msg"), not literal
            # last-line noise like JAX's traceback-filtering notice.
            tail = [ln for ln in proc.stderr.splitlines() if ln.strip()]
            exc_lines = [
                ln for ln in tail
                if re.match(r"[\w.]*\w(Error|Exception|Interrupt)\b", ln)
            ]
            pick = exc_lines[-1] if exc_lines else (tail[-1] if tail else "")
            summary = (
                pick[:300] if pick else f"rc={proc.returncode}, no output"
            )
        errors.append(summary)
        log(
            f"bench attempt {attempt}/{attempts} failed: {summary}"
        )
        if attempt < attempts:
            log(f"retrying in {backoff_s:.0f}s")
            time.sleep(backoff_s)
    failure = {
        "metric": "bench failed after retries",
        "value": 0.0,
        "unit": "Mrays/s",
        "error": errors[-1] if errors else "unknown",
        "attempts": len(errors),
        "attempt_errors": errors,
    }
    return failure, 1


def main() -> int:
    if os.environ.get("RT_BENCH_CHILD") == "1":
        return run_bench()
    attempts = int(os.environ.get("RT_BENCH_ATTEMPTS", "3"))
    backoff_s = float(os.environ.get("RT_BENCH_BACKOFF_S", "45"))
    result, rc = run_with_retry(
        [sys.executable, os.path.abspath(__file__)], attempts, backoff_s
    )
    print(json.dumps(result))
    return rc


if __name__ == "__main__":
    sys.exit(main())
