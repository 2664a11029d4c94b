#!/usr/bin/env python
"""Intersection routes on the GPU at 2048^2: the dense sweep (one
reduction over each primitive type's lanes, or a scan over windows of
lanes) against the flat-BVH walk (wide and narrow rows), for the
numbers behind the routing table (routing.py).

Each variant is compiled in its own process, all at once, with a time
limit: a compile that does not finish in time is reported, not waited
for. The compiled programs land in the persistent compile cache; then
each variant that compiled runs alone on the card (one process at a
time) for a short free-run through Renderer, and reports ms/iteration
and Mrays/s. Finally scripts/trace_profile.py runs.

Usage (on the card): python scripts/route_probe.py
ROUTE_PROBE_ONLY=<prefix> keeps the variants whose name starts with it;
ROUTE_PROBE_COMPILE_S bounds the compile phase (default 300 s).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZE = 2048
BOUNCES = 8
COMPILE_LIMIT_S = float(os.environ.get("ROUTE_PROBE_COMPILE_S", "300"))
RUN_LIMIT_S = 120
TOTAL_LIMIT_S = 840
# name: (scene, intersector, RT_BVH_PACKED, sweep form). Sweep forms:
# "windowed" is the GPU route (routing.sweep_window); "one" reduces each
# primitive type's lanes in one fusion.
VARIANTS = {
    "house sweep windowed": ("house", "sweep", None, "windowed"),
    "house sweep one": ("house", "sweep", None, "one"),
    "suzanne sweep one": ("suzanne", "sweep", None, "one"),
    "suzanne sweep windowed": ("suzanne", "sweep", None, "windowed"),
    "suzanne bvh packed": ("suzanne", "bvh", "1", "windowed"),
    "suzanne bvh narrow": ("suzanne", "bvh", "0", "windowed"),
    "suzanne_hi sweep one": ("suzanne_hi", "sweep", None, "one"),
    "suzanne_hi sweep windowed": ("suzanne_hi", "sweep", None, "windowed"),
    "suzanne_hi bvh packed": ("suzanne_hi", "bvh", "1", "windowed"),
    "suzanne_hi bvh narrow": ("suzanne_hi", "bvh", "0", "windowed"),
}
if os.environ.get("ROUTE_PROBE_ONLY"):
    VARIANTS = {k: v for k, v in VARIANTS.items()
                if k.startswith(os.environ["ROUTE_PROBE_ONLY"])}


def _setup(variant: str):
    scene, intersector, packed, form = VARIANTS[variant]
    if packed is None:
        os.environ.pop("RT_BVH_PACKED", None)
    else:
        os.environ["RT_BVH_PACKED"] = packed
    import dataclasses

    import jax

    from rsoderh_raytracing_tpu import load_scene, routing
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer
    from rsoderh_raytracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("route_probe: JAX found no GPU")
    if form == "one":
        routing.ROUTES["gpu"] = dataclasses.replace(
            routing.ROUTES["gpu"], sweep_window=None)
    r = Renderer(
        load_scene(os.path.join(ROOT, "assets", "scenes", f"{scene}.toml")),
        width=SIZE, height=SIZE, environments=load_default_environments(),
        max_bounces=BOUNCES, intersector=intersector,
    )
    return r


def compile_one(variant: str) -> dict:
    import numpy as np

    from rsoderh_raytracing_tpu.render.integrator import camera_pytree
    from rsoderh_raytracing_tpu.render.wavefront import render_freerun

    r = _setup(variant)
    t0 = time.perf_counter()
    compiled = render_freerun.lower(
        r.device_scene, r._device_env(), camera_pytree(r.camera),
        r.film.counts, (SIZE, SIZE), np.uint32(2), BOUNCES,
        with_stats=True,
    ).compile()
    m = compiled.memory_analysis()
    return {"compile_s": time.perf_counter() - t0,
            "temp_gib": m.temp_size_in_bytes / 2**30,
            "arg_gib": m.argument_size_in_bytes / 2**30,
            "route": r.intersector}


def run_one(variant: str) -> dict:
    import jax

    r = _setup(variant)
    t0 = time.perf_counter()
    r.step_freerun(1)  # a cache hit; warms the executable
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    r.step_freerun(2)
    wall = time.perf_counter() - t0
    st = r.last_stats
    rays = st["closest_rays"] + st["shadow_rays"]
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    return {"first_s": first, "iterations": st["iterations"], "wall_s": wall,
            "ms_per_iteration": wall / st["iterations"] * 1e3,
            "mrays": rays / wall / 1e6, "peak_gib": peak / 2**30}


def _child(mode: str, variant: str, env: dict, limit: float):
    cmd = [sys.executable, os.path.abspath(__file__), mode, variant]
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=limit)
    except subprocess.TimeoutExpired:
        return {"error": f"not finished within {limit:.0f} s"}
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        tail = [ln for ln in proc.stderr.splitlines() if ln.strip()][-3:]
        return {"error": f"rc {proc.returncode}: {' | '.join(tail)[:400]}"}
    return json.loads(lines[-1])


def main() -> int:
    if len(sys.argv) == 3:
        fn = compile_one if sys.argv[1] == "--compile" else run_one
        print(json.dumps(fn(sys.argv[2])), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    end = time.monotonic() + TOTAL_LIMIT_S

    # Compile every variant at once, each process with a small share of
    # the card (compiling needs almost none of its memory).
    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false",
               XLA_PYTHON_CLIENT_MEM_FRACTION="0.05")
    logs = os.path.join(ROOT, "chiprun_out", "route_probe")
    os.makedirs(logs, exist_ok=True)
    procs, errs = {}, {}
    for v in VARIANTS:
        errs[v] = open(os.path.join(logs, v.replace(" ", "_") + ".log"), "w")
        procs[v] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--compile", v],
            env=env, stdout=subprocess.PIPE, stderr=errs[v], text=True)
    deadline = time.monotonic() + COMPILE_LIMIT_S
    compiled = {}
    for v, p in procs.items():
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if p.returncode == 0 and lines:
                compiled[v] = json.loads(lines[-1])
                print(f"{v}: compile {json.dumps(compiled[v])}", flush=True)
            else:
                print(f"{v}: compile failed rc {p.returncode} (see"
                      f" chiprun_out/route_probe/)", flush=True)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            print(f"{v}: compile not finished within {COMPILE_LIMIT_S} s",
                  flush=True)
        finally:
            errs[v].close()

    for v in compiled:
        left = end - time.monotonic()
        if left < 60:
            print(f"{v}: run skipped (probe time limit)", flush=True)
            continue
        res = _child("--run", v, dict(os.environ), min(RUN_LIMIT_S, left))
        print(f"{v}: run {json.dumps(res)}", flush=True)

    if end - time.monotonic() < 120:
        print("trace_profile: skipped (probe time limit)", flush=True)
        return 0
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "trace_profile.py")],
            capture_output=True, text=True,
            timeout=max(60.0, end - time.monotonic()))
        for ln in proc.stdout.splitlines():
            print(f"trace_profile: {ln}", flush=True)
        if proc.returncode != 0:
            tail = [ln for ln in proc.stderr.splitlines() if ln.strip()][-5:]
            print(f"trace_profile rc {proc.returncode}: {tail}", flush=True)
    except subprocess.TimeoutExpired:
        print("trace_profile: not finished in the probe's time limit",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
