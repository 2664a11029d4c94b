#!/usr/bin/env python
"""Where an iteration's device time goes: a profiler trace of the
free-run wavefront on the GPU, reduced by named scope.

1. house.toml at 2048^2, 8 bounces, free-run through Renderer: one
   traced step after a warm-up. The device events are attributed to the
   wavefront's named scopes ("trace": closest hit + attributes + NEE
   occlusion; "env": alias draw and environment fetch; the rest is
   shading, regeneration and film) through the compiled program's HLO
   op metadata. Command buffers are off for this run, so that each
   kernel appears in the trace on its own. Prints the device idle share
   of the window, each scope's share of device time and the ten longest
   ops.
2. The trace step alone (ops/intersect.trace_nee on 2048^2 camera rays
   with random NEE directions): time, XLA's cost analysis (FLOPs and
   bytes) and the share of the FP32 and memory rooflines.

Usage (on the card): python scripts/trace_profile.py [size]
The trace is written under chiprun_out/trace_profile/.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data
# sheet): FP32 outside the tensor cores, and HBM3 bandwidth.
PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 3.35e12)}
BOUNCES = 8


def op_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> named scope ("trace", "env" or "other")."""
    scopes = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        name, op_name = m.groups()
        parts = op_name.split("/")
        scopes[name] = (
            "trace" if "trace" in parts else "env" if "env" in parts
            else "other"
        )
    return scopes


def _stat(ev, key):
    for k, v in ev.stats:
        if k == key:
            return v
    return None


def device_ops(trace_dir: str):
    """[(op name, start_ns, duration_ns)] of the first GPU plane."""
    import jax

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    data = jax.profiler.ProfileData.from_file(path)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {line.name: line for line in plane.lines}
        print(f"  device plane {plane.name}: lines {sorted(lines)}")
        if "XLA Ops" in lines:
            return [(ev.name, ev.start_ns, ev.duration_ns)
                    for ev in lines["XLA Ops"].events]
        ops = []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                ops.append((_stat(ev, "hlo_op") or ev.name, ev.start_ns,
                            ev.duration_ns))
        return ops
    return []


def busy_ns(ops) -> float:
    """Length of the union of the op intervals."""
    total, end = 0.0, -1.0
    for _, start, dur in sorted(ops, key=lambda o: o[1]):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def main() -> int:
    # XLA:GPU otherwise records whole while-loop bodies as CUDA graphs
    # ("command_buffer" events) and the trace cannot attribute their
    # kernels to scopes; the flag must be set before jax starts.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()
    import jax
    import jax.numpy as jnp

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.ops import rng
    from rsoderh_raytracing_tpu.ops.intersect import trace_nee
    from rsoderh_raytracing_tpu.render.integrator import camera_pytree
    from rsoderh_raytracing_tpu.render.renderer import Renderer
    from rsoderh_raytracing_tpu.render.wavefront import (
        _camera_rays,
        _lane_order,
        render_freerun,
    )
    from rsoderh_raytracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("trace_profile: JAX found no GPU", file=sys.stderr)
        return 1
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    iters = 16
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {card}; jax device_kind {dev.device_kind};"
          f" XLA_FLAGS={os.environ['XLA_FLAGS']!r}", flush=True)

    # 1. traced free-run step ------------------------------------------
    r = Renderer(
        load_scene(os.path.join(ROOT, "assets", "scenes", "house.toml")),
        width=size, height=size, environments=load_default_environments(),
        max_bounces=BOUNCES,
    )
    env = r._device_env()
    hlo = render_freerun.lower(
        r.device_scene, env, camera_pytree(r.camera), r.film.counts,
        (size, size), np.uint32(iters), BOUNCES, with_stats=True,
    ).compile().as_text()
    scopes = op_scopes(hlo)
    r.step_freerun(iters)
    trace_dir = os.path.join(ROOT, "chiprun_out", "trace_profile")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        r.step_freerun(iters)
    window = time.perf_counter() - t0
    st = r.last_stats
    ops = device_ops(trace_dir)
    if not ops:
        print("  no device events in the trace: shares not measured")
    else:
        busy = busy_ns(ops)
        span = max(s + d for _, s, d in ops) - min(s for _, s, d in ops)
        by_scope, by_op = {}, {}
        for name, _, dur in ops:
            key = scopes.get(name, scopes.get(name.split(":")[0], "other"))
            by_scope[key] = by_scope.get(key, 0) + dur
            by_op[name] = by_op.get(name, 0) + dur
        total = sum(by_scope.values())
        print(f"  house {size}^2 traced step: {st['iterations']} iterations,"
              f" host window {window:.3f} s, device busy {busy / 1e9:.3f} s"
              f" over a {span / 1e9:.3f} s device span (idle share"
              f" {1 - busy / span:.4f}); {busy / 1e6 / st['iterations']:.3f}"
              f" ms device time per iteration")
        for key in sorted(by_scope, key=by_scope.get, reverse=True):
            print(f"  scope {key}: {by_scope[key] / 1e6:.3f} ms"
                  f" ({by_scope[key] / total:.4f} of op time)")
        for name in sorted(by_op, key=by_op.get, reverse=True)[:10]:
            print(f"    op {name} [{scopes.get(name, '?')}]:"
                  f" {by_op[name] / 1e6:.3f} ms")
    del r

    # 2. the trace step alone ------------------------------------------
    ds = load_scene(os.path.join(ROOT, "assets", "scenes", "house.toml"))
    from rsoderh_raytracing_tpu.scene.device import build_device_scene

    scene = build_device_scene(ds)
    cam = camera_pytree(ds.camera)
    px, py, _, _ = _lane_order(size, size)
    n = size * size
    state = rng.seed(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0))
    state, ro, rd = _camera_rays(state, px, py, cam, (size, size))
    nd = jax.random.normal(jax.random.PRNGKey(0), (n, 3), jnp.float32)
    nd = nd / jnp.linalg.norm(nd, axis=-1, keepdims=True)
    step = jax.jit(lambda ro, rd, nd: trace_nee(scene, ro, rd, nd))
    compiled = step.lower(ro, rd, nd).compile()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    jax.block_until_ready(step(ro, rd, nd))
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        jax.block_until_ready(step(ro, rd, nd))
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    print(f"  trace_nee alone, house, {n} rays: median {t * 1e3:.3f} ms of"
          f" 7, XLA cost {flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB;"
          f" {flops / t / 1e12:.2f} TFLOP/s, {nbytes / t / 1e9:.1f} GB/s")
    peaks = PEAKS.get(dev.device_kind)
    if peaks is None:
        print(f"  no published peaks for {dev.device_kind!r}:"
              " roofline share not measured")
    else:
        bound = max(flops / peaks[0], nbytes / peaks[1])
        which = "FP32" if flops / peaks[0] >= nbytes / peaks[1] else "HBM"
        print(f"  roofline share {bound / t:.4f} ({which}-bound; peaks"
              f" {peaks[0] / 1e12:.0f} TFLOP/s FP32, {peaks[1] / 1e12:.2f}"
              f" TB/s at 700 W; card {card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
