#!/usr/bin/env python
"""On-card smoke test: the renderer's main path on one NVIDIA GPU.

Run from the repository root on a machine with the card:

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # phase 5 only, on four cards

Phases (any failure exits nonzero; there is no CPU fallback):

1. Device: JAX must report a GPU. Prints the device kind and count and
   the card's name and power limit from nvidia-smi.
2. Parity on the card: the GPU render against the independent numpy
   oracle (scripts/reference_estimator.py) on house and suzanne, with
   the bounds of tests/test_reference_estimator.py, and against the CPU
   goldens in tests/goldens/.
3. Main path: house.toml at 2048^2, 8 bounces, free-run through
   Renderer: compile seconds, memory analysis, Mrays/s from the
   wavefront's own ray counters, peak device memory, min/mean spp.
4. Large mesh: suzanne_hi.toml (15,488 triangles) at 2048^2 through
   intersector="auto": the route taken, memory analysis and Mrays/s.
5. Four cards (--four-cards): house 2048^2 free-run on a dp:4 and a
   tile:2,dp:2 mesh, each compared with the same global samples
   rendered on one card, plus the scaling and the all-reduce share.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(ROOT, "assets", "scenes")
GOLDENS = os.path.join(ROOT, "tests", "goldens")
FULL = 2048
BOUNCES = 8


class PhaseFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailure(what)


def card_line() -> str:
    """`name, power.limit` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    check(bool(out), "nvidia-smi printed no card")
    return out


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True,
         "device": {"platform": platform, "kind": kind, "count": count}}
    )


def scene_path(name: str) -> str:
    return os.path.join(SCENES, f"{name}.toml")


def memory_report(name: str, compiled) -> None:
    m = compiled.memory_analysis()
    gib = 1024.0 ** 3
    print(
        f"  [{name}] memory_analysis: arguments"
        f" {m.argument_size_in_bytes / gib:.3f} GiB, outputs"
        f" {m.output_size_in_bytes / gib:.3f} GiB, temp"
        f" {m.temp_size_in_bytes / gib:.3f} GiB, generated code"
        f" {m.generated_code_size_in_bytes / 1024:.0f} KiB",
        flush=True,
    )


# -- comparison metrics --------------------------------------------------


def oracle_metrics(ours, ref):
    """Pixel-matched metrics of tests/test_reference_estimator.py."""
    diff = ours - ref
    rel = float(np.sqrt((diff ** 2).mean())) / float(
        np.sqrt((ref ** 2).mean())
    )
    within = float((np.abs(diff) < 1e-3).mean())
    return rel, within


def close_metrics(a, b):
    """Kernel-vs-composed bounds of tests/test_cluster.py: the fraction
    of values within rtol 1e-4 / atol 1e-5 and the relative gap of the
    image means."""
    frac = float(np.isclose(a, b, rtol=1e-4, atol=1e-5).mean())
    mean_gap = abs(float(a.mean()) - float(b.mean())) / max(
        abs(float(b.mean())), 1e-30
    )
    return frac, mean_gap


# -- phase 2: parity -----------------------------------------------------


def parity_oracle(name: str, size: int = 32, spp: int = 2):
    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer
    from scripts.reference_estimator import render as oracle_render

    envs = load_default_environments()
    ref = oracle_render(scene_path(name), envs[0], size, size, spp)
    r = Renderer(load_scene(scene_path(name)), width=size, height=size,
                 environments=envs)
    r.step_batch(spp)
    ours = np.asarray(r.film.mean_radiance())
    rel, within = oracle_metrics(ours, ref)
    if name == "house":
        print(
            f"  oracle {name} {size}x{size}x{spp}spp: rel RMSE {rel:.6%}"
            f" (bound < 0.5%), values within 1e-3 {within:.6f}"
            f" (bound > 0.98)",
            flush=True,
        )
        check(rel < 5e-3 and within > 0.98, f"oracle parity on {name}")
        return rel, within
    # Mesh scenes: tests/test_reference_estimator.py's suzanne contract.
    # Hundreds of triangle edges per ray make whole-path flips (an FMA
    # contraction ulp sending a path down another branch) likelier than
    # on house, and one flipped pixel moves the plain RMSE by percent;
    # flips are bounded and the RMSE is taken over the rest.
    diff = np.abs(ours - ref).max(-1)
    flipped = diff > 1e-2
    keep = ~flipped
    rel_keep = float(np.sqrt(((ours - ref)[keep] ** 2).mean())) / float(
        np.sqrt((ref[keep] ** 2).mean())
    )
    tight = float((diff < 1e-4).mean())
    print(
        f"  oracle {name} {size}x{size}x{spp}spp: rel RMSE {rel:.6%} with"
        f" {int(flipped.sum())} flipped pixels ({flipped.mean():.4%},"
        f" bound < 1%); non-flipped rel RMSE {rel_keep:.6%} (bound < 0.5%);"
        f" pixels within 1e-4 {tight:.6f} (bound > 0.98); values within"
        f" 1e-3 {within:.6f}",
        flush=True,
    )
    check(flipped.mean() < 0.01 and tight > 0.98 and rel_keep < 5e-3,
          f"oracle parity on {name}")
    return rel_keep, tight


def golden_render(name: str):
    """tests/test_golden.py's configuration: 64x64, 8 spp, 4 bounces."""
    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        Environment,
        device_environment,
    )
    from rsoderh_raytracing_tpu.env.hdr_io import procedural_sky
    from rsoderh_raytracing_tpu.render.integrator import camera_pytree
    from rsoderh_raytracing_tpu.render.wavefront import render_wavefront
    from rsoderh_raytracing_tpu.scene.device import build_device_scene

    scene = load_scene(scene_path(name))
    env = device_environment(
        Environment.from_texture(
            "golden_sky", procedural_sky(256, 128, sun_radius=0.05)
        )
    )
    img = render_wavefront(
        build_device_scene(scene), env, camera_pytree(scene.camera),
        np.uint32(0), (64, 64), np.uint32(8), 4,
    )
    return np.asarray(img) / 8


def anchor_render():
    """tests/test_reference_estimator.py's suzanne_hi anchor config."""
    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    r = Renderer(load_scene(scene_path("suzanne_hi")), width=24, height=24,
                 environments=load_default_environments())
    r.step_batch(2)
    return np.asarray(r.film.mean_radiance())


def parity_goldens():
    out = {}
    for name, golden, render in (
        ("house", "house_64_8spp.npy", lambda: golden_render("house")),
        ("default", "default_64_8spp.npy", lambda: golden_render("default")),
        ("suzanne_hi anchor", "suzanne_hi_anchor_24_2spp.npy",
         anchor_render),
    ):
        ref = np.load(os.path.join(GOLDENS, golden))
        ours = render()
        frac, mean_gap = close_metrics(ours, ref)
        print(
            f"  golden {name}: values within rtol 1e-4/atol 1e-5"
            f" {frac:.6f} (bound > 0.99), image mean gap {mean_gap:.3e}"
            f" (bound < 1e-3)",
            flush=True,
        )
        check(frac > 0.99 and mean_gap < 1e-3, f"golden parity on {name}")
        out[name] = (frac, mean_gap)
    return out


# -- phases 3 and 4: 2048^2 through Renderer -----------------------------


def build_freerun(name: str, size: int, iters: int,
                  intersector: str = "auto"):
    """Renderer for `name` at size^2 and its free-run program, compiled
    ahead (so it can overlap other work). Returns (renderer, compiled,
    build seconds, compile seconds)."""
    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.render.integrator import camera_pytree
    from rsoderh_raytracing_tpu.render.renderer import Renderer
    from rsoderh_raytracing_tpu.render.wavefront import render_freerun

    t0 = time.perf_counter()
    r = Renderer(load_scene(scene_path(name)), width=size, height=size,
                 environments=load_default_environments(),
                 max_bounces=BOUNCES, intersector=intersector)
    env = r._device_env()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = render_freerun.lower(
        r.device_scene, env, camera_pytree(r.camera), r.film.counts,
        (size, size), np.uint32(iters), BOUNCES, with_stats=True,
    ).compile()
    return r, compiled, build_s, time.perf_counter() - t0


def freerun_phase(name: str, built, warm_iters: int, iters: int,
                  steps: int):
    """Renderer.step_freerun on a build_freerun result; returns a dict
    of readings."""
    import jax

    r, compiled, build_s, compile_s = built
    size = r.width
    print(f"  [{name}] route {r.intersector!r}, scene+env build"
          f" {build_s:.2f} s, compile {compile_s:.2f} s", flush=True)
    memory_report(name, compiled)

    t0 = time.perf_counter()
    r.step_freerun(warm_iters)
    first_s = time.perf_counter() - t0
    print(f"  [{name}] first step ({warm_iters} iterations) {first_s:.2f} s",
          flush=True)

    rays = 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        r.step_freerun(iters)  # reads its ray counters: a sync point
        rays += r.last_stats["closest_rays"] + r.last_stats["shadow_rays"]
    wall = time.perf_counter() - t0
    mrays = rays / wall / 1e6

    counts = np.asarray(r.film.counts)
    img = np.asarray(r.film.tonemapped())
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0) / 1024.0 ** 3
    print(
        f"  [{name}] {steps} x {iters} iterations in {wall:.3f} s:"
        f" {mrays:.2f} Mrays/s, peak_bytes_in_use {peak:.3f} GiB,"
        f" spp min {int(counts.min())} mean {float(counts.mean()):.2f},"
        f" image mean {float(img.mean()):.4f}",
        flush=True,
    )
    check(img.shape == (size, size, 3), f"{name} image shape {img.shape}")
    check(bool(np.isfinite(img).all()), f"{name} image is not finite")
    check(float(img.mean()) > 1e-3, f"{name} image is black")
    check(int(counts.min()) >= 1, f"{name} has pixels with no sample")
    return dict(route=r.intersector, compile_s=compile_s, mrays=mrays,
                peak_gib=peak, spp_min=int(counts.min()),
                spp_mean=float(counts.mean()))


# -- phase 5: four cards -------------------------------------------------


def collective_share(trace_dir: str) -> str:
    """All-reduce time over device busy time, per device, from the
    profiler trace under trace_dir ("not measured" when the trace holds
    no device events)."""
    import glob

    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        return "not measured (no trace file)"
    data = jax.profiler.ProfileData.from_file(paths[0])
    shares = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        busy = coll = 0
        for line in plane.lines:
            for ev in line.events:
                busy += ev.duration_ns
                lname = ev.name.lower()
                if "all-reduce" in lname or "allreduce" in lname or (
                    "nccl" in lname
                ):
                    coll += ev.duration_ns
        if busy:
            shares.append(coll / busy)
    if not shares:
        return "not measured (no device events)"
    return ", ".join(f"{s:.4%}" for s in shares)


def four_cards(size: int = FULL, iters: int = 16) -> None:
    import jax
    import jax.numpy as jnp

    from rsoderh_raytracing_tpu import load_scene
    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )
    from rsoderh_raytracing_tpu.parallel.sharding import (
        ShardedRenderer,
        _freerun_rows,
        render_freerun_sharded,
        render_spp_sharded,
    )
    from rsoderh_raytracing_tpu.render.integrator import (
        camera_pytree,
        render_sample,
    )
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    scene = load_scene(scene_path("house"))
    envs = load_default_environments()
    res = (size, size)
    dev0 = jax.devices()[0]

    # One card: the same global samples, device by device.
    base_r = Renderer(scene, width=size, height=size, environments=envs,
                      max_bounces=BOUNCES)
    env_all = base_r._device_env()  # built once, shared by every mesh
    ds = jax.device_put(base_r.device_scene, dev0)
    env = jax.device_put(env_all, dev0)
    cam = jax.device_put(camera_pytree(scene.camera), dev0)
    replay = jax.jit(
        _freerun_rows,
        static_argnames=("resolution", "rows", "max_bounces"),
    )

    def replay_args(tile, t, s, samples):
        rows = size // tile
        return ((ds, env, cam, jnp.zeros((rows * size,), jnp.uint32),
                 jnp.uint32(s), jnp.uint32(samples), jnp.int32(t)),
                dict(resolution=res, rows=rows,
                     iterations=jnp.uint32(iters), max_bounces=BOUNCES))

    meshes = {}
    for spec, tile, samples in (("dp:4", 1, 4), ("tile:2,dp:2", 2, 2)):
        sr = ShardedRenderer.wrap(
            Renderer(scene, width=size, height=size, environments=envs,
                     max_bounces=BOUNCES),
            spec,
        )
        inner = sr.inner
        inner._device_env_cache[inner.environment_index] = env_all
        free_args = (inner.device_scene, inner._device_env(),
                     camera_pytree(inner.camera),
                     jnp.zeros((size, size), jnp.uint32), sr.mesh, res,
                     np.uint32(iters), BOUNCES)
        spp_args = (inner.device_scene, inner._device_env(),
                    camera_pytree(inner.camera), 0, sr.mesh, res, BOUNCES)
        meshes[spec] = (tile, samples, free_args, spp_args)

    # Compile every program on worker threads first (host work that
    # overlaps); the calls below then find them compiled.
    jobs = [("one-card replay, full image",
             lambda: replay.lower(*replay_args(1, 0, 0, 1)[0],
                                  **replay_args(1, 0, 0, 1)[1]).compile()),
            ("one-card replay, half image",
             lambda: replay.lower(*replay_args(2, 0, 0, 2)[0],
                                  **replay_args(2, 0, 0, 2)[1]).compile()),
            ("one-card render_sample",
             lambda: render_sample.lower(ds, env, cam, np.uint32(0), res,
                                         BOUNCES).compile())]
    for spec, (_, _, free_args, spp_args) in meshes.items():
        jobs.append((f"{spec} render_freerun_sharded",
                     lambda a=free_args: render_freerun_sharded.lower(
                         *a).compile()))
        jobs.append((f"{spec} render_spp_sharded",
                     lambda a=spp_args: render_spp_sharded.lower(
                         *a).compile()))

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futs = [(name, pool.submit(timed, fn)) for name, fn in jobs]
        for name, fut in futs:
            print(f"  compile {name}: {fut.result():.2f} s", flush=True)
    print(f"  all compiles: {time.perf_counter() - t0:.2f} s wall",
          flush=True)

    def single_card(tile, samples):
        rows = size // tile
        img = np.zeros((size, size, 3), np.float64)
        cnt = np.zeros((size, size), np.int64)
        for t in range(tile):
            for s in range(samples):
                a, k = replay_args(tile, t, s, samples)
                im, c = replay(*a, **k)
                img[t * rows:(t + 1) * rows] += np.asarray(im)
                cnt[t * rows:(t + 1) * rows] += np.asarray(c)
        return img, cnt

    # Warm the one-card program, then time one full-image replay.
    single_card(1, 1)
    t0 = time.perf_counter()
    _, ref_cnt1 = single_card(1, 1)
    single_s = time.perf_counter() - t0
    single_rate = float(ref_cnt1.sum()) / single_s
    print(f"  one card: {iters} iterations on {size}^2 in {single_s:.3f} s,"
          f" {single_rate / 1e6:.3f} Msamples/s", flush=True)

    for spec, (tile, samples, free_args, spp_args) in meshes.items():
        img, cnt, _ = render_freerun_sharded(*free_args)  # warm
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        img, cnt, _ = render_freerun_sharded(*free_args)
        jax.block_until_ready(img)
        multi_s = time.perf_counter() - t0
        img, cnt = np.asarray(img), np.asarray(cnt)

        ref_img, ref_cnt = single_card(tile, samples)
        check(np.array_equal(cnt, ref_cnt), f"{spec}: counts differ")
        frac, mean_gap = close_metrics(img, ref_img)
        rate = float(cnt.sum()) / multi_s
        print(
            f"  {spec} free-run vs one card: counts equal, values within"
            f" rtol 1e-4/atol 1e-5 {frac:.6f} (bound > 0.99), mean gap"
            f" {mean_gap:.3e} (bound < 1e-3); {multi_s:.3f} s,"
            f" {rate / 1e6:.3f} Msamples/s, scaling"
            f" {rate / single_rate:.3f}x over one card"
            f" (efficiency {rate / single_rate / 4:.3f})",
            flush=True,
        )
        check(frac > 0.99 and mean_gap < 1e-3, f"{spec} free-run parity")

        trace_dir = os.path.join(ROOT, "chiprun_out", "trace_four_cards",
                                 spec.replace(":", "").replace(",", "_"))
        with jax.profiler.trace(trace_dir):
            out = render_freerun_sharded(*free_args)
            jax.block_until_ready(out[0])
        print(f"  {spec} all-reduce share of device busy time per card:"
              f" {collective_share(trace_dir)}", flush=True)

        # Exact-spp sharded step (scan integrator) vs the sequential sum.
        summed = np.asarray(render_spp_sharded(*spp_args))
        seq = np.zeros_like(summed)
        for s in range(samples):
            seq += np.asarray(render_sample(
                ds, env, cam, np.uint32(s), res, BOUNCES
            ))
        frac, mean_gap = close_metrics(summed, seq)
        print(
            f"  {spec} render_spp_sharded vs sequential sum of {samples}:"
            f" values within rtol 1e-4/atol 1e-5 {frac:.6f}"
            f" (bound > 0.99), mean gap {mean_gap:.3e} (bound < 1e-3)",
            flush=True,
        )
        check(frac > 0.99 and mean_gap < 1e-3, f"{spec} spp parity")


# -- driver --------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from rsoderh_raytracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    devices = jax.devices()
    platform, kind = devices[0].platform, devices[0].device_kind
    if platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {platform!r});"
              " this check runs only on the card", file=sys.stderr)
        return 1

    print("phase 1: device", flush=True)
    card = card_line()
    print(f"  jax: platform {platform}, device_kind {kind},"
          f" {len(devices)} device(s)")
    print(f"  nvidia-smi name, power.limit: {card}", flush=True)

    if args.four_cards:
        print("phase 5: four cards", flush=True)
        four_cards()
        print(f"card: {card}")
        print(result_line(platform, kind, len(devices)))
        return 0

    # The two 2048^2 programs compile on worker threads while phase 2
    # runs: compiling is host work, and the card stays with this process.
    with ThreadPoolExecutor(max_workers=2) as pool:
        house = pool.submit(build_freerun, "house", FULL, 128)
        hi = pool.submit(build_freerun, "suzanne_hi", FULL, 4)

        print("phase 2: parity on the card (f32, dots at HIGHEST)",
              flush=True)
        for name in ("house", "suzanne"):
            parity_oracle(name)
        parity_goldens()

        print(f"phase 3: main path, house {FULL}^2 free-run,"
              f" {BOUNCES} bounces", flush=True)
        freerun_phase("house", house.result(), warm_iters=64, iters=128,
                      steps=3)

        print(f"phase 4: large mesh, suzanne_hi {FULL}^2,"
              " intersector='auto'", flush=True)
        freerun_phase("suzanne_hi", hi.result(), warm_iters=2, iters=4,
                      steps=1)

    print(f"card: {card}")
    print(result_line(platform, kind, len(devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
