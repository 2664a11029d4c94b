"""Command-line interface.

Keeps the reference's flag surface (src/cli.rs:10-46): ``--scene``
(required, repeatable, last one wins), ``--state`` (base64 camera, exit
code 2 on bad keyboard config), ``--movement-keys``, ``--other-keys`` —
plus headless-first extensions (this build renders to files by
default; the interactive viewer is opt-in via ``--view``):

    --resolution WxH   output resolution          (default 512x512)
    --spp N            samples per pixel          (default 64)
    --max-bounces N    path depth                 (default 10)
    --output PATH      image output; .png = tonemapped sRGB,
                       .hdr = linear Radiance RGBE (default render.png)
    --env-index N      environment index          (default 0)
    --hdri-dir DIR     directory of .hdr/.npy HDRIs
    --checkpoint PATH  save/load accumulation state (.npz)
    --devices dp:N     shard the render across N devices
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="rsoderh_raytracing_tpu",
        description="Progressive Monte Carlo path tracer on JAX.",
    )
    parser.add_argument(
        "--movement-keys",
        default="wasdqe",
        help="Keys used to move camera as a string of 6 characters.",
    )
    parser.add_argument(
        "--other-keys",
        default="cpe",
        help="Keys for mouse capture / print camera state / next"
        " environment (3 characters).",
    )
    parser.add_argument(
        "--state",
        default=None,
        help="Initial camera state (base64, printed by the 'p' key;"
        " interchangeable with the reference renderer).",
    )
    parser.add_argument(
        "--scene",
        action="append",
        required=True,
        help="Path to TOML scene descriptor. Repeatable; last one wins.",
    )
    parser.add_argument("--resolution", default="512x512")
    parser.add_argument(
        "--mode",
        choices=("exact", "freerun"),
        default="exact",
        help="exact: every pixel gets exactly --spp samples."
        " freerun: fastest — per-pixel sample counts vary, rendering"
        " continues until the minimum reaches --spp.",
    )
    parser.add_argument("--spp", type=int, default=64)
    parser.add_argument(
        "--intersector",
        choices=("auto", "sweep", "bvh"),
        default="auto",
        help="auto: the backend's measured route (dense sweep below its"
        " crossover, flat-BVH traversal above)."
        " sweep: dense vectorized primitive tests (fastest for"
        " reference-scale scenes). bvh: flat-BVH traversal.",
    )
    parser.add_argument("--max-bounces", type=int, default=10)
    parser.add_argument("--output", default="render.png")
    parser.add_argument("--env-index", type=int, default=0)
    parser.add_argument("--hdri-dir", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument(
        "--save-checkpoint",
        default=None,
        help="Write accumulation state to this .npz after rendering.",
    )
    parser.add_argument(
        "--devices",
        default=None,
        help="Shard spec, e.g. 'dp:8' to split samples over 8 devices.",
    )
    parser.add_argument(
        "--view",
        action="store_true",
        help="Open the interactive terminal viewer instead of writing a"
        " single PNG.",
    )
    parser.add_argument("--quiet", action="store_true")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # Honor JAX_PLATFORMS even when a sitecustomize pre-imported jax
    # before the environment variable could take effect.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms:
        import jax

        try:
            jax.config.update("jax_platforms", platforms)
        except Exception:  # backends already initialized; keep going
            pass

    from rsoderh_raytracing_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from rsoderh_raytracing_tpu.scene.camera import Camera, KeyboardLayout

    try:
        layout = KeyboardLayout.parse_config(args.movement_keys, args.other_keys)
    except ValueError as err:
        print(f"Invalid keyboard config: {err}", file=sys.stderr)
        return 2

    from rsoderh_raytracing_tpu.scene.toml_loader import SceneError, load_scene

    try:
        scene = load_scene(args.scene[-1])
    except SceneError as err:
        print(err, file=sys.stderr)
        return 1

    if args.state is not None:
        scene.camera = Camera.deserialize(args.state)

    try:
        width, height = (int(v) for v in args.resolution.lower().split("x"))
    except ValueError:
        print(
            f"Invalid --resolution '{args.resolution}': expected WxH",
            file=sys.stderr,
        )
        return 2

    from rsoderh_raytracing_tpu.env.environment import load_default_environments
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    environments = load_default_environments(args.hdri_dir)

    if args.view:
        from rsoderh_raytracing_tpu.viewer.terminal import run_viewer

        return run_viewer(
            scene,
            layout,
            width=width,
            height=height,
            environments=environments,
            max_bounces=args.max_bounces,
            environment_index=args.env_index,
            intersector=args.intersector,
        )

    renderer = Renderer(
        scene,
        width=width,
        height=height,
        environments=environments,
        max_bounces=args.max_bounces,
        intersector=args.intersector,
    )
    renderer.environment_index = args.env_index % len(environments)

    if args.devices:
        from rsoderh_raytracing_tpu.parallel.sharding import ShardedRenderer

        renderer = ShardedRenderer.wrap(renderer, args.devices)

    if args.checkpoint:
        # Establish the state hash without rendering (a step at high
        # resolution is seconds of device time immediately overwritten
        # by the load).
        inner = getattr(renderer, "inner", renderer)
        inner._last_state_hash = inner._state_hash()
        renderer.load_checkpoint(args.checkpoint)
        if not args.quiet:
            print(
                f"Resumed from {args.checkpoint} at"
                f" {renderer.film.sample_count} spp"
            )

    start = time.perf_counter()
    renderer.render(spp=args.spp, progress=not args.quiet, mode=args.mode)
    elapsed = time.perf_counter() - start
    if args.output.lower().endswith(".hdr"):
        renderer.save_hdr(args.output)
    else:
        renderer.save_png(args.output)
    if args.save_checkpoint:
        renderer.save_checkpoint(args.save_checkpoint)
    if not args.quiet:
        total = renderer.film.sample_count
        print(
            f"Rendered {args.scene[-1]} at {width}x{height}, {total} spp in"
            f" {elapsed:.2f}s -> {args.output}"
        )
        stats = getattr(renderer, "last_stats", None)
        if stats:
            rays = stats["closest_rays"] + stats["shadow_rays"]
            print(
                f"last step: {rays / 1e6:.1f}M rays,"
                f" {stats['iterations']} wavefront iterations"
            )
        print(f"camera state: {scene.camera.serialize()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
