# Dev commands (the reference ships a justfile; same idea).

# Render the default scene headless.
run scene="assets/scenes/default.toml":
    python -m rsoderh_raytracing_tpu.cli --scene {{scene}} \
        --resolution 512x512 --spp 64 --output render.png

# Interactive terminal viewer (wasdqe + cpe keys, like the reference).
view scene="assets/scenes/default.toml":
    python -m rsoderh_raytracing_tpu.cli --scene {{scene}} --view

# Workman-layout variant (reference justfile parity).
view-workman scene="assets/scenes/default.toml":
    python -m rsoderh_raytracing_tpu.cli --scene {{scene}} --view \
        --movement-keys yahomn

# Tests on CPU with 8 fake devices.
test:
    python -m pytest tests/ -x -q

# Throughput benchmark (GPU). BENCH_SCENE=house|default|suzanne|
# suzanne_hi, BENCH_MODE=freerun|sync, BENCH_SIZE/ITERS/STEPS.
bench scene="house":
    BENCH_SCENE={{scene}} python bench.py

# On-card parity checks and the main path at 2048^2 (GPU).
chip-smoke:
    python chip_smoke.py

# Viewer frame rate (converge + moving) at the default viewer config.
viewer-fps scene="default":
    python scripts/viewer_fps.py {{scene}}

# Compile-check the driver entry points.
graft-check:
    python __graft_entry__.py
