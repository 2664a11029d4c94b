"""Interactive terminal viewer.

The reference opens a winit window with a fly camera (src/app.rs); an
accelerator host is usually headless, so the interactive surface here is the terminal:
the progressive render is drawn with ANSI 24-bit half-block characters
(two pixels per character cell) and the keyboard drives the same
controller contract (src/camera.rs:184-364):

- movement keys (default wasdqe) accelerate/decelerate the fly camera
- the capture key (default 'c') toggles mouse-look: xterm any-motion
  reporting (ESC[?1003h + SGR ESC[?1006h) feeds cell deltas to
  CameraController.add_mouse_delta, mirroring the reference's cursor
  grab + raw mouse deltas (src/app.rs:149-164, src/camera.rs:253-265)
- UPPERCASE movement keys move in slow mode (the reference's held
  Shift, src/camera.rs:285-291 — terminals don't report bare Shift)
- 'p' prints the base64 camera state (usable with --state, including in
  the reference renderer)
- 'e' cycles the environment map
- digits set dev_index (1 = normal, 3 = raw HDRI view)
- moving resets progressive accumulation; holding still converges
- resizing the terminal re-targets the render resolution and resets
  accumulation (the reference's Resized -> State::resize contract,
  src/app.rs:120, src/state.rs:651-700), capped at the requested
  --resolution; frames step the free-run wavefront (the production
  render path), so per-frame cost is one short device call
- 'q'/Ctrl-C exits

Terminal input is per-keypress (cbreak); without key-release events,
movement keys apply an impulse for a short hold window.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np


def _supports_tty() -> bool:
    return sys.stdin.isatty() and sys.stdout.isatty()


def _render_ansi(image: np.ndarray, max_cols: int, max_rows: int) -> str:
    """(H,W,3) float [0,1] -> ANSI 24-bit half-block string (one char
    cell shows two vertically stacked pixels)."""
    from rsoderh_raytracing_tpu.ops.tonemap import linear_to_srgb

    max_cols = max(8, max_cols)  # unsized PTYs report 0x0
    max_rows = max(4, max_rows)
    img8 = (np.clip(np.asarray(linear_to_srgb(image)), 0, 1) * 255).astype(
        np.uint8
    )
    height, width = img8.shape[:2]
    step = max(
        1,
        -(-width // max_cols),
        -(-(height // 2) // max_rows),
    )
    sub = img8[::step, ::step]
    lines = []
    for row in range(0, sub.shape[0] - 1, 2):
        top = sub[row]
        bottom = sub[row + 1]
        parts = [
            f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            for (tr, tg, tb), (br, bg, bb) in zip(top, bottom)
        ]
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


# One text cell covers ~(8, 16) window pixels; mouse deltas arrive in
# cells and are scaled so the reference's 0.25 degrees/pixel sensitivity
# feels comparable (a 10-cell swipe turns ~20 degrees).
CELL_PIXELS = (8.0, 16.0)

_SGR_MOUSE = b"\x1b[<"


def parse_input(buf: bytes):
    """Split an input byte buffer into events.

    Returns (events, remainder): each event is ("key", char) or
    ("mouse", button_code, col, row, is_press). Incomplete escape
    sequences stay in the remainder; unrecognized ESC sequences are
    dropped whole so arrow keys etc. never leak as letter keys."""
    events = []
    i = 0
    n = len(buf)
    while i < n:
        b = buf[i]
        if b != 0x1B:
            events.append(("key", chr(b)))
            i += 1
            continue
        # ESC sequence. SGR mouse: ESC [ < b ; x ; y (M|m)
        if buf[i : i + 3] == _SGR_MOUSE:
            j = i + 3
            while j < n and buf[j : j + 1] not in (b"M", b"m"):
                j += 1
            if j >= n:
                break  # incomplete: keep for the next read
            try:
                code, col, row = (
                    int(v) for v in buf[i + 3 : j].split(b";")
                )
                events.append(
                    ("mouse", code, col, row, buf[j : j + 1] == b"M")
                )
            except ValueError:
                pass
            i = j + 1
            continue
        if i + 1 < n and buf[i + 1 : i + 2] == b"[":
            # CSI sequence: consume through its final byte (0x40-0x7E).
            j = i + 2
            while j < n and not (0x40 <= buf[j] <= 0x7E):
                j += 1
            if j >= n:
                break
            i = j + 1
            continue
        if buf[i : i + 2] == b"\x1bO":
            # SS3 sequence (application-mode arrows: ESC O A..D): drop
            # the WHOLE three-byte sequence so the final byte never
            # leaks as a movement key.
            if i + 2 >= n:
                break
            i += 3
            continue
        if i + 1 >= n:
            break
        i += 2  # ESC + one char: drop
    return events, buf[i:]


def _fit_resolution(
    max_width: int, max_height: int, cols: int, rows: int
) -> tuple[int, int]:
    """Render resolution for a terminal of (cols, rows) cells: one pixel
    per half-block cell slot, capped at the requested maximum, quantized
    to multiples of 8 so a 1-column jiggle doesn't recompile, floored at
    16. Unsized PTYs (cols/rows <= 0) keep the requested maximum."""
    if cols <= 0 or rows <= 2:
        return max_width, max_height
    w = min(max_width, max(16, cols - cols % 8))
    h_px = (rows - 2) * 2  # status line + two pixels per cell row
    h = min(max_height, max(16, h_px - h_px % 8))
    return w, h


def run_viewer(
    scene,
    layout,
    width: int = 256,
    height: int = 144,
    environments=None,
    max_bounces: int = 10,
    max_fps: float = 30.0,
    environment_index: int = 0,
    intersector: str = "auto",
    adaptive_resolution: bool = True,
    freerun_iters: int = 12,
) -> int:
    from rsoderh_raytracing_tpu.render.renderer import Renderer
    from rsoderh_raytracing_tpu.scene.camera import CameraController

    if not _supports_tty():
        print(
            "viewer: stdin/stdout is not a TTY; use headless rendering"
            " instead (drop --view).",
            file=sys.stderr,
        )
        return 2

    import termios
    import tty

    renderer = Renderer(
        scene,
        width=width,
        height=height,
        environments=environments,
        max_bounces=max_bounces,
        intersector=intersector,
    )
    if environments is not None and len(environments):
        renderer.environment_index = environment_index % len(environments)
    controller = CameraController()
    key_to_action = {
        layout.forward: "forward",
        layout.left: "left",
        layout.back: "back",
        layout.right: "right",
        layout.down: "down",
        layout.up: "up",
    }
    # Impulse window: terminal has no key-release events, so a pressed
    # movement key stays "held" this long.
    hold = {name: 0.0 for name in key_to_action.values()}
    HOLD_SECS = 0.25

    fd = sys.stdin.fileno()
    old_attrs = termios.tcgetattr(fd)
    dev_index = 1
    captured = False
    last_cell = None
    pending = b""
    slow_hold = 0.0

    def set_capture(on: bool) -> None:
        nonlocal captured, last_cell
        captured = on
        last_cell = None
        # Any-motion tracking + SGR extended coordinates — the terminal
        # analog of the reference's cursor grab (src/camera.rs:253-265).
        sys.stdout.write(
            "\x1b[?1003h\x1b[?1006h" if on else "\x1b[?1003l\x1b[?1006l"
        )
        sys.stdout.flush()

    try:
        tty.setcbreak(fd)
        sys.stdout.write("\x1b[2J")  # clear
        last = time.monotonic()
        while True:
            # Drain pending input (keys + SGR mouse reports).
            while select.select([sys.stdin], [], [], 0)[0]:
                chunk = os.read(fd, 4096)
                if not chunk:
                    break
                events, pending = parse_input(pending + chunk)
                for ev in events:
                    if ev[0] == "mouse":
                        _, code, col, row, _press = ev
                        is_motion_or_drag = bool(code & 32) or code < 3
                        if captured and is_motion_or_drag:
                            if last_cell is not None:
                                dx = (col - last_cell[0]) * CELL_PIXELS[0]
                                dy = (row - last_cell[1]) * CELL_PIXELS[1]
                                controller.add_mouse_delta(dx, dy)
                            last_cell = (col, row)
                        continue
                    raw = ev[1]
                    ch = raw.lower()
                    if ch == "q" or ch == "\x03":
                        return 0
                    if ch in key_to_action:
                        hold[key_to_action[ch]] = HOLD_SECS
                        if raw.isupper():  # Shift held: slow mode
                            slow_hold = HOLD_SECS
                    elif ch == layout.capture_mouse:
                        set_capture(not captured)
                    elif ch == layout.print_camera_state:
                        sys.stdout.write("\x1b[2J\x1b[H")
                        print(renderer.camera)
                        print(
                            "state: (for use with --state)\n "
                            f" {renderer.camera.serialize()}"
                        )
                        print("press any key to continue...")
                        # os.read, not sys.stdin.read: the TextIO layer
                        # buffers readahead that select()/os.read in the
                        # main loop can never see. Then drain everything
                        # typed/reported during the pause so a partial
                        # mouse escape can't leak its tail into
                        # parse_input as spurious key presses.
                        os.read(fd, 1)
                        while select.select([sys.stdin], [], [], 0.05)[0]:
                            if not os.read(fd, 4096):
                                break
                        pending = b""
                    elif ch == layout.next_environment:
                        renderer.next_environment()
                    elif ch.isdigit():
                        dev_index = int(ch)

            now = time.monotonic()
            dt = min(now - last, 0.1)
            last = now
            for name in hold:
                hold[name] = max(0.0, hold[name] - dt)
                controller.set_key(name, hold[name] > 0.0)
            slow_hold = max(0.0, slow_hold - dt)
            controller.set_key("slow", slow_hold > 0.0)
            renderer.camera = controller.update(renderer.camera, dt)

            try:
                cols, rows = os.get_terminal_size()
            except OSError:
                cols, rows = 80, 24
            if adaptive_resolution:
                # The reference rebuilds its render surfaces and resets
                # accumulation when the window resizes
                # (src/app.rs:120 -> src/state.rs:651-700); the terminal
                # analog polls the cell grid and re-targets the render
                # resolution (film reset included via Renderer.resize).
                target = _fit_resolution(width, height, cols, rows)
                if target != (renderer.width, renderer.height):
                    renderer.resize(*target)
                    sys.stdout.write("\x1b[2J")  # stale frame geometry

            if dev_index == 2:
                img = renderer.debug_alias_scatter()
                count = 0
            elif dev_index == 3:
                img = renderer.debug_hdri_view()
                count = 0
            else:
                # Free-run wavefront stepping: the production render
                # path (fastest per frame, per-pixel sample counts).
                # `count` = minimum per-pixel spp.
                count = renderer.step_freerun(freerun_iters)
                img = renderer.film.tonemapped()
            frame = _render_ansi(img, cols, rows - 2)
            sys.stdout.write("\x1b[H" + frame)
            sys.stdout.write(
                f"\x1b[0m\n{renderer.width}x{renderer.height} "
                f"spp={count} env={renderer.environment_index} "
                f"dev={dev_index} mouse={'on' if captured else 'off'}"
                f" [q quit, p state, e env, {layout.capture_mouse} mouse]"
                "\x1b[K"
            )
            sys.stdout.flush()

            budget = 1.0 / max_fps - (time.monotonic() - now)
            if budget > 0:
                time.sleep(budget)
    except KeyboardInterrupt:
        # cbreak keeps ISIG, so Ctrl-C arrives as SIGINT (never as a
        # '\x03' byte); exit as cleanly as 'q' does.
        return 0
    finally:
        if captured:
            sys.stdout.write("\x1b[?1003l\x1b[?1006l")
        termios.tcsetattr(fd, termios.TCSADRAIN, old_attrs)
        sys.stdout.write("\x1b[0m\n")
    return 0
