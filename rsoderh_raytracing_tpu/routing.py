"""Backend routing policy: the one place that knows which backend runs
which intersection route.

Every choice here is made per backend from measurements on that
backend (PERF.md, "Routing"). A backend that is not in ``ROUTES`` is an
error, never a default: a table entry is only written once the route
has been measured there.

- ``bvh_above_lanes``: ``intersector="auto"`` attaches the flat BVH
  (ops/bvh_traverse.py) when the padded triangle lane count exceeds
  this; below it the scene takes the composed dense sweep
  (ops/intersect.py).
- ``bvh_packed``: the BVH walk reads one wide row per node visit and
  leaf slot instead of several narrow takes (bitwise-equal results).
- ``sweep_window``: the dense sweep scans a primitive type's lanes this
  many at a time (when they split evenly) instead of reducing all of
  them in one fusion; None sweeps all at once. Same winners and ties.
"""

from __future__ import annotations

import dataclasses
import os

import jax


@dataclasses.dataclass(frozen=True)
class Route:
    bvh_above_lanes: int
    bvh_packed: bool
    sweep_window: int | None


ROUTES = {
    # Host property: the dense sweep holds until 262,144 padded triangle
    # lanes (the CPU goldens and bit-compat suite pin the sweep below
    # it), and narrow takes beat wide rows because XLA:CPU lowers them
    # to strided loads.
    "cpu": Route(bvh_above_lanes=262144, bvh_packed=False,
                 sweep_window=None),
    # H100 (PERF.md "Routing", 2048^2, 8 bounces): the windowed sweep
    # wins on suzanne (1,024 lanes: 55 vs 354 ms/iteration) and loses on
    # suzanne_hi (15,488: 774 vs 567); a line through the sweep's points
    # meets a log curve through the walk's near 10k lanes. Wide rows beat
    # narrow takes (567 vs 661 ms). One fusion over all of a type's
    # lanes did not compile within 180-300 s at 2048^2 on any scene;
    # 64-lane windows compile in 15-20 s.
    "gpu": Route(bvh_above_lanes=10240, bvh_packed=True, sweep_window=64),
}


def route(backend: str | None = None) -> Route:
    """The routing entry for `backend` (default: JAX's default backend).
    Raises ValueError for a backend with no measured entry."""
    backend = backend or jax.default_backend()
    try:
        return ROUTES[backend]
    except KeyError:
        raise ValueError(
            f"no routing entry for backend {backend!r}: expected one of"
            f" {sorted(ROUTES)}"
        ) from None


def attach_bvh(tri_lanes: int, backend: str | None = None) -> bool:
    """Whether ``intersector="auto"`` attaches the flat BVH to a scene
    with `tri_lanes` padded triangle lanes. RT_BVH_ABOVE_TRIS=N lowers
    the crossover to N lanes (it never removes a BVH the table attaches)."""
    if tri_lanes > route(backend).bvh_above_lanes:
        return True
    thresh = os.environ.get("RT_BVH_ABOVE_TRIS")
    return bool(thresh) and tri_lanes > int(thresh)


def bvh_packed(backend: str | None = None) -> bool:
    """Wide-row BVH tables on `backend`; RT_BVH_PACKED=0/1 overrides."""
    v = os.environ.get("RT_BVH_PACKED")
    if v is not None:
        return v == "1"
    return route(backend).bvh_packed


def sweep_window(backend: str | None = None) -> int | None:
    """Lanes per scan step of the dense sweep on `backend` (None: all)."""
    return route(backend).sweep_window
