"""Chunk clustering orders (scene/cluster.py) + the RT_CHUNK_CLUSTER knob.

Like the Morton sort they extend, the SAH-derived orders are pure
storage-order changes: the closest hit is a min over the same triangle
set, so renders must come out bit-identical (exact-t ties are
measure-zero and absent from these scenes).
"""

import os

import numpy as np
import pytest

from tests.conftest import ASSETS


@pytest.fixture(scope="module")
def suzanne_scene():
    from rsoderh_raytracing_tpu import load_scene

    return load_scene(os.path.join(ASSETS, "scenes", "suzanne.toml"))


def _render(scene, mode, monkeypatch):
    from rsoderh_raytracing_tpu.render.renderer import Renderer

    if mode is None:
        monkeypatch.delenv("RT_CHUNK_CLUSTER", raising=False)
    else:
        monkeypatch.setenv("RT_CHUNK_CLUSTER", mode)
    r = Renderer(scene, width=48, height=32)
    return np.asarray(r.render(spp=2)), r.device_scene


def test_cluster_modes_bit_transparent(suzanne_scene, monkeypatch):
    base, ds_base = _render(suzanne_scene, None, monkeypatch)
    assert ds_base.num_triangle_lanes == 1024  # 968 tris -> 16 chunks
    for mode in ("bvh", "treelet"):
        img, ds = _render(suzanne_scene, mode, monkeypatch)
        assert int(np.asarray(ds.tri_valid).sum()) == 968
        if mode == "treelet":
            # padded treelet chunks: more lanes, still chunk-aligned
            assert ds.num_triangle_lanes > 1024
            assert ds.num_triangle_lanes % 64 == 0
        np.testing.assert_array_equal(img, base)


def test_cluster_mode_rejects_unknown(suzanne_scene, monkeypatch):
    from rsoderh_raytracing_tpu.scene.device import build_device_scene

    monkeypatch.setenv("RT_CHUNK_CLUSTER", "nope")
    with pytest.raises(ValueError, match="RT_CHUNK_CLUSTER"):
        build_device_scene(suzanne_scene)


def test_bvh_dfs_order_is_permutation(suzanne_scene):
    from rsoderh_raytracing_tpu.scene.cluster import bvh_dfs_order

    tris = suzanne_scene.meshes.triangles
    order = bvh_dfs_order(suzanne_scene.meshes.vertices, tris)
    assert sorted(order.tolist()) == list(range(len(tris)))


def test_treelet_pack_invariants(suzanne_scene):
    from rsoderh_raytracing_tpu.scene.cluster import treelet_pack

    tris = suzanne_scene.meshes.triangles
    out, valid = treelet_pack(suzanne_scene.meshes.vertices, tris, 64)
    assert len(out) == len(valid)
    assert len(out) % 64 == 0
    # real rows are a permutation of the input triangles
    real = out[valid]
    assert len(real) == len(tris)
    key = lambda a: sorted(map(tuple, a.tolist()))  # noqa: E731
    assert key(real) == key(tris)
    # pad rows are point-degenerate (all three corners the same vertex:
    # every Moller-Trumbore constant is exactly zero -> det == 0 ->
    # unhittable under the |det| >= TRI_DET_EPS gate)
    pads = out[~valid]
    assert (pads[:, 0] == pads[:, 1]).all() and (pads[:, 0] == pads[:, 2]).all()
    # each 64-row chunk contains at least one real triangle and its pad
    # rows collapse to a vertex used inside the same chunk
    v = valid.reshape(-1, 64)
    assert v.any(axis=1).all()
    for ci in range(len(v)):
        chunk_rows = out[ci * 64: (ci + 1) * 64]
        pad_rows = chunk_rows[~v[ci]]
        if len(pad_rows):
            real_v0 = set(chunk_rows[v[ci]][:, 0].tolist())
            assert set(pad_rows[:, 0].tolist()) <= real_v0


def test_package_render_not_shadowed_by_subpackage():
    """rsoderh_raytracing_tpu.render (the function) must survive deep
    imports of the `render` SUBPACKAGE: before the eager-import fix in
    __init__.py, the first `import ...render.renderer` rebound the
    package attribute to the module and a second rt.render(...) raised
    TypeError: 'module' object is not callable."""
    import rsoderh_raytracing_tpu as rt
    import rsoderh_raytracing_tpu.render.renderer  # noqa: F401

    assert callable(rt.render)
    assert callable(rt.view)
