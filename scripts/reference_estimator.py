#!/usr/bin/env python
"""Independent numpy re-implementation of the reference estimator.

A direct transcription of /root/reference/src/shaders/shader.wgsl into
numpy float32 — the naive per-primitive intersection formulas
(shader.wgsl:295-466), the alias-table environment sampling
(:663-820), the GGX/VNDF BSDF (:833-1203), the MIS loop (:1213-1303),
and the device RNG (:605-661) — with NO code shared with the JAX
renderer's compute path (rsoderh_raytracing_tpu/ops). It consumes the
same per-(pixel, sample) RNG streams, so comparing its render against
the JAX renderer at equal spp is the pixel-matched "RMSE vs reference"
comparison BASELINE.md intends, with this transcription standing in for
the unrunnable Rust/wgpu binary (no GPU / Rust toolchain here).

Differences from the WGSL (documented):
- cast_ray walks every primitive densely instead of BVH + linear
  fallback — mathematically the same closest hit except measure-zero
  flat-AABB/parallel-ray cases (see ops/intersect.py docstring).
- Vectorized over paths (the per-bounce and per-primitive loops are
  kept); masked lanes advance their RNG only where the reference would.

Usage:
  python scripts/reference_estimator.py --scene assets/scenes/house.toml \
      --size 64 --spp 8 --out /tmp/ref_mean.npy
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

F = np.float32
PI = F(3.14159)  # shader.wgsl:239
MAX_BOUNCES = 10
DIELECTRIC_F0 = np.array([0.04, 0.04, 0.04], F)

np.seterr(over="ignore", invalid="ignore", divide="ignore")


# -- RNG (shader.wgsl:605-661) ------------------------------------------------


def rng_next_u32(state):
    state = (state * np.uint32(747796405) + np.uint32(2891336453)).astype(
        np.uint32
    )
    shift = ((state >> np.uint32(28)) + np.uint32(4)).astype(np.uint32)
    result = (((state >> shift) ^ state) * np.uint32(277803737)).astype(
        np.uint32
    )
    result = (result >> np.uint32(22)) ^ result
    return state, result


def rng_uniform(state, mask=None):
    """Advance WHERE mask (None = all); masked-off lanes keep state."""
    new_state, bits = rng_next_u32(state)
    value = bits.astype(F) / F(4294967295.0)
    if mask is None:
        return new_state, value
    return np.where(mask, new_state, state), value


def rng_seed(pixel_index, sample_index):
    state = np.zeros_like(pixel_index, np.uint32)
    state ^= pixel_index.astype(np.uint32)
    state, _ = rng_next_u32(state)
    state ^= np.asarray(sample_index, np.uint32)
    state, _ = rng_next_u32(state)
    return state


def rng_in_circle(state):
    state, u = rng_uniform(state)
    angle = u * F(2.0 * 3.1415926)
    state, v = rng_uniform(state)
    r = np.sqrt(v)
    return state, np.stack([r * np.cos(angle), r * np.sin(angle)], -1)


# -- intersections (shader.wgsl:295-466, naive forms) --------------------------


def _dot(a, b):
    return (a * b).sum(-1)


def cast_ray(scene, ro, rd):
    """Dense closest hit over all primitives. Returns dict of arrays."""
    n = ro.shape[0]
    best_t = np.full(n, np.float32(np.inf))
    hit_point = np.zeros((n, 3), F)
    normal = np.zeros((n, 3), F)
    mat = np.zeros(n, np.int32)
    did = np.zeros(n, bool)

    def consider(h, t, p, nrm, m):
        nonlocal best_t, hit_point, normal, mat, did
        better = h & (t < best_t)
        best_t = np.where(better, t, best_t)
        hit_point = np.where(better[:, None], p, hit_point)
        normal = np.where(better[:, None], nrm, normal)
        mat = np.where(better, m, mat)
        did = did | better

    for sph in scene["spheres"]:
        pos, radius, m = sph
        l = ro - pos  # noqa: E741
        a = _dot(rd, rd)
        b = F(2.0) * _dot(rd, l)
        c = _dot(l, l) - F(radius) * F(radius)
        disc = b * b - F(4.0) * a * c
        sq = np.sqrt(np.maximum(disc, 0))
        q = np.where(b > 0, F(-0.5) * (b + sq), F(-0.5) * (b - sq))
        t0 = q / a
        t1 = c / np.where(q == 0, F(1), q)
        eps = F(1.0e-4)
        t = np.where(t0 < eps, t1, np.where(t1 < eps, t0, np.minimum(t0, t1)))
        t = np.where(disc == 0, F(-0.5) * b / a, t)
        h = (disc >= 0) & (t >= eps)
        p = ro + rd * t[:, None]
        nrm = p - pos
        nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
        inside = _dot(pos - ro, pos - ro) - F(radius) * F(radius) < F(1.0e-6)
        nrm = np.where(inside[:, None], -nrm, nrm)
        consider(h, t, p, nrm, m)

    for pln in scene["planes"]:
        pos, nrm0, bcm, m = pln
        denom = _dot(nrm0[None], rd)
        ok = np.abs(denom) >= F(0.0001)
        t = _dot(nrm0[None], pos[None] - ro) / np.where(ok, denom, F(1))
        inter = ro + rd * t[:, None]
        local = inter - pos
        ps = local @ bcm.T
        h = (
            ok
            & (t >= F(0.001))
            & (ps[:, 0] >= 0)
            & (ps[:, 0] <= 1)
            & (ps[:, 2] >= 0)
            & (ps[:, 2] <= 1)
        )
        nrm = np.where(
            (_dot(ro, nrm0[None]) < 0)[:, None], -nrm0[None], nrm0[None]
        )
        consider(h, t, inter, np.broadcast_to(nrm, inter.shape), m)

    for tri in scene["triangles"]:
        a_, e0, e1, n0, n1, n2, m = tri
        p0 = np.cross(ro - a_, e0)
        p1 = np.cross(rd, np.broadcast_to(e1, rd.shape))
        det = _dot(e0[None], p1)
        ok = np.abs(det) >= F(1.0e-8)
        inv = F(1.0) / np.where(ok, det, F(1))
        u = _dot(ro - a_, p1) * inv
        v = _dot(rd, p0) * inv
        t = _dot(e1[None], p0) * inv
        h = (
            ok
            & (u >= 0)
            & (u <= 1)
            & (v >= 0)
            & (u + v <= 1)
            & (t >= F(1.0e-5))
        )
        nrm = (1 - u - v)[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2
        nrm = nrm / np.maximum(
            np.linalg.norm(nrm, axis=-1, keepdims=True), F(1e-20)
        )
        nrm = np.where((_dot(nrm, rd) > 0)[:, None], -nrm, nrm)
        consider(h, t, ro + rd * t[:, None], nrm, m)

    return did, best_t, hit_point, normal, mat


# -- environment (shader.wgsl:663-831) -----------------------------------------


def direction_to_uv(d):
    u = np.arctan2(d[:, 2], d[:, 0]) * F(1.0 / PI * 0.5) + F(0.5)
    v = F(0.5) - np.arcsin(np.clip(d[:, 1], -1, 1)) * F(1.0 / PI)
    return u, v


def uv_to_direction(u, v):
    phi = (F(2) * u - F(1)) * PI
    theta = PI * v
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), np.cos(theta), st * np.sin(phi)], -1)


def bilinear(tex, u, v):
    hgt, wid = tex.shape[:2]
    x = u * F(wid) - F(0.5)
    y = v * F(hgt) - F(0.5)
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = np.where(x0 < 0, F(0), x - x0)[:, None]
    fy = np.where(y0 < 0, F(0), y - y0)[:, None]
    x0i = np.clip(x0.astype(np.int64), 0, wid - 1)
    x1i = np.clip(x0.astype(np.int64) + 1, 0, wid - 1)
    y0i = np.clip(y0.astype(np.int64), 0, hgt - 1)
    y1i = np.clip(y0.astype(np.int64) + 1, 0, hgt - 1)
    c00, c10 = tex[y0i, x0i], tex[y0i, x1i]
    c01, c11 = tex[y1i, x0i], tex[y1i, x1i]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def pixel_solid_angle(v, wid, hgt):
    theta = PI * v
    sin_t = np.maximum(F(1.0e-6), np.sin(theta))
    return F(2.0) * PI / F(wid) * (PI / F(hgt)) * sin_t


def env_uv_pmf(env, u, v):
    hgt, wid = env["texture"].shape[:2]
    x = np.minimum((u * F(wid)).astype(np.int64), wid - 1)
    y = np.minimum((v * F(hgt)).astype(np.int64), hgt - 1)
    return env["pmf"][x + y * wid]


def sample_environment(env, state, mask):
    hgt, wid = env["texture"].shape[:2]
    length = wid * hgt
    state, u_index = rng_uniform(state, mask)
    index = np.minimum((u_index * F(length)).astype(np.int64), length - 1)
    state, u_accept = rng_uniform(state, mask)
    keep = u_accept < env["prob"][index]
    index = np.where(keep, index, env["alias"][index])
    pmf = env["pmf"][index]
    x = index % wid
    y = index // wid
    state, jx = rng_uniform(state, mask)
    state, jy = rng_uniform(state, mask)
    u = (x.astype(F) + jx) / F(wid)
    v = (y.astype(F) + jy) / F(hgt)
    direction = uv_to_direction(u, v)
    radiance = bilinear(env["texture"], u, v)
    pdf = pmf / pixel_solid_angle(v, wid, hgt)
    return state, direction, radiance, pdf


# -- BSDF (shader.wgsl:833-1203) -----------------------------------------------


def saturate(x):
    return np.clip(x, F(0), F(1))


def luminance(c):
    return F(0.2126) * c[..., 0] + F(0.7152) * c[..., 1] + F(0.0722) * c[..., 2]


def make_frame(n):
    use_z = np.abs(n[:, 2]) < F(0.999)
    helper = np.where(use_z[:, None], np.array([0, 0, 1], F), np.array([1, 0, 0], F))
    t = np.cross(helper, n)
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), F(1e-20))
    b = np.cross(n, t)
    return t, b, n


def to_local(frame, v):
    t, b, n = frame
    return np.stack([_dot(v, t), _dot(v, b), _dot(v, n)], -1)


def to_world(frame, v):
    t, b, n = frame
    return v[:, 0:1] * t + v[:, 1:2] * b + v[:, 2:3] * n


def d_ggx(ndh, alpha):
    a2 = alpha * alpha
    den = ndh * ndh * (a2 - 1) + 1
    return a2 / (PI * den * den)


def lambda_ggx(ndv, alpha):
    ndv2 = ndv * ndv
    return (np.sqrt(1 + alpha * alpha * (1 - ndv2) / ndv2) - 1) / 2


def g1_ggx(ndv, alpha):
    return F(1.0) / (1 + lambda_ggx(ndv, alpha))


def f_schlick(f0, cos_t):
    x = 1 - saturate(cos_t)
    x5 = (x * x) * (x * x) * x
    return f0 + (1 - f0) * x5[..., None]


def surface_kd(color, metallic, f0):
    kd0 = color * (1 - saturate(metallic))[:, None]
    return kd0 * (1 - f0.max(-1))[:, None]


def bsdf_eval_local(wo, wi, mat):
    ok = (wo[:, 2] > 0) & (wi[:, 2] > 0)
    h = wo + wi
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), F(1e-20))
    ndh = saturate(h[:, 2])
    fs = (
        d_ggx(ndh, mat["alpha"]) * g1_ggx(wo[:, 2], mat["alpha"])
        * g1_ggx(wi[:, 2], mat["alpha"])
    )[:, None] / (4 * wo[:, 2] * wi[:, 2])[:, None] * f_schlick(
        mat["f0"], _dot(h, wo)
    )
    fd = surface_kd(mat["color"], mat["metallic"], mat["f0"]) * F(1.0 / PI)
    return np.where(ok[:, None], fd + fs, F(0))


def bsdf_pdf_local(wo, wi, mat):
    ok = (wo[:, 2] > 0) & (wi[:, 2] > 0)
    spec_p = saturate(luminance(mat["f0"]))
    pdf_cos = np.where(wi[:, 2] > 0, wi[:, 2] / PI, F(0))
    h = wo + wi
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), F(1e-20))
    wodh = np.abs(_dot(wo, h))
    ndh = h[:, 2]
    pdf_half = np.where(
        ndh > 0,
        d_ggx(ndh, mat["alpha"]) * g1_ggx(wo[:, 2], mat["alpha"])
        * np.maximum(0, _dot(wo, h)) / wo[:, 2],
        F(0),
    )
    pdf_spec = np.where(wodh > 0, pdf_half / (4 * wodh), F(0))
    return np.where(ok, (1 - spec_p) * pdf_cos + spec_p * pdf_spec, F(0))


def sample_cosine_hemisphere(s):
    r = np.sqrt(s[:, 0])
    phi = 2 * PI * s[:, 1]
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    z = np.sqrt(np.maximum(0, 1 - x * x - y * y))
    return np.stack([x, y, z], -1)


def sample_ggx_vndf(s, wo, alpha):
    v = np.stack([wo[:, 0] * alpha, wo[:, 1] * alpha, wo[:, 2]], -1)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    lsq = v[:, 0] ** 2 + v[:, 1] ** 2
    tx = np.where(
        (lsq > 0)[:, None],
        np.stack([-v[:, 1], v[:, 0], np.zeros_like(lsq)], -1)
        / np.sqrt(np.maximum(lsq, F(1e-30)))[:, None],
        np.array([1, 0, 0], F),
    )
    ty = np.cross(v, tx)
    radius = np.sqrt(s[:, 0])
    az = 2 * PI * s[:, 1]
    dx = radius * np.cos(az)
    dy = radius * np.sin(az)
    dy = (1 - v[:, 2]) * np.sqrt(np.maximum(0, 1 - dx * dx)) + v[:, 2] * dy
    hz = np.sqrt(np.maximum(0, 1 - dx * dx - dy * dy))
    h = dx[:, None] * tx + dy[:, None] * ty + hz[:, None] * v
    h = np.stack(
        [alpha * h[:, 0], alpha * h[:, 1], np.maximum(0, h[:, 2])], -1
    )
    return h / np.linalg.norm(h, axis=-1, keepdims=True)


def bsdf_sample(state, rd, normal, mat, mask):
    """Returns (state, wi_world, scattering, pdf, zero_direction)."""
    wo_world = -rd
    bail0 = _dot(normal, wo_world) <= 0  # draws nothing
    frame = make_frame(normal)
    wo = to_local(frame, wo_world)
    bail1 = ~bail0 & (wo[:, 2] <= 0)  # draws nothing
    draws = mask & ~bail0 & ~bail1

    spec_p = saturate(luminance(mat["f0"]))
    diff_p = 1 - spec_p
    state, s0 = rng_uniform(state, draws)
    state, s1 = rng_uniform(state, draws)

    pick_diffuse = s0 < diff_p
    wi_d = sample_cosine_hemisphere(
        np.stack([s0 / np.maximum(diff_p, F(1e-6)), s1], -1)
    )
    h = sample_ggx_vndf(
        np.stack([(s0 - diff_p) / np.maximum(spec_p, F(1e-6)), s1], -1),
        wo,
        mat["alpha"],
    )
    wi_s = 2 * _dot(wo, h)[:, None] * h - wo
    wi = np.where(pick_diffuse[:, None], wi_d, wi_s)
    bail2 = ~pick_diffuse & (wi_s[:, 2] <= 0)  # red sentinel, pdf-0 exit

    scattering = bsdf_eval_local(wo, wi, mat)
    pdf = bsdf_pdf_local(wo, wi, mat)
    wi_world = to_world(frame, wi)
    bail3 = _dot(normal, wi_world) < 0  # zero-dir green sentinel

    # Reference semantics (shader.wgsl:1155-1203): bail0/bail1/bail3
    # return a ZERO direction (the caller replaces incoming with the
    # sentinel color); bail2 returns direction (1,0,0) with pdf 0, so the
    # path terminates WITHOUT replacing incoming.
    zero = bail0 | bail1 | (bail3 & ~bail2)
    direction = np.where(zero[:, None], F(0), wi_world)
    direction = np.where(
        (bail2 & ~bail0 & ~bail1)[:, None], np.array([1, 0, 0], F), direction
    )
    scattering = np.where(bail3[:, None], np.array([0, 1, 0], F), scattering)
    scattering = np.where(bail2[:, None], np.array([1, 0, 0], F), scattering)
    scattering = np.where(bail1[:, None], np.array([0, 1, 0], F), scattering)
    scattering = np.where(bail0[:, None], np.array([0, 0, 1], F), scattering)
    pdf = np.where(bail0 | bail1 | bail2 | bail3, F(0), pdf)
    return state, direction, scattering, pdf, zero


# -- the estimator loop (shader.wgsl:1213-1303) ---------------------------------


def power_heuristic(a, b):
    return a * a / (a * a + b * b)


def trace(scene, env, ro, rd, state):
    n = ro.shape[0]
    incoming = np.zeros((n, 3), F)
    throughput = np.ones((n, 3), F)
    last_pdf = np.ones(n, F)
    alive = np.ones(n, bool)
    wid, hgt = env["texture"].shape[1], env["texture"].shape[0]

    for _ in range(MAX_BOUNCES):
        did, t, point, normal, mat_id = cast_ray(scene, ro, rd)
        miss = alive & ~did
        if miss.any():
            u, v = direction_to_uv(rd)
            env_light = bilinear(env["texture"], u, v)
            pdf = env_uv_pmf(env, u, v) / pixel_solid_angle(v, wid, hgt)
            w = power_heuristic(last_pdf, pdf)
            incoming = np.where(
                miss[:, None],
                incoming + throughput * env_light * w[:, None],
                incoming,
            )
        alive = alive & did
        if not alive.any():
            break

        mats = scene["materials"]
        color = mats["color"][mat_id]
        metallic = mats["metallic"][mat_id]
        alpha = np.maximum(F(0.001), mats["roughness"][mat_id] ** 2)
        f0 = DIELECTRIC_F0 + (color - DIELECTRIC_F0) * saturate(metallic)[
            :, None
        ]
        mat = {"color": color, "metallic": metallic, "alpha": alpha, "f0": f0}
        emission = mats["emission"][mat_id]
        incoming = np.where(
            alive[:, None], incoming + throughput * emission, incoming
        )

        # NEE (draws only where alive/hit — matches the reference branch)
        state, nee_dir, nee_rad, nee_pdf = sample_environment(
            env, state, alive
        )
        cos_t = np.maximum(0, _dot(normal, nee_dir))
        occ_did, *_ = cast_ray(scene, point, nee_dir)
        ok = alive & (cos_t > 0) & (nee_pdf > 0) & ~occ_did
        frame = make_frame(normal)
        wo = to_local(frame, -rd)
        wi = to_local(frame, nee_dir)
        sc = bsdf_eval_local(wo, wi, mat)
        pdf_b = bsdf_pdf_local(wo, wi, mat)
        w = power_heuristic(nee_pdf, pdf_b)
        incoming = np.where(
            ok[:, None],
            incoming
            + throughput
            * w[:, None]
            * nee_rad
            * sc
            * (cos_t / np.maximum(nee_pdf, F(1e-30)))[:, None],
            incoming,
        )

        state, direction, scattering, pdf, zero = bsdf_sample(
            state, rd, normal, mat, alive
        )
        err = alive & zero
        incoming = np.where(err[:, None], scattering, incoming)
        cos_b = np.maximum(0, _dot(normal, direction))
        new_tp = throughput * scattering * (cos_b / np.maximum(pdf, F(1e-30)))[
            :, None
        ]
        cont = (
            alive
            & ~zero
            & (pdf > 0)
            & (np.linalg.norm(new_tp, axis=-1) >= F(0.001))
        )
        throughput = np.where(cont[:, None], new_tp, throughput)
        last_pdf = np.where(cont, pdf, last_pdf)
        ro = np.where(cont[:, None], point, ro)
        rd = np.where(cont[:, None], direction, rd)
        alive = cont
        if not alive.any():
            break
    return incoming


def build_scene(scene_path):
    from rsoderh_raytracing_tpu import load_scene

    s = load_scene(scene_path)
    spheres = [(np.asarray(x.pos, F), F(x.radius), x.material_id) for x in s.spheres]
    planes = [
        (
            np.asarray(p.pos, F),
            np.asarray(p.normal(), F),
            np.asarray(p.base_change_matrix(), F),
            p.material_id,
        )
        for p in s.planes
    ]
    tris = []
    tri_data = s.meshes.triangles
    if len(tri_data):
        vv, nn = s.meshes.vertices, s.meshes.normals
        for row in tri_data:
            a = vv[row[0]].astype(F)
            b = vv[row[1]].astype(F)
            c = vv[row[2]].astype(F)
            tris.append(
                (
                    a,
                    b - a,
                    c - a,
                    nn[row[3]].astype(F),
                    nn[row[4]].astype(F),
                    nn[row[5]].astype(F),
                    int(row[6]),
                )
            )
    mats = {
        "color": np.array([m.color for m in s.materials], F),
        "roughness": np.array([m.roughness for m in s.materials], F),
        "metallic": np.array([m.metallic for m in s.materials], F),
        "emission": np.array([m.emission for m in s.materials], F),
    }
    return s, {
        "spheres": spheres,
        "planes": planes,
        "triangles": tris,
        "materials": mats,
    }


def build_env(environment):
    return {
        "texture": np.asarray(environment.texture, F),
        "prob": np.asarray(environment.alias.probability, F),
        "alias": np.asarray(environment.alias.alias_index, np.int64),
        "pmf": np.asarray(environment.alias.pmf, F),
    }


def render(scene_path, environment, width, height, spp):
    host_scene, scene = build_scene(scene_path)
    env = build_env(environment)
    cam = host_scene.camera
    rot = np.asarray(cam.rot_transform(), F)
    pos = np.asarray(cam.pos, F)
    n = width * height
    pix = np.arange(n, dtype=np.uint32)
    px = (pix % width).astype(F)
    py = (pix // width).astype(F)

    total = np.zeros((n, 3), F)
    for s_idx in range(spp):
        state = rng_seed(pix, np.uint32(s_idx))
        state, jitter = rng_in_circle(state)
        jx = px + jitter[:, 0]
        jy = py + jitter[:, 1]
        sx = (jx / F(width) * 2 - 1)
        sy = -(jy / F(height) * 2 - 1)
        max_y = np.sin(F(cam.fov_y) / 2)
        aspect = F(width) / F(height)
        rc = np.stack(
            [sx * max_y * aspect, sy * max_y, -np.ones_like(sx)], -1
        )
        rd = rc @ rot.T
        rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        ro = np.broadcast_to(pos, rd.shape).astype(F)
        total += trace(scene, env, ro.copy(), rd.astype(F), state)
    return (total / F(spp)).reshape(height, width, 3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="assets/scenes/house.toml")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default="/tmp/reference_mean.npy")
    args = ap.parse_args()

    from rsoderh_raytracing_tpu.env.environment import (
        load_default_environments,
    )

    env = load_default_environments()[0]
    img = render(args.scene, env, args.size, args.size, args.spp)
    np.save(args.out, img)
    print(f"wrote {args.out} mean={img.mean():.4f} max={img.max():.2f}")


if __name__ == "__main__":
    main()
