#!/usr/bin/env python
"""Generate midpoint-subdivided suzanne assets.

Each subdivision level splits every triangle into 4 at welded edge
midpoints (positions averaged, baked vertex normals averaged and
renormalized — the OBJ contract from src/mesh.rs:60-64 requires
normals). Two levels take suzanne's 968 triangles to 15,488
(assets/suzanne_hi.obj, committed); four levels to 247,808
(assets/suzanne_xhi.obj — the past-65,536-triangle benchmark,
generated on demand: too large to commit).

Deterministic: same input -> same output bytes. Run from the repo root:
  python scripts/subdivide_obj.py [levels] [output.obj]
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_obj(path):
    verts, norms, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                refs = []
                for p in parts[1:]:
                    comps = p.split("/")
                    vi = int(comps[0]) - 1
                    ni = int(comps[2]) - 1 if len(comps) > 2 and comps[2] else 0
                    refs.append((vi, ni))
                # fan-triangulate (scene/mesh.py does the same)
                for k in range(1, len(refs) - 1):
                    faces.append([refs[0], refs[k], refs[k + 1]])
    return (
        np.asarray(verts, np.float64),
        np.asarray(norms, np.float64),
        faces,
    )


def subdivide(verts, norms, faces):
    """One midpoint-subdivision level with edge welding. Midpoint vertex
    AND normal indices are keyed by the undirected (vi, ni) edge pair so
    shared edges produce shared midpoints (smooth shading preserved)."""
    verts = list(map(tuple, verts))
    norms = list(map(tuple, norms))
    edge_mid = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key in edge_mid:
            return edge_mid[key]
        (va, na), (vb, nb) = a, b
        v = tuple(
            (x + y) / 2.0 for x, y in zip(verts[va], verts[vb])
        )
        nsum = [x + y for x, y in zip(norms[na], norms[nb])]
        length = float(np.sqrt(sum(x * x for x in nsum))) or 1.0
        nvec = tuple(x / length for x in nsum)
        verts.append(v)
        norms.append(nvec)
        ref = (len(verts) - 1, len(norms) - 1)
        edge_mid[key] = ref
        return ref

    out = []
    for a, b, c in faces:
        ab = midpoint(a, b)
        bc = midpoint(b, c)
        ca = midpoint(c, a)
        out.extend(
            [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        )
    return np.asarray(verts, np.float64), np.asarray(norms, np.float64), out


def write_obj(path, verts, norms, faces, comment):
    with open(path, "w") as f:
        f.write(f"# {comment}\n")
        f.write("o Suzanne_hi\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for n in norms:
            f.write(f"vn {n[0]:.4f} {n[1]:.4f} {n[2]:.4f}\n")
        f.write("s 1\n")
        for (va, na), (vb, nb), (vc, nc) in faces:
            f.write(
                f"f {va + 1}//{na + 1} {vb + 1}//{nb + 1} {vc + 1}//{nc + 1}\n"
            )


def main() -> int:
    levels = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    verts, norms, faces = load_obj(os.path.join(ROOT, "assets", "suzanne.obj"))
    for _ in range(levels):
        verts, norms, faces = subdivide(verts, norms, faces)
    default_out = "suzanne_hi.obj" if levels <= 2 else "suzanne_xhi.obj"
    out = (
        sys.argv[2]
        if len(sys.argv) > 2
        else os.path.join(ROOT, "assets", default_out)
    )
    write_obj(
        out,
        verts,
        norms,
        faces,
        f"suzanne.obj midpoint-subdivided x{levels} "
        f"({len(faces)} triangles) — scripts/subdivide_obj.py",
    )
    print(f"{out}: {len(verts)} verts, {len(norms)} normals, "
          f"{len(faces)} tris")
    return 0


if __name__ == "__main__":
    sys.exit(main())
