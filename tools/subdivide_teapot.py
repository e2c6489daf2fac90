"""Subdivide the reference's 240-triangle teapot decimation to the ~6k
triangles BASELINE config 2 names ("Utah teapot, ~6k tris").

Midpoint (linear) 4:1 subdivision — positions/normals/uvs interpolated,
normals renormalized; geometry is unchanged (same surface), so renders
differ from the 240-tri mesh only by shading interpolation. Two levels
give 3840 tris; a third level on the largest ~1/5 of triangles lands at
~6k. Output: assets/teapot_6k.obj (single-index OBJ, v/vn/vt + f)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cs397raytracingsp22.utils import obj_loader


def subdivide(pos, nrm, uv, tris, select=None):
    """One 4:1 midpoint subdivision; `select` masks which triangles
    split (others kept). Returns new (pos, nrm, uv, tris)."""
    pos = list(map(tuple, pos))
    nrm = list(map(tuple, nrm))
    uv = list(map(tuple, uv))
    midpoint_cache = {}

    def midpoint(a, b):
        k = (min(a, b), max(a, b))
        if k in midpoint_cache:
            return midpoint_cache[k]
        p = tuple((np.array(pos[a]) + np.array(pos[b])) / 2.0)
        nv = np.array(nrm[a]) + np.array(nrm[b])
        ln = np.linalg.norm(nv)
        nv = tuple(nv / ln) if ln > 0 else tuple(nv)
        t = tuple((np.array(uv[a]) + np.array(uv[b])) / 2.0)
        pos.append(p)
        nrm.append(nv)
        uv.append(t)
        idx = len(pos) - 1
        midpoint_cache[k] = idx
        return idx

    out = []
    for ti, (a, b, c) in enumerate(tris):
        if select is not None and not select[ti]:
            out.append((a, b, c))
            continue
        ab = midpoint(a, b)
        bc = midpoint(b, c)
        ca = midpoint(c, a)
        out += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
    return (
        np.asarray(pos, np.float64),
        np.asarray(nrm, np.float64),
        np.asarray(uv, np.float64),
        np.asarray(out, np.int64),
    )


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/obj/teapot.obj"
    dst = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "teapot_6k.obj",
    )
    target = int(sys.argv[3]) if len(sys.argv) > 3 else 6000

    m = obj_loader.load_obj(src)
    pos, nrm, uv, tris = (
        m.positions.astype(np.float64), m.normals.astype(np.float64),
        m.texcoords.astype(np.float64), m.indices.astype(np.int64),
    )
    while tris.shape[0] * 4 <= target:
        pos, nrm, uv, tris = subdivide(pos, nrm, uv, tris)
        print(f"subdivided -> {tris.shape[0]} tris")
    if tris.shape[0] < target:
        # split the largest triangles until ~target (each split: +3)
        need = (target - tris.shape[0]) // 3
        a = pos[tris[:, 0]]
        e1 = pos[tris[:, 1]] - a
        e2 = pos[tris[:, 2]] - a
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        thresh = np.partition(area, -need)[-need] if need else np.inf
        select = area >= thresh
        pos, nrm, uv, tris = subdivide(pos, nrm, uv, tris, select)
        print(f"selective split -> {tris.shape[0]} tris")

    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        f.write(f"# teapot_6k: midpoint-subdivided {src} ({tris.shape[0]} tris)\n")
        for p in pos:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for t in uv:
            f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
        for v in nrm:
            f.write(f"vn {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in tris + 1:
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")
    print(f"wrote {dst}: {pos.shape[0]} verts, {tris.shape[0]} tris")


if __name__ == "__main__":
    main()
