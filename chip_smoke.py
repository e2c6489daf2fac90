"""Quickest proof that the path tracer runs on the GPU.

    python3 chip_smoke.py               # one card: phases a-d
    python3 chip_smoke.py --four-cards  # four cards: phase e only

a. Device: JAX must compute on a GPU; prints its kind, the device count,
   and the card's name and power limit from nvidia-smi.
b. Main render: the Cornell box + 6,144-triangle teapot at 512², 64 spp,
   depth 8 through `cli.main` in this process. Prints wall, compile and
   steady-state Mrays/s; the image must be finite and not black.
c. Kernel parity: the Triton dense triangle scan against the jnp scan
   compiled by XLA, both on the card, at 2^20 rays (camera rays plus
   scattered secondary rays) against the 6,144 triangles.
d. CPU vs GPU: the same renders on the card and on the host CPU, in this
   process, compared image to image.
e. (--four-cards) The main scene over ("dp", "sp") meshes of 4×1 and 2×2,
   each compared with a one-card render.

Every failure raises, so the exit code is non-zero; the last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Phase c: hit masks agree on all but 1e-4 of rays; the same winner agrees
# in t to rtol 1e-5; a different winner only at a tie (|Δt| <= 1e-5·t).
SCAN_HIT_AGREE = 1.0 - 1e-4
SCAN_T_RTOL = 1e-5
# Phases d and e: mean |Δ| <= 0.05 u8 and at most 1e-3 of subpixels off by
# more than 2 u8. FMA contraction and transcendentals differ between
# backends (and psum reorders per-pixel sums), and one flipped winner
# re-rolls a whole path.
IMG_MEAN_ABS = 0.05
IMG_FRAC_OFF = 1e-3
IMG_OFF_U8 = 2


def scan_parity(ref, got) -> dict:
    """Compare two (hit, t, tri, u, v) scan results (numpy arrays)."""
    hit_r, t_r, tri_r = (np.asarray(x) for x in ref[:3])
    hit_g, t_g, tri_g = (np.asarray(x) for x in got[:3])
    both = hit_r & hit_g
    rel = np.abs(t_g.astype(np.float64) - t_r) / np.maximum(np.abs(t_r), 1e-30)
    same = both & (tri_r == tri_g)
    other = both & (tri_r != tri_g)
    return {
        "rays": int(hit_r.size),
        "hit_agree": float(np.mean(hit_r == hit_g)),
        "same_winner_t_rel": float(rel[same].max(initial=0.0)),
        "other_winner": int(other.sum()),
        "other_winner_t_rel": float(rel[other].max(initial=0.0)),
    }


def scan_parity_ok(p: dict) -> bool:
    return (
        p["hit_agree"] >= SCAN_HIT_AGREE
        and p["same_winner_t_rel"] <= SCAN_T_RTOL
        and p["other_winner_t_rel"] <= SCAN_T_RTOL
    )


def image_diff(a: np.ndarray, b: np.ndarray) -> dict:
    """Mean |Δ| in u8 and the share of subpixels off by more than 2."""
    if a.shape != b.shape:
        raise ValueError(f"image shapes differ: {a.shape} vs {b.shape}")
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {
        "mean_abs": float(d.mean()),
        "frac_off": float(np.mean(d > IMG_OFF_U8)),
        "max_abs": int(d.max()),
    }


def image_diff_ok(d: dict) -> bool:
    return d["mean_abs"] <= IMG_MEAN_ABS and d["frac_off"] <= IMG_FRAC_OFF


def scan_rays(scene_data, camera, mesh_index: int, n: int, seed: int = 0):
    """n rays in a mesh's object space: half camera rays of `camera`, half
    secondary rays leaving random points of the mesh's surface in
    uniformly random directions. Returns (o, d) float32 device arrays."""
    import jax.numpy as jnp

    from cs397raytracingsp22.ops import intersect
    from cs397raytracingsp22.utils import threefry

    mesh = scene_data.meshes[mesh_index]
    rng = np.random.default_rng(seed)
    n_cam = n // 2
    n_px = camera.screen_width * camera.screen_height
    ids = jnp.asarray(rng.integers(0, n_px, n_cam, dtype=np.int32))
    o_c, d_c = camera.generate_rays(threefry.key_words(seed), ids, spp=1)
    o_c = intersect._transform_point(mesh.inv_transform, o_c.reshape(-1, 3))
    d_c = intersect._transform_vector(mesh.inv_transform, d_c.reshape(-1, 3))
    verts = np.asarray(mesh.tri_verts)
    tri = rng.integers(0, verts.shape[0], n - n_cam)
    uv = rng.uniform(size=(n - n_cam, 2))
    uv = np.where(uv.sum(1, keepdims=True) > 1.0, 1.0 - uv, uv)
    v = verts[tri]
    o_s = v[:, 0] + uv[:, :1] * (v[:, 1] - v[:, 0]) + uv[:, 1:] * (v[:, 2] - v[:, 0])
    d_s = rng.normal(size=(n - n_cam, 3))
    d_s /= np.linalg.norm(d_s, axis=1, keepdims=True)
    o = jnp.concatenate([o_c, jnp.asarray(o_s, jnp.float32)])
    d = jnp.concatenate([d_c, jnp.asarray(d_s, jnp.float32)])
    return o, d


def device_line() -> dict:
    """Phase a."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"JAX computes on {dev.platform!r}, not a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    info = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": smi[0],
    }
    print(f"[a] device: {info['kind']} x{info['count']} ({info['platform']})")
    print(smi[0])
    return info


def main_render(card: str, width=512, height=512, spp=64, depth=8) -> dict:
    """Phase b, through the CLI entry point in this process."""
    from cs397raytracingsp22 import cli
    from cs397raytracingsp22.utils.png import read_png

    png = os.path.join(OUT_DIR, "main_512_64spp.png")
    stats_path = os.path.join(OUT_DIR, "main_512_64spp.json")
    rc = cli.main([
        os.path.join(ROOT, "scenes", "cornell_teapot.py"),
        "-o", png, "--stats-json", stats_path, "-q",
        "--width", str(width), "--height", str(height), "--spp", str(spp),
        "--set", f"path_depth={depth}",
    ])
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    with open(stats_path) as f:
        stats = json.load(f)
    img = read_png(png)
    if img.shape != (height, width, 3):
        raise RuntimeError(f"image shape {img.shape}")
    if not img.mean() > 1.0:
        raise RuntimeError(f"image is black (mean {img.mean():.3f} u8)")
    print(
        f"[b] main render {width}x{height} {spp}spp depth {depth} on {card}: "
        f"wall {stats['wall_seconds']:.3f} s, compile "
        f"{stats['compile_seconds']:.3f} s, steady "
        f"{stats['segment_mrays_per_sec']:.1f} Mrays/s segments, "
        f"image mean {img.mean():.2f} u8"
    )
    return stats


def kernel_parity(card: str, n: int = 1 << 20) -> dict:
    """Phase c: Triton scan vs the jnp scan under XLA, both on the card."""
    import jax

    from cs397raytracingsp22.ops import bvh
    from cs397raytracingsp22.ops.pallas import tri_scan
    from scenes import cornell_teapot

    scene = cornell_teapot.build(512, 512, spp=1)
    data = scene.compile()
    o, d = scan_rays(data, scene.camera, 0, n)
    mesh = data.meshes[0]
    ref = jax.jit(bvh.intersect_tris_scan)(o, d, mesh.tri_verts, 1e-3, 100.0)
    got = tri_scan.tri_scan(o, d, mesh.tri_table, 1e-3, 100.0)
    p = scan_parity(jax.device_get(ref), jax.device_get(got))
    print(
        f"[c] triton tri_scan vs XLA scan, {n} rays x "
        f"{mesh.tri_verts.shape[0]} tris on {card}: {p}"
    )
    if not scan_parity_ok(p):
        raise RuntimeError(f"kernel parity failed: {p}")
    return p


def _render(scene_fn, device, nee=False, mesh=None):
    import dataclasses

    import jax

    from cs397raytracingsp22.render.driver import render_to_image

    scene = scene_fn()
    if nee:
        scene = dataclasses.replace(
            scene, camera=dataclasses.replace(scene.camera, nee=True)
        )
    with jax.default_device(device):
        img, _ = render_to_image(scene, seed=0, verbose=False, mesh=mesh)
    return img


def cpu_vs_gpu(card: str) -> list:
    """Phase d."""
    import functools

    import jax

    from scenes import cornell_teapot

    cases = [
        ("main 128x128 16spp depth 8", functools.partial(
            cornell_teapot.build, 128, 128, spp=16, path_depth=8), False),
        ("main 128x128 16spp depth 8 nee", functools.partial(
            cornell_teapot.build, 128, 128, spp=16, path_depth=8), True),
        ("big mesh 64x64 8spp depth 8", functools.partial(
            cornell_teapot.build_big_mesh, 64, 64, spp=8, path_depth=8), False),
    ]
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    out = []
    for name, fn, nee in cases:
        d = image_diff(_render(fn, gpu, nee), _render(fn, cpu, nee))
        print(f"[d] {name}: GPU ({card}) vs CPU {d}")
        if not image_diff_ok(d):
            raise RuntimeError(f"CPU/GPU images differ: {name}: {d}")
        out.append(d)
    return out


def four_cards(card: str, width=128, height=128, spp=16, depth=8) -> list:
    """Phase e: sharded renders against a one-card render."""
    import functools

    import jax

    from cs397raytracingsp22.parallel.sharding import make_device_mesh
    from scenes import cornell_teapot

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, have {len(jax.devices())}")
    fn = functools.partial(cornell_teapot.build, width, height, spp=spp,
                           path_depth=depth)
    ref = _render(fn, jax.devices()[0])
    out = []
    for n_dp, n_sp in ((4, 1), (2, 2)):
        t0 = time.perf_counter()
        img = _render(fn, jax.devices()[0], mesh=make_device_mesh(n_dp, n_sp))
        d = image_diff(img, ref)
        print(
            f"[e] mesh {n_dp}x{n_sp} vs one card ({card}): {d}, "
            f"{time.perf_counter() - t0:.3f} s incl. compile"
        )
        if not image_diff_ok(d):
            raise RuntimeError(f"sharded image differs: {n_dp}x{n_sp}: {d}")
        out.append(d)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)

    info = device_line()
    card = info["card"]
    if args.four_cards:
        four_cards(card)
    else:
        main_render(card)
        kernel_parity(card)
        cpu_vs_gpu(card)
    print(f"[smoke] all phases passed on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"], "count": info["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
