"""GPU bring-up measurements: dense-scan kernel vs XLA, the dense/BVH
crossover, the main scene end to end with each scan, the chunk budget,
and the executor A/B on the big-mesh scene.

    python tools/gpu_bringup.py [phase ...]
    # phases: scan cap main budget executors trace

Prints one line per measurement, each with the card's name and power
limit, and writes them all to chiprun_out/gpu_bringup.json. Needs a GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

RESULTS: list = []
CARD = ""


def record(**kw):
    kw["card"] = CARD
    RESULTS.append(kw)
    print(json.dumps(kw), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gpu_bringup.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)


def timed(fn, *args, reps=5):
    """Median wall seconds of fn(*args) after one warm call."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), first, out


# (block_rays, block_tris, num_warps) of the Triton scan, timed in turns
BLOCKS = ((32, 32, 2), (16, 16, 1), (16, 32, 1), (16, 64, 2),
          (32, 32, 2), (16, 16, 1))


def _set_blocks(br, bt, nw):
    from cs397raytracingsp22.ops.pallas import tri_scan

    tri_scan.BLOCK_RAYS, tri_scan.BLOCK_TRIS, tri_scan.NUM_WARPS = br, bt, nw


def _blocks_name(br, bt, nw):
    return f"triton {br}x{bt} w{nw}"


def phase_scan():
    """The Triton scan at each block shape in BLOCKS vs the XLA scan, at
    2^20 main-scene rays against the 6,144-triangle teapot."""
    from cs397raytracingsp22.ops import bvh
    from cs397raytracingsp22.ops.pallas import tri_scan
    from scenes import cornell_teapot

    scene = cornell_teapot.build(512, 512, spp=1)
    data = scene.compile()
    mesh = data.meshes[0]
    n = 1 << 20
    nt = int(mesh.tri_verts.shape[0])
    o, d = chip_smoke.scan_rays(data, scene.camera, 0, n)
    xla = jax.jit(lambda o, d: bvh.intersect_tris_scan(
        o, d, mesh.tri_verts, 1e-3, 100.0))
    t, first, ref = timed(xla, o, d)
    ref = jax.device_get(ref)
    record(phase="scan", impl="xla", rays=n, tris=nt, seconds=t, first_call=first)
    default = (tri_scan.BLOCK_RAYS, tri_scan.BLOCK_TRIS, tri_scan.NUM_WARPS)
    for cfg in BLOCKS:
        _set_blocks(*cfg)
        fn = jax.jit(lambda o, d: tri_scan.tri_scan(o, d, mesh.tri_table, 1e-3, 100.0))
        t, first, got = timed(fn, o, d)
        p = chip_smoke.scan_parity(ref, jax.device_get(got))
        record(phase="scan", impl=_blocks_name(*cfg), rays=n, tris=nt,
               seconds=t, first_call=first, parity=p,
               parity_ok=chip_smoke.scan_parity_ok(p))
    _set_blocks(*default)


CAP_BLOCKS = ((32, 32, 2), (16, 16, 1))


def phase_cap():
    """Dense scan (Triton at each of CAP_BLOCKS, XLA) vs BVH traversal as
    the mesh grows."""
    import numpy as np

    from cs397raytracingsp22.ops import bvh
    from cs397raytracingsp22.ops.pallas import tri_scan
    from cs397raytracingsp22.models.geometry import StaticMesh
    from cs397raytracingsp22 import Lambertian, Scene
    from cs397raytracingsp22.models import transform as tf
    from cs397raytracingsp22.utils.obj_loader import uv_sphere
    from scenes import cornell_teapot

    n = 1 << 20
    default = (tri_scan.BLOCK_RAYS, tri_scan.BLOCK_TRIS, tri_scan.NUM_WARPS)
    for lat, lon in ((48, 64), (64, 96), (72, 112), (80, 112), (90, 128),
                     (128, 128)):
        sc = cornell_teapot.build_big_mesh(512, 512, spp=1)
        sphere = StaticMesh(uv_sphere(lat, lon), [None] * 5,
                            Lambertian(albedo=(0.5, 0.5, 0.5)),
                            (tf.translate(0.0, 1.1, -0.6) @ tf.scale(1.1)).astype(np.float32))
        sc = Scene(camera=sc.camera, objects=list(sc.objects[:-1]) + [sphere])
        data = sc.compile()
        m = data.meshes[0]
        nt = int(m.tri_verts.shape[0])
        o, d = chip_smoke.scan_rays(data, sc.camera, 0, n)
        trav = jax.jit(lambda o, d, m=m: bvh.traverse(
            o, d, 1e-3, 100.0, m.bounds_min, m.bounds_max, m.skip,
            m.leaf_start, m.leaf_count, m.tri_verts, m.leaf_size))
        t, first, _ = timed(trav, o, d, reps=3)
        record(phase="cap", impl="bvh.traverse", rays=n, tris=nt, seconds=t, first_call=first)
        for cfg in CAP_BLOCKS:
            _set_blocks(*cfg)
            tk, first, _ = timed(jax.jit(lambda o, d, m=m: tri_scan.tri_scan(
                o, d, m.tri_table, 1e-3, 100.0)), o, d, reps=3)
            record(phase="cap", impl=_blocks_name(*cfg), rays=n, tris=nt,
                   seconds=tk, first_call=first)
        _set_blocks(*default)
        tx, first, _ = timed(jax.jit(lambda o, d, m=m: bvh.intersect_tris_scan(
            o, d, m.tri_verts, 1e-3, 100.0)), o, d, reps=3)
        record(phase="cap", impl="xla scan", rays=n, tris=nt, seconds=tx, first_call=first)


def _render(scene, **kw):
    from cs397raytracingsp22.render.driver import render_to_image

    t0 = time.perf_counter()
    img, st = render_to_image(scene, seed=0, verbose=False, **kw)
    return img, st, time.perf_counter() - t0


def _stats(st):
    return dict(wall=st.wall_seconds, compile=st.compile_seconds,
                steady=st.steady_seconds, segments=st.path_segments,
                mrays=st.segment_mrays_per_sec)


def _use_xla_scan(on: bool):
    from cs397raytracingsp22.ops import bvh, intersect

    if not hasattr(intersect, "_dense_scan_kernel"):
        intersect._dense_scan_kernel = intersect.dense_scan
    if on:
        intersect.dense_scan = lambda mesh, o, d, lo, hi: bvh.intersect_tris_scan(
            o, d, mesh.tri_verts, lo, hi)
    else:
        intersect.dense_scan = intersect._dense_scan_kernel
    jax.clear_caches()


def phase_main():
    """The main scene end to end with each scan, in turns; every variant
    renders twice (cold, then warm)."""
    import numpy as np

    from cs397raytracingsp22.ops.pallas import tri_scan
    from scenes import cornell_teapot

    default = (tri_scan.BLOCK_RAYS, tri_scan.BLOCK_TRIS, tri_scan.NUM_WARPS)
    variants = [c for c in CAP_BLOCKS] + ["xla"]
    for impl in variants + variants[::-1]:
        _use_xla_scan(impl == "xla")
        if impl != "xla":
            _set_blocks(*impl)
        scene = cornell_teapot.build(512, 512, spp=64, path_depth=8)
        _, _, w0 = _render(scene)
        img, st, w = _render(scene)
        record(phase="main", impl=impl if impl == "xla" else _blocks_name(*impl),
               res=512, spp=64, depth=8, cold_total=w0, total=w,
               img_mean=float(np.mean(img)), **_stats(st))
    _use_xla_scan(False)
    _set_blocks(*default)


def phase_budget():
    """Compiled memory of one chunk and wall time per chunk size."""
    from cs397raytracingsp22.render import driver
    from cs397raytracingsp22.utils import threefry
    from scenes import cornell_teapot

    scene = cornell_teapot.build(512, 512, spp=64, path_depth=8)
    data = scene.compile()
    for px in (4096, 16384, 65536):
        ids = jnp.arange(px, dtype=jnp.int32)
        lowered = driver.render_chunk.lower(
            data, scene.camera, ids, threefry.key_words(0), jnp.int32(0), 64, 1)
        ma = lowered.compile().memory_analysis()
        _, st, w = _render(scene, scene_data=data, pixel_chunk=px)
        record(phase="budget", pixel_chunk=px, rays=px * 64,
               temp_bytes=getattr(ma, "temp_size_in_bytes", None),
               arg_bytes=getattr(ma, "argument_size_in_bytes", None),
               out_bytes=getattr(ma, "output_size_in_bytes", None),
               peak=jax.devices()[0].memory_stats().get("peak_bytes_in_use"),
               total=w, **_stats(st))


def phase_executors():
    """path_trace vs the staged executor tier on the big-mesh scene,
    warm (each variant renders once to compile, then once measured), in
    turns."""
    from cs397raytracingsp22.render.driver import StagedOptions
    from scenes import cornell_teapot

    variants = {
        "path_trace": None,
        "staged+sort": StagedOptions(sort=True),
        "staged": StagedOptions(),
    }
    order = ["path_trace", "staged+sort", "staged", "staged", "staged+sort",
             "path_trace"]
    for name in order:
        jax.clear_caches()
        scene = cornell_teapot.build_big_mesh(512, 512, spp=32, path_depth=8)
        data = scene.compile()
        kw = {"scene_data": data, "staged": variants[name]}
        _, st0, w0 = _render(scene, **kw)
        _, st, w = _render(scene, **kw)
        record(phase="executors", impl=name, res=512, spp=32, depth=8,
               cold_total=w0, total=w, **_stats(st))


def reduce_trace(path: str, top: int = 12) -> dict:
    """Device time by kernel from an .xplane.pb: for every GPU plane, the
    line with the most events (the ops line), its busy time (union of
    event intervals), its span, and the `top` kernel names by summed
    duration."""
    pd = jax.profiler.ProfileData.from_file(path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        if not lines:
            continue
        name, events = max(lines.items(), key=lambda kv: len(kv[1]))
        if not events:
            continue
        spans = sorted((e.start_ns, e.end_ns) for e in events)
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s0, e0 in spans[1:]:
            if s0 > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s0, e0
            else:
                cur_e = max(cur_e, e0)
        busy += cur_e - cur_s
        by_name: dict = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.duration_ns
        out[plane.name] = {
            "line": name,
            "lines": sorted(lines),
            "events": len(events),
            "span_s": (spans[-1][1] - spans[0][0]) * 1e-9,
            "busy_s": busy * 1e-9,
            "top": sorted(((k, v * 1e-9) for k, v in by_name.items()),
                          key=lambda kv: -kv[1])[:top],
        }
    return out


def phase_trace():
    """Device trace of a warm main-scene render at 256², 64 spp (four
    2^20-ray chunks), reduced to device time by kernel."""
    import glob
    import tempfile

    from scenes import cornell_teapot

    scene = cornell_teapot.build(256, 256, spp=64, path_depth=8)
    data = scene.compile()
    _render(scene, scene_data=data)
    log_dir = tempfile.mkdtemp(prefix="rt_trace_")
    jax.profiler.start_trace(log_dir)
    _, st, w = _render(scene, scene_data=data)
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    record(phase="trace", res=256, spp=64, depth=8, total=w, **_stats(st),
           device=reduce_trace(path))


def main(argv):
    global CARD
    CARD = chip_smoke.device_line()["card"]
    phases = argv or ["scan", "cap", "main", "budget", "executors", "trace"]
    failed = []
    for ph in phases:
        t0 = time.perf_counter()
        try:
            globals()[f"phase_{ph}"]()
        except Exception as e:  # record and go on to the next phase
            import traceback

            traceback.print_exc()
            record(phase=ph, error=repr(e)[:1000])
            failed.append(ph)
        print(f"[{ph}] done in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise SystemExit(f"phases failed: {failed}")


if __name__ == "__main__":
    main(sys.argv[1:])
