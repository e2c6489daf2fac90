"""Command-line renderer: `python -m cs397raytracingsp22.cli scene.py -o out.png`.

The reference has no CLI — its entire configuration is a hard-coded scene
in run() (tracing.rs:354-548). Here a scene is any Python file exposing
`build(**overrides) -> Scene`; the five BASELINE configs live in scenes/.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys


def load_scene_module(path: str):
    spec = importlib.util.spec_from_file_location("user_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "build"):
        raise SystemExit(f"{path} must define build(**overrides) -> Scene")
    return mod


def main(argv=None):
    p = argparse.ArgumentParser(description="JAX wavefront path tracer")
    p.add_argument("scene", help="scene script exposing build(**overrides)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--checkpoint", help="HDR accumulator checkpoint (.npz) for resume")
    p.add_argument("--spp-chunk", type=int, help="samples per accumulation chunk")
    p.add_argument("--pixel-chunk", type=int)
    p.add_argument("--stats-json", help="write render stats to this path")
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        dest="set_overrides",
        help="extra build(**overrides) kwarg, repeatable — e.g. "
        "--set obj_path=assets/teapot_6k.obj --set path_depth=4; "
        "VALUE is parsed as a Python literal, else kept as a string",
    )
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument(
        "--nee",
        action="store_true",
        help="next-event estimation (explicit light sampling) — an "
        "opt-in estimator beyond the reference: same converged image "
        "at equal depth, far less noise per sample on small-light "
        "scenes (render/nee.py)",
    )
    p.add_argument(
        "--mesh",
        help="render over a DPxSP device mesh, e.g. --mesh 4x2 "
        "(pixels shard over dp, spp over sp; defaults to single device)",
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        help="multi-host: call jax.distributed.initialize before rendering "
        "(run the same command on every host with --coordinator/"
        "--num-processes/--process-id)",
    )
    p.add_argument("--coordinator", help="host:port of process 0")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.distributed:
        from cs397raytracingsp22.parallel import multihost

        multihost.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    mesh = None
    if args.mesh:
        from cs397raytracingsp22.parallel.sharding import make_device_mesh

        try:
            n_dp, n_sp = (int(x) for x in args.mesh.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh must look like 4x2, got {args.mesh!r}")
        mesh = make_device_mesh(n_dp=n_dp, n_sp=n_sp)

    from cs397raytracingsp22.render.driver import render_to_image, save_png

    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.spp:
        overrides["spp"] = args.spp
    for kv in args.set_overrides:
        key, eq, value = kv.partition("=")
        if not eq or not key:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        import ast

        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value  # bare strings (paths) stay strings

    mod = load_scene_module(args.scene)
    scene = mod.build(**overrides)
    if args.nee:
        import dataclasses

        scene = dataclasses.replace(
            scene, camera=dataclasses.replace(scene.camera, nee=True)
        )

    from cs397raytracingsp22.utils.profiling import device_trace

    # RT_PROFILE_DIR=dir captures a jax.profiler trace of the whole
    # render (TensorBoard/Perfetto); no-op when unset
    with device_trace():
        img, stats = render_to_image(
            scene,
            seed=args.seed,
            pixel_chunk=args.pixel_chunk,
            spp_chunk=args.spp_chunk,
            checkpoint_path=args.checkpoint,
            verbose=not args.quiet,
            mesh=mesh,
        )
    import jax as _jax

    if _jax.process_index() == 0:
        save_png(img, args.output)
        if not args.quiet:
            print(f"[cli] wrote {args.output}")
    if args.stats_json and _jax.process_index() == 0:
        with open(args.stats_json, "w") as f:
            json.dump(
                {
                    "width": stats.width,
                    "height": stats.height,
                    "spp": stats.spp,
                    "path_depth": stats.path_depth,
                    "wall_seconds": stats.wall_seconds,
                    "compile_seconds": stats.compile_seconds,
                    "primary_rays": stats.primary_rays,
                    "path_segments": stats.path_segments,
                    "primary_mrays_per_sec": stats.primary_mrays_per_sec,
                    "segment_mrays_per_sec": stats.segment_mrays_per_sec,
                },
                f,
                indent=2,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
