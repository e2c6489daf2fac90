"""Render driver: chunked megabatch rendering, accumulation, image I/O.

Replaces the reference's rayon row loop (tracing.rs:221-263) with a
jit-compiled chunk kernel: pixels are processed in fixed-size chunks
(static shapes → one compile), each chunk generating pixel×spp rays,
integrating them with the wavefront loop, and averaging samples. spp can
additionally be chunked for memory control and checkpointed accumulation
(SURVEY.md §5 checkpoint/resume — the reference loses a render killed at
99%; we persist the running HDR accumulator).

All chunking is invisible to the image: RNG is content-keyed, so the
sample VALUES never depend on (pixel_chunk, spp_chunk, device count).
Pixel chunking and device sharding are pure partitions — bit-identical
output. spp chunking splits the per-pixel f32 sample sum into partial
sums, so a pixel sitting exactly on a u8 quantization boundary can round
differently (measured: ≤1 u8 on ~1e-6 of subpixels at 512²x64spp; zero
on smaller configs).

The HDR accumulator is DEVICE-RESIDENT (f32 pieces, one per pixel
chunk): chunk radiance is added on device and only the final tonemapped
u8 image crosses the device→host link (plus the f64 accumulator at
checkpoint writes), so no per-chunk host flush stalls the dispatch queue.
Failure recovery tracks a known-good snapshot of the accumulator
pieces: if an async device error surfaces at a sync point, the chunks
dispatched since the snapshot are re-run synchronously and re-added.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22.models.camera import Camera, ShadingMode
from cs397raytracingsp22.models.scene import Scene, SceneData
from cs397raytracingsp22.ops import tonemap as tonemap_ops
from cs397raytracingsp22.render import integrator
from cs397raytracingsp22.utils import threefry


@dataclasses.dataclass
class RenderStats:
    """Per-render metrics (SURVEY.md §5 observability)."""

    width: int = 0
    height: int = 0
    spp: int = 0
    path_depth: int = 0
    wall_seconds: float = 0.0
    compile_seconds: float = 0.0
    primary_rays: int = 0
    path_segments: float = 0.0
    # post-first-chunk accounting: the first chunk's wall time is
    # dominated by compile, so steady-state rates come from the
    # remaining chunks (zero for single-chunk renders → rates fall back
    # to whole-wall, the only measurement available)
    steady_seconds: float = 0.0
    steady_segments: float = 0.0
    steady_primary: int = 0
    device_count: int = 1

    @property
    def primary_mrays_per_sec(self) -> float:
        if self.steady_seconds > 0:
            return self.steady_primary / self.steady_seconds / 1e6
        return self.primary_rays / (self.wall_seconds or 1e-9) / 1e6

    @property
    def segment_mrays_per_sec(self) -> float:
        if self.steady_seconds > 0:
            return self.steady_segments / self.steady_seconds / 1e6
        return self.path_segments / (self.wall_seconds or 1e-9) / 1e6

    def summary(self) -> str:
        return (
            f"{self.width}x{self.height} @ {self.spp}spp depth {self.path_depth} | "
            f"{self.wall_seconds:.2f}s wall ({self.compile_seconds:.2f}s compile) | "
            f"{self.primary_mrays_per_sec:.1f} Mrays/s primary, "
            f"{self.segment_mrays_per_sec:.1f} Mrays/s segments | "
            f"{self.device_count} device(s)"
        )


def _gen_chunk_rays(camera, pixel_ids, rng_key, sample_offset, spp, n_chains):
    """Camera rays + chain uids for one chunk (shared by the fused and
    staged-shrink executors)."""
    o, d = camera.generate_rays(
        rng_key, pixel_ids, spp=spp, sample_offset=sample_offset
    )
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    sample_ids = sample_offset + jnp.arange(spp, dtype=jnp.int32)
    uids = pixel_ids[:, None] * jnp.int32(camera.aa_sample_count) + sample_ids[None, :]
    uids = uids.reshape(-1)
    if n_chains > 1:
        o = jnp.repeat(o, n_chains, axis=0)
        d = jnp.repeat(d, n_chains, axis=0)
        uids = uids[:, None] * jnp.int32(n_chains) + jnp.arange(
            n_chains, dtype=jnp.int32
        )
        uids = uids.reshape(-1)
    return o, d, uids


def render_chunk_core(
    scene: SceneData,
    camera: Camera,
    pixel_ids: jnp.ndarray,
    rng_key,
    sample_offset: jnp.ndarray,
    spp: int,
    n_chains: int = 1,
):
    """Render one pixel chunk at `spp` samples (trace-level core).

    `n_chains` replicates each camera sample into independent bounce
    chains (the path_samples analogue — see integrator docstring).
    Returns (radiance_sum, segments): per-pixel SUM over this chunk's
    samples (caller accumulates and divides) and traced segment count.
    Pure function of its inputs — used directly under jit (render_chunk)
    and inside shard_map (parallel.sharding).
    """
    n_px = pixel_ids.shape[0]
    o, d, uids = _gen_chunk_rays(
        camera, pixel_ids, rng_key, sample_offset, spp, n_chains
    )

    if camera.shading_mode is ShadingMode.PHONG:
        radiance = integrator.phong_trace(
            scene, o, d, uids, rng_key, camera.eyepoint, camera.max_trace_dist
        )
        segments = jnp.asarray(float(o.shape[0]), jnp.float32)
    elif camera.nee:
        # opt-in NEE estimator (render/nee.py): its own integrator
        radiance, segments = integrator.path_trace_nee(
            scene, o, d, uids, rng_key,
            camera.path_depth, camera.max_trace_dist,
        )
    else:
        radiance, segments = integrator.path_trace(
            scene, o, d, uids, rng_key, camera.path_depth, camera.max_trace_dist
        )

    radiance = radiance.reshape(n_px, spp * n_chains, 3)
    return jnp.sum(radiance, axis=1) / n_chains, segments


render_chunk = jax.jit(
    render_chunk_core, static_argnames=("camera", "spp", "n_chains")
)


_raygen_jit = jax.jit(
    _gen_chunk_rays, static_argnames=("camera", "spp", "n_chains")
)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _pixel_sum(radiance, n_px, per_px):
    return jnp.sum(radiance.reshape(n_px, per_px, 3), axis=1)


@dataclasses.dataclass(frozen=True)
class StagedOptions:
    """The staged executor tier (render_chunk_staged), which a render
    takes only when render_to_image is given `staged=StagedOptions(...)`.
    No entry point does: on an H100 (400 W) the big-mesh scene at
    512²·32 spp, depth 8, rendered in 2.745 and 2.852 s warm through
    path_trace and in 3.079 and 3.141 s through this tier
    (tools/gpu_bringup.py executors). ROADMAP 3.1 removes it.

    static: after the first chunk of each ray count, run
      integrator.path_trace_static with a width schedule baked from its
      live counts; else the per-bounce shrink executors.
    margin: the schedule is the measured live counts times this.
    max_margin: when violations push the margin past this, the static
      executor is off for the rest of the render.
    min_width: the narrowest width a schedule may use.
    fuse: wrap each static chunk in one jit (one compile per (n, widths)
      shape) instead of composing the per-bounce programs on the host.
    sort: coherence-sort the wavefront between bounces.
    """

    static: bool = True
    margin: float = 1.5
    max_margin: float = 16.0
    min_width: int = 4096
    fuse: bool = False
    sort: bool = False


def _build_width_schedule(n, live_counts, depth, margin, min_width=4096):
    """Width schedule for path_trace_static from the measured (max-
    merged) post-bounce live counts: widths[b] bounds the live count
    entering bounce b (= live-after-(b-1) measured × margin), rounded up
    to the next POWER-OF-4 bucket of n — exactly the bucket series the
    shrink executor dispatches (N, N/4, N/16, … ≥ min_width), so the
    static schedule can NEVER mint a bounce-program shape the shrink
    path hasn't already compiled: every new width would be a fresh
    compile, and with the live-piece truncation the over-provision is
    cheap. Clamped to [min_width, n], nonincreasing; widths[0] = n."""
    widths = [n]
    for b in range(1, depth):
        if b - 1 < len(live_counts):
            scaled = live_counts[b - 1] * margin
            # margin is finite by the sync() widening cap, but guard the
            # 0·inf=NaN corner anyway (a measured-zero bounce cannot be
            # widened multiplicatively — that case falls back to the
            # shrink executor via staged_state["disabled"])
            need = int(scaled) if math.isfinite(scaled) else n
        else:
            need = 0
        w = n
        while w // 4 >= max(need, min_width):
            w //= 4
        widths.append(min(w, widths[-1]))
    return tuple(widths)


def _merge_live_schedule(staged_state, n, counts, depth):
    """Fold one measured chunk's per-bounce live counts into the RUNNING
    MAX for ray-count `n` and (re)bake its width schedule. One chunk's
    counts are a biased sample (contiguous pixel blocks — a sky-heavy
    first chunk undershoots chunks over geometry); a violating chunk is
    replayed through the measure branch, so its own counts join the max
    and the rebaked schedule covers it. With margin ≥ 1 every violation
    strictly grows the max, so a render pays at most one cheap
    measure-replay per record-setting chunk instead of runaway margin
    doubling (sync() widens margin only when the max did NOT grow).
    Shared by the single-device and sharded staged dispatchers."""
    counts = (list(counts) + [0] * depth)[:depth]
    prev = staged_state.setdefault("live_max", {}).get(n)
    if prev is None:
        merged = counts
        grew = True
    else:
        merged = [max(a, b) for a, b in zip(prev, counts)]
        grew = merged != prev
    staged_state["live_max"][n] = merged
    staged_state.setdefault("grew", {})[n] = grew
    staged_state["widths"][n] = _build_width_schedule(
        n, merged, depth, staged_state["margin"],
        min_width=staged_state["opts"].min_width,
    )


def render_chunk_staged(scene, camera, pixel_ids, rng_key, sample_offset,
                        spp, n_chains=1, staged_state=None,
                        opts: StagedOptions = StagedOptions()):
    """Staged chunk executor (see StagedOptions).

    Default (staged_state given, non-NEE, opts.static): ONE fused
    program with a PREDICTED width schedule (integrator.path_trace_
    static). The first chunk per ray-count runs the host-orchestrated
    shrink executor with collect_live to measure per-bounce live counts
    (one extra sync), bakes a schedule (live × opts.margin,
    power-of-4 buckets), and every later chunk dispatches the whole
    depth as one program — no per-bounce dispatch, no alive-count
    round-trips, and every stage (sort/kernels/resolve/BSDF) pays only
    the scheduled width. A chunk whose live count beats the schedule
    raises the `ok=False` flag, which the driver's sync() folds into
    its snapshot-replay recovery (the chunk re-runs exactly).

    Fallback (no staged_state, or --nee): per-bounce shrink executors.
    Bit-identical radiance either way (content-keyed RNG; only dead
    rays are ever retired early)."""
    n_px = pixel_ids.shape[0]
    o, d, uids = _raygen_jit(
        camera, pixel_ids, rng_key, sample_offset, spp, n_chains
    )
    use_static = (
        staged_state is not None
        and not staged_state.get("disabled", False)
        and not camera.nee
        and opts.static
    )
    if camera.nee:
        radiance, segments = integrator.path_trace_nee_shrink(
            scene, o, d, uids, rng_key, camera.path_depth,
            camera.max_trace_dist, sort_rays=opts.sort,
        )
    elif use_static:
        n = o.shape[0]
        widths = staged_state["widths"].get(n)
        if widths is None:
            live: list = []
            radiance, segments = integrator.path_trace_shrink(
                scene, o, d, uids, rng_key, camera.path_depth,
                camera.max_trace_dist, collect_live=live,
                sort_rays=opts.sort,
            )
            counts = [int(x) for x in live]  # one-time sync per shape
            _merge_live_schedule(
                staged_state, n, counts, camera.path_depth
            )
        elif opts.fuse:
            # whole-chunk jit: one device program per chunk instead of
            # one per bounce, bit-identical
            cache = staged_state.setdefault("fused", {})
            fn = cache.get((n, widths))
            if fn is None:
                fn = jax.jit(
                    lambda o_, d_, u_, k_, s=scene, w=widths:
                    integrator.path_trace_static(
                        s, o_, d_, u_, k_, camera.path_depth,
                        camera.max_trace_dist, widths=w,
                        sort_rays=opts.sort,
                    )
                )
                cache[(n, widths)] = fn
            radiance, segments, ok = fn(o, d, uids, rng_key)
            staged_state["oks"].append((ok, n))
        else:
            # the per-bounce programs (integrator._bounce_once) are
            # jitted per width, shared with the shrink executor and
            # composed on the host, all dispatched async
            radiance, segments, ok = integrator.path_trace_static(
                scene, o, d, uids, rng_key,
                path_depth=camera.path_depth,
                max_trace_dist=camera.max_trace_dist, widths=widths,
                sort_rays=opts.sort,
            )
            staged_state["oks"].append((ok, n))
    else:
        radiance, segments = integrator.path_trace_shrink(
            scene, o, d, uids, rng_key, camera.path_depth,
            camera.max_trace_dist, sort_rays=opts.sort,
        )
    rad_sum = _pixel_sum(radiance, n_px, spp * n_chains) / n_chains
    return rad_sum, segments


# Device-side accumulate: new buffer each call (no donation) so the
# previous value stays valid — the retry path replays onto the last
# known-good snapshot after an async device error.
_accum_add = jax.jit(lambda a, b: a + b)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _finalize_image(pieces, n_px, spp, gamma, interleave=False):
    """On-device epilogue: mean + channel-bleed + gamma + u8 quantize.
    Only the quantized image crosses the device→host link (786 KB at
    512² vs 3 MB f32). Module-level jit: cached across renders.
    interleave: pieces hold strided pixel chunks (piece[ci][j] = pixel
    ci + nc*j) — de-interleave is a transpose; ragged-tail padding
    lands past n_px and the slice drops it."""
    if interleave:
        full = jnp.stack(pieces).transpose(1, 0, 2).reshape(-1, 3)
    else:
        full = jnp.concatenate(pieces, axis=0)
    mean = full[:n_px] / jnp.float32(max(spp, 1))
    return tonemap_ops.tonemap(mean, gamma)


def _dispatch_with_retry(dispatch, args, retries: int = 2):
    """Failure detection + recovery (SURVEY.md §5): chunks are stateless,
    so a transient device error (a lost device, an infra hiccup) is
    recovered by simply re-running the chunk — synchronously, so the
    result is validated before it re-enters the accumulator."""
    for attempt in range(retries + 1):
        try:
            rad_sum, segs = dispatch(*args)
            return jax.block_until_ready(rad_sum), segs
        except jax.errors.JaxRuntimeError as e:
            if attempt == retries:
                raise
            print(
                f"\n[render] device error ({type(e).__name__}); retrying chunk "
                f"({attempt + 1}/{retries})"
            )
            time.sleep(1.0 + attempt)


def render_to_image(
    scene: Scene,
    seed: int = 0,
    pixel_chunk: Optional[int] = None,
    spp_chunk: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    verbose: bool = True,
    scene_data: Optional[SceneData] = None,
    mesh=None,
    sync_every: int = 8,
    staged: Optional[StagedOptions] = None,
) -> tuple[np.ndarray, RenderStats]:
    """Full render: returns ((H, W, 3) uint8 image, RenderStats).

    Equivalent surface to Scene::render_to_image (tracing.rs:221-263):
    generate AA rays per pixel, shade by camera.shading_mode, average,
    channel-bleed + gamma + quantize.

    checkpoint_path: if set, the running HDR accumulator is persisted
    after every spp chunk and restored on restart, making long renders
    resumable and previewable.

    mesh: a jax.sharding.Mesh with ("dp", "sp") axes → every chunk runs
    the shard_map'ed renderer (parallel.sharding) over it; pixels shard
    across "dp", samples across "sp". Same chunk loop, checkpointing,
    retry, and progress as single-device — and bit-identical output
    (content-keyed RNG; tested on the 8-virtual-device CPU mesh).

    sync_every: pixel chunks dispatched between device sync points
    (error detection + progress). Between syncs, dispatch is fully
    async — nothing crosses the device→host link.

    staged: run the staged executor tier with these options instead of
    path_trace (StagedOptions; not for Phong shading). Bit-identical
    images either way.
    """
    cam = scene.camera
    w, h = cam.screen_width, cam.screen_height
    n_px_total = w * h
    spp = cam.aa_sample_count
    n_chains = max(1, cam.path_samples)

    if scene_data is None:
        scene_data = scene.compile()

    # The Threefry counter identifies a ray by a 32-bit uid
    # (pixel·spp·chains packing, _gen_chunk_rays); int32 wrap keeps the
    # patterns distinct up to 2^32 tuples, beyond which distinct rays
    # would share every draw (fully correlated paths — a silent quality
    # regression, not noise).
    total_uids = n_px_total * spp * n_chains
    if total_uids > 2**32:
        raise ValueError(
            f"{w}x{h} at {spp} spp x {n_chains} chains = {total_uids:.3g} "
            "rays, beyond the 2^32 distinct 32-bit RNG uids — rays would "
            "repeat each other's draws. Render in tiles (separate "
            "renders with different seeds) or reduce spp."
        )

    if cam.nee and cam.shading_mode is ShadingMode.PHONG:
        raise ValueError(
            "Camera(nee=True) has no effect under ShadingMode.PHONG — "
            "NEE is a path-tracer estimator and the Phong debug shader "
            "ignores it. Drop --nee or switch the scene to path shading."
        )
    if cam.nee and not scene_data.nee_ok:
        raise ValueError(
            "Camera(nee=True) needs every emissive object to be a "
            "standalone Triangle or Sphere (the sampled-light set, "
            "render/nee.py) — this scene has emissive planes/meshes/"
            "media or no lights at all, so NEE's emission suppression "
            "would be wrong. Render without --nee."
        )

    if pixel_chunk is None:
        # Budget per dispatch by WORK (ray-segments × primitive tests):
        # big enough to fill the card, small enough that one dispatch's
        # temporaries stay a few hundred MB. Sized against the spp
        # actually dispatched per chunk (spp_chunk). Measured on an H100
        # (700 W), main scene 512²·64 spp (tools/gpu_bringup.py budget):
        # 2^18-, 2^20- and 2^22-ray chunks run 45.2, 47.5 and 47.9 Mrays/s
        # with 58, 234 and 969 MB of temporaries; this budget lands that
        # scene on 2^20-ray chunks.
        eff_spp = min(spp, spp_chunk) if spp_chunk else spp
        per_px_rays = max(1, eff_spp * n_chains)
        prim_tests = (
            scene_data.n_spheres
            + scene_data.n_planes
            + scene_data.n_tris
            + scene_data.n_volumes
            + sum(int(g.shape[0]) for g in scene_data.gvol_tri)
            + sum(int(m.tri_verts.shape[0]) for m in scene_data.meshes)
        )
        work_per_px = per_px_rays * max(1, cam.path_depth) * max(16, prim_tests)
        budget = 1 << 36
        pixel_chunk = max(1, min(n_px_total, budget // work_per_px))
        # round down to a power of two: the chunk size sets the compiled
        # program's shape, and pow2 sizes collapse the (resolution, spp,
        # scene) space onto few distinct shapes — fewer compiles and more
        # persistent-cache hits. Output is bit-identical for any chunking
        # (content-keyed RNG).
        if pixel_chunk < n_px_total:
            pixel_chunk = 1 << (pixel_chunk.bit_length() - 1)
    if spp_chunk is None:
        spp_chunk = spp
    spp_chunk = min(spp_chunk, spp)

    rng_key = threefry.key_words(seed)
    if cam.shading_mode is ShadingMode.PHONG:
        staged = None
    staged_state = None
    if staged is not None:
        staged_state = {
            "widths": {}, "oks": [], "margin": staged.margin, "opts": staged,
        }
    # Multi-process handling (global arrays, per-host gathers) only
    # applies when rendering over a device mesh; a plain mesh-less call
    # from a multi-process job renders its full local image with
    # ordinary per-process arrays, and gathering those would duplicate
    # every row process_count times.
    multiproc = jax.process_count() > 1 and mesh is not None

    if mesh is not None:
        from cs397raytracingsp22.parallel import sharding as _sharding

        n_dp = int(mesh.shape["dp"])
        n_sp = int(mesh.shape["sp"])
        # chunk shapes must tile the mesh axes
        pixel_chunk = max(n_dp, pixel_chunk - pixel_chunk % n_dp)
        if spp_chunk % n_sp:
            spp_chunk = min(spp, spp_chunk + (n_sp - spp_chunk % n_sp))
        if spp % n_sp:
            # ValueError, not assert: user input, and python -O strips
            # asserts (samples would silently floor-drop)
            raise ValueError(
                f"spp {spp} not divisible by the mesh's sp axis {n_sp}"
            )
        if multiproc:
            # multi-host: jit over a global mesh requires global arrays —
            # replicate the (identical-everywhere) scene + key once, and
            # shard each chunk's pixel ids over "dp" so every process
            # donates only its addressable slice
            from cs397raytracingsp22.parallel import multihost as _mh

            scene_data = _mh.replicate_to_global(mesh, scene_data)
            rng_key = _mh.replicate_to_global(mesh, rng_key)
        _sharded_fns: dict = {}

        def _plain_dispatch(ids_dev, s0_dev, s_count):
            fn = _sharded_fns.get(s_count)
            if fn is None:
                fn = _sharding.make_sharded_render_chunk(
                    mesh, cam, s_count, n_chains
                )
                _sharded_fns[s_count] = fn
            return fn(scene_data, ids_dev, rng_key, s0_dev)

        # The staged tier runs its static-width executor inside
        # shard_map, composed per device: local width schedule, zero
        # extra collectives beyond the plain path's psum.
        # Host-orchestrated shrink can't run inside shard_map
        # (per-bounce int() syncs), so the sharded tier is static-only:
        # measure at full width (one chunk, collect_live pmax'ed over
        # devices), bake a LOCAL schedule, then one fused program per
        # chunk. NEE keeps the traceable path_trace_nee in
        # render_chunk_core; multi-host keeps the plain path (the
        # measure sync would have to agree across processes).
        if staged is not None and (cam.nee or multiproc or not staged.static):
            staged_state = None
        if staged_state is not None:
            _staged_fns: dict = {}

            def _staged_fn(s_count, widths_l):
                fn = _staged_fns.get((s_count, widths_l))
                if fn is None:
                    fn = _sharding.make_sharded_staged_render_chunk(
                        mesh, cam, s_count, n_chains, widths_l,
                        sort_rays=staged.sort,
                    )
                    _staged_fns[(s_count, widths_l)] = fn
                return fn

            def _dispatch(ids_dev, s0_dev, s_count):
                if staged_state.get("disabled", False):
                    # persistent schedule violations: the always-correct
                    # full-width sharded path finishes the render
                    return _plain_dispatch(ids_dev, s0_dev, s_count)
                n_local = (
                    (ids_dev.shape[0] // n_dp)
                    * (s_count // n_sp)
                    * n_chains
                )
                widths_l = staged_state["widths"].get(n_local)
                if widths_l is None:
                    rad, segs, live = _staged_fn(s_count, None)(
                        scene_data, ids_dev, rng_key, s0_dev
                    )
                    counts = [int(x) for x in np.asarray(live)]  # sync
                    _merge_live_schedule(
                        staged_state, n_local, counts, cam.path_depth
                    )
                    return rad, segs
                rad, segs, ok = _staged_fn(s_count, widths_l)(
                    scene_data, ids_dev, rng_key, s0_dev
                )
                staged_state["oks"].append((ok, n_local))
                return rad, segs

        else:
            _dispatch = _plain_dispatch

        if multiproc:
            from jax.sharding import PartitionSpec as _P

            def _make_args(ids, s0):
                return (
                    _mh.shard_to_global(mesh, ids, _P("dp")),
                    _mh.replicate_to_global(mesh, jnp.int32(s0)),
                )

        else:

            def _make_args(ids, s0):
                return (jnp.asarray(ids), jnp.int32(s0))

    else:
        # with cam.nee the staged executor runs the NEE twin
        # (path_trace_nee_shrink) — same shrink machinery
        if staged is not None:

            def _dispatch(ids_dev, s0_dev, s_count):
                # fused static-width program (first chunk measures the
                # live-count schedule; render_chunk_staged docstring);
                # bit-identical output
                return render_chunk_staged(
                    scene_data, cam, ids_dev, rng_key, s0_dev, s_count,
                    n_chains, staged_state=staged_state, opts=staged,
                )

        else:

            def _dispatch(ids_dev, s0_dev, s_count):
                # module-global lookup (not captured) so tests can
                # monkeypatch render_chunk for failure injection
                return render_chunk(
                    scene_data, cam, ids_dev, rng_key, s0_dev, s_count,
                    n_chains,
                )

        def _make_args(ids, s0):
            return (jnp.asarray(ids), jnp.int32(s0))

    # Single-host pixel ids are made on the device (one arange per
    # chunk), so nothing but two scalars crosses the host→device link
    # per dispatch (a 262k-pixel chunk's id upload would be 1 MB).
    # Multi-host keeps the host path: each process
    # donates its addressable slice of a host-built global array.
    #
    # Single-host chunks are INTERLEAVED (chunk ci = pixels ci, ci+nc,
    # ci+2nc, …): contiguous raster chunks have wildly different
    # per-bounce liveness (sky rows vs geometry), which made the staged
    # executor's measured width schedule a biased sample — every
    # record-setting chunk cost a shrink replay. Strided chunks are
    # statistical clones of the whole image, so one chunk's measure
    # holds for all (and compute per chunk is uniform). Radiance is
    # per-pixel content-keyed, so the partition cannot change the image
    # (chunking bit-invariance tests). De-interleave is a free
    # transpose: piece[ci][j] holds pixel ci + nc*j, so
    # stack(pieces).transpose(1,0,2).reshape(-1) is raster order, and
    # padded ids (>= n_px, from the ragged tail) land at positions
    # >= n_px where the finalize slice drops them. Multi-host keeps
    # raster chunks (the global-array donation path).
    interleave = not multiproc

    def _pull(x, dtype=None):
        """Device→host; gathers non-addressable shards on multi-host."""
        if multiproc:
            from cs397raytracingsp22.parallel import multihost as _mh

            a = _mh.gather_to_host(x)
        else:
            a = np.asarray(x)
        return a.astype(dtype) if dtype is not None else a

    if checkpoint_path and not checkpoint_path.endswith(".npz"):
        checkpoint_path = checkpoint_path + ".npz"

    spp_done = 0
    resume_accum = None
    ckpt_nee = -1  # -1 = unknown (pre-flag checkpoint)
    if checkpoint_path and multiproc:
        # only process 0 writes checkpoints (below); a host-local read
        # on the other processes would disagree on spp_done (no shared
        # FS ⇒ absent/stale file) and deadlock the global-mesh
        # collectives — process 0's view is broadcast instead
        from cs397raytracingsp22.parallel import multihost as _mh0

        resume_accum, spp_done, ckpt_nee = _mh0.broadcast_checkpoint(
            checkpoint_path, n_px_total, seed
        )
        if resume_accum is not None:
            if mesh is not None and spp_done % int(mesh.shape["sp"]):
                raise ValueError(
                    f"checkpoint at spp_done={spp_done} is not divisible"
                    f" by this mesh's sp axis ({int(mesh.shape['sp'])});"
                    " resume on the original device configuration or"
                    " finish the render without an sp axis"
                )
            if verbose:
                print(
                    f"[render] resuming from {checkpoint_path} at "
                    f"{spp_done} spp"
                )
    elif checkpoint_path and os.path.exists(checkpoint_path):
        ckpt = np.load(checkpoint_path, allow_pickle=False)
        if ckpt["accum"].shape == (n_px_total, 3) and int(ckpt["seed"]) == seed:
            resume_accum = ckpt["accum"].astype(np.float32)
            spp_done = int(ckpt["spp_done"])
            if "nee" in ckpt.files:
                ckpt_nee = int(ckpt["nee"])
            if mesh is not None and spp_done % int(mesh.shape["sp"]):
                # every sharded dispatch splits its spp over the sp axis,
                # so the remaining spp - spp_done must be coverable by
                # sp-divisible chunks; a checkpoint written on a device
                # config with a different sp alignment can't be
                raise ValueError(
                    f"checkpoint at spp_done={spp_done} is not divisible"
                    f" by this mesh's sp axis ({int(mesh.shape['sp'])});"
                    " resume on the original device configuration or"
                    " finish the render without an sp axis"
                )
            if verbose:
                print(f"[render] resuming from {checkpoint_path} at {spp_done} spp")

    if resume_accum is not None:
        # an accumulator holding MORE samples than the target cannot be
        # finalized (the divide-by-spp would over-brighten 2x silently),
        # and mixing estimators blends two different integrals
        if spp_done > spp:
            raise ValueError(
                f"checkpoint holds {spp_done} spp but this render asks "
                f"for {spp} — raise --spp (a resume can only extend a "
                "render) or delete the checkpoint"
            )
        if ckpt_nee >= 0 and bool(ckpt_nee) != bool(cam.nee):
            raise ValueError(
                f"checkpoint was rendered with nee={bool(ckpt_nee)} but "
                f"this render has nee={bool(cam.nee)} — the accumulator "
                "would blend two different estimators; match --nee or "
                "delete the checkpoint"
            )

    stats = RenderStats(
        width=w,
        height=h,
        spp=spp,
        path_depth=cam.path_depth,
        device_count=int(mesh.devices.size) if mesh is not None else 1,
    )

    all_pixel_ids = np.arange(n_px_total, dtype=np.int32)
    n_pixel_chunks = (n_px_total + pixel_chunk - 1) // pixel_chunk

    # Device-resident accumulator: one (pixel_chunk, 3) f32 piece per
    # pixel chunk. Ragged-tail padding rows are duplicate pixel 0 under
    # multi-host raster chunking and out-of-range ids (>= n_px_total,
    # traced as off-screen rays) under the interleave; either way their
    # contributions land at positions the finalize/checkpoint slice
    # drops. Chunk dispatch + accumulation is fully async; sync() is
    # the only place the host waits.
    pieces: list = [None] * n_pixel_chunks
    if resume_accum is not None:
        for ci in range(n_pixel_chunks):
            if interleave:
                # checkpoints are raster order; re-split into this run's
                # strided chunks (layout-independent resume)
                part = resume_accum[ci::n_pixel_chunks]
            else:
                part = resume_accum[ci * pixel_chunk : (ci + 1) * pixel_chunk]
            if part.shape[0] < pixel_chunk:
                part = np.concatenate(
                    [part, np.zeros((pixel_chunk - part.shape[0], 3), np.float32)]
                )
            if mesh is not None and multiproc:
                from jax.sharding import PartitionSpec as _PP

                from cs397raytracingsp22.parallel import multihost as _mh2

                pieces[ci] = _mh2.shard_to_global(mesh, part, _PP("dp"))
            else:
                pieces[ci] = jnp.asarray(part)

    t_start = time.perf_counter()
    first_chunk_done = False
    seg_total = None  # device f32 scalar, chained adds
    # known-good snapshot for async-failure replay
    good_pieces = list(pieces)
    seg_good = None
    pending: list = []  # (ci, args) dispatched since the last sync
    since_sync = 0
    last_sync = None
    window_primary = 0
    seg_at_last = 0.0
    chunks_done = 0
    n_spp_chunks = max(1, -(-(spp - spp_done) // spp_chunk))
    total_chunks = n_spp_chunks * n_pixel_chunks

    def _replay_pending():
        """Rebuild the accumulator from the last known-good snapshot by
        re-running every pending chunk synchronously."""
        nonlocal pieces, seg_total
        pieces = list(good_pieces)
        seg_total = seg_good
        for ci, args in pending:
            rad, segs = _dispatch_with_retry(_dispatch, args)
            pieces[ci] = (
                rad if pieces[ci] is None else _accum_add(pieces[ci], rad)
            )
            seg_total = (
                segs if seg_total is None else _accum_add(seg_total, segs)
            )
        jax.block_until_ready([p for p in pieces if p is not None])

    def sync():
        """Wait for everything dispatched so far; on an async device
        error, replay the chunks since the last known-good snapshot
        synchronously (SURVEY §5 failure recovery). The staged static-
        width executor's schedule-violation flags are checked here too —
        a violated chunk's radiance is invalid, so the same snapshot-
        replay rebuilds the window (with a widened schedule)."""
        nonlocal pieces, good_pieces, seg_total, seg_good, pending
        nonlocal since_sync, first_chunk_done, last_sync
        nonlocal window_primary, seg_at_last
        if not pending:
            return
        try:
            wait = [pieces[ci] for ci, _ in pending]
            if seg_total is not None:
                wait.append(seg_total)
            jax.block_until_ready(wait)
        except jax.errors.JaxRuntimeError:
            if multiproc:
                # the replay below re-runs global-mesh collectives; if
                # only SOME processes saw the error, replaying here
                # desynchronizes the global dispatch schedule and hangs.
                # Multi-host recovery is restart-from-checkpoint (chunks
                # are stateless; the checkpoint is authoritative).
                raise
            _replay_pending()
        while staged_state is not None and staged_state["oks"]:
            oks = staged_state["oks"]
            staged_state["oks"] = []
            bad_shapes = {n for okv, n in oks if not bool(okv)}
            if not bad_shapes:
                break
            # schedule undershot for these ray counts: drop the
            # schedules — the replay routes the FIRST pending chunk of
            # each bad shape through the measure branch, which
            # max-merges its live counts into the schedule
            # (_merge_live_schedule). Under the default interleaved
            # chunking every chunk of a shape is a statistical clone of
            # the image, so the first-replayed chunk's counts cover the
            # violator too; if they don't (raster chunking, unlucky
            # tail), the violation recurs, grew=False, and the margin
            # doubling below converges it.
            # Margin doubling is the backstop for violations that recur
            # WITHOUT live-max growth (only possible with margin < 1,
            # e.g. test-forced): past opts.max_margin the static
            # executor is disabled for this render and the replay runs
            # the always-correct shrink executor instead.
            if any(
                not staged_state.get("grew", {}).get(n_bad, False)
                for n_bad in bad_shapes
            ):
                staged_state["margin"] *= 2.0
            if staged_state["margin"] > staged_state["opts"].max_margin:
                staged_state["disabled"] = True
                if verbose:
                    print(
                        "\n[render] static width schedule keeps "
                        "undershooting; falling back to the always-"
                        "correct executor for this render (shrink "
                        "single-device, full-width sharded)"
                    )
            for n_bad in bad_shapes:
                staged_state["widths"].pop(n_bad, None)
            if verbose and not staged_state.get("disabled", False):
                print(
                    "\n[render] static width schedule undershot; "
                    f"remeasuring with margin {staged_state['margin']}"
                )
            _replay_pending()
        now = time.perf_counter()
        segs_now = float(seg_total) if seg_total is not None else 0.0
        if not first_chunk_done:
            stats.compile_seconds = now - t_start
            first_chunk_done = True
        else:
            # sync-to-sync deltas: dispatches overlap, so per-chunk
            # timing would double-count wall time
            stats.steady_seconds += now - last_sync
            stats.steady_segments += segs_now - seg_at_last
            stats.steady_primary += window_primary
        last_sync = now
        seg_at_last = segs_now
        window_primary = 0
        good_pieces = list(pieces)
        seg_good = seg_total
        pending = []
        since_sync = 0
        if verbose:
            # progress with elapsed/ETA (the reference's indicatif bar,
            # tracing.rs:223-224)
            done_frac = min(1.0, max(1e-9, chunks_done / total_chunks))
            elapsed = now - t_start
            eta = elapsed / done_frac - elapsed
            print(
                f"\r[render] chunk {chunks_done}/{total_chunks} "
                f"({100 * done_frac:.0f}%, elapsed {elapsed:.1f}s, "
                f"eta {eta:.1f}s)",
                end="",
                flush=True,
            )

    for s0 in range(spp_done, spp, spp_chunk):
        s_count = min(spp_chunk, spp - s0)
        for ci in range(n_pixel_chunks):
            if interleave:
                # chunk ci = pixels ci, ci+nc, … (see the interleave
                # comment above); ids >= n_px are ragged-tail padding
                # whose contributions the finalize slice drops
                n_valid = -(-(n_px_total - ci) // n_pixel_chunks)
                ids = (
                    jnp.arange(pixel_chunk, dtype=jnp.int32)
                    * jnp.int32(n_pixel_chunks)
                    + jnp.int32(ci)
                )
                args = (ids, jnp.int32(s0), s_count)
            else:
                lo = ci * pixel_chunk
                n_valid = min(pixel_chunk, n_px_total - lo)
                ids = all_pixel_ids[lo : lo + n_valid]
                if n_valid < pixel_chunk:
                    ids = np.concatenate(
                        [ids, np.zeros(pixel_chunk - n_valid, np.int32)]
                    )
                args = (*_make_args(ids, s0), s_count)
            try:
                rad, segs = _dispatch(*args)
            except jax.errors.JaxRuntimeError:
                rad, segs = _dispatch_with_retry(_dispatch, args)
            pieces[ci] = (
                rad if pieces[ci] is None else _accum_add(pieces[ci], rad)
            )
            seg_total = (
                segs if seg_total is None else _accum_add(seg_total, segs)
            )
            pending.append((ci, args))
            window_primary += n_valid * s_count * n_chains
            since_sync += 1
            chunks_done += 1
            if not first_chunk_done or since_sync >= sync_every:
                sync()
        if checkpoint_path:
            # the accumulator must be complete for this spp chunk before
            # it is persisted (one f64 host pull per checkpoint)
            sync()
            host_pieces = [_pull(p, np.float64) for p in pieces]
            if interleave:
                # de-interleave to raster order: checkpoints stay
                # layout-independent (resume re-splits for the resuming
                # run's own chunking)
                host = (
                    np.stack(host_pieces)
                    .transpose(1, 0, 2)
                    .reshape(-1, 3)[:n_px_total]
                )
            else:
                host = np.concatenate(host_pieces)[:n_px_total]
            if jax.process_index() == 0:
                np.savez(
                    checkpoint_path,
                    accum=host,
                    spp_done=np.int64(s0 + s_count),
                    seed=np.int64(seed),
                    # estimator identity: resuming with a different --nee
                    # would blend two estimators into one accumulator
                    nee=np.int64(int(bool(cam.nee))),
                )
            # don't charge the checkpoint pull+write (host I/O between
            # spp chunks) to the next chunk's steady-state window
            last_sync = time.perf_counter()
    sync()
    if verbose:
        print()

    stats.primary_rays = n_px_total * (spp - spp_done) * n_chains
    stats.path_segments = (
        float(seg_total) if seg_total is not None else 0.0
    )

    img = _pull(
        _finalize_image(tuple(pieces), n_px_total, spp, cam.gamma, interleave)
    ).reshape(h, w, 3)
    stats.wall_seconds = time.perf_counter() - t_start
    if verbose:
        print("[render] " + stats.summary())
    return img, stats


def save_png(img: np.ndarray, path: str) -> None:
    """Write an (H, W, 3) uint8 image as PNG (reference tracing.rs:546)."""
    from cs397raytracingsp22.utils.png import write_png

    write_png(path, img)


def render_and_save(scene: Scene, path: str = "render.png", **kw):
    img, stats = render_to_image(scene, **kw)
    save_png(img, path)
    return img, stats
