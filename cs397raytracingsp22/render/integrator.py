"""Light-transport integrators over ray megabatches.

The reference's recursive `shade_ray` (tracing.rs:300-324) becomes an
iterative wavefront: a `lax.fori_loop` over bounce depth carrying
(origin, direction, throughput, radiance, alive) SoA buffers for the whole
batch. With path_samples=1 the recursion is a linear chain, so the loop
computes exactly the same estimator:

    radiance = Σ_k  (Π_{j<k} dot_j·brdf_j/pdf_j) · emission_k

with the depth cutoff returning the background (black) — i.e. rays still
alive after `path_depth` bounces contribute nothing further, and misses
add background·throughput then die.

path_samples > 1 (branching at every recursion level, tracing.rs:310-318)
is supported by chain replication in the driver: each camera ray spawns
`path_samples` independent linear chains, which has the same expectation
as the reference's branching tree (Monte-Carlo estimators differ only in
variance allocation). The reference itself documents values > 1 as
unnecessary (tracing.rs:146).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cs397raytracingsp22.models.scene import SceneData
from cs397raytracingsp22.ops import bsdf
from cs397raytracingsp22.ops.intersect import intersect_scene
from cs397raytracingsp22.utils import rng as rnglib
from cs397raytracingsp22.utils import sampling
from cs397raytracingsp22.utils import threefry
from cs397raytracingsp22.utils import vecmath as vm

# Path-trace ray epsilon (tracing.rs:305) and phong shadow offset
# (tracing.rs:289).
PATH_T_MIN = 0.001
PHONG_SHADOW_OFFSET = 0.01


def background_color(d: jnp.ndarray) -> jnp.ndarray:
    """Black void (tracing.rs:266-274)."""
    return jnp.zeros(d.shape[:-1] + (3,), jnp.float32)


def _bounce_draws(scene: SceneData, rng_key, uids: jnp.ndarray, site):
    """Per-ray draws for one bounce: ball vector, branch uniform, volume
    uniforms — all from the counter RNG (utils/threefry.py). Sphere-boundary
    volumes use draw slots 4..4+V, general-boundary volumes the G slots
    after (the counter RNG makes each slot independent, so adding gvol
    draws never shifts the sphere-vol draws)."""
    n_vol = scene.vol_center.shape[0]
    u = threefry.bounce_uniforms(
        rng_key, uids, site, 4 + n_vol + scene.n_gvols
    )
    ball = sampling.ball_vec_from_uniform(u[:, 0:3])
    return ball, u[:, 3], u[:, 4:]


# (position, direction) bits per axis of the coherence key; 3p + 3q
# must fit under the dead-ray bit (≤ 30). Not measured on a GPU.
KEY_BITS = (1, 6)


def _big_mesh_vis_bits(scene, o, d, max_bits):
    """Per-ray MISS mask over the big (BVH-traversed) meshes: bit i is
    set iff the ray's slab interval against big mesh i's world-space
    root AABB is empty — the ray cannot hit that mesh. Used only as the
    TOP bits of the coherence key, so rays that miss a mesh pack
    together. Pure sort heuristic — any permutation is
    radiance-bit-identical (content-keyed RNG), so FP edge cases here
    (0·inf NaNs on boundary-origin axis-parallel rays → conservative
    false miss) cannot affect the image. Returns None when the scene
    has no big meshes or no key headroom."""
    big = [
        i for i in range(len(scene.meshes))
        if i not in scene.dense_mesh_ids
    ][:max_bits]
    if not big:
        return None, 0
    inv = 1.0 / d
    sel = jnp.asarray(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        jnp.float32,
    )
    vis = jnp.zeros(o.shape[:1], jnp.int32)
    for bi, mi in enumerate(big):
        m = scene.meshes[mi]
        # world AABB of the transformed object-space root AABB
        # (conservative superset of the mesh)
        c_obj = m.bounds_min[0] * (1.0 - sel) + m.bounds_max[0] * sel
        c_w = c_obj @ m.transform[:3, :3].T + m.transform[:3, 3]
        lo = jnp.min(c_w, axis=0)
        hi = jnp.max(c_w, axis=0)
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        near = jnp.max(jnp.minimum(t0, t1), axis=1)
        far = jnp.min(jnp.maximum(t0, t1), axis=1)
        miss = ~((far >= jnp.maximum(near, 0.0)) & (far >= 0.0))
        vis = vis | (miss.astype(jnp.int32) << bi)
    return vis, len(big)


def _coherence_key(o, d, alive, scene=None):
    """Sort key: dead rays last, then (for big-mesh scenes) which big
    meshes the ray can possibly hit (_big_mesh_vis_bits), then a
    POSITION-MAJOR Morton — p bits per axis of Morton-interleaved
    origin cell (over the batch's own bounding box), then q bits per
    axis of direction ((p, q) = KEY_BITS): blocks first share an origin
    region, direction fine-sorts within the cell. Without `scene` the
    key has no big-mesh bits. The content-keyed RNG (uids
    travel with the rays) makes any permutation produce bit-identical
    radiance."""
    pbits, qbits = KEY_BITS
    dn = d * jax.lax.rsqrt(vm.magnitude2(d) + 1e-30)[:, None]
    qd = jnp.clip(
        ((dn + 1.0) * (2.0 ** (qbits - 1) - 1e-3)).astype(jnp.int32),
        0, (1 << qbits) - 1,
    )
    lo = jnp.min(o, axis=0)
    hi = jnp.max(o, axis=0)
    qp = jnp.clip(
        ((o - lo) / jnp.maximum(hi - lo, 1e-6) * ((1 << pbits) - 1e-3))
        .astype(jnp.int32),
        0, (1 << pbits) - 1,
    )
    dmort = jnp.zeros(d.shape[:1], jnp.int32)
    for i in range(qbits):
        for a in range(3):
            dmort = dmort | (((qd[:, a] >> i) & 1) << (3 * i + a))
    pmort = jnp.zeros(o.shape[:1], jnp.int32)
    for i in range(pbits):
        for a in range(3):
            pmort = pmort | (((qp[:, a] >> i) & 1) << (3 * i + (2 - a)))
    key = pmort << (3 * qbits) | dmort
    if scene is not None:
        vis, _ = _big_mesh_vis_bits(
            scene, o, d, max_bits=30 - 3 * (pbits + qbits)
        )
        if vis is not None:
            key = key | vis << (3 * (pbits + qbits))
    return (~alive).astype(jnp.int32) << 30 | key


def _sort_state(o, d, thr, rad, uids, pos, alive, extra_i=None,
                scene=None, apply=None):
    """Coherence sort of the full wavefront state (dead rays last, then
    the position-major Morton key): the ONE reordering primitive every
    executor shares — XLA scatter compaction measured 13.8× slower, so
    sorting is the only reordering used. The content-keyed RNG (uids
    travel with the rays) makes any permutation produce bit-identical
    radiance.

    extra_i: optional (N,) int32 rider permuted with the state (the NEE
    executors carry their emission-suppression flag this way); returned
    as the last element when given.

    apply: how the permutation is applied — one 16-operand lax.sort that
    carries the payload ("sort"), or a key+iota sort followed by two
    row gathers ("take"); None picks "sort" from 2^20 rows up (a
    crossover not measured on a GPU). Both apply the SAME permutation
    (lax.sort is stable, iota breaks ties identically) → bit-identical
    images."""
    key = _coherence_key(o, d, alive, scene=scene)
    if apply is None:
        apply = "sort" if key.shape[0] >= (1 << 20) else "take"
    if apply == "take":
        n = key.shape[0]
        _, perm = jax.lax.sort(
            [key, jnp.arange(n, dtype=jnp.int32)], num_keys=1
        )
        fmat = jnp.take(
            jnp.concatenate([o, d, thr, rad], axis=1), perm, axis=0
        )
        icols = [
            jax.lax.bitcast_convert_type(uids, jnp.int32),
            pos,
            alive.astype(jnp.int32),
        ]
        if extra_i is not None:
            icols.append(extra_i)
        imat = jnp.take(jnp.stack(icols, axis=-1), perm, axis=0)
        base = (
            fmat[:, 0:3],
            fmat[:, 3:6],
            fmat[:, 6:9],
            fmat[:, 9:12],
            jax.lax.bitcast_convert_type(imat[:, 0], uids.dtype),
            imat[:, 1],
            imat[:, 2] > 0,
        )
        if extra_i is None:
            return base
        return base + (imat[:, 3],)
    ops = [key, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
           thr[:, 0], thr[:, 1], thr[:, 2],
           rad[:, 0], rad[:, 1], rad[:, 2],
           uids, pos, alive.astype(jnp.int32)]
    if extra_i is not None:
        ops.append(extra_i)
    out = jax.lax.sort(ops, num_keys=1)
    (_, ox_, oy_, oz_, dx_, dy_, dz_, tr_, tg_, tb_,
     rr_, rg_, rb_, uid_, pos_, al_) = out[:16]
    base = (
        jnp.stack([ox_, oy_, oz_], axis=-1),
        jnp.stack([dx_, dy_, dz_], axis=-1),
        jnp.stack([tr_, tg_, tb_], axis=-1),
        jnp.stack([rr_, rg_, rb_], axis=-1),
        uid_,
        pos_,
        al_ > 0,
    )
    if extra_i is None:
        return base
    return base + (out[16],)


# Jitted twins for the HOST-ORCHESTRATED executors' entry sort and
# closing unsort: inside a jitted program the whole sort+apply is one
# dispatch instead of ~10 eager ones. Bit-identical by construction
# (same ops).
_sort_state_jit = jax.jit(_sort_state, static_argnames=("apply",))

import functools as _functools


@_functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _truncate_retire(state, w, pos_idx, rad_idx, alive_idx):
    """Truncate the wavefront state tuple to width w, returning the
    retired (pos, rad) tail and whether any clipped row was still
    ALIVE (the static schedule's violation flag) — as ONE device
    program instead of ~10 eager slice dispatches."""
    clipped = jnp.any(state[alive_idx][w:])
    return (tuple(x[:w] for x in state), state[pos_idx][w:],
            state[rad_idx][w:], clipped)


@jax.jit
def _finish_unsort(pos_parts, rad_parts, segs_parts, clip_flags):
    """Closing epilogue of the host-orchestrated executors as ONE
    device program: reassemble retired pieces, restore caller order
    (pos-keyed sort), sum the per-bounce segment counts, and combine
    the truncation violation flags (ok=True when clip_flags is
    empty — the shrink executors never clip live rays)."""
    pos_all = jnp.concatenate(list(pos_parts))
    rad_all = jnp.concatenate(list(rad_parts))
    _, rr, rg, rb = jax.lax.sort(
        [pos_all, rad_all[:, 0], rad_all[:, 1], rad_all[:, 2]],
        num_keys=1,
    )
    segments = jnp.sum(jnp.stack(list(segs_parts)))
    if clip_flags:
        ok = ~jnp.any(jnp.stack(list(clip_flags)))
    else:
        ok = jnp.asarray(True)
    return jnp.stack([rr, rg, rb], axis=-1), segments, ok


def _bounce_update(scene, o, d, thr, rad, alive, uids, rng_key, site,
                   max_trace_dist):
    """The estimator body for ONE bounce (tracing.rs:300-324), shared
    verbatim by every executor (path_trace's fori body, the shrink
    executor's staged step) so their bit-identity contract is enforced
    by construction rather than by parallel edits. Returns the updated
    (o, d, thr, rad, live_hit, segs-this-bounce)."""
    ball, u_choice, u_vol = _bounce_draws(scene, rng_key, uids, site)
    # dead rays get an empty [t_min, 0] window: every primitive test
    # rejects, and BVH traversal of a dead ray ends at the root box.
    t_max = jnp.where(alive, jnp.float32(max_trace_dist), 0.0)
    hit = intersect_scene(scene, o, d, PATH_T_MIN, t_max, u_vol)

    live_hit = alive & hit.valid
    live_miss = alive & ~hit.valid

    # Miss: background·throughput, then die (tracing.rs:306).
    rad = rad + jnp.where(live_miss[:, None], thr * background_color(d), 0.0)

    # Hit: emission + scatter (tracing.rs:307-322).
    new_dir, att, inv_pdf = bsdf.scatter(hit, d, ball, u_choice)
    # dot_term: |new_dir · n| clamped to [0,1]; forced to 1 for
    # zero-normal volume hits (tracing.rs:313).
    has_normal = vm.magnitude2(hit.normal) > 0.0
    dot_term = jnp.where(
        has_normal,
        jnp.clip(jnp.abs(jnp.sum(new_dir * hit.normal, axis=-1)), 0.0, 1.0),
        1.0,
    )
    factor = (dot_term * inv_pdf)[:, None] * att

    rad = rad + jnp.where(live_hit[:, None], thr * hit.emission, 0.0)
    thr = jnp.where(live_hit[:, None], thr * factor, thr)
    o = jnp.where(live_hit[:, None], hit.point, o)
    d = jnp.where(live_hit[:, None], new_dir, d)
    segs = jnp.sum(alive.astype(jnp.float32))
    return o, d, thr, rad, live_hit, segs


def path_trace(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    uids: jnp.ndarray,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    sort_rays: bool = False,
):
    """Trace N ray chains to completion.

    Args:
      o, d: (N, 3) primary rays.
      uids: (N,) int32 global chain ids (content-derived RNG counters).
      rng_key: int seed or (2,) uint32 key words.
      path_depth: bounce budget (static loop bound).
      max_trace_dist: scene far limit.
      sort_rays: sort ray state by a coherence Morton key between bounces.
        Off by default: on an H100 (400 W) it left the big-mesh scene at
        512²·32 spp unchanged (2.785 s warm with, 2.745 and 2.852 s
        without — tools/gpu_bringup.py executors). Bit-identical output
        either way.

    Returns:
      (radiance, segments): (N, 3) estimated radiance per chain and the
      total number of path segments actually traced (for Mrays/s metrics).
    """
    n = o.shape[0]
    init = (
        o,
        d,
        jnp.ones((n, 3), jnp.float32),  # throughput
        jnp.zeros((n, 3), jnp.float32),  # radiance
        jnp.ones((n,), bool),  # alive
        uids,
        jnp.arange(n, dtype=jnp.int32),  # caller position (for unsort)
        # float accumulator: segment counts exceed int32 range on big
        # renders and x64 is disabled.
        jnp.zeros((), jnp.float32),
    )

    def bounce(depth, state):
        o, d, thr, rad, alive, uids, pos, segs = state
        if sort_rays:
            o, d, thr, rad, uids, pos, alive = _sort_state(
                o, d, thr, rad, uids, pos, alive, scene=scene
            )
        o, d, thr, rad, live_hit, segs_b = _bounce_update(
            scene, o, d, thr, rad, alive, uids, rng_key,
            rnglib.SITE_BOUNCE0 + depth, max_trace_dist,
        )
        return o, d, thr, rad, live_hit, uids, pos, segs + segs_b

    _, _, _, radiance, _, _, out_pos, segments = jax.lax.fori_loop(
        0, path_depth, bounce, init
    )
    if sort_rays:
        # restore caller order: one final sort by the carried position
        # index undoes every per-bounce permutation
        _, rr, rg, rb = jax.lax.sort(
            [out_pos, radiance[:, 0], radiance[:, 1], radiance[:, 2]],
            num_keys=1,
        )
        radiance = jnp.stack([rr, rg, rb], axis=-1)
    return radiance, segments


def _nee_bounce_update(
    scene, o, d, thr, rad, alive, prev_nee, uids, rng_key, depth,
    max_trace_dist, do_nee,
):
    """One NEE-estimator bounce (shared by path_trace_nee and
    path_trace_nee_shrink exactly as _bounce_update is shared by the
    plain executors). Deliberately separate from `_bounce_update` — that
    helper is the reference-parity contract, and the NEE estimator
    differs (emission suppression, direct-light term, gated last
    bounce). The indirect chain uses the SAME draw sites as path_trace,
    so turning NEE on changes only the estimator, not the sampled paths.

    `depth` may be a traced scalar (it only feeds RNG sites); `do_nee`
    must be static — the caller passes False for the LAST bounce, which
    keeps the expectation identical to the depth-limited plain estimator
    (an NEE term at depth k equals emission at a depth-(k+1) vertex —
    nee.py module doc).

    Returns (o, d, thr, rad, live_hit, prev_nee, segs-this-bounce)."""
    from cs397raytracingsp22.render import nee as neelib

    site = rnglib.SITE_BOUNCE0 + depth
    ball, u_choice, u_vol = _bounce_draws(scene, rng_key, uids, site)
    t_max = jnp.where(alive, jnp.float32(max_trace_dist), 0.0)
    hit = intersect_scene(scene, o, d, PATH_T_MIN, t_max, u_vol)

    live_hit = alive & hit.valid
    live_miss = alive & ~hit.valid
    rad = rad + jnp.where(live_miss[:, None], thr * background_color(d), 0.0)

    # emission, suppressed where the PREVIOUS vertex's NEE sample
    # already covered it (nee.py: everything a scatter ray hits first
    # is straight-line visible from its origin)
    emit_ok = live_hit & ~prev_nee
    rad = rad + jnp.where(emit_ok[:, None], thr * hit.emission, 0.0)

    new_dir, att, inv_pdf = bsdf.scatter(hit, d, ball, u_choice)
    has_normal = vm.magnitude2(hit.normal) > 0.0
    dot_term = jnp.where(
        has_normal,
        jnp.clip(jnp.abs(jnp.sum(new_dir * hit.normal, axis=-1)), 0.0, 1.0),
        1.0,
    )
    factor = (dot_term * inv_pdf)[:, None] * att

    if do_nee:
        contrib, did, shadow_segs = neelib.direct_light(
            scene, hit, d, u_choice, live_hit, uids, rng_key,
            depth, PATH_T_MIN, max_trace_dist,
        )
        rad = rad + jnp.where(live_hit[:, None], thr * contrib, 0.0)
        prev_nee = live_hit & did
    else:
        prev_nee = jnp.zeros(alive.shape, bool)
        shadow_segs = jnp.zeros((), jnp.float32)

    thr = jnp.where(live_hit[:, None], thr * factor, thr)
    o = jnp.where(live_hit[:, None], hit.point, o)
    d = jnp.where(live_hit[:, None], new_dir, d)
    # shadow rays are real traced segments (full scene sweep each):
    # count them so --nee stats-json Mrays/s stays honest
    segs = jnp.sum(alive.astype(jnp.float32)) + shadow_segs
    return o, d, thr, rad, live_hit, prev_nee, segs


def path_trace_nee(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    uids: jnp.ndarray,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    sort_rays: bool = False,
):
    """path_trace with next-event estimation (render/nee.py — opt-in,
    beyond the reference's by-chance light transport).

    Traceable (runs under render_chunk's jit and inside shard_map —
    the inner per-bounce jit inlines); bounces are a static Python loop
    so the last-bounce NEE gate compiles out. Each bounce goes through
    the SAME jitted `_nee_bounce_once` program the shrink twin
    dispatches — called eagerly, the three executors therefore run
    literally identical compiled code and produce bit-identical
    radiance (a Python op-by-op loop here measured 1-ulp off the jitted
    twin: XLA's algebraic simplifier, e.g. div(a,sqrt(b))→a·rsqrt(b),
    only fires inside fused programs). Big-mesh scenes get the same
    per-bounce coherence sort as path_trace (the suppression flag rides
    the sort as an extra operand); the host-orchestrated shrinking
    variant for the staged driver path is path_trace_nee_shrink.
    """
    assert scene.nee_ok, (
        "NEE requires every emissive object to be a standalone Triangle "
        "or Sphere (scene compiled with nee_ok=False)"
    )
    if isinstance(rng_key, int):
        rng_key = threefry.key_words(rng_key)
    n = o.shape[0]
    thr = jnp.ones((n, 3), jnp.float32)
    rad = jnp.zeros((n, 3), jnp.float32)
    alive = jnp.ones((n,), bool)
    prev_nee = jnp.zeros((n,), bool)
    pos = jnp.arange(n, dtype=jnp.int32)
    segments = jnp.zeros((), jnp.float32)

    if sort_rays:
        o, d, thr, rad, uids, pos, alive, pn = _sort_state(
            o, d, thr, rad, uids, pos, alive,
            extra_i=prev_nee.astype(jnp.int32), scene=scene,
        )
        prev_nee = pn > 0
    for depth in range(path_depth):
        (o, d, thr, rad, alive, prev_nee, uids, pos, segs, _) = (
            _nee_bounce_once(
                scene, o, d, thr, rad, alive, prev_nee, uids, pos,
                rng_key, jnp.int32(depth), max_trace_dist,
                do_nee=depth < path_depth - 1,
                sort_exit=sort_rays and depth < path_depth - 1,
            )
        )
        segments = segments + segs

    if sort_rays:
        _, rr, rg, rb = jax.lax.sort(
            [pos, rad[:, 0], rad[:, 1], rad[:, 2]], num_keys=1
        )
        rad = jnp.stack([rr, rg, rb], axis=-1)
    return rad, segments


def _nee_bounce_once_core(
    scene, o, d, thr, rad, alive, prev_nee, uids, pos, rng_key, depth,
    max_trace_dist, do_nee, sort_exit,
):
    """One staged NEE bounce + optional exit sort (the NEE twin of
    _bounce_once_core; `depth` is traced so all bounces of one width
    share a compile, `do_nee`/`sort_exit` are static)."""
    o, d, thr, rad, alive, prev_nee, segs = _nee_bounce_update(
        scene, o, d, thr, rad, alive, prev_nee, uids, rng_key, depth,
        max_trace_dist, do_nee,
    )
    if sort_exit:
        o, d, thr, rad, uids, pos, alive, pn = _sort_state(
            o, d, thr, rad, uids, pos, alive,
            extra_i=prev_nee.astype(jnp.int32), scene=scene,
        )
        prev_nee = pn > 0
    n_alive = jnp.sum(alive.astype(jnp.int32))
    return o, d, thr, rad, alive, prev_nee, uids, pos, segs, n_alive


_nee_bounce_once = jax.jit(
    _nee_bounce_once_core,
    static_argnames=("max_trace_dist", "do_nee", "sort_exit"),
)


def path_trace_nee_shrink(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    uids: jnp.ndarray,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    shrink_points: tuple = (1, 4),
    min_width: int = 4096,
    sort_rays: bool = False,
):
    """path_trace_nee with host-orchestrated per-bounce dispatch and the
    SHRINKING wavefront of path_trace_shrink (see its docstring for the
    bucket/retire mechanics — shared design, NEE estimator body). Used
    by the driver for --nee renders of textured/big-mesh scenes, where
    full-width dead-ray dispatches dominate; NOT traceable (host
    round-trips at shrink_points)."""
    assert scene.nee_ok, (
        "NEE requires every emissive object to be a standalone Triangle "
        "or Sphere (scene compiled with nee_ok=False)"
    )
    if isinstance(rng_key, int):
        rng_key = threefry.key_words(rng_key)
    n = o.shape[0]
    state = (
        o, d,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), bool),
        jnp.zeros((n,), bool),  # prev_nee
        uids,
        jnp.arange(n, dtype=jnp.int32),
    )
    if sort_rays:
        o_, d_, thr_, rad_, uids_, pos_, alive_, pn = _sort_state_jit(
            state[0], state[1], state[2], state[3], state[6], state[7],
            state[4], extra_i=state[5].astype(jnp.int32), scene=scene,
        )
        state = (o_, d_, thr_, rad_, alive_, pn > 0, uids_, pos_)

    retired: list = []
    segs_list: list = []
    width = n
    for b in range(path_depth):
        shrink_here = (
            b in shrink_points and b < path_depth - 1 and width > min_width
        )
        o_, d_, thr, rad, alive, prev, uids_, pos = state
        (o_, d_, thr, rad, alive, prev, uids_, pos, segs, n_alive) = (
            _nee_bounce_once(
                scene, o_, d_, thr, rad, alive, prev, uids_, pos, rng_key,
                jnp.int32(b), max_trace_dist,
                do_nee=b < path_depth - 1,
                # no exit sort after the last bounce (nothing follows
                # it) — keeps the dispatched programs identical to
                # path_trace_nee's, which is the bit-identity contract
                sort_exit=(sort_rays and b < path_depth - 1)
                or shrink_here,
            )
        )
        segs_list.append(segs)
        state = (o_, d_, thr, rad, alive, prev, uids_, pos)
        if shrink_here:
            count = int(n_alive)
            if count == 0:
                break
            new_w = width
            while new_w // 4 >= max(count, min_width):
                new_w //= 4
            if new_w < width:
                state, rpos, rrad, _ = _truncate_retire(
                    state, new_w, 7, 3, 4
                )
                retired.append((rpos, rrad))
                width = new_w

    pos_parts = [state[7]] + [p for p, _ in retired]
    rad_parts = [state[3]] + [r for _, r in retired]
    rad3, segments, _ = _finish_unsort(
        tuple(pos_parts), tuple(rad_parts), tuple(segs_list), ()
    )
    return rad3, segments


def _bounce_once_core(
    scene, o, d, thr, rad, alive, uids, pos, rng_key, site,
    max_trace_dist, sort_exit,
):
    """One staged bounce over the current wavefront + exit sort that
    parks dead rays at the tail (same estimator and RNG counters as
    path_trace's fori body — `_bounce_update` is literally shared — and
    the content-keyed RNG makes the exit-sorted order equivalent to
    path_trace's entry-sorted one)."""
    o, d, thr, rad, alive, segs = _bounce_update(
        scene, o, d, thr, rad, alive, uids, rng_key, site, max_trace_dist
    )
    if sort_exit:
        o, d, thr, rad, uids, pos, alive = _sort_state(
            o, d, thr, rad, uids, pos, alive, scene=scene
        )
    n_alive = jnp.sum(alive.astype(jnp.int32))
    return o, d, thr, rad, alive, uids, pos, segs, n_alive


_bounce_once = jax.jit(
    _bounce_once_core, static_argnames=("max_trace_dist", "sort_exit")
)


def path_trace_static(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    uids: jnp.ndarray,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    widths: tuple,
    collect_live: list | None = None,
    sort_rays: bool = False,
):
    """path_trace_shrink with a STATIC width schedule: the whole staged
    pipeline traces as ONE program — no alive-count round-trips to the
    host. The driver measures per-bounce live
    counts on a render's FIRST chunk (path_trace_shrink with
    collect_live) and bakes a width schedule for the rest; live counts
    are scene- and depth-stationary across chunks of one render, so the
    schedule holds with margin.

    widths: len == path_depth, nonincreasing, widths[0] == n, each a
    bound on the live count entering that bounce. Truncated tail rows
    are retired exactly like path_trace_shrink's buckets.

    collect_live: if a list, the post-bounce alive-count scalars are
    appended (traced values — fully traceable, unlike the shrink
    executor's host syncs). The sharded staged driver path measures its
    schedule this way: full-width schedule + collect_live inside
    shard_map, per-device counts pmax-combined by the caller.

    Returns (radiance, segments, ok): `ok` is False iff some truncation
    dropped a ray that was still ALIVE — the schedule was too tight for
    this chunk, the radiance is invalid, and the caller must re-run the
    chunk with path_trace_shrink (the driver folds this into its
    existing snapshot-replay recovery). When ok is True the output is
    bit-identical to path_trace/path_trace_shrink (content-keyed RNG;
    only dead rays were retired early).
    """
    n = o.shape[0]
    assert len(widths) == path_depth and widths[0] == n
    assert all(widths[i + 1] <= widths[i] for i in range(path_depth - 1))
    if isinstance(rng_key, int):
        rng_key = threefry.key_words(rng_key)
    state = (
        o, d,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), bool),
        uids,
        jnp.arange(n, dtype=jnp.int32),
    )
    if sort_rays:
        o_, d_, thr_, rad_, uids_, pos_, alive_ = _sort_state_jit(
            state[0], state[1], state[2], state[3],
            state[5], state[6], state[4], scene=scene,
        )
        state = (o_, d_, thr_, rad_, alive_, uids_, pos_)

    retired: list = []
    clip_flags: list = []
    segs_list: list = []
    width = n
    for b in range(path_depth):
        if widths[b] < width:
            # truncation correctness: the previous bounce's exit sort
            # parked dead rays at the tail, so a tail row that is still
            # alive means the schedule undershot — flagged by
            # _truncate_retire, combined in _finish_unsort
            state, rpos, rrad, clipped = _truncate_retire(
                state, widths[b], 6, 3, 4
            )
            clip_flags.append(clipped)
            retired.append((rpos, rrad))
            width = widths[b]
        o_, d_, thr, rad, alive, uids_, pos = state
        shrink_next = b + 1 < path_depth and widths[b + 1] < width
        (o_, d_, thr, rad, alive, uids_, pos, segs, n_alive) = _bounce_once(
            scene, o_, d_, thr, rad, alive, uids_, pos, rng_key,
            rnglib.SITE_BOUNCE0 + b, max_trace_dist,
            (sort_rays and b < path_depth - 1) or shrink_next,
        )
        segs_list.append(segs)
        state = (o_, d_, thr, rad, alive, uids_, pos)
        if collect_live is not None:
            collect_live.append(n_alive)

    pos_parts = [state[6]] + [p for p, _ in retired]
    rad_parts = [state[3]] + [r for _, r in retired]
    return _finish_unsort(
        tuple(pos_parts), tuple(rad_parts), tuple(segs_list),
        tuple(clip_flags),
    )


def path_trace_shrink(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    uids: jnp.ndarray,
    rng_key,
    path_depth: int,
    max_trace_dist: float,
    shrink_points: tuple = (1, 4),
    min_width: int = 4096,
    collect_live: list | None = None,
    sort_rays: bool = False,
):
    """path_trace with host-orchestrated per-bounce dispatch and a
    SHRINKING wavefront: after each bounce the (exit-sorted, dead-last)
    state is truncated to a power-of-4 bucket covering the live rays, so
    later bounces stop paying full-width intersection/resolve/BSDF for
    dead rays: stream compaction by a sort (already paid for big-mesh
    coherence) plus a static slice. On open scenes most of the segment
    budget dies within 2 bounces.

    Buckets step by 4x (N, N/4, N/16, ...) down to `min_width` so each
    scene compiles at most ~4 staged-kernel shapes. Bit-identical to
    path_trace (content-keyed RNG; the dropped tail rows are dead and
    their radiance is retired before truncation). Used by the driver's
    staged executor (driver.StagedOptions).

    The alive count is read from the device ONLY at `shrink_points`
    (bounce indices): each read costs a host round-trip, and a count
    measured at bounce b remains a VALID width bound for every later
    bounce because rays only die. Two points (post-bounce-1 for the
    big first die-off, post-bounce-4 for deep traces) capture most of
    the shrink at two RTTs per chunk.

    collect_live: if a list, the post-bounce alive-count DEVICE scalars
    are appended (no sync) — the driver fetches them after its first
    chunk to bake a path_trace_static width schedule for the rest.
    """
    if isinstance(rng_key, int):
        rng_key = threefry.key_words(rng_key)  # _bounce_once is jitted
    n = o.shape[0]
    state = (
        o, d,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), bool),
        uids,
        jnp.arange(n, dtype=jnp.int32),
    )
    if sort_rays:
        # entry sort for bounce 0 (primary coherence for the big-mesh
        # kernels), matching path_trace's per-bounce entry sort
        o_, d_, thr_, rad_, uids_, pos_, alive_ = _sort_state_jit(
            state[0], state[1], state[2], state[3],
            state[5], state[6], state[4], scene=scene,
        )
        state = (o_, d_, thr_, rad_, alive_, uids_, pos_)

    retired: list = []  # (pos, rad) of truncated dead tails
    segs_list: list = []
    width = n
    for b in range(path_depth):
        shrink_here = (
            b in shrink_points and b < path_depth - 1 and width > min_width
        )
        # the exit sort parks dead rays at the tail — required at shrink
        # points (truncation correctness) and kept every bounce when the
        # scene wants coherence sorting anyway (big meshes); skipped
        # after the FINAL bounce (nothing follows it, and the closing
        # pos-keyed sort below restores caller order regardless)
        o_, d_, thr, rad, alive, uids_, pos = state
        (o_, d_, thr, rad, alive, uids_, pos, segs, n_alive) = _bounce_once(
            scene, o_, d_, thr, rad, alive, uids_, pos, rng_key,
            rnglib.SITE_BOUNCE0 + b, max_trace_dist,
            (sort_rays and b < path_depth - 1) or shrink_here,
        )
        segs_list.append(segs)
        state = (o_, d_, thr, rad, alive, uids_, pos)
        if collect_live is not None:
            collect_live.append(n_alive)
        if shrink_here:
            count = int(n_alive)  # host round-trip: picks the bucket
            if count == 0:
                break
            new_w = width
            while new_w // 4 >= max(count, min_width):
                new_w //= 4
            if new_w < width:
                state, rpos, rrad, _ = _truncate_retire(
                    state, new_w, 6, 3, 4
                )
                retired.append((rpos, rrad))
                width = new_w

    # reassemble full width and restore caller order
    pos_parts = [state[6]] + [p for p, _ in retired]
    rad_parts = [state[3]] + [r for _, r in retired]
    rad3, segments, _ = _finish_unsort(
        tuple(pos_parts), tuple(rad_parts), tuple(segs_list), ()
    )
    return rad3, segments


def phong_trace(
    scene: SceneData,
    o: jnp.ndarray,
    d: jnp.ndarray,
    uids: jnp.ndarray,
    rng_key,
    eyepoint,
    max_trace_dist: float,
):
    """Blinn-ish Phong debug shading with hard shadows (tracing.rs:277-297).

    ambient + diffuse·albedo + 0.4·(r·v)^40, one point light, shadow rays
    offset 0.01·n with 0.3 occlusion weight. The "albedo" is the
    attenuation returned by the material's scatter — stochastic for
    ParameterizedMaterial, exactly like the reference's call at
    tracing.rs:294.
    """
    ball, u_choice, u_vol = _bounce_draws(scene, rng_key, uids, rnglib.SITE_BOUNCE0)
    hit = intersect_scene(scene, o, d, 0.0, max_trace_dist, u_vol)

    light = scene.point_light_pos
    to_light = vm.normalize(light - hit.point, eps=1e-30)
    to_camera = vm.normalize(
        jnp.asarray(eyepoint, jnp.float32) - hit.point, eps=1e-30
    )
    n = hit.normal
    reflected = -to_light + 2.0 * vm.vdot(to_light, n) * n
    diffuse_w = jnp.clip(jnp.sum(n * to_light, axis=-1), 0.0, 1.0)
    specular_w = jnp.clip(jnp.sum(to_camera * reflected, axis=-1), 0.0, 1.0) ** 40.0

    # Shadow ray (tracing.rs:289-293): note the occlusion test compares the
    # shadow hit's distance against the light distance measured from the
    # SHADOW hit's own hitpoint (the reference rebinds `hit` in the inner
    # match) — replicated literally.
    shadow_o = hit.point + PHONG_SHADOW_OFFSET * n
    light_dist = vm.magnitude(light - hit.point)
    _, _, u_vol2 = _bounce_draws(scene, rng_key, uids, rnglib.SITE_BOUNCE0 + 1)
    sh = intersect_scene(scene, shadow_o, to_light, 0.0, light_dist, u_vol2)
    far_enough = sh.t * sh.t > vm.magnitude2(light - sh.point)
    shadow_w = jnp.where(~sh.valid | far_enough, 1.0, 0.3)

    _, att, _ = bsdf.scatter(hit, d, ball, u_choice)
    color = shadow_w[:, None] * (
        scene.ambient + diffuse_w[:, None] * att + specular_w[:, None] * 0.4
    )
    return jnp.where(hit.valid[:, None], color, background_color(d))
