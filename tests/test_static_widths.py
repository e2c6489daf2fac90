"""Static-width fused staged executor (integrator.path_trace_static +
driver schedule building): bit-identical to path_trace/path_trace_shrink
when the schedule holds, ok=False when a truncation clips a live ray,
and the driver-level schedule-measure/violation-replay loop produces
bit-identical images."""

import numpy as np
import jax.numpy as jnp
import pytest

from cs397raytracingsp22.render import integrator
from cs397raytracingsp22.render.driver import (
    StagedOptions,
    _build_width_schedule,
    render_to_image,
)
from tests.test_shrink import textured_scene


def _rays(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-2, 3, (n, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    return o, d, jnp.arange(n, dtype=jnp.int32)


def test_static_full_width_matches_path_trace():
    data = textured_scene().compile()
    o, d, uids = _rays()
    rad_ref, segs_ref = integrator.path_trace(
        data, o, d, uids, 7, 6, max_trace_dist=100.0
    )
    rad_s, segs_s, ok = integrator.path_trace_static(
        data, o, d, uids, 7, 6, max_trace_dist=100.0, widths=(1024,) * 6
    )
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(rad_ref), np.asarray(rad_s))
    assert float(segs_ref) == float(segs_s)


def test_static_measured_schedule_matches():
    # exit sorts every bounce park dead rays at the tail
    data = textured_scene().compile()
    o, d, uids = _rays()
    live: list = []
    rad_ref, segs_ref = integrator.path_trace_shrink(
        data, o, d, uids, 7, 6, max_trace_dist=100.0, min_width=64,
        collect_live=live, sort_rays=True,
    )
    widths = _build_width_schedule(
        1024, [int(x) for x in live], 6, margin=1.5, min_width=64
    )
    assert widths[0] == 1024 and widths[-1] < 1024  # schedule does shrink
    rad_s, segs_s, ok = integrator.path_trace_static(
        data, o, d, uids, 7, 6, max_trace_dist=100.0, widths=widths,
        sort_rays=True,
    )
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(rad_ref), np.asarray(rad_s))
    assert float(segs_ref) == float(segs_s)


def test_static_violation_flag():
    # a schedule far below the live count must raise ok=False
    data = textured_scene().compile()
    o, d, uids = _rays()
    widths = (1024,) + (4,) * 5
    _, _, ok = integrator.path_trace_static(
        data, o, d, uids, 7, 6, max_trace_dist=100.0, widths=widths,
        sort_rays=True,
    )
    assert not bool(ok)


def test_schedule_nonfinite_margin_is_full_width():
    """0×inf (a measured-zero bounce after runaway margin widening) must
    not NaN-crash the schedule builder: a non-finite scaled count falls
    back to full width for that bounce."""
    w = _build_width_schedule(
        1024, [512, 0, 3], 5, margin=float("inf"), min_width=16
    )
    assert w[0] == 1024
    assert all(x == 1024 for x in w[1:2])  # 512 * inf -> full width
    # 0 * inf is NaN -> guarded to full width, not a crash
    assert w[2] == 1024


_SHRINK_IMG: dict = {}


def _shrink_reference_image():
    """Module-memoized seed-3 shrink-executor render: the comparison
    baseline both driver-level tests share (one XLA-CPU compile+render
    instead of two; shrink-vs-jnp identity itself is covered by
    test_shrink.test_driver_shrink_bit_identical)."""
    if "img" not in _SHRINK_IMG:
        img, _ = render_to_image(
            textured_scene(), seed=3, verbose=False, pixel_chunk=64,
            staged=StagedOptions(static=False),
        )
        _SHRINK_IMG["img"] = np.asarray(img)
    return _SHRINK_IMG["img"]


def test_driver_static_fallback_on_persistent_violation():
    """When the width schedule keeps undershooting (margin widening is
    capped by max_margin), the driver disables the static executor for
    the render and the shrink fallback still produces the bit-identical
    image."""
    img_shrink = _shrink_reference_image()
    # a deliberately hopeless schedule (margin ~0 truncates everything)
    # plus a cap below the first doubling: the first violation trips the
    # disabled flag and the replay must run the shrink executor
    opts = StagedOptions(margin=0.001, max_margin=0.001, min_width=16)
    img_static, _ = render_to_image(
        textured_scene(), seed=3, verbose=False, pixel_chunk=64,
        staged=opts,
    )
    np.testing.assert_array_equal(img_shrink, img_static)


def test_driver_static_bit_identical():
    """Driver end-to-end: static-schedule executor (default) vs the
    shrink executor — bit-identical (shrink vs the pure-jnp path is
    covered by test_shrink). Several pixel chunks so the baked schedule
    is actually reused."""
    img_shrink = _shrink_reference_image()
    # margin 1.0 + a tiny min width: the schedule truncates for real,
    # and later chunks can undershoot it — exercising the violation-
    # replay path as well as the happy path
    img_static, _ = render_to_image(
        textured_scene(), seed=3, verbose=False, pixel_chunk=64,
        staged=StagedOptions(margin=1.0, min_width=16),
    )
    np.testing.assert_array_equal(img_shrink, img_static)


def test_merge_live_schedule_is_running_max():
    """_merge_live_schedule must fold counts into the elementwise
    RUNNING MAX (driver.py merge path) — replacing the max with the
    latest counts would let a previously-covered chunk violate again
    — and must only mint widths from the power-of-4
    bucket series of n (the shapes the shrink path compiles)."""
    from cs397raytracingsp22.render.driver import _merge_live_schedule

    st = {"widths": {}, "margin": 1.0, "opts": StagedOptions(min_width=4)}
    _merge_live_schedule(st, 1024, [512, 100, 10], 4)
    assert st["grew"][1024] is True
    assert st["live_max"][1024] == [512, 100, 10, 0]

    # mixed higher/lower counts: max per bounce, not replacement
    _merge_live_schedule(st, 1024, [300, 200, 5], 4)
    assert st["live_max"][1024] == [512, 200, 10, 0]
    assert st["grew"][1024] is True  # bounce-1 max grew

    # strictly lower counts: max unchanged, grew=False (the sync() loop
    # uses this to tell "schedule was stale" from "margin too small")
    _merge_live_schedule(st, 1024, [1, 1, 1], 4)
    assert st["live_max"][1024] == [512, 200, 10, 0]
    assert st["grew"][1024] is False

    # pow4 bucket series only: every width ∈ {1024, 256, 64, 16, 4},
    # nonincreasing, widths[0] = n
    w = st["widths"][1024]
    assert w[0] == 1024 and len(w) == 4
    assert all(x in (1024, 256, 64, 16, 4) for x in w)
    assert all(w[i + 1] <= w[i] for i in range(3))


def test_driver_one_measure_replay_per_violation(monkeypatch):
    """A schedule baked from a lying first measurement must trigger
    EXACTLY one re-measure (the replay routes the violating window's
    first chunk through the measure branch, whose honest counts max-
    merge into the schedule) — not runaway margin doubling — and the
    final image must still be bit-identical to the shrink executor's."""
    from cs397raytracingsp22.render import driver as drv
    from cs397raytracingsp22.render import integrator

    img_shrink = _shrink_reference_image()

    real_shrink = integrator.path_trace_shrink
    measure_calls = {"n": 0}

    def lying_shrink(*args, collect_live=None, **kw):
        out = real_shrink(*args, collect_live=collect_live, **kw)
        if collect_live is not None:
            measure_calls["n"] += 1
            if measure_calls["n"] == 1:
                # claim everything died instantly: the baked schedule
                # truncates to min width and every later chunk violates
                collect_live[:] = [jnp.int32(0)] * len(collect_live)
        return out

    monkeypatch.setattr(integrator, "path_trace_shrink", lying_shrink)

    merges = []
    real_merge = drv._merge_live_schedule

    def spy_merge(st, n, counts, depth):
        real_merge(st, n, counts, depth)
        merges.append((list(counts), list(st["live_max"][n]), st["grew"][n]))

    monkeypatch.setattr(drv, "_merge_live_schedule", spy_merge)

    img_static, _ = drv.render_to_image(
        textured_scene(), seed=3, verbose=False, pixel_chunk=64,
        staged=StagedOptions(min_width=16),
    )
    np.testing.assert_array_equal(img_shrink, img_static)
    # exactly 2 measures: the lying first one + ONE honest replay
    assert measure_calls["n"] == 2, measure_calls
    # the replay's honest counts grew the running max
    assert merges[-1][2] is True
    assert any(c > 0 for c in merges[-1][1])


@pytest.mark.heavy
def test_driver_static_fused_bit_identical():
    """StagedOptions(fuse=True) (whole-chunk jit around
    path_trace_static) must produce the bit-identical image to the eager
    staged composition — same programs, one outer jit. Heavy tier: the
    option is off by default and the whole-chunk jit is a fresh
    multi-bounce XLA-CPU compile."""
    img_shrink = _shrink_reference_image()
    img_fused, _ = render_to_image(
        textured_scene(), seed=3, verbose=False, pixel_chunk=64,
        staged=StagedOptions(min_width=16, fuse=True),
    )
    np.testing.assert_array_equal(img_shrink, img_fused)


def test_staged_checkpoint_resume_bit_identical(tmp_path):
    """Checkpoint/resume through the STAGED static-width executor: the
    schedule-measure/bake machinery must compose with spp-chunked
    checkpointing (staged_state persists across spp chunks), and a
    resume from the final checkpoint must reproduce the image bit-
    exactly with zero new rays — the textured-scene twin of
    test_driver.test_checkpoint_resume (which covers the dense path)."""
    import dataclasses

    from tests.test_shrink import textured_scene

    opts = StagedOptions(min_width=4)
    base = textured_scene(width=8, height=8, spp=4)
    scene = dataclasses.replace(
        base, camera=dataclasses.replace(base.camera, path_depth=4)
    )
    ckpt = str(tmp_path / "staged.npz")

    img_ref, _ = render_to_image(
        scene, seed=9, spp_chunk=2, pixel_chunk=16, verbose=False,
        staged=opts,
    )
    img_ck, _ = render_to_image(
        scene, seed=9, spp_chunk=2, pixel_chunk=16, verbose=False,
        checkpoint_path=ckpt, staged=opts,
    )
    np.testing.assert_array_equal(img_ref, img_ck)
    img_res, stats = render_to_image(
        scene, seed=9, spp_chunk=2, pixel_chunk=16, verbose=False,
        checkpoint_path=ckpt, staged=opts,
    )
    np.testing.assert_array_equal(img_ref, img_res)
    assert stats.primary_rays == 0  # fully resumed from the checkpoint
