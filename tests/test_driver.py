"""Driver-level tests: checkpoint/resume, CLI, stats."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cs397raytracingsp22.render.driver import render_to_image
from scenes import cornell

ROOT = str(Path(__file__).resolve().parents[1])


def test_checkpoint_resume(tmp_path):
    scene = cornell.build(width=8, height=8, spp=4, path_depth=2)
    ckpt = str(tmp_path / "accum.npz")

    # Render only the first 2 spp (simulate an interrupted render by
    # chunking spp and snapshotting the checkpoint mid-way).
    img_full, _ = render_to_image(scene, seed=5, spp_chunk=2, verbose=False)

    # fresh run with checkpointing, chunked the same way
    img_ck, _ = render_to_image(
        scene, seed=5, spp_chunk=2, checkpoint_path=ckpt, verbose=False
    )
    np.testing.assert_array_equal(img_full, img_ck)
    assert os.path.exists(ckpt)

    # resuming from the final checkpoint renders nothing new but
    # reproduces the image exactly from the accumulator
    img_res, stats = render_to_image(
        scene, seed=5, spp_chunk=2, checkpoint_path=ckpt, verbose=False
    )
    np.testing.assert_array_equal(img_full, img_res)
    assert stats.primary_rays == 0  # everything came from the checkpoint


def test_checkpoint_resume_rejects_mismatched_run(tmp_path):
    """Resuming with fewer target spp than the checkpoint holds (the
    accumulator cannot be un-summed; finalize would divide 4 samples by
    2 → a 2x over-bright image) or with a flipped --nee (two estimators
    blended into one accumulator) must raise, not silently corrupt."""
    import dataclasses

    scene4 = cornell.build_config3(width=8, height=8, spp=4, path_depth=2)
    ckpt = str(tmp_path / "accum.npz")
    render_to_image(scene4, seed=5, spp_chunk=2, checkpoint_path=ckpt,
                    verbose=False)

    scene2 = cornell.build_config3(width=8, height=8, spp=2, path_depth=2)
    with pytest.raises(ValueError, match="holds 4 spp"):
        render_to_image(scene2, seed=5, checkpoint_path=ckpt, verbose=False)

    scene_nee = dataclasses.replace(
        scene4, camera=dataclasses.replace(scene4.camera, nee=True,
                                           aa_sample_count=8)
    )
    with pytest.raises(ValueError, match="nee"):
        render_to_image(scene_nee, seed=5, checkpoint_path=ckpt,
                        verbose=False)


def test_partial_checkpoint_resume(tmp_path):
    """Simulate a kill mid-render: build a checkpoint at 2/4 spp by
    rendering a half-spp scene, then resume to the full result."""
    scene_half = cornell.build(width=8, height=8, spp=2, path_depth=2)
    scene_full = cornell.build(width=8, height=8, spp=4, path_depth=2)
    ckpt = str(tmp_path / "accum.npz")

    render_to_image(scene_half, seed=5, checkpoint_path=ckpt, verbose=False)
    # the half-render checkpoint says spp_done=2; full render resumes at 2.
    # NOTE: per-sample RNG depends on camera.aa_sample_count, so resuming
    # into a DIFFERENT total spp is only valid because the sample uid uses
    # aa_sample_count of each camera... assert behavior matches a direct
    # spp-chunked run instead of bitwise comparing across cameras.
    img_resumed, stats = render_to_image(
        scene_full, seed=5, checkpoint_path=ckpt, verbose=False
    )
    assert stats.primary_rays == 8 * 8 * 2  # only 2 remaining spp traced
    assert img_resumed.shape == (8, 8, 3)


def test_stats_populated():
    scene = cornell.build(width=8, height=8, spp=2, path_depth=2)
    _, stats = render_to_image(scene, verbose=False)
    assert stats.primary_rays == 8 * 8 * 2
    assert stats.path_segments > 0
    assert stats.wall_seconds > 0
    assert "Mrays" in stats.summary()


@pytest.mark.slow
def test_cli_end_to_end(tmp_path):
    out = str(tmp_path / "out.png")
    stats = str(tmp_path / "stats.json")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [
            sys.executable,
            "-m",
            "cs397raytracingsp22.cli",
            "scenes/cornell.py",
            "-o",
            out,
            "--width", "8", "--height", "8", "--spp", "2",
            "--stats-json", stats,
            "--cpu", "-q",
        ],
        cwd=ROOT,
        env=env,
        capture_output=True,
        timeout=300,
        text=True,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out) and os.path.exists(stats)
    from PIL import Image

    img = Image.open(out)
    assert img.size == (8, 8)


@pytest.mark.slow
def test_cli_set_overrides(tmp_path):
    """--set KEY=VALUE forwards arbitrary build(**overrides) kwargs:
    literals parse (path_depth=3 → int), and the stats record proves the
    override reached the scene."""
    out = str(tmp_path / "out.png")
    stats = str(tmp_path / "stats.json")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [
            sys.executable, "-m", "cs397raytracingsp22.cli",
            "scenes/cornell.py", "-o", out,
            "--width", "8", "--height", "8", "--spp", "2",
            "--set", "path_depth=3",
            "--stats-json", stats, "--cpu", "-q",
        ],
        cwd=ROOT, env=env, capture_output=True, timeout=300,
        text=True,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    import json

    with open(stats) as f:
        assert json.load(f)["path_depth"] == 3

    # malformed --set fails fast with a clear message
    r = subprocess.run(
        [
            sys.executable, "-m", "cs397raytracingsp22.cli",
            "scenes/cornell.py", "-o", out, "--set", "nonsense", "--cpu",
        ],
        cwd=ROOT, env=env, capture_output=True, timeout=60,
        text=True,
    )
    assert r.returncode != 0
    assert "KEY=VALUE" in r.stderr


def test_path_samples_chains():
    """path_samples > 1 (reference tracing.rs:310-318 branching) runs the
    chain-replication path: deterministic, statistically consistent with
    path_samples=1, and strictly different sample sets."""
    s1 = cornell.build(width=8, height=8, spp=4, path_depth=3)
    import dataclasses

    s2 = cornell.build(width=8, height=8, spp=4, path_depth=3)
    s2 = dataclasses.replace(
        s2, camera=dataclasses.replace(s2.camera, path_samples=2)
    )
    img1, st1 = render_to_image(s1, seed=3, verbose=False)
    img2, st2 = render_to_image(s2, seed=3, verbose=False)
    img2b, _ = render_to_image(s2, seed=3, verbose=False)
    np.testing.assert_array_equal(img2, img2b)  # deterministic
    assert float(st2.path_segments) > float(st1.path_segments)  # 2x chains traced
    # same estimator expectation: mean brightness within MC noise
    assert abs(float(img1.mean()) - float(img2.mean())) < 25.0


def test_orthographic_render():
    """End-to-end orthographic projection render (reference quirk
    tracing.rs:194-203: ortho ray origins ignore the eyepoint)."""
    from cs397raytracingsp22.models.camera import CameraProjectionMode

    import dataclasses

    scene = cornell.build(width=8, height=8, spp=2, path_depth=2)
    scene = dataclasses.replace(
        scene,
        camera=dataclasses.replace(
            scene.camera, projection_mode=CameraProjectionMode.ORTHOGRAPHIC
        ),
    )
    img, stats = render_to_image(scene, seed=0, verbose=False)
    assert img.shape == (8, 8, 3)
    assert np.isfinite(img.astype(np.float64)).all()


def test_chunk_retry_recovers_transient_device_error(monkeypatch):
    """SURVEY §5 failure detection: a transient device error on one chunk
    is recovered by re-running it (chunks are stateless)."""
    import jax

    from cs397raytracingsp22.render import driver as drv

    scene = cornell.build(width=8, height=8, spp=2, path_depth=2)
    img_ref, _ = render_to_image(scene, seed=9, verbose=False)

    calls = {"n": 0}
    real = drv.render_chunk

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise jax.errors.JaxRuntimeError("injected transient failure")
        return real(*args, **kw)

    monkeypatch.setattr(drv, "render_chunk", flaky)
    img, _ = render_to_image(scene, seed=9, verbose=False)
    np.testing.assert_array_equal(img_ref, img)
    assert calls["n"] >= 2


def test_cli_mesh_flag_matches_single_device(tmp_path):
    """--mesh DPxSP must produce the bit-identical image of a plain run
    (sharding invariance through the CLI entry point)."""
    out1 = str(tmp_path / "single.png")
    out2 = str(tmp_path / "sharded.png")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    base = [
        sys.executable, "-m", "cs397raytracingsp22.cli",
        "scenes/cornell.py", "--width", "8", "--height", "8",
        "--spp", "4", "--cpu", "-q",
    ]
    for args, out in ((base, out1), (base + ["--mesh", "4x2"], out2)):
        r = subprocess.run(
            args + ["-o", out], cwd=ROOT, env=env,
            capture_output=True, timeout=300, text=True,
        )
        assert r.returncode == 0, r.stderr[-2000:]
    from PIL import Image
    import numpy as np

    a = np.asarray(Image.open(out1))
    b = np.asarray(Image.open(out2))
    assert (a == b).all()
