"""Multi-host (multi-process) rendering exercised for real: two spawned
processes, a gRPC coordinator on localhost, 2 virtual CPU devices each →
a global 4-device ("dp","sp") mesh. The multi-host image must be
bit-identical to the single-process render (SURVEY.md §2.3 multi-process
DP; the reference has no multi-process story at all)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = str(Path(__file__).resolve().parents[1])

_WORKER = r"""
import sys
proc_id = int(sys.argv[1])
coord = sys.argv[2]
out = sys.argv[3]

from cs397raytracingsp22.parallel import multihost

pid, nproc = multihost.initialize(
    coord, num_processes=2, process_id=proc_id, local_device_count=2
)
assert nproc == 2, nproc

import jax
assert jax.device_count() == 4, jax.devices()
assert jax.local_device_count() == 2

from scenes import cornell

scene = cornell.build(width=16, height=16, spp=4, path_depth=3)
img, stats = multihost.render_to_image_multihost(
    scene, n_sp=2, seed=7, verbose=False
)
assert stats.device_count == 4
if pid == 0:
    import numpy as np
    np.save(out, img)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    out = str(tmp_path / "mh_img.npy")
    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER)

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), coord, out],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so[-2000:]}\n{se[-2000:]}"
    img_mh = np.load(out)

    # single-process reference (this process: 8 virtual devices via
    # conftest, but the plain driver is single-device)
    from cs397raytracingsp22.render.driver import render_to_image
    from scenes import cornell

    scene = cornell.build(width=16, height=16, spp=4, path_depth=3)
    img_ref, _ = render_to_image(scene, seed=7, verbose=False)
    np.testing.assert_array_equal(img_ref, img_mh)


_CKPT_WORKER = r"""
import os
import sys
proc_id = int(sys.argv[1])
coord = sys.argv[2]
outdir = sys.argv[3]
out = sys.argv[4]

from cs397raytracingsp22.parallel import multihost

pid, nproc = multihost.initialize(
    coord, num_processes=2, process_id=proc_id, local_device_count=1
)
import jax
assert jax.device_count() == 2

import numpy as np
from scenes import cornell

scene = cornell.build(width=16, height=16, spp=4, path_depth=3)

# phase A: uninterrupted full render = the equality reference
img_full, _ = multihost.render_to_image_multihost(
    scene, n_sp=1, seed=9, verbose=False, spp_chunk=2
)

# phase B1: same render, checkpointed, "killed" after the first spp
# chunk — np.savez is wrapped to drop every write but the first, so the
# file on disk is a genuine mid-render spp_done=2 checkpoint. The path
# is PER-PROCESS (no shared filesystem): only process 0 ever writes.
import cs397raytracingsp22.render.driver as drv
ckpt = os.path.join(outdir, f"proc{pid}_ckpt.npz")
orig_savez = np.savez
calls = {"n": 0}
def savez_once(path, **kw):
    calls["n"] += 1
    if calls["n"] == 1:
        orig_savez(path, **kw)
drv.np.savez = savez_once
multihost.render_to_image_multihost(
    scene, n_sp=1, seed=9, verbose=False, spp_chunk=2,
    checkpoint_path=ckpt,
)
drv.np.savez = orig_savez
assert os.path.exists(ckpt) == (pid == 0), "only process 0 writes"

# phase B2: resume. Process 1 has NO checkpoint file — process 0's
# spp_done must be broadcast (multihost.broadcast_checkpoint) or the
# processes disagree on dispatch counts and the collectives deadlock.
img_res, _ = multihost.render_to_image_multihost(
    scene, n_sp=1, seed=9, verbose=False, spp_chunk=2,
    checkpoint_path=ckpt,
)
assert (img_res == img_full).all(), "resumed render must be bit-identical"
if pid == 0:
    np.save(out, img_res)
"""


@pytest.mark.slow
def test_two_process_checkpoint_resume(tmp_path):
    """Checkpoint/resume on a 2-process mesh WITHOUT a shared
    filesystem: only process 0 holds the checkpoint; resume must
    broadcast its spp_done (driver + multihost.broadcast_checkpoint) and
    reproduce the uninterrupted render bit-for-bit on every process."""
    port = _free_port()
    coord = f"localhost:{port}"
    out = str(tmp_path / "ckpt_img.npy")
    worker = str(tmp_path / "ckpt_worker.py")
    with open(worker, "w") as f:
        f.write(_CKPT_WORKER)

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p
    )
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), coord, str(tmp_path), out],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so[-2000:]}\n{se[-2000:]}"
    assert os.path.exists(out)


@pytest.mark.slow
def test_cli_distributed_two_processes(tmp_path):
    """The CLI --distributed/--mesh flags run the same recipe: two
    spawned CLI processes (1 CPU device each → global 2-device dp mesh),
    process 0 writes the PNG, bit-identical to a plain single-process
    CLI render."""
    port = _free_port()
    coord = f"localhost:{port}"
    out_mh = str(tmp_path / "mh.png")
    out_ref = str(tmp_path / "ref.png")

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p
    )
    base = [
        sys.executable, "-m", "cs397raytracingsp22.cli",
        "scenes/cornell.py", "--width", "8", "--height", "8",
        "--spp", "2", "--cpu", "-q", "--seed", "5",
    ]
    procs = [
        subprocess.Popen(
            base + [
                "-o", out_mh, "--mesh", "2x1", "--distributed",
                "--coordinator", coord, "--num-processes", "2",
                "--process-id", str(i),
            ],
            cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"cli worker failed:\n{so[-2000:]}\n{se[-2000:]}"

    r = subprocess.run(
        base + ["-o", out_ref], cwd=ROOT, env=env,
        capture_output=True, timeout=300, text=True,
    )
    assert r.returncode == 0, r.stderr[-2000:]

    from PIL import Image

    a = np.asarray(Image.open(out_mh))
    b = np.asarray(Image.open(out_ref))
    assert (a == b).all()
