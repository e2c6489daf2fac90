"""chip_smoke.py's comparison helpers and its refusal to run off the card
(the phases themselves need the GPU)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _scan(n=10000, seed=0):
    rng = np.random.default_rng(seed)
    hit = rng.uniform(size=n) < 0.6
    t = rng.uniform(0.5, 50.0, n).astype(np.float32)
    tri = np.where(hit, rng.integers(0, 6144, n), -1).astype(np.int32)
    return [hit, t, tri]


def test_scan_parity_identical():
    ref = _scan()
    p = chip_smoke.scan_parity(ref, [x.copy() for x in ref])
    assert p["hit_agree"] == 1.0 and p["other_winner"] == 0
    assert chip_smoke.scan_parity_ok(p)


@pytest.mark.parametrize("case,ok", [
    ("one_hit_flip", True),        # 1e-4 of 10^4 rays: at the bound
    ("two_hit_flips", False),
    ("t_rounding", True),          # same winner, t within rtol 1e-5
    ("t_off", False),
    ("tie_winner", True),          # other winner at |Δt| <= 1e-5·t
    ("wrong_winner", False),
])
def test_scan_parity_bounds(case, ok):
    ref = _scan()
    got = [x.copy() for x in ref]
    hits = np.flatnonzero(ref[0])
    if case == "one_hit_flip":
        got[0][hits[0]] = False
    elif case == "two_hit_flips":
        got[0][hits[:2]] = False
    elif case == "t_rounding":
        got[1] = got[1] * np.float32(1 + 4e-6)
    elif case == "t_off":
        got[1][hits[3]] *= np.float32(1.001)
    elif case == "tie_winner":
        got[2][hits[5]] += 1
        got[1][hits[5]] *= np.float32(1 + 5e-6)
    elif case == "wrong_winner":
        got[2][hits[5]] += 1
        got[1][hits[5]] *= np.float32(1.01)
    assert chip_smoke.scan_parity_ok(chip_smoke.scan_parity(ref, got)) is ok


@pytest.mark.parametrize("case,ok", [
    ("same", True),
    ("few_off", True),      # 1e-3 of subpixels off by 3
    ("many_off", False),    # 2e-3 of subpixels off by 3
    ("all_plus_one", False),  # mean |Δ| = 1 > 0.05
    ("off_by_two", True),   # 1e-2 of subpixels off by 2 (not "more than 2")
])
def test_image_diff_bounds(case, ok):
    rng = np.random.default_rng(1)
    a = rng.integers(10, 240, (100, 100, 3), dtype=np.uint8)
    b = a.copy()
    flat = b.reshape(-1)
    if case == "few_off":
        flat[:30] += 3
    elif case == "many_off":
        flat[:60] += 3
    elif case == "all_plus_one":
        b += 1
    elif case == "off_by_two":
        flat[:300] += 2
    d = chip_smoke.image_diff(a, b)
    assert chip_smoke.image_diff_ok(d) is ok, d


def test_image_diff_shape_mismatch():
    with pytest.raises(ValueError):
        chip_smoke.image_diff(np.zeros((2, 2, 3), np.uint8), np.zeros((2, 3, 3), np.uint8))


def test_scan_rays_shapes_and_frame():
    """Half camera rays, half surface rays, all in the mesh's frame."""
    import jax.numpy as jnp

    from scenes import cornell_teapot

    scene = cornell_teapot.build(16, 16, spp=1)
    data = scene.compile()
    o, d = chip_smoke.scan_rays(data, scene.camera, 0, 101)
    assert o.shape == d.shape == (101, 3)
    verts = np.asarray(data.meshes[0].tri_verts).reshape(-1, 3)
    lo, hi = verts.min(0) - 1e-4, verts.max(0) + 1e-4
    surf = np.asarray(o[50:])
    assert ((surf >= lo) & (surf <= hi)).all()
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d[50:]), axis=1), 1.0, rtol=1e-5)
    assert bool(jnp.isfinite(o).all() & jnp.isfinite(d).all())


def test_refuses_to_run_without_a_gpu():
    """On the CPU it exits non-zero and prints no result line."""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=str(ROOT), capture_output=True, text=True, timeout=300,
                       env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
