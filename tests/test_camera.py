"""Camera ray-generation tests vs reference semantics (tracing.rs:159-209)."""

import jax
import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22.models.camera import Camera, CameraProjectionMode


def make_camera(**kw):
    defaults = dict(
        eyepoint=(0.0, 2.0, 5.5),
        view_dir=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        focal_length=0.6,
        focus_dist=5.0,
        lens_radius=0.0,
        screen_width=8,
        screen_height=8,
        aa_sample_count=4,
    )
    defaults.update(kw)
    return Camera(**defaults)


def test_center_pixel_ray_points_forward():
    # Reference quirk: x centers at pixel (W-1)/2 but y at (H+1)/2 — the
    # vertical pixel-center formula is offset a full pixel from the
    # horizontal one (tracing.rs:177-179). On a 9x9 screen the on-axis
    # pixel is therefore (x=4, y=5).
    cam = make_camera(screen_width=9, screen_height=9, aa_sample_count=100)
    pid = jnp.array([5 * 9 + 4], dtype=jnp.int32)  # pixel (x=4, y=5)
    o, d = cam.generate_rays(0, pid)
    d_mean = np.asarray(d[0]).mean(axis=0)
    d_mean /= np.linalg.norm(d_mean)
    # center pixel looks straight down -z, modulo the reference's
    # deliberate jitter bias of -ps/(2√n)-ps/(2n) (tracing.rs:172-173)
    # and finite-sample noise.
    np.testing.assert_allclose(d_mean, [0.0, 0.0, -1.0], atol=0.06)
    np.testing.assert_allclose(np.asarray(o[0]), [[0.0, 2.0, 5.5]] * 100, atol=1e-6)


def test_directions_unit_length():
    cam = make_camera(aa_sample_count=9)
    pid = jnp.arange(64, dtype=jnp.int32)
    _, d = cam.generate_rays(0, pid)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-5
    )


def test_image_orientation():
    # Pixel (x=W-1, y=0) is top-right: direction has +x and +y components.
    cam = make_camera(screen_width=16, screen_height=16, aa_sample_count=100)
    pid = jnp.array([15], dtype=jnp.int32)
    _, d = cam.generate_rays(1, pid)
    dm = np.asarray(d[0]).mean(axis=0)
    assert dm[0] > 0 and dm[1] > 0 and dm[2] < 0


def test_jitter_distribution_matches_reference():
    # Multi-jittered offsets: subpixel grid + integer lattice jitter
    # (tracing.rs:165-174). Check the offset of sample i=0 stays within
    # the reference's possible range and is non-degenerate.
    cam = make_camera(screen_width=4, screen_height=4, aa_sample_count=16)
    pid = jnp.zeros((512,), dtype=jnp.int32)  # same pixel many times? no -
    # use distinct pixels so RNG differs; pixel 0 repeated would repeat rays.
    pid = jnp.arange(16, dtype=jnp.int32) % 16
    o, d = cam.generate_rays(2, pid)
    # Rays from the same pixel with different sample ids must differ (AA).
    assert not np.allclose(np.asarray(d[0, 0]), np.asarray(d[0, 1]))


def test_determinism_and_content_keying():
    # Same pixel id produces identical rays regardless of batch position.
    cam = make_camera(aa_sample_count=4)
    key = 3
    pid_a = jnp.array([5, 9, 11], dtype=jnp.int32)
    pid_b = jnp.array([11, 5], dtype=jnp.int32)
    oa, da = cam.generate_rays(key, pid_a)
    ob, db = cam.generate_rays(key, pid_b)
    np.testing.assert_array_equal(np.asarray(da[2]), np.asarray(db[0]))
    np.testing.assert_array_equal(np.asarray(da[0]), np.asarray(db[1]))


def test_orthographic_mode():
    # Quirk: ortho origins are camera-space pixel centers (z=0), eyepoint
    # ignored; direction = rotation @ view_dir (tracing.rs:196,200,204).
    cam = make_camera(
        projection_mode=CameraProjectionMode.ORTHOGRAPHIC,
        aa_sample_count=4,
        eyepoint=(100.0, 100.0, 100.0),
        view_dir=(0.0, 0.0, -1.0),
    )
    pid = jnp.array([0], dtype=jnp.int32)
    o, d = cam.generate_rays(4, pid)
    o = np.asarray(o[0])
    assert np.all(o[:, 2] == 0.0)  # z = 0, eyepoint ignored
    assert np.all(np.abs(o[:, 0]) < 1.0)  # camera-space units
    # rotation @ (0,0,-1) with identity-ish basis = (0,0,-1) rotated:
    # basis cols [x=(−1·cross), up, -view] → R @ view = view for this basis.
    np.testing.assert_allclose(np.asarray(d[0]), [[0.0, 0.0, -1.0]] * 4, atol=1e-6)


def test_defocus_blur_spreads_origins():
    cam = make_camera(lens_radius=0.2, aa_sample_count=16)
    pid = jnp.array([0], dtype=jnp.int32)
    o, _ = cam.generate_rays(5, pid)
    o = np.asarray(o[0])
    spread = o.std(axis=0)
    assert spread[0] > 0.01 and spread[1] > 0.01
    # lens offsets lie within lens_radius of the eyepoint
    r = np.linalg.norm(o - np.array([0.0, 2.0, 5.5]), axis=-1)
    assert r.max() <= 0.2 + 1e-5
