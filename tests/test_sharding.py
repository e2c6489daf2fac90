"""Multi-device rendering on the 8-virtual-CPU-device mesh: the sharded
render must be bit-identical to single-device (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cs397raytracingsp22.parallel import sharding
from cs397raytracingsp22.render.driver import render_chunk
from scenes import cornell


@pytest.fixture(scope="module")
def small_scene():
    scene = cornell.build(width=16, height=16, spp=8, path_depth=3)
    return scene, scene.compile()


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_device(small_scene, shape):
    scene, data = small_scene
    n_dp, n_sp = shape
    mesh = sharding.make_device_mesh(n_dp=n_dp, n_sp=n_sp)
    spp = scene.camera.aa_sample_count

    from cs397raytracingsp22.utils import threefry

    key = threefry.key_words(11)
    pixel_ids = jnp.arange(256, dtype=jnp.int32)

    ref_sum, ref_segs = render_chunk(
        data, scene.camera, pixel_ids, key, jnp.int32(0), spp, 1
    )

    fn = sharding.make_sharded_render_chunk(mesh, scene.camera, spp)
    out_sum, out_segs = fn(data, pixel_ids, key, jnp.int32(0))

    np.testing.assert_array_equal(np.asarray(ref_sum), np.asarray(out_sum))
    np.testing.assert_allclose(float(ref_segs), float(out_segs))


def test_sharded_nee_matches_single_device():
    """Camera(nee=True) under a ("dp","sp") mesh: the NEE integrator
    rides the same render_chunk_core inside shard_map, so the sharded
    driver image must be bit-identical to the single-device one."""
    import dataclasses

    from cs397raytracingsp22.render.driver import render_to_image

    base = cornell.build_config3(width=16, height=16, spp=8, path_depth=3)
    scene = dataclasses.replace(
        base, camera=dataclasses.replace(base.camera, nee=True)
    )
    img_ref, _ = render_to_image(scene, seed=6, verbose=False)
    mesh = sharding.make_device_mesh(n_dp=4, n_sp=2)
    img_sh, _ = sharding.render_to_image_sharded(
        scene, mesh, seed=6, verbose=False
    )
    np.testing.assert_array_equal(img_ref, img_sh)
    assert img_ref.mean() > 1.0  # NEE actually lights the 8spp render


def test_mesh_construction():
    mesh = sharding.make_device_mesh(n_dp=4, n_sp=2)
    assert mesh.shape["dp"] == 4 and mesh.shape["sp"] == 2


def test_render_to_image_sharded_matches_driver(small_scene):
    """Full sharded image == single-device driver image, bit for bit."""
    from cs397raytracingsp22.render.driver import render_to_image

    scene, _ = small_scene
    img_ref, _ = render_to_image(scene, seed=4, verbose=False)
    mesh = sharding.make_device_mesh(n_dp=4, n_sp=2)
    img_sh, stats = sharding.render_to_image_sharded(scene, mesh, seed=4, verbose=False)
    np.testing.assert_array_equal(img_ref, img_sh)
    assert stats.device_count == 8


def test_sharded_big_mesh_scene_matches_single_device():
    """The big-mesh (BVH traversal + sorted-wavefront) path also shards:
    a mesh above DENSE_MESH_MAX_TRIS forces bvh.traverse inside the
    sharded chunk; per-shard sorting is a pure permutation (content-keyed
    RNG), so the sharded result is bit-identical to the unsharded chunk."""
    import numpy as np

    from cs397raytracingsp22 import Camera, Lambertian, Plane, Scene, Sphere
    from cs397raytracingsp22.models.geometry import StaticMesh
    from cs397raytracingsp22.ops.bvh import DENSE_MESH_MAX_TRIS
    from cs397raytracingsp22.render.driver import render_chunk
    from cs397raytracingsp22.utils import threefry

    # synthesize an OBJ just above the dense limit so it takes the big path
    import tempfile, os

    n_quads = DENSE_MESH_MAX_TRIS // 2 + 8  # triangulates to > max tris
    rng = np.random.default_rng(0)
    lines = []
    k = int(np.ceil(np.sqrt(n_quads)))
    for i in range(k + 1):
        for j in range(k + 1):
            lines.append(f"v {i * 0.02 - k * 0.01} {j * 0.02 - k * 0.01} {rng.uniform(-0.01, 0.01):.4f}")
    def vid(i, j):
        return i * (k + 1) + j + 1
    c = 0
    for i in range(k):
        for j in range(k):
            if c >= n_quads:
                break
            lines.append(f"f {vid(i,j)} {vid(i+1,j)} {vid(i+1,j+1)} {vid(i,j+1)}")
            c += 1
    with tempfile.NamedTemporaryFile("w", suffix=".obj", delete=False) as f:
        f.write("\n".join(lines))
        obj_path = f.name
    try:
        mesh_obj = StaticMesh.load_from_file(
            obj_path, material=Lambertian(albedo=(0.6, 0.6, 0.6))
        )
        scene = Scene(
            camera=Camera(
                eyepoint=(0, 0, 1.2), view_dir=(0, 0, -1), up=(0, 1, 0),
                screen_width=8, screen_height=8, aa_sample_count=2,
                path_depth=2,
            ),
            objects=[
                mesh_obj,
                Plane(point=(0, -1, 0), normal=(0, 1, 0),
                      material=Lambertian(albedo=(0.5, 0.5, 0.5))),
                Sphere(center=(0, 2, 0), radius=0.5,
                       material=Lambertian(albedo=(0, 0, 0), emission=(5, 5, 5))),
            ],
        )
        data = scene.compile()
        assert len(data.dense_mesh_ids) < len(data.meshes), "must take big path"

        key = threefry.key_words(7)
        pixel_ids = jnp.arange(64, dtype=jnp.int32)
        ref_sum, ref_segs = render_chunk(
            data, scene.camera, pixel_ids, key, jnp.int32(0), 2, 1
        )
        mesh = sharding.make_device_mesh(n_dp=4, n_sp=2)
        fn = sharding.make_sharded_render_chunk(mesh, scene.camera, 2)
        out_sum, out_segs = fn(data, pixel_ids, key, jnp.int32(0))
        np.testing.assert_array_equal(np.asarray(ref_sum), np.asarray(out_sum))
    finally:
        os.unlink(obj_path)


def test_resume_misaligned_spp_raises(small_scene, tmp_path):
    """A checkpoint whose spp_done is not divisible by the mesh's sp
    axis cannot be finished with sp-divisible chunks — the driver must
    refuse with a clear error, not trip a deep kernel assert."""
    from cs397raytracingsp22.render.driver import render_to_image

    scene, data = small_scene
    ckpt = str(tmp_path / "r.npz")
    n_px = scene.camera.screen_width * scene.camera.screen_height
    np.savez(
        ckpt,
        accum=np.zeros((n_px, 3), np.float64),
        spp_done=np.int64(3),  # not divisible by sp=2
        seed=np.int64(4),
    )
    mesh = sharding.make_device_mesh(n_dp=4, n_sp=2)
    with pytest.raises(ValueError, match="sp axis"):
        render_to_image(
            scene, seed=4, verbose=False, scene_data=data,
            mesh=mesh, checkpoint_path=ckpt,
        )


def test_sharded_staged_static_bit_identical(monkeypatch):
    """Textured/big-mesh scenes under a device mesh route through the
    STAGED static-width executor inside shard_map (driver mesh branch →
    sharding.make_sharded_staged_render_chunk) and the image is
    bit-identical to the single-device staged render. Spies on the
    factory to prove the fast path actually ran (round-4 gap: sharded
    big-mesh renders silently fell back to full-width path_trace)."""
    import dataclasses

    from cs397raytracingsp22.render.driver import StagedOptions, render_to_image
    from tests.test_shrink import textured_scene


    # smallest scene that exercises the whole machinery: XLA-CPU
    # compile of the shard_map staged programs scales with path_depth
    # (one bounce-program instance per bounce), and this test's cold
    # compile is the default tier's single largest line
    base = textured_scene(width=8, height=8, spp=4)
    scene = dataclasses.replace(
        base, camera=dataclasses.replace(base.camera, path_depth=4)
    )
    img_ref, _ = render_to_image(
        scene, seed=3, verbose=False, pixel_chunk=16,
        staged=StagedOptions(static=False),
    )

    calls = []
    real_factory = sharding.make_sharded_staged_render_chunk

    def spy(mesh_, camera, spp, n_chains=1, widths=None, **kw):
        calls.append(widths)
        return real_factory(mesh_, camera, spp, n_chains, widths, **kw)

    monkeypatch.setattr(
        sharding, "make_sharded_staged_render_chunk", spy
    )
    mesh = sharding.make_device_mesh(n_dp=2, n_sp=2)
    img_sh, _ = render_to_image(
        scene, seed=3, verbose=False, pixel_chunk=16, mesh=mesh,
        staged=StagedOptions(min_width=4),
    )
    np.testing.assert_array_equal(img_ref, img_sh)
    # one measure build (widths=None) + ≥1 static-schedule build
    assert None in calls and any(w is not None for w in calls)
    # the baked schedules are LOCAL widths (16px/2dp × 4spp/2sp × 1
    # chain = 16 rays/device) that actually shrink for this mostly-sky
    # scene (most rays die within two bounces)
    baked = [w for w in calls if w is not None]
    assert all(w[0] == 16 for w in baked)
    assert any(w[-1] < w[0] for w in baked)


@pytest.mark.heavy
def test_sharded_staged_violation_replay_and_fallback():
    """A hopeless width schedule under the sharded staged executor must
    trip the ok=False flag, hit the driver's margin-cap fallback, and
    still produce the bit-identical image via the full-width sharded
    path (the always-correct executor). Heavy tier: its cold XLA-CPU
    compile (measure + static + plain shard_map programs) is minutes;
    the same violation/margin/fallback logic runs in the default tier
    single-device (test_static_widths) and the sharded happy path +
    measure/bake is test_sharded_staged_static_bit_identical."""
    from cs397raytracingsp22.render.driver import StagedOptions, render_to_image
    from tests.test_shrink import textured_scene
    from tests.test_static_widths import _shrink_reference_image

    img_ref = _shrink_reference_image()
    mesh = sharding.make_device_mesh(n_dp=2, n_sp=2)
    img_sh, _ = render_to_image(
        textured_scene(), seed=3, verbose=False, pixel_chunk=64,
        mesh=mesh,
        staged=StagedOptions(margin=0.001, max_margin=0.001, min_width=4),
    )
    np.testing.assert_array_equal(img_ref, img_sh)
