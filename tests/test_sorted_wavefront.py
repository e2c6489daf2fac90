"""Sorted-wavefront invariants (render/integrator.py).

The bounce-to-bounce coherence sort must be invisible: the RNG is
content-keyed by (uid, site), so any permutation of the ray state
produces bit-identical radiance once restored to caller order.
"""

import numpy as np
import jax
import jax.numpy as jnp

from cs397raytracingsp22 import Camera, Lambertian, Metal, Plane, Scene, Sphere, Triangle
from cs397raytracingsp22.models.geometry import StaticMesh
from cs397raytracingsp22.models import transform as tf
from cs397raytracingsp22.render import integrator
from cs397raytracingsp22.utils import threefry


def _big_mesh_scene(tmp_path):
    """A scene whose mesh exceeds DENSE_MESH_MAX_TRIS → big-mesh path."""
    from cs397raytracingsp22.ops.bvh import DENSE_MESH_MAX_TRIS

    rng = np.random.default_rng(5)
    n_quads = DENSE_MESH_MAX_TRIS // 2 + 8  # triangulates past the cap
    obj = ["# synthetic"]
    for i in range(n_quads):
        c = rng.uniform(-1.0, 1.0, 3)
        a = c + rng.uniform(-0.05, 0.05, 3)
        b = c + rng.uniform(-0.05, 0.05, 3)
        d = c + rng.uniform(-0.05, 0.05, 3)
        e = c + rng.uniform(-0.05, 0.05, 3)
        for p in (a, b, d, e):
            obj.append(f"v {p[0]} {p[1]} {p[2]}")
        base = 4 * i + 1
        obj.append(f"f {base} {base+1} {base+2} {base+3}")
    path = tmp_path / "blob.obj"
    path.write_text("\n".join(obj) + "\n")

    white = Lambertian(albedo=(0.7, 0.7, 0.7))
    light = Lambertian(albedo=(0, 0, 0), emission=(10.0, 10.0, 10.0))
    objects = [
        Plane(point=(0, -1.5, 0), normal=(0, 1, 0), material=white),
        Sphere(center=(1.8, 0.0, 0.0), radius=0.5,
               material=Metal(albedo=(0.9, 0.8, 0.6), roughness=0.2)),
        Triangle(a=(-1, 3, -1), b=(1, 3, -1), c=(1, 3, 1), material=light),
        StaticMesh.load_from_file(
            str(path), material=white, transform=tf.translate(0, 0, 0)
        ),
    ]
    cam = Camera(
        eyepoint=(0, 0.5, 4), view_dir=(0, -0.1, -1), up=(0, 1, 0),
        focal_length=0.9, screen_width=16, screen_height=16,
        aa_sample_count=2, path_depth=5, max_trace_dist=50.0, gamma=2.0,
    )
    return Scene(camera=cam, objects=objects)


def test_sorted_path_trace_bit_identical(tmp_path):
    scene = _big_mesh_scene(tmp_path)
    data = scene.compile()
    assert len(data.dense_mesh_ids) < len(data.meshes), "mesh must take the big path"

    n = 512
    key = threefry.key_words(7)
    rng = np.random.default_rng(3)
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    tgt = jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = tgt - o
    uids = jnp.asarray(rng.permutation(n).astype(np.int32))  # non-ascending

    rad_plain, segs_plain = integrator.path_trace(
        data, o, d, uids, key, 5, 50.0, sort_rays=False
    )
    rad_sorted, segs_sorted = integrator.path_trace(
        data, o, d, uids, key, 5, 50.0, sort_rays=True
    )
    np.testing.assert_array_equal(np.asarray(rad_plain), np.asarray(rad_sorted))
    assert float(segs_plain) == float(segs_sorted)
    assert float(jnp.abs(rad_plain).sum()) > 0.0


def test_oct_normal_roundtrip():
    """Octahedral corner-normal quantization: decode(encode(n)) within
    ~6e-4 rad of the unit input (worst case near octahedron diagonals),
    and host decode matches expectations."""
    from cs397raytracingsp22.models.scene import _oct_decode, _oct_encode

    rng = np.random.default_rng(0)
    n = rng.normal(size=(5000, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    dec = _oct_decode(_oct_encode(n))
    np.testing.assert_allclose(np.linalg.norm(dec, axis=-1), 1.0, atol=1e-6)
    dots = np.clip(np.sum(dec * n, axis=-1), -1, 1)
    ang = np.arccos(dots)
    assert ang.max() < 6e-4, ang.max()

    # axis directions are exact
    axes = np.eye(3)
    dec_axes = _oct_decode(_oct_encode(np.concatenate([axes, -axes])))
    np.testing.assert_allclose(dec_axes, np.concatenate([axes, -axes]), atol=1e-6)


def test_sort_apply_take_matches_multi_operand_sort():
    """The take-based permutation apply (_sort_state apply="take") must be
    BIT-identical to the 16-operand lax.sort it replaces: lax.sort is
    stable and iota breaks ties in input order, so both paths realize
    the same permutation — including duplicate coherence keys and the
    extra_i rider."""
    rng = np.random.default_rng(11)
    n = 4096
    o = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    thr = jnp.asarray(rng.uniform(size=(n, 3)), jnp.float32)
    rad = jnp.asarray(rng.uniform(size=(n, 3)), jnp.float32)
    uids = jnp.asarray(rng.integers(0, 2**31, n), jnp.uint32)
    pos = jnp.arange(n, dtype=jnp.int32)
    alive = jnp.asarray(rng.uniform(size=n) < 0.4)
    extra = jnp.asarray(rng.integers(0, 7, n), jnp.int32)

    ref = integrator._sort_state(o, d, thr, rad, uids, pos, alive, extra,
                                 apply="sort")
    out = integrator._sort_state(o, d, thr, rad, uids, pos, alive, extra,
                                 apply="take")

    assert out[4].dtype == ref[4].dtype
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_big_mesh_vis_bits_semantics(tmp_path):
    """_big_mesh_vis_bits: the miss bit is SET for rays whose slab
    interval against the big mesh's world AABB is empty and CLEAR for
    rays aimed at it; the bits land above the position/direction Morton
    in the coherence key (so rays that miss the mesh pack together);
    without the scene the key has none. Pure sort-key semantics — image
    invariance under the key change is
    test_sorted_path_trace_bit_identical."""
    scene = _big_mesh_scene(tmp_path)
    data = scene.compile()
    big = [i for i in range(len(data.meshes))
           if i not in data.dense_mesh_ids]
    assert big, "fixture must have a big mesh"

    # the blob mesh spans roughly [-1.05, 1.05]^3 at identity transform
    o = jnp.asarray([[0.0, 0.0, 4.0], [0.0, 0.0, 4.0], [5.0, 0.0, 0.0]],
                    jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0],   # toward the mesh -> hit
                     [0.0, 0.0, 1.0],    # away -> miss
                     [-1.0, 0.0, 0.0]],  # toward from +x -> hit
                    jnp.float32)
    vis, nbits = integrator._big_mesh_vis_bits(data, o, d, max_bits=8)
    assert nbits == len(big)
    v = np.asarray(vis)
    assert v[0] & 1 == 0
    assert v[1] & 1 == 1
    assert v[2] & 1 == 0

    alive = jnp.ones((3,), bool)
    key_on = np.asarray(integrator._coherence_key(o, d, alive, scene=data))
    key_off = np.asarray(integrator._coherence_key(o, d, alive))
    pbits, qbits = integrator.KEY_BITS
    shift = 3 * (pbits + qbits)
    np.testing.assert_array_equal(key_on, key_off | (v << shift))
    assert (key_off >> shift == 0).all()  # vis sits above pos|dir bits
