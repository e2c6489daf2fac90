"""Texture atlas + sampling semantics vs texture.rs:26-32."""

import jax.numpy as jnp
import numpy as np

from cs397raytracingsp22 import Camera, Scene
from cs397raytracingsp22.ops.intersect import sample_texture
from cs397raytracingsp22.utils.texture import TextureAtlasBuilder


def atlas_scene(images):
    """Build a SceneData whose atlas contains `images` (hack: build the
    atlas directly and graft it onto an empty compiled scene)."""
    scene = Scene(camera=Camera(), objects=[]).compile()
    b = TextureAtlasBuilder()
    ids = [b.add(img) for img in images]
    packed = b.build()
    scene = type(scene)(
        **{
            **{f.name: getattr(scene, f.name) for f in scene.__dataclass_fields__.values()},
            "tex_pixels": jnp.asarray(packed.pixels),
            "tex_offset": jnp.asarray(packed.offset),
            "tex_width": jnp.asarray(packed.width),
            "tex_height": jnp.asarray(packed.height),
        }
    )
    return scene, ids


def gradient_image(w, h):
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.arange(w)[None, :] * (255 // max(1, w - 1))
    img[..., 1] = np.arange(h)[:, None] * (255 // max(1, h - 1))
    return img


def test_v_flip_and_corners():
    img = np.zeros((2, 2, 3), np.uint8)
    img[0, 0] = [255, 0, 0]  # top-left
    img[0, 1] = [0, 255, 0]  # top-right
    img[1, 0] = [0, 0, 255]  # bottom-left
    img[1, 1] = [255, 255, 255]  # bottom-right
    scene, (tid,) = atlas_scene([img])
    uv = jnp.asarray(
        [
            [0.0, 0.999],  # u=0, v≈1 → y=(1-0.999)*2=0.002→row 0 (top-left)
            [0.999, 0.999],
            [0.0, 0.0],  # v=0 → y=min(2,1)=1 → bottom-left
            [0.999, 0.0],
        ]
    )
    out = np.asarray(sample_texture(scene, tid, uv))
    np.testing.assert_allclose(out[0], [1, 0, 0])
    np.testing.assert_allclose(out[1], [0, 1, 0])
    np.testing.assert_allclose(out[2], [0, 0, 1])
    np.testing.assert_allclose(out[3], [1, 1, 1])


def test_uv_clamping_out_of_range():
    img = gradient_image(8, 8)
    scene, (tid,) = atlas_scene([img])
    uv = jnp.asarray([[-0.5, 0.5], [1.5, 0.5], [0.5, -0.5], [0.5, 1.5]])
    out = np.asarray(sample_texture(scene, tid, uv))
    # u<0 clamps to column 0; u>1 clamps to column 7 (0.999*8=7.99→7)
    np.testing.assert_allclose(out[0, 0], img[4, 0, 0] / 255.0)
    np.testing.assert_allclose(out[1, 0], img[4, 7, 0] / 255.0)
    assert np.isfinite(out).all()


def test_multiple_textures_packed():
    a = np.full((2, 3, 3), 10, np.uint8)
    b = np.full((4, 5, 3), 200, np.uint8)
    scene, (ta, tb) = atlas_scene([a, b])
    uv = jnp.asarray([[0.5, 0.5]])
    np.testing.assert_allclose(np.asarray(sample_texture(scene, ta, uv))[0], 10 / 255.0)
    np.testing.assert_allclose(np.asarray(sample_texture(scene, tb, uv))[0], 200 / 255.0)


def test_atlas_dedup():
    img = gradient_image(4, 4)
    b = TextureAtlasBuilder()
    assert b.add(img) == b.add(img)


def test_atlas_dedup_by_content():
    # The same texture FILE loaded twice yields distinct arrays with
    # equal pixels — must pack once (content hash, not id()).
    img = gradient_image(4, 4)
    b = TextureAtlasBuilder()
    t0 = b.add(img)
    t1 = b.add(img.copy())
    assert t0 == t1
    atlas = b.build()
    assert atlas.pixels.shape[0] == 16

    # Same pixels but different shape must NOT collide (shape is part
    # of the hash key).
    c = TextureAtlasBuilder()
    flat = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    tall = flat.reshape(4, 2, 3).copy()
    assert c.add(flat) != c.add(tall)
