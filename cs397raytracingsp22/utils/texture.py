"""Texture loading and the packed texture atlas.

The reference wraps one `image::DynamicImage` per texture and samples it
nearest-neighbor per hit (texture.rs:12-33). Array design: all
textures in a scene are packed into ONE flat (total_pixels, 3) uint8
buffer with per-texture (offset, width, height) tables, so a batch of hits
samples with a single gather — no per-texture dispatch.

Sampling semantics replicate texture.rs:26-32 exactly:
  x = min(u32(clamp(u, 0, 0.999) * w), w-1)
  y = min(u32((1 - clamp(v, 0, 0.999)) * h), h-1)
  rgb = pixel / 255
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def load_image(path: str) -> np.ndarray | None:
    """Load an image file to (H, W, 3) uint8; None if the file is missing.

    Mirrors Texture::load_from_file's graceful None for absent files
    (texture.rs:16-25) — the reference's drone TGA maps are absent and the
    scene must still render. PNG is decoded with the standard library
    (utils/png.py); other formats (JPG, TGA) need Pillow, and a missing
    decoder raises instead of silently dropping the texture.
    """
    if not os.path.isfile(path):
        return None
    if path.lower().endswith(".png"):
        from cs397raytracingsp22.utils.png import read_png

        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path!r} needs Pillow (only PNG is decoded without it)"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


@dataclasses.dataclass
class TextureAtlas:
    """Packed scene textures: row-major pixels concatenated per texture."""

    pixels: np.ndarray  # (P, 3) uint8
    offset: np.ndarray  # (T,) int32 — start index into pixels
    width: np.ndarray  # (T,) int32
    height: np.ndarray  # (T,) int32


class TextureAtlasBuilder:
    def __init__(self):
        self._images: list[np.ndarray] = []
        # content hash → texture id: the same texture file loaded twice
        # (e.g. by two meshes) packs once; id()-keyed dedup would store
        # duplicate pixel runs in the atlas.
        self._index: dict[bytes, int] = {}
        self._id_cache: dict[int, int] = {}  # id(array) → texture id

    def add(self, img: np.ndarray) -> int:
        """Register an (H, W, 3) uint8 image, returning its texture id."""
        fast = id(img)
        if fast in self._id_cache:
            return self._id_cache[fast]
        import hashlib

        key = hashlib.sha1(
            img.shape[0].to_bytes(4, "little")
            + np.ascontiguousarray(img).tobytes()
        ).digest()
        tid = self._index.get(key)
        if tid is None:
            tid = len(self._images)
            self._images.append(img)
            self._index[key] = tid
        self._id_cache[fast] = tid
        return tid

    def build(self) -> TextureAtlas:
        if not self._images:
            # 1-pixel placeholder so compiled arrays are never empty.
            self._images.append(np.zeros((1, 1, 3), np.uint8))
        offsets, ws, hs, flats = [], [], [], []
        cursor = 0
        for img in self._images:
            h, w, _ = img.shape
            offsets.append(cursor)
            ws.append(w)
            hs.append(h)
            flats.append(img.reshape(-1, 3))
            cursor += h * w
        return TextureAtlas(
            pixels=np.concatenate(flats, axis=0),
            offset=np.asarray(offsets, np.int32),
            width=np.asarray(ws, np.int32),
            height=np.asarray(hs, np.int32),
        )
