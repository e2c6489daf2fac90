"""Image-regression tests: tiny deterministic renders vs committed goldens
(SURVEY.md §4 "image regression"). Goldens are produced by
tools/make_goldens.py on the CPU backend with seed 42; the content-keyed
RNG makes these bit-stable across chunkings and shardings."""

import os

import numpy as np
import pytest
from PIL import Image

from cs397raytracingsp22.render.driver import render_to_image
from tools.make_goldens import GOLDEN_DIR, configs

ALL = sorted(configs().keys())


@pytest.mark.slow
@pytest.mark.parametrize("name", ALL)
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    if not os.path.exists(path):
        pytest.skip(f"golden {name} not generated yet")
    golden = np.asarray(Image.open(path).convert("RGB"))
    scene = configs()[name]()
    img, _ = render_to_image(scene, seed=42, verbose=False)
    # Bit-exact on the same backend; allow ±1 u8 for cross-platform float
    # rounding in tonemap.
    diff = np.abs(img.astype(int) - golden.astype(int))
    assert diff.max() <= 1, f"{name}: max diff {diff.max()}, mean {diff.mean():.3f}"
