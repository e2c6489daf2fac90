"""Regenerate the committed render artifacts from current code.

One deterministic recipe per artifact (scene builder, resolution, spp,
seed) so `artifacts/` can always be reproduced and diffed against a
fresh render — images are bit-reproducible for a fixed code version
(content-keyed Threefry RNG).

Usage: python tools/make_artifacts.py [name ...]   (default: all)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RECIPES = {
    # name: (scene module, builder, kwargs)
    "config1_cornell.png": ("scenes.cornell", "build", dict(width=256, height=256, spp=16)),
    "config2_teapot_phong.png": ("scenes.teapot", "build", dict(width=256, height=256)),
    "config3_metal_glass.png": ("scenes.cornell", "build_config3", dict(width=256, height=256, spp=64)),
    "config3_metal_glass_512.png": ("scenes.cornell", "build_config3", dict(width=512, height=512, spp=64)),
    "config4_textured.png": ("scenes.textured_spheres", "build", dict(width=256, height=256, spp=32)),
    "config5_demo.png": ("scenes.drone_demo", "build", dict(width=128, height=128, spp=16)),
    "bench_cornell_teapot_512.png": ("scenes.cornell_teapot", "build", dict(width=512, height=512, spp=64)),
    # BASELINE config-5 FULL SPEC: 1.05G primary rays; its time on the
    # card is not measured. Run on demand:
    #   python tools/make_artifacts.py config5_demo_1024_1000spp.png
    "config5_demo_1024_1000spp.png": ("scenes.drone_demo", "build", dict(width=1024, height=1024, spp=1000)),
    # BASELINE config-4 at spec resolution
    "config4_textured_512.png": ("scenes.textured_spheres", "build", dict(width=512, height=512, spp=64)),
}

# artifacts regenerated by the no-argument invocation (the full-spec
# config-5 and config-4 renders are opt-in by name)
DEFAULT_SKIP = {
    "config5_demo_1024_1000spp.png",
    "config4_textured_512.png",
}


def main(argv):
    import importlib

    from cs397raytracingsp22.render.driver import render_to_image, save_png

    names = argv[1:] or [n for n in RECIPES if n not in DEFAULT_SKIP]
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")
    for name in names:
        mod_name, fn_name, kwargs = RECIPES[name]
        scene = getattr(importlib.import_module(mod_name), fn_name)(**kwargs)
        t0 = time.time()
        img, stats = render_to_image(scene, seed=0, verbose=False)
        save_png(img, os.path.join(out_dir, name))
        print(f"{name}: {stats.summary()}")


if __name__ == "__main__":
    main(sys.argv)
