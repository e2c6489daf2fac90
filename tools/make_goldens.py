"""Regenerate the image-regression goldens (tests/goldens/*.png).

Run on the CPU backend (like the tests): deterministic given the seed.
Usage: python tools/make_goldens.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "goldens")


def configs():
    from scenes import cornell, drone_demo, teapot, textured_spheres

    return {
        "cornell_16": lambda: cornell.build(width=16, height=16, spp=8, path_depth=4),
        "cornell_metal_glass_16": lambda: cornell.build_config3(
            width=16, height=16, spp=8, path_depth=4
        ),
        # pinned to the 240-tri checkout mesh: the golden gates the
        # phong/dense code path, not the config-2 spec mesh size (the
        # 6k default would also make this golden ~25x slower to check)
        "teapot_phong_16": lambda: teapot.build(
            width=16, height=16, spp=4,
            obj_path="/root/reference/obj/teapot.obj",
        ),
        "textured_16": lambda: textured_spheres.build(width=16, height=16, spp=4),
        "demo_16": lambda: drone_demo.build(width=16, height=16, spp=4, path_depth=4),
    }


def main():
    from cs397raytracingsp22.render.driver import render_to_image, save_png

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, build in configs().items():
        scene = build()
        img, stats = render_to_image(scene, seed=42, verbose=False)
        path = os.path.join(GOLDEN_DIR, f"{name}.png")
        save_png(img, path)
        print(f"{name}: mean={img.mean():.2f} → {path}")


if __name__ == "__main__":
    main()
