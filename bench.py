"""Benchmark: Cornell box + 6,144-triangle teapot, 512² at 64 spp, depth 8.

Its last line is one JSON object: Mrays/s of traced path segments
(steady state, after compile) on the main scene, and the wall time to
64 spp of the Cornell box at 512² through the full driver, beside the
device it ran on (platform, kind, count, and the card's name and power
limit from `nvidia-smi`). It fails when JAX finds no GPU.

    python bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cs397raytracingsp22.render.driver import render_chunk, render_to_image
    from cs397raytracingsp22.utils import threefry
    from chip_smoke import device_line
    from scenes import cornell, cornell_teapot

    device = device_line()
    spp = 64
    width = height = 512
    scene = cornell_teapot.build(width, height, spp=spp)
    data = scene.compile()
    cam = scene.camera

    # One dispatch per 2^20-ray chunk: steady-state segment rate of the
    # one-program executor, compile excluded.
    n_px = width * height
    chunk_px = min(n_px, (1 << 20) // spp)
    key = threefry.key_words(0)
    all_ids = [
        jnp.arange(ci * chunk_px, (ci + 1) * chunk_px, dtype=jnp.int32)
        for ci in range(n_px // chunk_px)
    ]
    rad, segs = render_chunk(data, cam, all_ids[0], key, jnp.int32(0), spp, 1)
    jax.block_until_ready(rad)

    t0 = time.perf_counter()
    seg_list = [
        render_chunk(data, cam, ids, key, jnp.int32(0), spp, 1)[1]
        for ids in all_ids
    ]
    jax.block_until_ready(seg_list)
    wall = time.perf_counter() - t0
    mrays = float(np.sum([float(s) for s in seg_list])) / wall / 1e6

    # Wall time to 64 spp on the Cornell box at 512² through the driver:
    # best of two runs after a warm one.
    sc64 = cornell.build(width=512, height=512, spp=64, path_depth=10)
    d64 = sc64.compile()
    render_to_image(sc64, seed=0, verbose=False, scene_data=d64)
    t64 = min(
        render_to_image(sc64, seed=0, verbose=False, scene_data=d64)[1].wall_seconds
        for _ in range(2)
    )

    print(json.dumps({
        "metric": "Mrays_per_sec_cornell_teapot6k_512_64spp",
        "value": mrays,
        "unit": "Mrays/s",
        "time_to_64spp_cornell512_s": t64,
        "device": device,
    }))


if __name__ == "__main__":
    main()
