"""Config-4 END-TO-END at HEAD: full 512² spec through the real driver.

BASELINE.json config 4 (earth-textured + normal-mapped sphere meshes,
defocus-blur camera) at the scene's committed spec (512², 32 spp,
depth 8) — the staged static-width executor path. Prints the warm-run
steady-state segment rate and wall; BASELINE.md's "Config 4 end-to-end"
section records the result (round-4 gap: the 14× truncation win lived
only in a commit message; chunk-level numbers are not end-to-end).

Run on the card: python tools/bench_config4_e2e.py [spp]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from scenes import textured_spheres
from cs397raytracingsp22.render.driver import render_to_image


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    pc = int(sys.argv[2]) if len(sys.argv) > 2 else None
    scene = textured_spheres.build(width=512, height=512, spp=spp)
    data = scene.compile()
    # cold run: compile + schedule measure
    img1, st1 = render_to_image(scene, seed=0, verbose=False,
                                scene_data=data, pixel_chunk=pc)
    print("cold:", st1.summary(), flush=True)
    best = None
    for i in range(2):
        img, st = render_to_image(scene, seed=0, verbose=False,
                                  scene_data=data, pixel_chunk=pc)
        rate = st.path_segments / st.wall_seconds / 1e6
        print(
            f"warm{i}: wall {st.wall_seconds:.2f}s  "
            f"segs {st.path_segments:.3g}  {rate:.2f} Mrays/s  "
            f"(steady {st.segment_mrays_per_sec:.2f})",
            flush=True,
        )
        if best is None or st.wall_seconds < best[0]:
            best = (st.wall_seconds, rate, st.segment_mrays_per_sec)
    assert (np.asarray(img) == np.asarray(img1)).all(), "non-deterministic!"
    print(json.dumps({
        "metric": "config4_e2e_512_mrays",
        "wall_s": round(best[0], 3),
        "mrays_whole_wall": round(best[1], 3),
        "mrays_steady": round(best[2], 3),
        "spp": spp,
    }), flush=True)


if __name__ == "__main__":
    main()
