"""North-star metric 2: wall time to 64 spp, Cornell 512² (BASELINE.json).

Measures the full driver path (device-resident HDR accumulation — the
radiance stays on device between spp chunks and transfers once at the
end), steady-state after one warm run. Target: ≥100× the measured
native C++ CPU reference (BASELINE.md records the honest arithmetic).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from scenes import cornell
from cs397raytracingsp22.render.driver import render_to_image


def main():
    scene = cornell.build(width=512, height=512, spp=64, path_depth=10)
    data = scene.compile()
    img1, st1 = render_to_image(scene, seed=0, verbose=False, scene_data=data)
    print("warm:", st1.summary(), flush=True)
    best = None
    for i in range(3):
        img, st = render_to_image(scene, seed=0, verbose=False, scene_data=data)
        rate = st.path_segments / st.wall_seconds / 1e6
        print(
            f"run{i}: wall {st.wall_seconds:.3f}s  segs {st.path_segments:.0f}"
            f"  seg-rate {rate:.0f} Mrays/s",
            flush=True,
        )
        if best is None or st.wall_seconds < best:
            best = st.wall_seconds
    assert (np.asarray(img) == np.asarray(img1)).all(), "non-deterministic!"
    print(json.dumps({
        "metric": "time_to_64spp_cornell512_s",
        "value": round(best, 4),
        "unit": "s",
    }), flush=True)


if __name__ == "__main__":
    main()
