"""Preview a running render from its checkpoint accumulator.

The driver persists the HDR accumulation buffer (and spp progress) after
every spp chunk (render/driver.py checkpoint_path). This tool tonemaps
that buffer with the same channel-bleed + gamma pipeline as the final
image (ops/tonemap.py, reference tracing.rs:241-256), so a 1000-spp
render can be inspected at any point without interrupting it.

Usage: python tools/preview_checkpoint.py ckpt.npz out.png WIDTH HEIGHT [GAMMA]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv):
    if len(argv) < 5:
        print(__doc__)
        return 1
    ckpt_path, out_path = argv[1], argv[2]
    w, h = int(argv[3]), int(argv[4])
    gamma = float(argv[5]) if len(argv) > 5 else 2.2

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from cs397raytracingsp22.ops import tonemap as tonemap_ops
    from cs397raytracingsp22.render.driver import save_png

    d = np.load(ckpt_path, allow_pickle=False)
    accum = d["accum"]
    spp_done = int(d["spp_done"])
    if accum.shape[0] != w * h:
        print(f"checkpoint has {accum.shape[0]} pixels, not {w}x{h}")
        return 1
    mean = (accum / max(spp_done, 1)).astype(np.float32).reshape(h, w, 3)
    img = np.asarray(tonemap_ops.tonemap(jnp.asarray(mean), gamma))
    save_png(img, out_path)
    print(f"[preview] {out_path}: {spp_done} spp accumulated")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
