"""Draw-site addressing for the render path's counter-based RNG.

Every random draw in a render is addressed by (seed, ray_uid, site, lane):
`ray_uid = pixel_id * spp + sample_id` identifies the ray's pixel/sample
globally, `site` identifies the draw site (camera jitter, bounce 0, bounce
1, ...). Because draws are derived from *content* (ray uid), not buffer
position, a render is bit-identical no matter how the ray megabatch is
tiled, chunked, or sharded across devices — the determinism property the
multi-device tests assert (replacing the reference's ambient thread_rng,
tracing.rs:72).

The generator itself is utils/threefry.py (counter-based Threefry-2x32,
identical on every backend).
"""

# Draw-site tags. Bounces use SITE_BOUNCE0 + bounce index.
SITE_CAMERA = 0
SITE_BOUNCE0 = 1
# NEE draw sites (render/nee.py): SITE_NEE0 + bounce index — a disjoint
# site range so enabling NEE never shifts the base path's draws (the
# indirect chain of an NEE render stays draw-identical to the plain
# path trace). Sites live in the UPPER 16 bits of the threefry counter
# (threefry.counter_uniforms: `site << 16`), so the base must stay
# below 2^16 — a larger value silently wraps to site 0 and ALIASES the
# camera-jitter draws (a measured 1.34x NEE bias before this was
# caught by tests/test_nee.py's paired-mean check).
SITE_NEE0 = 1 << 12
