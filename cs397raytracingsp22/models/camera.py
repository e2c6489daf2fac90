"""Camera model and vectorized ray generation.

Mirrors the reference camera (tracing.rs:137-209) field-for-field:
eyepoint/view_dir/up, perspective & orthographic projection, thin-lens
defocus blur, multi-jittered AA. Instead of a per-pixel Vec<Ray>, rays are
generated for a whole batch of pixels at once: (N_pix, spp) rays in one
fused jnp computation.

Replicated reference quirks (see SURVEY.md §3.5):
- the subpixel grid index uses integer division by floor(sqrt(n)) while
  the offset scaling uses float sqrt(n) (tracing.rs:169-173);
- the random jitter is a discrete integer lattice sample
  `gen_range(0..n)/n - 0.5` whose total offset can exceed one pixel
  (tracing.rs:167-168,172-173);
- orthographic ray origins ignore the eyepoint and the camera rotation
  (origin stays in camera space, tracing.rs:196) and the direction is the
  *rotated* view_dir (tracing.rs:200,204 — view_dir is rotated by the
  camera basis even though it is already a world vector);
- the camera basis is [normalize(view_dir × up), up, -view_dir] with up
  and view_dir NOT renormalized (tracing.rs:187-191).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from cs397raytracingsp22.utils import rng as rnglib
from cs397raytracingsp22.utils import sampling
from cs397raytracingsp22.utils import threefry
from cs397raytracingsp22.utils import vecmath as vm


class CameraProjectionMode(enum.Enum):
    ORTHOGRAPHIC = "orthographic"
    PERSPECTIVE = "perspective"


class ShadingMode(enum.Enum):
    PHONG = "phong"
    PATH_TRACE = "path_trace"


@dataclasses.dataclass(frozen=True)
class Camera:
    """Static camera configuration (reference tracing.rs:137-155).

    All fields are Python scalars: the camera is static configuration that
    shapes the compiled program (image dims, spp, path depth are shapes /
    loop bounds), exactly the set of knobs the reference exposes.
    """

    eyepoint: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    view_dir: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    projection_mode: CameraProjectionMode = CameraProjectionMode.PERSPECTIVE
    shading_mode: ShadingMode = ShadingMode.PATH_TRACE
    path_depth: int = 10
    path_samples: int = 1
    screen_width: int = 100
    screen_height: int = 100
    focal_length: float = 0.6
    focus_dist: float = 5.0
    lens_radius: float = 0.0
    aa_sample_count: int = 100
    max_trace_dist: float = 100.0
    gamma: float = 2.0
    # Next-event estimation (render/nee.py): a beyond-reference opt-in —
    # the default False keeps every estimator convention and parity
    # contract exactly the reference's (tracing.rs has no NEE).
    nee: bool = False

    def rotation(self) -> jnp.ndarray:
        """Camera→world rotation, columns [normalize(view×up), up, -view].

        Matches tracing.rs:187-191 including NOT normalizing up/-view.
        """
        view = jnp.asarray(self.view_dir, jnp.float32)
        up = jnp.asarray(self.up, jnp.float32)
        right = vm.normalize(jnp.cross(view, up))
        return jnp.stack([right, up, -view], axis=-1)

    def generate_rays(
        self,
        rng_key,
        pixel_ids: jnp.ndarray,
        spp: int | None = None,
        sample_offset=0,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Generate multi-jittered AA camera rays for a batch of pixels.

        Args:
          rng_key: python int seed or (2,) uint32 key words
            (utils.threefry.key_words) — the render's counter-RNG key.
          pixel_ids: (N,) int32 flat pixel indices (y * screen_width + x).
          spp: samples per pixel generated in THIS call; defaults to
            aa_sample_count.
          sample_offset: global index of the first sample — spp-chunked
            accumulation passes offsets so sample i walks the same
            subpixel grid and draws the same jitter as a single
            full-spp call (may be a traced scalar).

        Returns:
          (origins, directions), each (N, spp, 3) float32. Directions are
          normalized in camera space before rotation (tracing.rs:201), so
          primary rays are unit length like the reference's.

        Vectorized rewrite of tracing.rs:159-209.
        """
        if spp is None:
            spp = self.aa_sample_count
        if isinstance(rng_key, int):
            rng_key = threefry.key_words(rng_key)
        return _generate_rays_jit(self, rng_key, pixel_ids, spp, sample_offset)

    def _generate_rays_impl(
        self, rng_key, pixel_ids, spp: int, sample_offset
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        n_px = pixel_ids.shape[0]
        x = (pixel_ids % self.screen_width).astype(jnp.float32)
        y = (pixel_ids // self.screen_width).astype(jnp.float32)

        pixel_size = 1.0 / float(self.screen_height)
        n = float(self.aa_sample_count)
        rootn = math.sqrt(n)
        rootn_i = int(rootn)  # `rootn as u32` (tracing.rs:169-170)

        # Per-(pixel, sample) RNG keyed by content, not position. uid uses
        # the camera's TOTAL sample count so chunked calls reproduce the
        # draws of a single full-spp call.
        sample_ids = sample_offset + jnp.arange(spp, dtype=jnp.int32)
        uids = (
            pixel_ids[:, None] * jnp.int32(self.aa_sample_count)
            + sample_ids[None, :]
        )
        # 4 camera-site uniforms per ray: integer-lattice jitter x/y
        # (gen_range(0..n) → floor(u*n), tracing.rs:167-168) + lens disk.
        u4 = threefry.counter_uniforms(
            rng_key, uids.reshape(-1), rnglib.SITE_CAMERA, 4
        )
        n_int = float(self.aa_sample_count)
        rand_x = jnp.floor(u4[:, 0] * n_int).reshape(n_px, spp)
        rand_y = jnp.floor(u4[:, 1] * n_int).reshape(n_px, spp)

        # Subpixel grid walk: i/⌊√n⌋, i%⌊√n⌋ (tracing.rs:169-170), with i
        # the GLOBAL sample index so chunked accumulation still covers the
        # reference's full grid pattern.
        i = sample_ids[None, :]
        subpixel_x = (i // rootn_i).astype(jnp.float32)
        subpixel_y = (i % rootn_i).astype(jnp.float32)

        off_x = (subpixel_x - 0.5 * rootn) * pixel_size / rootn + (
            rand_x - 0.5 * n
        ) * pixel_size / n
        off_y = (subpixel_y - 0.5 * rootn) * pixel_size / rootn + (
            rand_y - 0.5 * n
        ) * pixel_size / n

        # Camera-space pixel center + jitter (tracing.rs:177-181).
        cx = pixel_size * (x[:, None] - 0.5 * self.screen_width + 0.5) + off_x
        cy = pixel_size * (0.5 + 0.5 * self.screen_height - y[:, None]) + off_y
        cz = jnp.full_like(cx, -self.focal_length)
        center = jnp.stack([cx, cy, cz], axis=-1)  # (N, spp, 3)

        rotation = self.rotation()

        if self.projection_mode is CameraProjectionMode.ORTHOGRAPHIC:
            # Quirk: origin stays in camera space, unrotated/untranslated
            # (tracing.rs:196); direction is rotation @ view_dir
            # (tracing.rs:200,204).
            origins = jnp.stack([cx, cy, jnp.zeros_like(cx)], axis=-1)
            view = jnp.asarray(self.view_dir, jnp.float32)
            d = vm.apply_mat3(rotation, view)
            directions = jnp.broadcast_to(d, origins.shape)
            return origins, directions

        # Thin-lens: random lens point, aim at the focus plane
        # (tracing.rs:182-184,197,201).
        disk = sampling.disk_vec_from_uniform(u4[:, 2:4])
        lens_origin = self.lens_radius * disk.reshape(n_px, spp, 3)
        focus_center = vm.normalize(center) * self.focus_dist
        origins = jnp.asarray(self.eyepoint, jnp.float32) + vm.apply_mat3(
            rotation, lens_origin
        )
        directions = vm.apply_mat3(
            rotation, vm.normalize(focus_center - lens_origin)
        )
        return origins, directions


@partial(jax.jit, static_argnames=("camera", "spp"))
def _generate_rays_jit(camera: "Camera", base_key, pixel_ids, spp, sample_offset):
    return camera._generate_rays_impl(base_key, pixel_ids, spp, sample_offset)
