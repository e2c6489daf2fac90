"""cs397raytracingsp22 — a wavefront Monte-Carlo path-tracing framework in JAX.

A from-scratch rebuild of the capabilities of the reference Rust CPU ray
tracer (mbk6/CS397RayTracingSP22) as an idiomatic JAX/XLA wavefront
renderer:

- Scene descriptions compile to flat structure-of-arrays pytrees
  (sphere/plane/triangle tables, concatenated mesh vertex/index buffers,
  threaded flat BVHs, a material parameter table, and a packed texture
  atlas) instead of the reference's `Arc<dyn Intersectable>` object graph.
- The recursive `shade_ray` (reference src/util/tracing.rs:300-324) becomes
  an iterative bounce loop over ray megabatches with alive masks.
- Per-hit `Arc<dyn Material>` dynamic dispatch (tracing.rs:113) becomes a
  branchless masked BSDF switch over a material-type enum.
- Ambient `rand::thread_rng()` becomes counter-based threefry keyed by
  (pixel, sample, bounce) — renders are deterministic given a seed.
- rayon row-parallelism (tracing.rs:228) becomes pixel/sample sharding over
  a `jax.sharding.Mesh` via `shard_map`.

Public API mirrors the reference's scene-description surface: `Camera`,
`Scene`, `Sphere`, `Triangle`, `Plane`, `ConvexVolume`, `StaticMesh`, and
the material types `Lambertian`, `Metal`, `Dielectric`,
`ParameterizedMaterial`, `Isotropic`.
"""

import os as _os

import jax as _jax

# Persistent compilation cache: JAX itself honours JAX_COMPILATION_CACHE_DIR;
# without it the cache lives in the checkout (<repo>/.jax_cache, git-ignored).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from cs397raytracingsp22.models.camera import (
    Camera,
    CameraProjectionMode,
    ShadingMode,
)
from cs397raytracingsp22.models.materials import (
    Dielectric,
    Isotropic,
    Lambertian,
    Metal,
    ParameterizedMaterial,
)
from cs397raytracingsp22.models.geometry import (
    ConvexVolume,
    Plane,
    Sphere,
    StaticMesh,
    Triangle,
)
from cs397raytracingsp22.models.scene import Scene

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "CameraProjectionMode",
    "ShadingMode",
    "Scene",
    "Sphere",
    "Triangle",
    "Plane",
    "ConvexVolume",
    "StaticMesh",
    "Lambertian",
    "Metal",
    "Dielectric",
    "ParameterizedMaterial",
    "Isotropic",
]
