"""BASELINE config 2: Utah teapot OBJ under BVH with smooth vertex
normals, hard shadows (Phong debug mode — the reference's shadow-ray
shading, tracing.rs:277-297).

Defaults to the ~6k-triangle spec mesh (assets/teapot_6k.obj, the
midpoint subdivision of the reference checkout's 240-tri decimation —
BASELINE config 2 says "~6k tris target"). Pass obj_path or --set
obj_path=... for the raw 240-tri /root/reference/obj/teapot.obj."""

from __future__ import annotations

import os


from cs397raytracingsp22 import (
    Camera,
    Lambertian,
    Plane,
    Scene,
    ShadingMode,
)
from cs397raytracingsp22.models import transform as tf
from cs397raytracingsp22.models.geometry import StaticMesh

ASSET_DIR = os.environ.get("RT_ASSET_DIR", "/root/reference")


def build(
    width: int = 256,
    height: int = 256,
    spp: int = 16,
    shading: ShadingMode = ShadingMode.PHONG,
    obj_path: str | None = None,
) -> Scene:
    if obj_path is None:
        spec = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "assets", "teapot_6k.obj",
        )
        if os.path.exists(spec):
            obj_path = spec  # config-2 spec mesh (~6k tris)
        else:
            # fallback: the reference checkout's 240-tri decimation
            # (regenerate the spec mesh with tools/subdivide_teapot.py)
            obj_path = os.path.join(ASSET_DIR, "obj", "teapot.obj")

    teapot = StaticMesh.load_from_file(
        obj_path,
        material=Lambertian(albedo=(0.7, 0.45, 0.2)),
        transform=tf.translate(0.0, 0.8, 0.0)
        @ tf.rotate_x(-90.0)
        @ tf.scale(1.2),
    )
    floor = Plane(
        point=(0.0, 0.0, 0.0),
        normal=(0.0, 1.0, 0.0),
        material=Lambertian(albedo=(0.5, 0.5, 0.5)),
    )

    camera = Camera(
        eyepoint=(0.0, 1.8, 4.0),
        view_dir=(0.0, -0.25, -1.0),
        up=(0.0, 1.0, 0.0),
        focal_length=0.7,
        focus_dist=4.0,
        lens_radius=0.0,
        screen_width=width,
        screen_height=height,
        aa_sample_count=spp,
        shading_mode=shading,
        path_depth=6,
        max_trace_dist=100.0,
        gamma=2.0,
    )
    return Scene(
        camera=camera,
        objects=[teapot, floor],
        point_light_pos=(3.0, 6.0, 4.0),
        ambient=(0.1, 0.1, 0.1),
    )
