"""BASELINE config 4: earth-textured + normal-mapped spheres with a
defocus-blur camera, 512².

Texture-mapped spheres are realized the way the reference does it: a
sphere OBJ mesh (with UVs) carrying albedo + normal maps
(tracing.rs:395-404), plus analytic spheres for the material grid.
"""

from __future__ import annotations

import os

from cs397raytracingsp22 import (
    Camera,
    Lambertian,
    ParameterizedMaterial,
    Plane,
    Scene,
    Sphere,
    Triangle,
)
from cs397raytracingsp22.models import transform as tf
from cs397raytracingsp22.models.geometry import StaticMesh

ASSET_DIR = os.environ.get("RT_ASSET_DIR", "/root/reference")


def build(
    width: int = 512,
    height: int = 512,
    spp: int = 32,
    lens_radius: float = 0.08,
    mesh_obj: str | None = None,
) -> Scene:
    if mesh_obj is None:
        mesh_obj = os.path.join(ASSET_DIR, "obj", "sphere.obj")
    tex = lambda name: os.path.join(ASSET_DIR, "texture", name)

    earth = StaticMesh.load_from_file(
        mesh_obj,
        albedo_path=tex("earthmap.jpg"),
        normal_path=tex("normal_test.png"),
        transform=tf.translate(-1.1, 1.0, 0.0) @ tf.rotate_y(90.0) @ tf.scale(1.0),
    )
    magenta = StaticMesh.load_from_file(
        mesh_obj,
        albedo_path=tex("magenta.jpg"),
        normal_path=tex("normal_test.jpg"),
        transform=tf.translate(1.4, 0.8, 0.8) @ tf.rotate_y(45.0) @ tf.scale(0.8),
    )

    floor = Plane(
        point=(0.0, 0.0, 0.0),
        normal=(0.0, 1.0, 0.0),
        material=ParameterizedMaterial(
            albedo=(0.33, 0.33, 0.33), metallic=0.3, roughness=0.7
        ),
    )
    light = Lambertian(albedo=(0.0, 0.6, 0.0), emission=(7.0, 7.0, 7.0))
    objects = [
        earth,
        magenta,
        floor,
        Sphere(center=(0.2, 0.5, 2.2), radius=0.5,
               material=ParameterizedMaterial(albedo=(0.01, 0.02, 0.5), roughness=0.2, metallic=0.8)),
        Triangle(a=(-2.5, 7.5, -0.5), b=(2.5, 7.5, -0.5), c=(2.5, 7.5, 3.5), material=light),
        Triangle(a=(-2.5, 7.5, -0.5), b=(-2.5, 7.5, 3.5), c=(2.5, 7.5, 3.5), material=light),
    ]

    camera = Camera(
        eyepoint=(0.0, 1.6, 5.0),
        view_dir=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        focal_length=0.6,
        focus_dist=5.0,
        lens_radius=lens_radius,
        screen_width=width,
        screen_height=height,
        aa_sample_count=spp,
        path_depth=8,
        max_trace_dist=100.0,
        gamma=2.0,
    )
    return Scene(camera=camera, objects=objects)
