"""The main scene: Cornell box walls, two spheres, an area light and the
committed 6,144-triangle teapot (assets/teapot_6k.obj, the mesh size of
BASELINE config 2), 512² at 64 spp and depth 8 — 16.8 M camera paths at
BASELINE config 3's settings. The teapot takes the dense mesh scan.

`build_big_mesh` puts a generated 128×128 UV sphere (32,512 triangles,
above DENSE_MESH_MAX_TRIS, so BVH traversal) in the teapot's place.
"""

from __future__ import annotations

import os

import numpy as np

from cs397raytracingsp22 import (
    Camera,
    Dielectric,
    Lambertian,
    Metal,
    Plane,
    Scene,
    Sphere,
    Triangle,
)
from cs397raytracingsp22.models import transform as tf
from cs397raytracingsp22.models.geometry import StaticMesh
from cs397raytracingsp22.utils.obj_loader import uv_sphere

TEAPOT_OBJ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "teapot_6k.obj"
)


def _cornell_objects():
    white = Lambertian(albedo=(0.73, 0.73, 0.73))
    red = Lambertian(albedo=(0.65, 0.05, 0.05))
    green = Lambertian(albedo=(0.12, 0.45, 0.15))
    light = Lambertian(albedo=(0.0, 0.0, 0.0), emission=(15.0, 15.0, 15.0))
    return [
        Plane(point=(0, 0, 0), normal=(0, 1, 0), material=white),
        Plane(point=(0, 5, 0), normal=(0, -1, 0), material=white),
        Plane(point=(0, 0, -2.5), normal=(0, 0, 1), material=white),
        Plane(point=(-2.5, 0, 0), normal=(1, 0, 0), material=red),
        Plane(point=(2.5, 0, 0), normal=(-1, 0, 0), material=green),
        Sphere(center=(1.4, 0.7, 0.6), radius=0.7, material=Metal(albedo=(0.8, 0.8, 0.9), roughness=0.05)),
        Sphere(center=(-1.6, 0.6, 1.2), radius=0.6, material=Dielectric(idx_of_refraction=1.5)),
        Triangle(a=(-1.2, 4.99, -1.5), b=(1.2, 4.99, -1.5), c=(1.2, 4.99, 0.5), material=light),
        Triangle(a=(-1.2, 4.99, -1.5), b=(-1.2, 4.99, 0.5), c=(1.2, 4.99, 0.5), material=light),
    ]


def _camera(width, height, spp, path_depth):
    return Camera(
        eyepoint=(0.0, 2.5, 7.5),
        view_dir=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        focal_length=0.8,
        focus_dist=5.0,
        screen_width=width,
        screen_height=height,
        aa_sample_count=spp,
        path_depth=path_depth,
        max_trace_dist=100.0,
        gamma=2.0,
    )


def build(width=512, height=512, spp=64, path_depth=8):
    """The main scene: Cornell box walls, two spheres, an area light and
    the committed 6,144-triangle teapot (dense mesh scan)."""
    teapot = StaticMesh.load_from_file(
        TEAPOT_OBJ,
        material=Lambertian(albedo=(0.7, 0.45, 0.2)),
        transform=tf.translate(0.0, 0.75, -0.6) @ tf.rotate_x(-90.0) @ tf.scale(1.5),
    )
    return Scene(
        camera=_camera(width, height, spp, path_depth),
        objects=_cornell_objects() + [teapot],
    )


def build_big_mesh(width=512, height=512, spp=32, path_depth=8):
    """The same Cornell box around a generated 128×128 UV sphere of
    32,512 triangles — above DENSE_MESH_MAX_TRIS, so it traverses its
    BVH."""
    sphere = StaticMesh(
        uv_sphere(128, 128),
        [None] * 5,
        Lambertian(albedo=(0.7, 0.45, 0.2)),
        (tf.translate(0.0, 1.1, -0.6) @ tf.scale(1.1)).astype(np.float32),
    )
    return Scene(
        camera=_camera(width, height, spp, path_depth),
        objects=_cornell_objects() + [sphere],
    )
