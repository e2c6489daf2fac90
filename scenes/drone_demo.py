"""BASELINE config 5 / the reference's full demo scene (tracing.rs:354-543):
drone/cube/sphere meshes with texture sets, the 15-sphere
metallic×roughness ParameterizedMaterial grid, dielectric + emissive
spheres, two subsurface ConvexVolumes, parameterized floor, and the
2-triangle area light.

The drone's 5 TGA maps are absent from the reference checkout
(.MISSING_LARGE_BLOBS); like the reference's graceful texture fallback
(texture.rs:16-25) the drone renders with default parameters
(albedo/emission 0, metallic 0, roughness 1 — geometry.rs:260-263).
"""

from __future__ import annotations

import os

from cs397raytracingsp22 import (
    Camera,
    ConvexVolume,
    Dielectric,
    Isotropic,
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
    width: int = 100,
    height: int = 100,
    spp: int = 100,
    path_depth: int = 10,
    include_meshes: bool = True,
) -> Scene:
    tex = lambda name: os.path.join(ASSET_DIR, "texture", name)
    obj = lambda name: os.path.join(ASSET_DIR, "obj", name)

    objects = []
    if include_meshes:
        objects += [
            StaticMesh.load_from_file(
                obj("drone.obj"),
                albedo_path=tex("Drone_Albedo.tga"),
                emission_path=tex("Drone_Emission.tga"),
                metallic_path=tex("Drone_Metallic.tga"),
                roughness_path=tex("Drone_Roughness.tga"),
                normal_path=tex("Drone_Normal.tga"),
                transform=tf.translate(0.0, 1.3, 1.7)
                @ tf.rotate_y(-60.0)
                @ tf.rotate_x(180.0)
                @ tf.scale(0.0030),
            ),
            StaticMesh.load_from_file(
                obj("cube.obj"),
                albedo_path=tex("green.png"),
                normal_path=tex("normal_test.jpg"),
                transform=tf.translate(-1.7, 0.5, 2.7)
                @ tf.rotate_y(45.0)
                @ tf.scale(0.4),
            ),
            StaticMesh.load_from_file(
                obj("sphere.obj"),
                albedo_path=tex("magenta.jpg"),
                normal_path=tex("normal_test.png"),
                transform=tf.translate(1.7, 0.5, 2.7)
                @ tf.rotate_y(45.0)
                @ tf.scale(0.6),
            ),
        ]

    # ParameterizedMaterial demo grid: metallic rows × roughness columns.
    blue = (0.01, 0.02, 0.5)
    for row, metallic in ((3.3, 0.0), (4.4, 0.5), (5.5, 1.0)):
        for col, roughness in zip(
            (-2.6, -1.3, 0.0, 1.3, 2.6), (0.0, 0.25, 0.5, 0.75, 1.0)
        ):
            objects.append(
                Sphere(
                    center=(col, row, 0.0),
                    radius=0.5,
                    material=ParameterizedMaterial(
                        albedo=blue, roughness=roughness, metallic=metallic
                    ),
                )
            )

    objects += [
        Sphere(center=(-2.3, 2.0, 2.0), radius=0.4, material=Dielectric(idx_of_refraction=2.5)),
        Sphere(
            center=(2.3, 2.0, 2.0),
            radius=0.4,
            material=Lambertian(albedo=(0.3, 0.3, 0.3), emission=(0.0, 1.0, 1.0)),
        ),
        ConvexVolume(
            boundary=Sphere(center=(-3.0, 1.0, 1.0), radius=1.0,
                            material=Dielectric(idx_of_refraction=1.5)),
            phase_function=Isotropic(albedo=(1.0, 1.0, 1.0)),
            density=0.6,
        ),
        ConvexVolume(
            boundary=Sphere(center=(3.0, 1.0, 1.0), radius=1.0,
                            material=Dielectric(idx_of_refraction=1.5)),
            phase_function=Isotropic(albedo=(0.0, 0.0, 0.0)),
            density=0.8,
        ),
        Plane(
            point=(0.0, 0.0, 0.0),
            normal=(0.0, 1.0, 0.0),
            material=ParameterizedMaterial(albedo=(0.33, 0.33, 0.33), metallic=0.3, roughness=0.7),
        ),
        Triangle(
            a=(-2.5, 7.5, -0.5), b=(2.5, 7.5, -0.5), c=(2.5, 7.5, 3.5),
            material=Lambertian(albedo=(0.0, 0.6, 0.0), emission=(7.0, 7.0, 7.0)),
        ),
        Triangle(
            a=(-2.5, 7.5, -0.5), b=(-2.5, 7.5, 3.5), c=(2.5, 7.5, 3.5),
            material=Lambertian(albedo=(0.0, 0.6, 0.0), emission=(7.0, 7.0, 7.0)),
        ),
    ]

    camera = Camera(
        eyepoint=(0.0, 2.0, 5.5),
        view_dir=(0.0, 0.0, -1.0),
        up=(0.0, 1.0, 0.0),
        focal_length=0.6,
        focus_dist=5.0,
        lens_radius=0.0,
        screen_width=width,
        screen_height=height,
        aa_sample_count=spp,
        path_depth=path_depth,
        path_samples=1,
        max_trace_dist=100.0,
        gamma=2.0,
    )
    return Scene(
        camera=camera,
        objects=objects,
        point_light_pos=(0.0, 1.0, 5.0),
        ambient=(0.1, 0.1, 0.1),
    )
