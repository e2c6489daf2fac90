"""Pixel-tile + sample sharding over a jax.sharding.Mesh.

The reference's only parallelism is rayon fork-join over image rows on one
machine (tracing.rs:228). The equivalent here is SPMD over a device
mesh with two axes:

- "dp" (data parallel): the pixel batch shards across devices — tiles are
  embarrassingly parallel, so this axis needs no communication at all
  until image assembly (XLA gathers the sharded output).
- "sp" (sample parallel): samples-per-pixel shard across devices; each
  device integrates its slice of the spp range and the per-pixel sums are
  combined with one `psum` over the "sp" axis — the only collective in
  the renderer (NCCL over NVLink on one host).

Because the RNG is content-keyed (utils/rng.py), any mesh shape produces
bit-identical images to the single-device render — asserted by
tests/test_sharding.py on the 8-virtual-device CPU mesh.

Scene arrays are small (KBs–MBs) and replicated (in_spec P()); scaling
state is the ray megabatch, not the scene.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from cs397raytracingsp22.models.camera import Camera
from cs397raytracingsp22.models.scene import SceneData
from cs397raytracingsp22.render.driver import render_chunk_core

shard_map = jax.shard_map
_NO_CHECK = {"check_vma": False}


def make_device_mesh(
    n_dp: Optional[int] = None,
    n_sp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("dp", "sp") mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_sp <= 0:
        raise ValueError(f"n_sp must be positive, got {n_sp}")
    if n_dp is None:
        n_dp = len(devices) // n_sp
    if n_dp <= 0 or n_dp * n_sp > len(devices):
        raise ValueError(
            f"mesh {n_dp}x{n_sp} needs {n_dp * n_sp} devices, have "
            f"{len(devices)} (is n_sp larger than the device count?)"
        )
    arr = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(arr, ("dp", "sp"))


def make_sharded_render_chunk(
    mesh: Mesh, camera: Camera, spp: int, n_chains: int = 1
):
    """Build a jitted sharded chunk renderer for a fixed camera/spp.

    Returns fn(scene_data, pixel_ids, base_key, sample_offset) →
    (radiance_sum (N_px, 3), segments). pixel_ids length must divide by
    the mesh's dp size; spp by its sp size.
    """
    n_sp = mesh.shape["sp"]
    if spp % n_sp:
        # user input — must raise even under python -O (an assert would
        # vanish and silently floor-drop samples while the finalize
        # still divides by the full spp: a dimmed image)
        raise ValueError(f"spp {spp} not divisible by sp axis {n_sp}")
    spp_local = spp // n_sp

    def local(scene: SceneData, pixel_ids, base_key, sample_offset):
        sp_idx = jax.lax.axis_index("sp")
        local_offset = sample_offset + sp_idx * spp_local
        rad_sum, segs = render_chunk_core(
            scene, camera, pixel_ids, base_key, local_offset, spp_local, n_chains
        )
        # The renderer's one collective: combine per-device spp slices.
        rad_sum = jax.lax.psum(rad_sum, "sp")
        segs = jax.lax.psum(segs, ("dp", "sp"))
        return rad_sum, segs

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P("dp"), P(), P()),
        out_specs=(P("dp"), P()),
        **_NO_CHECK,
    )
    return jax.jit(sharded)


def make_sharded_staged_render_chunk(
    mesh: Mesh, camera: Camera, spp: int, n_chains: int = 1,
    widths: Optional[tuple] = None,
    sort_rays: bool = False,
):
    """Sharded chunk renderer through the STAGED static-width executor
    (integrator.path_trace_static; driver.StagedOptions). Each device
    traces its own ray shard with its own static truncation schedule
    (and, with sort_rays, its own local coherence sort);
    any permutation/truncation of dead rays is radiance-bit-identical
    (content-keyed RNG), so the sharded image equals the single-device
    one exactly (tests/test_sharding.py::test_sharded_staged_*).

    widths: the LOCAL per-device width schedule (len == path_depth,
    widths[0] == local ray count = |pixel_ids|/dp × spp/sp × n_chains).
    None → MEASURE variant: traces at full width and returns per-bounce
    live counts pmax'ed over every device — the bound the driver bakes
    the local schedule from (driver.render_to_image mesh branch).

    Returns fn(scene_data, pixel_ids, base_key, sample_offset) →
      (radiance_sum, segments, live_max (depth,) int32)   when measuring
      (radiance_sum, segments, ok)                        with a schedule
    where `ok` is False iff ANY device's truncation clipped a live ray
    (psum-combined) — same violation contract as the single-device
    static executor, handled by the driver's snapshot-replay.
    """
    from cs397raytracingsp22.render import integrator
    from cs397raytracingsp22.render.driver import _gen_chunk_rays

    n_sp = mesh.shape["sp"]
    if spp % n_sp:
        raise ValueError(f"spp {spp} not divisible by sp axis {n_sp}")
    spp_local = spp // n_sp
    depth = camera.path_depth

    def local(scene: SceneData, pixel_ids, base_key, sample_offset):
        sp_idx = jax.lax.axis_index("sp")
        local_offset = sample_offset + sp_idx * spp_local
        o, d, uids = _gen_chunk_rays(
            camera, pixel_ids, base_key, local_offset, spp_local, n_chains
        )
        n_local = o.shape[0]
        w = widths if widths is not None else (n_local,) * depth
        live: list = []
        rad, segs, ok = integrator.path_trace_static(
            scene, o, d, uids, base_key, depth,
            camera.max_trace_dist, widths=w,
            collect_live=live if widths is None else None,
            sort_rays=sort_rays,
        )
        n_px = pixel_ids.shape[0]
        rad_sum = jnp.sum(
            rad.reshape(n_px, spp_local * n_chains, 3), axis=1
        ) / n_chains
        rad_sum = jax.lax.psum(rad_sum, "sp")
        segs = jax.lax.psum(segs, ("dp", "sp"))
        if widths is None:
            live_max = jax.lax.pmax(
                jnp.stack([x.astype(jnp.int32) for x in live]),
                ("dp", "sp"),
            )
            return rad_sum, segs, live_max
        # schedule holds only if it held on EVERY device
        ok = jax.lax.psum(1 - ok.astype(jnp.int32), ("dp", "sp")) == 0
        return rad_sum, segs, ok

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P("dp"), P(), P()),
        out_specs=(P("dp"), P(), P()),
        **_NO_CHECK,
    )
    return jax.jit(sharded)


def render_to_image_sharded(
    scene,
    mesh: Mesh,
    seed: int = 0,
    verbose: bool = True,
    **kw,
):
    """Full sharded render: the multi-device render_to_image.

    A thin wrapper over render.driver.render_to_image(mesh=...) — the
    SAME chunk loop, device-resident accumulation, checkpoint/resume,
    retry, progress, and steady-state stats as the single-device driver.
    Pixels shard over "dp", samples over "sp"; only the final u8 image
    (and checkpoints, if enabled) cross to the host. Bit-identical to
    the single-device driver (content-keyed RNG). For multi-host
    (DCN-connected slices), initialize jax.distributed first and pass a
    global mesh — each process contributes its addressable devices;
    rendering needs no cross-host traffic beyond the final gather
    (see parallel.multihost).
    """
    from cs397raytracingsp22.render.driver import render_to_image

    return render_to_image(scene, seed=seed, verbose=verbose, mesh=mesh, **kw)
