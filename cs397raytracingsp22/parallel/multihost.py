"""Multi-host rendering: the same shard_map program over DCN-connected
processes (SURVEY.md §2.3 "Multi-process / multi-node DP").

The reference is a single process (tracing.rs: one `main`, rayon threads
only). The scale-out story has two tiers:

1. one host: one process, several cards over NVLink — `render_to_image`
   with a ("dp", "sp") mesh (parallel.sharding).
2. multi-host: several processes, each owning a subset of the devices,
   running the SAME jit program over one global mesh. JAX inserts the
   collectives; rendering itself needs no cross-host traffic — pixels
   are embarrassingly parallel — so the network only carries the final image
   gather (`process_allgather`) and the distributed-init handshake.

Launch recipe (one command per host):

    python -c "
    from cs397raytracingsp22.parallel import multihost
    multihost.initialize('host0:8476', num_processes=N, process_id=i)
    multihost.render_demo()"

On a cluster that JAX can discover, the argument-free form suffices;
elsewhere pass the coordinator address, process count and id. The 2-process CPU
exercise in tests/test_multihost.py runs exactly this path (spawned
subprocesses, gRPC coordinator on localhost) and asserts the multi-host
image is bit-identical to the single-process render.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
):
    """Bring up jax.distributed for a multi-process render.

    Must run BEFORE any other jax use in the process. Where JAX can
    discover the cluster all arguments are optional; on a plain GPU or
    CPU host pass them explicitly. `local_device_count` forces N virtual CPU devices per
    process (testing without a cluster).
    """
    import jax

    if local_device_count is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", local_device_count)
    kw = {}
    if coordinator_address is not None:
        kw = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif num_processes is not None or process_id is not None:
        # silently falling back to env discovery would discard the
        # caller's explicit topology (and then hang looking for a pod)
        raise ValueError(
            "num_processes/process_id require coordinator_address "
            "(pass --coordinator host:port, or none of the three for "
            "cluster discovery)"
        )
    jax.distributed.initialize(**kw)
    return jax.process_index(), jax.process_count()


def make_global_mesh(n_dp: Optional[int] = None, n_sp: int = 1):
    """A ("dp", "sp") mesh over ALL processes' devices. Device order is
    jax.devices() (process-major), so the dp axis naturally groups each
    host's pixels onto its own chips — tile assembly is per-host."""
    from cs397raytracingsp22.parallel.sharding import make_device_mesh

    return make_device_mesh(n_dp=n_dp, n_sp=n_sp)


def replicate_to_global(mesh, tree):
    """Host-local pytree (identical on every process) → global replicated
    arrays on the mesh. Required in multi-process: jit over a global mesh
    rejects host-local inputs."""
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    return multihost_utils.host_local_array_to_global_array(
        tree, mesh, jax.tree.map(lambda _: P(), tree)
    )


def shard_to_global(mesh, arr, spec):
    """Full host-local array (identical on every process) → global array
    sharded by `spec`: each process donates only its addressable slice."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: np.asarray(arr[idx])
    )


def gather_to_host(x):
    """Global (possibly non-addressable) array → full numpy on EVERY
    host. The renderer's only DCN traffic: final image / checkpoint
    assembly."""
    import jax

    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def broadcast_checkpoint(checkpoint_path: str, n_px: int, seed: int):
    """Process-0's checkpoint → (accum f32 (n_px,3) | None, spp_done,
    nee_flag) on EVERY process; nee_flag is -1 for checkpoints written
    before the flag existed. Only process 0 writes checkpoints
    (render.driver), so on hosts without a shared filesystem the other
    processes must not read their own (absent or stale) copy: a
    disagreeing spp_done gives each process a different number of
    global-mesh dispatches and the collectives deadlock. One
    broadcast_one_to_all makes process 0's view authoritative."""
    import os

    import jax
    from jax.experimental import multihost_utils

    have = np.int32(0)
    accum = np.zeros((n_px, 3), np.float32)
    sd = np.int32(0)
    nee = np.int32(-1)
    if jax.process_index() == 0 and os.path.exists(checkpoint_path):
        ckpt = np.load(checkpoint_path, allow_pickle=False)
        if ckpt["accum"].shape == (n_px, 3) and int(ckpt["seed"]) == seed:
            have = np.int32(1)
            accum = ckpt["accum"].astype(np.float32)
            sd = np.int32(ckpt["spp_done"])
            if "nee" in ckpt.files:
                nee = np.int32(ckpt["nee"])
    have, sd, nee, accum = multihost_utils.broadcast_one_to_all(
        (have, sd, nee, accum)
    )
    if not int(have):
        return None, 0, -1
    return np.asarray(accum), int(sd), int(nee)


def render_to_image_multihost(scene, n_sp: int = 1, seed: int = 0, **kw):
    """Full multi-host render: global ("dp","sp") mesh over every
    process's devices, unified driver loop (chunking, checkpoint, retry,
    progress — render.driver.render_to_image). Every process executes
    the same program and returns the same image."""
    from cs397raytracingsp22.render.driver import render_to_image

    mesh = make_global_mesh(n_sp=n_sp)
    return render_to_image(scene, seed=seed, mesh=mesh, **kw)
