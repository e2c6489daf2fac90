"""Test configuration: JAX on 8 virtual CPU devices.

Every test sees an 8-device CPU mesh, so the shard_map renderer is
exercised without a cluster (SURVEY.md §4 "multi-device without a
cluster"). Set through jax.config before the first backend use, which
also overrides any JAX_PLATFORMS in the environment.

Tests marked `gpu` need the card and skip on the CPU; run them there with

    RT_TEST_GPU=1 python -m pytest tests/ -m gpu

which leaves JAX on its default (GPU) backend.
"""

import os

import jax
import pytest

# importing the package points the persistent compilation cache at
# <checkout>/.jax_cache unless JAX_COMPILATION_CACHE_DIR is set
import cs397raytracingsp22  # noqa: F401

if os.environ.get("RT_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: run with RT_TEST_GPU=1 on the card")
    return gpus[0]
