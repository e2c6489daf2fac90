"""Where the persistent compilation cache goes: JAX_COMPILATION_CACHE_DIR
when set (the package then sets nothing), else <checkout>/.jax_cache."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_PROBE = (
    "import jax, cs397raytracingsp22 as c\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "print(c.CACHE_DIR)\n"
)


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, check=True, timeout=300)
    return out.stdout.split()


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_cache_dir(tmp_path, env_dir):
    want_env = str(tmp_path / "cache") if env_dir else None
    configured, default = _probe(want_env)
    assert default == str(ROOT / ".jax_cache")
    assert configured == (want_env or default)


def test_checkout_cache_is_git_ignored():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
