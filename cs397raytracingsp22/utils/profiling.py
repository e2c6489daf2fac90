"""Phase timing + device profiling (SURVEY.md §5 tracing/profiling).

The reference's only instrumentation is a progress bar and println
status lines (tracing.rs:223-224). Here:

- `PhaseTimer` collects named wall-clock phases (load / compile-scene /
  compile-kernel / render / tonemap) for the per-render summary.
- `device_trace` wraps jax.profiler.trace so a render can emit a full
  XLA trace viewable in TensorBoard/Perfetto (`RT_PROFILE_DIR=... python
  -m cs397raytracingsp22.cli ...`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict


class PhaseTimer:
    def __init__(self):
        self.phases: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def summary(self) -> str:
        return " | ".join(f"{k}: {v:.2f}s" for k, v in self.phases.items())


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Capture a jax.profiler trace when a directory is configured.

    Activated by the RT_PROFILE_DIR env var or an explicit argument;
    no-op otherwise (zero overhead in production renders).
    """
    log_dir = log_dir or os.environ.get("RT_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
