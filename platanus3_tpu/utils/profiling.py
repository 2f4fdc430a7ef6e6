"""Profiling hooks.

The reference has no tracing/profiling at all (SURVEY.md §5); its closest
artifact is the per-node log spam.  Here: (a) stage-level wall-clock is
built into PipelineLog timestamps; (b) this module adds an opt-in
``jax.profiler`` trace around a pipeline run producing a TensorBoard/
Perfetto trace directory, plus a tiny stage-timer utility used by perf
scripts.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Wrap a region in a jax.profiler trace (no-op when dir is falsy)."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield


class StageTimer:
    """Accumulates named wall-clock spans.  With ``barriers=True`` each
    mark first waits (``jax.block_until_ready``) for the arrays passed as
    ``sync``, so a span ends when the device work does."""

    def __init__(self, barriers: bool = False):
        self.spans = {}
        self.barriers = barriers
        self._last = time.time()

    def mark(self, name: str, sync=None):
        """Record time since the previous mark as span ``name``.

        ``sync``: optional pytree of device arrays; when the timer was
        built with ``barriers=True`` they are blocked on first, so the
        span measures actual device completion rather than dispatch.
        """
        if self.barriers and sync is not None:
            import jax
            jax.block_until_ready(sync)
        now = time.time()
        self.spans[name] = self.spans.get(name, 0.0) + now - self._last
        self._last = now

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        total = sum(self.spans.values()) or 1.0
        lines = [f"{name}: {dt:.3f}s ({100 * dt / total:.0f}%)"
                 for name, dt in sorted(self.spans.items(),
                                        key=lambda kv: -kv[1])]
        return "\n".join(lines)
