"""Sliding-window minimum via doubling (sparse-table) decomposition.

Array analog of the reference's monotonic-deque sliding minimum (misnamed
``RMQ``, reference ``src/MakeBloomFilter.cpp:8-22``): for window width
``w`` over a vector ``v`` it yields ``out[j] = min(v[j : j+w])`` with
``len(out) = len(v) - w + 1``.  The deque is inherently sequential;
``lax.reduce_window`` expresses the parallel version as an O(w)-per-element
windowed reduction.  The sparse-table trick is O(log w) shifted
elementwise mins instead: build ``m_p[j] = min(v[j:j+p])`` for the largest
power of two ``p <= w`` by doubling, then combine two overlapping
p-windows.  ~3 elementwise passes for the production w=5.

Used to turn per-position short-k-mer counts into a conservative coverage
estimate per large k-mer (reference ``src/MakeBloomFilter.cpp:62``):
window width = ``k - short_k + 1``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["window_min"]


def window_min(values: jnp.ndarray, window: int) -> jnp.ndarray:
    """Windowed min over the last axis, VALID padding.

    values: ``[..., P]`` int32; returns ``[..., P - window + 1]``.
    """
    assert window >= 1
    if window == 1:
        return values
    assert values.shape[-1] >= window
    p = 1
    m = values
    while p * 2 <= window:
        m = jnp.minimum(m[..., : m.shape[-1] - p], m[..., p:])
        p *= 2
    # m[j] = min(v[j : j+p]) with w/2 < p <= w: two overlapping p-windows
    # starting at j and j + w - p cover [j, j + w) exactly.
    out_len = values.shape[-1] - window + 1
    return jnp.minimum(m[..., :out_len],
                       m[..., window - p : window - p + out_len])
