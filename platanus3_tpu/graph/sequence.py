"""Per-state sequence character contributions.

The reference spells a unitig during its walk by concatenating one base
per step plus the seed k-mer (``SearchNode``'s left_part + kmer +
right_part, reference ``src/DeBruijnGraph.cpp:183-223``).  Array-native
version: every kept chain member state contributes exactly one character
-- the LAST base of its k-mer in the traversal orientation (the head
contributes its whole k-mer); ``graph/emit.py`` scatters these into flat
per-unitig sequence buffers on device.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from platanus3_tpu.graph.build import DBG
from platanus3_tpu.ops import kmer as kmer_mod

__all__ = ["member_chars"]


def member_chars(dbg: DBG, k: int) -> jnp.ndarray:
    """[2M] uint32 char code contributed by each node state
    (``s = 2*node + o``; flat, like every per-state DBG array).

    o=0 (canonical orientation): last base of the canonical k-mer;
    o=1: last base of the reverse complement = complement of first base.
    """
    m = dbg.nodes.shape[0]
    lastb = kmer_mod.last_base(dbg.nodes, k)
    firstb = kmer_mod.first_base(dbg.nodes, k)
    s = jnp.arange(2 * m)
    return jnp.where((s & 1) == 0, lastb[s >> 1],
                     np.uint32(3) - firstb[s >> 1])
