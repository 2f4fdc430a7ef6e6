"""Node coverage + junction edge tallies as segment reductions.

Array replacement for ``DeBruijnGraph::CountNodeCoverage`` (reference
``src/DeBruijnGraph.cpp:393-449``): the reference re-scans every read with
a rolling k-mer window under ``omp critical`` sections; here the second
pass is one vectorized node-id lookup per owned read position followed by
scatter-adds (``segment_sum``) -- no locks, no serial section.

Semantics matched:

* node coverage: the reference calls ``AddNodeCoverage(fw)`` AND
  ``AddNodeCoverage(bw)`` per position (``:402-404``); a map keyed by one
  orientation matches exactly one of the two EXCEPT a palindromic k-mer
  which matches twice -- so coverage = +1 per position, +2 for
  palindromes.  Coverage is accumulated for every node id; the GFA layer
  reads it for junctions (KC tag) and joints.

* junction edge tallies ``left_kmers_cov[4]`` / ``right_kmers_cov[4]``
  (``:407-435``): at a read position whose k-mer matches a junction in
  forward orientation, the preceding read base increments the junction's
  LEFT tally and the following base its RIGHT tally; a reverse-orientation
  match mirrors both through the complement.  First/last positions of a
  read simply lack a preceding/following base (the reference's pre-loop
  block and ``i < size-1`` guard) -- here a mask.

Orientation note: the reference keys nodes by traversal-encounter
orientation; this framework keys by canonical form.  Tallies are stored
relative to the canonical orientation, and the GFA writer emits signs
relative to it too, so the output graph is isomorphic with segment
sequences possibly reverse-complemented (the documented equality contract,
SURVEY.md §4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.graph.build import DBG
from platanus3_tpu.ops import count as count_mod
from platanus3_tpu.ops import kmer as kmer_mod

__all__ = ["CoverageResult", "count_coverage"]


class CoverageResult(NamedTuple):
    node_cov: jnp.ndarray      # [M] int32 coverage per node id
    jun_tally: jnp.ndarray     # [M*8] int32 FLAT (row nid*8 + col);
                               # cols 0-3 left A/C/G/T, 4-7 right A/C/G/T.
                               # Rows are gathered only at the small
                               # junction pack (graph/emit.py).
    """Both relative to the node's canonical orientation."""


jax.tree_util.register_pytree_node(
    CoverageResult,
    lambda r: ((r.node_cov, r.jun_tally), None),
    lambda _, leaves: CoverageResult(*leaves),
)


def count_coverage(dbg: DBG, k: int, bases, valid_len, start, read_len,
                   prev_base, next_base, nid=None) -> CoverageResult:
    """One pass over the chunked read batch.

    ``bases [C, chunk_len]`` unpacked codes; ownership masks recomputed
    like the solidity stage so each global read position contributes once.

    ``nid [C, Pk] int32``: per-position node ids, when stage 1 already
    derived them from its node-table sort (count_solid_with_ids).  When
    ``None`` (sharded stage 1, checkpoint restore) they are resolved here
    with one sort-join over all positions.
    """
    m, l = dbg.nodes.shape
    c, chunk_len = bases.shape
    stride = chunk_len - k + 1

    fw, valid = kmer_mod.extract_kmers(bases, valid_len, k)
    canon, is_fw = kmer_mod.canonical(fw, k)
    pk = fw.shape[1]
    local = jnp.arange(pk, dtype=jnp.int32)[None, :]
    in_read = start[:, None] + local + k <= read_len[:, None]
    owned = (local < stride) & in_read & valid

    if nid is None:
        table = count_mod.KmerTable(dbg.nodes, jnp.zeros((m,), jnp.int32),
                                    dbg.size)
        nid = count_mod.lookup_id_join(
            table, canon.reshape(-1, l)).reshape(c, pk)
    hit = owned & (nid >= 0)
    pal = kmer_mod.is_palindrome(canon, k)

    # ---- node coverage ---------------------------------------------------
    inc = jnp.where(hit, jnp.where(pal, 2, 1), 0)
    node_cov = jax.ops.segment_sum(
        inc.reshape(-1), jnp.clip(nid, 0, m - 1).reshape(-1),
        num_segments=m).astype(jnp.int32)

    # ---- junction edge tallies ------------------------------------------
    is_jun = dbg.is_junction_final[jnp.clip(nid, 0, m - 1)] & hit

    # Neighboring read bases (global prev/next of the k-mer window).
    prev_in = jnp.concatenate(
        [prev_base[:, None].astype(jnp.int32), bases[:, : pk - 1].astype(jnp.int32)],
        axis=1)
    has_prev = jnp.where(local == 0, prev_base[:, None] < 4,
                         jnp.ones((), bool))
    # next base after window at local p is bases[p + k]
    nxt_cols = bases[:, k:].astype(jnp.int32)  # covers p = 0 .. chunk_len-k-1
    nxt_in = jnp.concatenate(
        [nxt_cols, next_base[:, None].astype(jnp.int32)], axis=1)  # [C, Pk]
    g_next_ok = start[:, None] + local + k <= read_len[:, None] - 1
    has_next = g_next_ok & jnp.where(local == pk - 1,
                                     next_base[:, None] < 4,
                                     jnp.ones((), bool))

    # Column in [M, 8] tally matrix, canonical-relative:
    #   forward hit:  left[prev], right[next]
    #   reverse hit:  right[3-prev], left[3-next]
    def scatter_tally(tally, col, active):
        flat_idx = jnp.where(active, nid * 8 + col, m * 8)
        return tally.at[flat_idx.reshape(-1)].add(1, mode="drop")

    tally = jnp.zeros((m * 8,), dtype=jnp.int32)
    p_col = jnp.where(is_fw, prev_in, 7 - prev_in)       # left[b] vs right[3-b]
    tally = scatter_tally(tally, p_col, is_jun & has_prev)
    n_col = jnp.where(is_fw, 4 + nxt_in, 3 - nxt_in)     # right[b] vs left[3-b]
    tally = scatter_tally(tally, n_col, is_jun & has_next)

    return CoverageResult(node_cov=node_cov, jun_tally=tally)
