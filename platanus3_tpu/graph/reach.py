"""Seed-component reachability on the contracted graph.

The reference materializes only what its seed-driven BFS visits
(``MakeDBG``, reference ``src/DeBruijnGraph.cpp:93-155``): traversal from
each read's first solid k-mer floods the whole connected component.  The
array-native equivalent is a connected-component flood on the CONTRACTED
graph (junction nodes + unitigs as vertices), which is tiny compared to
the k-mer graph, so an iterate-until-fixpoint flood is cheap: each round
propagates "reached" across junction<->junction and junction<->unitig
edges; rounds needed = contracted-graph diameter (1 for a clean genome).

Vertices: ``v in [0, M)`` junction-final nodes; ``M + uid`` unitigs.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.graph.build import DBG
from platanus3_tpu.ops import count as count_mod
from platanus3_tpu.ops import kmer as kmer_mod

__all__ = ["reachable"]


def _edge_targets(dbg: DBG):
    """[8M] FLAT contracted-vertex target of each junction edge (-1 none),
    column-major over the 8 (side, base) slots.

    For a junction's present neighbor: the neighbor node is a junction
    (vertex = its id) or a chain member (vertex = M + uid of its chain; a
    chain node adjacent to a junction is necessarily a chain END, but any
    member state carries the uid).  Neighbors absent from the node table
    (Bloom false positives) have no vertex.

    Flat per-column processing: one [8M] array, never an [M, 8] stack.
    """
    m = dbg.nodes.shape[0]
    uid = dbg.node_state_uid
    cols = []
    for side_id, side_pres in ((dbg.left_id, dbg.left_present),
                               (dbg.right_id, dbg.right_present)):
        for b in range(4):
            nid = side_id[:, b]
            present = side_pres[:, b]
            nidc = jnp.clip(nid, 0, m - 1)
            n_jun = dbg.is_junction_final[nidc]
            n_uid = jnp.maximum(uid[2 * nidc], uid[2 * nidc + 1])
            tgt = jnp.where(n_jun, nidc, jnp.where(n_uid >= 0, m + n_uid,
                                                   -1))
            tgt = jnp.where(present & (nid >= 0) & dbg.is_junction_final,
                            tgt, -1)
            cols.append(tgt)
    return jnp.concatenate(cols)


# Staged flood (chromosome scale): like graph/build's staged pointer
# doubling, the flood runs as a host loop of batched jitted rounds above
# the threshold, so no single execution spans the whole flood (a
# repeat-tangled chromosome graph can have a contracted diameter in the
# hundreds).  Post-fixpoint rounds are identities, so batching cannot
# change the result.
_REACH_STAGED_THRESHOLD = 1 << 23
_REACH_ROUNDS_PER_EXEC = 2


def _flood_round(reach, e_tgt):
    """One propagation round.  Only ``e_tgt`` is materialized ([8M]
    int32, -1 = no edge): the edge source is ``i mod m`` (column-major
    tile) and validity is ``e_tgt >= 0``, both fused on the fly --
    keeping resident flood state to one array.  The backward pass reads
    the forward pass's result, which only accelerates propagation; the
    monotone flood's fixpoint (seed components) is unchanged."""
    nv = reach.shape[0]
    ne = e_tgt.shape[0]
    m = ne // 8
    src = jnp.arange(ne, dtype=jnp.int32) % np.int32(m)
    ok = e_tgt >= 0
    tgt_c = jnp.clip(e_tgt, 0, nv - 1)
    fwd = ok & reach[src]
    new = reach.at[jnp.where(fwd, tgt_c, nv)].set(True, mode="drop")
    back = ok & new[tgt_c]
    return new.at[jnp.where(back, src, nv)].set(True, mode="drop")


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("k",))
def _reach_setup(dbg, seed_fw, has_seed, *, k):
    """Seed-vertex resolution + initial reach mask + edge targets as
    ONE program (eager in staged mode these are ~50 unfused 47M-row
    dispatches)."""
    m, l = dbg.nodes.shape
    nv = 3 * m
    canon, _ = kmer_mod.canonical(seed_fw, k)
    table = count_mod.KmerTable(dbg.nodes, jnp.zeros((m,), jnp.int32),
                                dbg.size)
    sid = count_mod.lookup_id(table, canon)
    sid = jnp.where(has_seed, sid, -1)
    sidc = jnp.clip(sid, 0, m - 1)
    s_uid = jnp.maximum(dbg.node_state_uid[2 * sidc],
                        dbg.node_state_uid[2 * sidc + 1])
    s_vert = jnp.where(dbg.is_junction_final[sidc], sidc,
                       jnp.where(s_uid >= 0, m + s_uid, -1))
    s_vert = jnp.where(sid >= 0, s_vert, -1)
    reach = jnp.zeros((nv,), bool).at[
        jnp.where(s_vert >= 0, s_vert, nv)
    ].set(True, mode="drop")
    return reach, _edge_targets(dbg)


@jax.jit
def _staged_flood_rounds(reach, e_tgt):
    for _ in range(_REACH_ROUNDS_PER_EXEC):
        new = _flood_round(reach, e_tgt)
        changed = jnp.any(new != reach)
        reach = new
    return reach, changed


def reachable(dbg: DBG, seed_fw: jnp.ndarray, has_seed: jnp.ndarray, k: int,
              max_rounds: int = 0, staged: bool = False):
    """-> (reach_junction [M] bool, reach_unitig [2M] bool).

    ``seed_fw [R, L]``: per-read seed k-mers in forward orientation
    (``src/MakeBloomFilter.cpp:79-83``); flood starts from the vertices
    containing them.

    ``staged=True`` (eager callers only): host-looped batched flood
    rounds, one short execution each -- REQUIRED at chromosome scale
    (see ``_REACH_STAGED_THRESHOLD``); results identical.
    """
    m, l = dbg.nodes.shape
    reach, e_tgt = _reach_setup(dbg, seed_fw, has_seed, k=k)

    if staged:
        while True:
            reach, changed = _staged_flood_rounds(reach, e_tgt)
            if not bool(changed):
                break
    else:
        def body(state):
            reach, _ = state
            new = _flood_round(reach, e_tgt)
            changed = jnp.any(new != reach)
            return new, changed

        def cond(state):
            return state[1]

        reach, _ = jax.lax.while_loop(cond, lambda s: body(s),
                                      (reach, True))
    reach_junction = reach[:m] & dbg.is_junction_final
    reach_unitig = reach[m:]
    return reach_junction, reach_unitig
