"""Implicit de Bruijn graph -> junction/joint/unitig decomposition,
as bulk array passes.

Array re-design of ``DeBruijnGraph`` (reference
``src/DeBruijnGraph.cpp``).  The reference materializes the graph node by
node: seed-driven BFS, one thread per k-mer, 8 Bloom probes per step,
mutex-guarded hash maps (``MakeDBG``/``SearchNode``/``ExtendLeft/Right``,
``src/DeBruijnGraph.cpp:93-297``).  None of that suits an accelerator.  The
same decomposition falls out of three data-parallel facts:

* a node's class depends only on its own 8-neighborhood:
  ``junction <=> left_degree != 1 or right_degree != 1``
  (``SearchNode``'s branch, ``src/DeBruijnGraph.cpp:167``); the walk loops
  in ``ExtendLeft/Right`` continue exactly while the visited node has
  degree pattern (1,1), so "unitig interior" == (1,1) nodes;

* maximal runs of (1,1) nodes are chains in a functional graph whose
  successor map is computable per-node (one gather each), so chain
  contraction is pointer doubling: O(log N) rounds of
  ``ptr = ptr[ptr]`` instead of a sequential walk;

* reverse-complement symmetry is handled by working on DIRECTED STATES
  ``s = 2*node + orientation``: every chain appears once per direction and
  a canonical keep-rule dedups the mirror copy.

Degrees are counted through the same membership oracle the reference uses
-- the Bloom filter (``IsRecorded``, ``src/DeBruijnGraph.cpp:317-323``) --
so false-positive behavior matches; an exact-membership mode (node-table
lookups) is available as an upgrade the reference cannot express.

Glossary mapping to the reference:
  junction node  -> ``junctions`` map entry  (``AddJunctionNode``)
  joint node     -> ``joints`` map entry     (chain ends, ``AddJointNode``)
  straight node  -> ``straights`` unitig     (``AddStraightNode``)
  lone (1,1) node between junctions -> junction (``SearchNode``
      "cannot extend" branch, ``src/DeBruijnGraph.cpp:212-216``)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.ops import bloom as bloom_mod
from platanus3_tpu.ops import count as count_mod
from platanus3_tpu.ops import kmer as kmer_mod

__all__ = ["DBG", "build_graph", "phantom_neighbors"]

_NO_STATE = np.int32(-1)



class DBG(NamedTuple):
    """Array-form de Bruijn graph decomposition.  ``M`` = node capacity
    (static), ``size`` = valid node count; states ``s = 2*v + o`` where
    ``o=0`` means the canonical (stored) orientation.

    nodes:        ``[M, L] uint32`` sorted canonical solid k-mers
    size:         scalar int32
    left_present / right_present: ``[M, 4] bool`` membership of the 4
                  left/right neighbors (via Bloom -- includes FPs, like the
                  reference's ``CheckDirections``)
    left_id / right_id: ``[M, 4] int32`` node id of each neighbor's
                  canonical form, -1 if not in the node table
    left_isfw / right_isfw: ``[M, 4] bool`` neighbor's traversal form ==
                  its canonical form
    is_junction:  ``[M] bool``  degree != (1,1)   (raw, before lone-chain
                  promotion)
    is_junction_final: ``[M] bool``  junction or lone chain node
    is_joint:     ``[M] bool``  end node of a kept chain (n>=2)
    joint_uid:    ``[M] int32`` unitig id a joint bounds, -1 otherwise
    node_state_uid / node_state_pos: ``[2M] int32`` per-state unitig
                  membership (-1 when not a member of a kept chain),
                  indexed by state ``s = 2*node + o`` (flat, like
                  every per-state array)
    unitig_head / unitig_tail: ``[U] int32`` head/tail STATE of each kept
                  chain (U = M capacity -- kept chains have >= 2 disjoint
                  nodes so num_unitigs <= M/2; first num_unitigs valid)
    unitig_len:   ``[U] int32`` number of chain nodes n (sequence length =
                  k + n - 1)
    unitig_circular: ``[U] bool`` chain was a junction-free cycle (the
                  reference's traversal would not terminate on these)
    num_unitigs:  scalar int32
    """

    nodes: jnp.ndarray
    size: jnp.ndarray
    left_present: jnp.ndarray
    right_present: jnp.ndarray
    left_id: jnp.ndarray
    right_id: jnp.ndarray
    left_isfw: jnp.ndarray
    right_isfw: jnp.ndarray
    is_junction: jnp.ndarray
    is_junction_final: jnp.ndarray
    is_joint: jnp.ndarray
    joint_uid: jnp.ndarray
    node_state_uid: jnp.ndarray
    node_state_pos: jnp.ndarray
    state_next_id: jnp.ndarray   # [2M] raw rightward continuation node id
                                 # per state (valid for (1,1) nodes; -1 if
                                 # the neighbor is not in the node table)
    state_next_o: jnp.ndarray    # [2M] orientation the continuation is
                                 # encountered in (0 = canonical)
    unitig_head: jnp.ndarray
    unitig_tail: jnp.ndarray
    unitig_len: jnp.ndarray
    unitig_circular: jnp.ndarray
    num_unitigs: jnp.ndarray


jax.tree_util.register_pytree_node(
    DBG,
    lambda g: (tuple(g), None),
    lambda _, leaves: DBG(*leaves),
)


# Above this node count the 8-neighbor resolution runs as 8 separate
# per-(side, base) sort-joins instead of one fused 9M-row join: the fused
# join's transient sort buffers are ~9x the node table and dominate peak
# HBM at chromosome scale (VERDICT r2 weak #5), while 8 joins of 2M rows
# peak at ~2x the table for ~1.8x the sorted-row count.
_NEIGHBOR_CHUNK_THRESHOLD = 1 << 22


from functools import partial as _jit_partial


@_jit_partial(jax.jit, static_argnames=("side", "k", "use_exact"))
def _neighbor_one(nodes, size, bf, base, *, side, k, use_exact):
    """Resolve ONE (side, base) neighbor column: shifted k-mer ->
    canonical -> node-table sort-join (+ membership)."""
    m, l = nodes.shape
    shift_fn = kmer_mod.shift_in_left if side == 0 else kmer_mod.shift_in_right
    table = count_mod.KmerTable(nodes, jnp.zeros((m,), jnp.int32), size)
    u = shift_fn(nodes, base, k)
    canon, u_isfw = kmer_mod.canonical(u, k)
    nid_b = count_mod.lookup_id_join(table, canon, k=k)
    pres = (nid_b >= 0 if use_exact
            else bloom_mod.bloom_query(bf, canon, k))
    return nid_b, u_isfw, pres


def _neighbor_info(nodes, size, k, bf, use_exact):
    """Membership/id/orientation of all 8 neighbors of every node.

    Neighbor canonical forms are resolved against the node table with
    sort-joins (``lookup_id_join``) instead of 8 binary searches -- the
    neighbor-resolution analog of ``CheckDirections``'s 8 Bloom probes
    (reference ``src/DeBruijnGraph.cpp:325-345``) but batched over every
    node at once.  Small graphs fuse all 8*M queries into one join;
    large graphs join per (side, base) to bound peak memory (see
    ``_NEIGHBOR_CHUNK_THRESHOLD``).
    """
    m, l = nodes.shape
    row_valid = jnp.arange(m) < size
    table = count_mod.KmerTable(nodes, jnp.zeros((m,), jnp.int32), size)

    if m > _NEIGHBOR_CHUNK_THRESHOLD:
        nid_cols, isfw_cols, pres_cols = [], [], []
        for side in range(2):
            for b in range(4):
                # One jitted program per join, reused across all 8
                # (side, base) pairs (base is a traced scalar), so the
                # STAGED build does not run this phase as hundreds of
                # unfused eager op dispatches.
                nid_b, u_isfw, pres_b = _neighbor_one(
                    nodes, size, bf, np.uint32(b), side=side, k=k,
                    use_exact=use_exact)
                nid_cols.append(nid_b)
                isfw_cols.append(u_isfw)
                pres_cols.append(pres_b)
        nid = jnp.stack(nid_cols, axis=1)          # [M, 8]
        all_isfw = jnp.stack(isfw_cols, axis=1)    # [M, 8]
        pres = jnp.stack(pres_cols, axis=1)
    else:
        canons, isfws = [], []
        for shift_fn in (kmer_mod.shift_in_left, kmer_mod.shift_in_right):
            for b in range(4):
                u = shift_fn(nodes, np.uint32(b), k)
                canon, u_isfw = kmer_mod.canonical(u, k)
                canons.append(canon)
                isfws.append(u_isfw)
        all_canon = jnp.stack(canons, axis=1)      # [M, 8, L]
        all_isfw = jnp.stack(isfws, axis=1)        # [M, 8]
        nid = count_mod.lookup_id_join(
            table, all_canon.reshape(-1, l), k=k).reshape(m, 8)
        if use_exact:
            pres = nid >= 0
        else:
            pres = bloom_mod.bloom_query(bf, all_canon, k)
    pres = pres & row_valid[:, None]

    lp, rp = pres[:, :4], pres[:, 4:]
    lid, rid = nid[:, :4], nid[:, 4:]
    lfw, rfw = all_isfw[:, :4], all_isfw[:, 4:]
    return lp, lid, lfw, rp, rid, rfw


def phantom_neighbors(dbg: DBG, k: int):
    """Canonical k-mers of Bloom-positive neighbors ABSENT from the node
    table: ``([M*8, L] uint32, [M*8] bool mask)``.

    The reference enqueues every Bloom-positive neighbor during traversal
    (``SearchNode``/``Extend*`` push to ``visiting``, reference
    ``src/DeBruijnGraph.cpp:167-179, 248-258``), so false-positive k-mers
    that never occur in any read become REAL graph nodes.  The array
    pipeline reproduces that closure by iterating: build graph ->
    collect phantom (present, id<0) neighbors -> merge into the node
    table -> rebuild, until fixpoint (pipeline Bloom mode).
    """
    nodes = dbg.nodes
    m, l = nodes.shape
    canons = []
    for shift_fn in (kmer_mod.shift_in_left, kmer_mod.shift_in_right):
        for b in range(4):
            u = shift_fn(nodes, np.uint32(b), k)
            canon, _ = kmer_mod.canonical(u, k)
            canons.append(canon)
    all_canon = jnp.stack(canons, axis=1).reshape(m * 8, l)
    pres = jnp.concatenate([dbg.left_present, dbg.right_present], axis=1)
    nid = jnp.concatenate([dbg.left_id, dbg.right_id], axis=1)
    mask = (pres & (nid < 0)).reshape(m * 8)
    return all_canon, mask


# ---- pointer-doubling round bodies (module level: the staged path jits
# them directly, and a module-level jit's shape-keyed cache means the
# simplify / bloom-closure graph REBUILDS at chromosome scale reuse the
# compiled round executables instead of re-tracing per build_graph call
# (ADVICE r4)).

def _body0(_, c):
    ptr, minv = c
    return (ptr[ptr],
            jnp.minimum(minv, minv[ptr]))


def _body1(c):
    # Chain loop carries only (ptr, dist): the per-chain min member and
    # min FLIPPED member that used to ride here as two extra gathers per
    # round are both recoverable from loop 0's reachable-min (cyc_min):
    # at a chain head h, cyc_min[h] is the min member of h's chain, and
    # cyc_min[flip(tail[h])] is the min member of the MIRROR chain
    # (flip(tail) is the mirror's head; for broken cycles, flip(tail)
    # lies on the mirror cycle whose pre-break reachable set is the
    # whole cycle) -- i.e. the min of flipped members.  Halves the
    # gather traffic of the longest doubling loop.
    i, ptr, dist, _ = c
    p2 = ptr[ptr]
    dist = dist + dist[ptr]
    return (i + 1, p2, dist, jnp.all(p2 == ptr))


@_jit_partial(jax.jit, static_argnames=("k",))
def _successor_states(nodes, size, lp, lid, lfw, rp, rid, rfw, *, k):
    """Degrees, junction mask, and the per-state successor map, as ONE
    jitted program (the staged build would otherwise run it as ~50
    unfused eager op dispatches)."""
    m, l = nodes.shape
    row_valid = jnp.arange(m, dtype=jnp.int32) < size
    ldeg = jnp.sum(lp, axis=1)
    rdeg = jnp.sum(rp, axis=1)
    is_junction = ((ldeg != 1) | (rdeg != 1)) & row_valid
    chain_node = (~is_junction) & row_valid

    # Palindrome flags of neighbors (orientation propagation, even k).
    # Per-COLUMN [M]-index gathers: never an [M, 4, L] intermediate.
    if k % 2 == 0:
        def pal_of(ids):
            cols = []
            for b in range(4):
                idb = ids[:, b]
                idc = jnp.clip(idb, 0, m - 1)
                cols.append(kmer_mod.is_palindrome(nodes[idc], k)
                            & (idb >= 0))
            return jnp.stack(cols, axis=1)
        lpal = pal_of(lid)
        rpal = pal_of(rid)
    else:
        lpal = jnp.zeros_like(lp)
        rpal = jnp.zeros_like(rp)

    def pick(arr, b):
        return jnp.take_along_axis(arr, b[:, None], axis=1)[:, 0]

    rb = jnp.argmax(rp, axis=1).astype(jnp.int32)
    lb = jnp.argmax(lp, axis=1).astype(jnp.int32)
    r_id, r_fw, r_pal = pick(rid, rb), pick(rfw, rb), pick(rpal, rb)
    l_id, l_fw, l_pal = pick(lid, lb), pick(lfw, lb), pick(lpal, lb)

    # Walking right in canonical orientation (o=0): encountered form is
    # the raw right neighbor; next orientation 0 iff that form is
    # canonical.
    nxt0_id = r_id
    nxt0_o = jnp.where(r_fw, 0, 1).astype(jnp.int32)
    # Walking right in reversed orientation (o=1): encountered form is
    # revcomp(left neighbor); canonical iff the left neighbor is NOT
    # canonical (or palindromic).
    nxt1_id = l_id
    nxt1_o = jnp.where(l_fw & ~l_pal, 1, 0).astype(jnp.int32)

    def state_of(ids, orient):
        ok = chain_node & (ids >= 0)
        ok = ok & chain_node[jnp.clip(ids, 0, m - 1)]
        s = ids * 2 + orient
        return ok, s

    ok0, s0 = state_of(nxt0_id, nxt0_o)
    ok1, s1 = state_of(nxt1_id, nxt1_o)
    states = jnp.arange(2 * m, dtype=jnp.int32)
    # Build nxt FLAT over the 2M states (gathers from [M] per-node
    # arrays by node id).
    node_of_s = states >> 1
    odd = (states & 1) == 1
    nxt = jnp.where(odd,
                    jnp.where(ok1[node_of_s],
                              s1[node_of_s], states),
                    jnp.where(ok0[node_of_s],
                              s0[node_of_s], states))
    chain_state = chain_node[node_of_s]
    nxt = jnp.where(chain_state, nxt, states)
    state_next_id = jnp.where(odd, nxt1_id[node_of_s],
                              nxt0_id[node_of_s])
    state_next_o = jnp.where(odd, nxt1_o[node_of_s],
                             nxt0_o[node_of_s])
    return (is_junction, chain_node, chain_state, nxt,
            state_next_id, state_next_o)


# Staged mode: doubling rounds batched per XLA execution, so the host's
# convergence test (one scalar fetch) is paid once per 4 rounds.
_STAGED_ROUNDS_PER_EXEC = 4

# Active-set compaction tiers for the staged doubling loops.  A state's
# carry stops changing exactly when its pointer has reached a fixpoint
# (monotone: once converged, every later round is an identity), so after
# each batch the still-changing states are the only ones whose rounds do
# work -- yet the full-array batch keeps gathering all 2M rows.  When
# the changed count fits a tier, the loop switches to COMPACTED rounds:
# carry rows only for active states, gather targets from and scatter
# results back to the full-size global arrays each round (gather-all-
# then-scatter preserves the synchronous round semantics bit-exactly).
# Tiers are FIXED fractions of the state count so each loop compiles at
# most len(_COMPACT_TIERS) extra shapes, reused across rebuilds.
# Payoff is shape-dependent: a repeat-tangled graph (realistic chr21:
# 762k chains averaging 37 nodes over 56.8M states) converges ~99% of
# states within 2 batches, leaving 5+ batches to run at 1/8..1/128 of
# the full-row cost; a junction-free random genome (42k-node average
# chains) only sheds the last few batches.
_COMPACT_TIERS = (8, 32, 128)


def _compact_pad(n_active: int, m2: int):
    """Smallest tier capacity holding ``n_active`` rows, or None when
    only the full array does."""
    best = None
    for frac in _COMPACT_TIERS:
        cap = max(m2 // frac, 16)
        if n_active <= cap:
            best = cap
    return best

from functools import partial as _partial


# The ``changed`` masks below compare the LAST SINGLE ROUND only, never
# the whole batch: ``ptr[s]`` unchanged over one round means ``ptr[s]``
# is a fixpoint of the map, which (acyclic chains AND cycles alike)
# happens exactly when s's doubling reach is complete -- so min/dist are
# final too and the state can retire from the active set.  A batch-level
# comparison is UNSOUND on cycles: a length-c cycle looks unchanged
# across a 4-round batch whenever c divides 2^i * 15 (e.g. c=5 at round
# 8) yet keeps rotating afterwards.


@_partial(jax.jit, static_argnames=("r",))
def _staged_round0(c, *, r: int):
    ptr, minv = c
    for _ in range(r - 1):
        ptr, minv = _body0(None, (ptr, minv))
    p2, minv = _body0(None, (ptr, minv))
    changed = p2 != ptr
    return p2, minv, jnp.all(p2 == ptr), changed


@_partial(jax.jit, static_argnames=("r",))
def _staged_round1(c, *, r: int):
    for _ in range(r - 1):
        c = _body1(c)
    prev_ptr = c[1]
    c = _body1(c)
    changed = c[1] != prev_ptr
    return c, changed


# ---- compacted round programs (active rows only; see _COMPACT_TIERS).
# ``idx [pad]`` holds the active states' ids (fill = m2, out of range:
# gathers clamp to a junk-but-in-range row, scatters drop).  Each round
# gathers the targets' PREVIOUS-round values from the globals first and
# scatters the new carries back after -- identical to the synchronous
# full-array round restricted to rows that can still change.


@_partial(jax.jit, static_argnames=("r",))
def _compact_round0(idx, ptr_a, min_a, ptr_g, min_g, *, r: int):
    m2 = ptr_g.shape[0]
    valid = idx < m2
    p_prev = ptr_a
    for _ in range(r):
        p_prev = ptr_a
        pg = ptr_g[ptr_a]
        mg = min_g[ptr_a]
        ptr_a = pg
        min_a = jnp.minimum(min_a, mg)
        ptr_g = ptr_g.at[idx].set(ptr_a, mode="drop")
        min_g = min_g.at[idx].set(min_a, mode="drop")
    changed = (ptr_a != p_prev) & valid
    return ptr_a, min_a, ptr_g, min_g, changed, jnp.sum(changed)


@_partial(jax.jit, static_argnames=("r",))
def _compact_round1(idx, ptr_a, dist_a, ptr_g, dist_g, *, r: int):
    m2 = ptr_g.shape[0]
    valid = idx < m2
    p_prev = ptr_a
    for _ in range(r):
        p_prev = ptr_a
        pg = ptr_g[ptr_a]
        dg = dist_g[ptr_a]
        dist_a = dist_a + dg
        ptr_a = pg
        ptr_g = ptr_g.at[idx].set(ptr_a, mode="drop")
        dist_g = dist_g.at[idx].set(dist_a, mode="drop")
    changed = (ptr_a != p_prev) & valid
    return ptr_a, dist_a, ptr_g, dist_g, changed, jnp.sum(changed)


def _compact_select(mask, pad, m2, idx=None, *carries):
    """Active-row ids (+ carries) compacted to ``pad`` rows.  With
    ``idx`` given, ``mask``/``carries`` are in COMPACT coordinates of
    the previous tier and are re-based through it."""
    sub = jnp.nonzero(mask, size=pad, fill_value=mask.shape[0])[0]
    sub = sub.astype(jnp.int32)
    ok = sub < mask.shape[0]
    sub_c = jnp.clip(sub, 0, mask.shape[0] - 1)
    new_idx = (jnp.where(ok, sub, m2) if idx is None
               else jnp.where(ok, idx[sub_c], m2))
    return (new_idx,) + tuple(c[sub_c] for c in carries)


def _staged_doubling(loop, init_carry, rounds, probe=None):
    """Host-driven doubling loop with batched rounds and active-set
    compaction.  ``loop`` is 0 (cycle detection: carry (ptr, min)) or 1
    (chains: carry (ptr, dist)); returns the two final global arrays.

    Phase 1 runs `_STAGED_ROUNDS_PER_EXEC`-round batches over the full
    state array, keeping the pre-batch carry to derive the changed set
    (one scalar fetch per batch -- the same sync the early-exit test
    already paid).  Once the changed count fits a `_COMPACT_TIERS`
    capacity, phase 2 runs compacted batches, re-basing to a smaller
    tier whenever the count allows.  Results are bit-identical to the
    all-full-array loop: rounds past a state's convergence are
    identities, and compact rounds replay the exact synchronous update
    on the only rows that can still change.
    """
    a_g, b_g = init_carry
    m2 = a_g.shape[0]
    batch = _STAGED_ROUNDS_PER_EXEC
    full_round = _staged_round0 if loop == 0 else _staged_round1
    comp_round = _compact_round0 if loop == 0 else _compact_round1
    done_rounds = 0
    idx = None
    a_c = b_c = None
    pad = None
    while done_rounds < rounds:
        # Exact round budget (last batch may be short): cycle states
        # rotate forever, so running past ``rounds`` would leave their
        # pointers at a different (production-benign but not
        # bit-identical-to-jitted) rotation.
        r_b = min(batch, rounds - done_rounds)
        if idx is None:
            if loop == 0:
                a_g, b_g, done, changed = _staged_round0((a_g, b_g),
                                                         r=r_b)
            else:
                c, changed = _staged_round1(
                    (jnp.zeros((), jnp.int32), a_g, b_g,
                     jnp.zeros((), bool)), r=r_b)
                _, a_g, b_g, done = c
            done_rounds += r_b
            if bool(done):
                break
            n_act = int(jnp.sum(changed))
            pad = _compact_pad(n_act, m2)
            if pad is not None and pad < m2:
                idx, a_c, b_c = _compact_select(
                    changed, pad, m2, None, a_g, b_g)
                if probe is not None:
                    probe(f"compact@{done_rounds}r->{pad}", idx)
        else:
            a_c, b_c, a_g, b_g, changed, n_ch = comp_round(
                idx, a_c, b_c, a_g, b_g, r=r_b)
            done_rounds += r_b
            n_act = int(n_ch)
            if n_act == 0:
                break
            npad = _compact_pad(n_act, m2)
            if npad is not None and npad < pad:
                idx, a_c, b_c = _compact_select(
                    changed, npad, m2, idx, a_c, b_c)
                pad = npad
                if probe is not None:
                    probe(f"recompact@{done_rounds}r->{pad}", idx)
    return a_g, b_g


@jax.jit
def _finalize_chains(nxt_orig, chain_state, chain_node, is_junction,
                     cyc_head, cyc_min, tail, d2t):
    """Heads, mirror dedup, unitig slots, membership, joints -- one
    jitted program (the staged build would otherwise run it as ~30
    unfused eager op dispatches).

    Per-chain minima come from loop 0's reachable-min (``cyc_min``): at
    a chain head h, cyc_min[h] is the min member state of h's chain, and
    cyc_min[flip(tail[h])] is the min member of the MIRROR chain
    (flip(tail) is the mirror's head; for broken cycles it lies on the
    mirror cycle, whose pre-break reachable set is the whole cycle) --
    exactly the min of flipped members the old 4-gather loop carried.
    """
    m2 = chain_state.shape[0]
    m = m2 // 2
    states = jnp.arange(m2, dtype=jnp.int32)
    flip = states ^ 1
    minall = cyc_min
    fmin = cyc_min[tail ^ 1]

    # prev state: s has a predecessor iff its flip has a successor in the
    # PRE-break map (nxt_orig[flip]==flip means flip is a tail -> s is a
    # head).  Using the broken map here would also make the flip of a
    # mirror cycle's break-tail look like a head mid-cycle.  Cycle heads
    # are heads by construction.
    has_prev = chain_state & (nxt_orig[flip] != flip) \
        & ~cyc_head
    is_head = chain_state & ~has_prev

    # Mirror dedup: every chain appears once per direction; keep the copy
    # whose minimum member state is <= the mirror's minimum.  Strictly
    # smaller for distinct mirror pairs; EQUAL exactly when the chain is
    # its own mirror (a palindromic unitig whose spelled sequence equals
    # its reverse complement) -- '<=' keeps it once.
    keep = is_head & (minall <= fmin)

    n_nodes = d2t + 1  # chain length in nodes, per head

    # Lone chains (n == 1): promoted to junction (reference
    # ``src/DeBruijnGraph.cpp:212-216``).
    lone_state = is_head & (d2t == 0)
    lone_node = lone_state[0::2] | lone_state[1::2]  # flat: no [M, 2]
    is_junction_final = is_junction | (chain_node & lone_node)

    real_head = keep & (d2t >= 1)

    # ---- unitig ids, membership, positions ------------------------------
    uid_of_head = jnp.cumsum(real_head.astype(jnp.int32)) - 1
    num_unitigs = jnp.sum(real_head.astype(jnp.int32))
    # Capacity M suffices: kept chains have >= 2 states and are
    # state-disjoint over the 2M states, so num_unitigs <= M.
    head_tgt = jnp.where(real_head, uid_of_head, m)
    unitig_head = jnp.full((m,), _NO_STATE).at[head_tgt].set(
        states, mode="drop")
    unitig_tail = jnp.full((m,), _NO_STATE).at[head_tgt].set(
        tail, mode="drop")
    unitig_len = jnp.zeros((m,), jnp.int32).at[head_tgt].set(
        n_nodes, mode="drop")
    unitig_circular = jnp.zeros((m,), bool).at[head_tgt].set(
        cyc_head, mode="drop")

    # member -> head via the chain's unique tail state
    head_by_tail = jnp.full((m2,), _NO_STATE).at[
        jnp.where(real_head, tail, m2)].set(states, mode="drop")
    my_head = head_by_tail[tail]  # -1 if chain not kept
    member = chain_state & (my_head >= 0)
    my_head_c = jnp.clip(my_head, 0, m2 - 1)
    uid = jnp.where(member, uid_of_head[my_head_c],
                    -1).astype(jnp.int32)
    pos = jnp.where(member, d2t[my_head_c] - d2t, -1)

    # joints: end nodes of kept chains
    head_node = unitig_head >> 1
    tail_node = unitig_tail >> 1
    valid_u = jnp.arange(m) < num_unitigs
    uslot = jnp.arange(m, dtype=jnp.int32)
    tgt_h = jnp.where(valid_u, head_node, m)
    tgt_t = jnp.where(valid_u, tail_node, m)
    is_joint = jnp.zeros((m,), bool).at[tgt_h].set(True, mode="drop")
    is_joint = is_joint.at[tgt_t].set(True, mode="drop")
    joint_uid = jnp.full((m,), np.int32(-1)).at[tgt_h].max(
        uslot, mode="drop")
    joint_uid = joint_uid.at[tgt_t].max(uslot, mode="drop")
    return (is_junction_final, is_joint, joint_uid, uid, pos,
            unitig_head, unitig_tail, unitig_len, unitig_circular,
            num_unitigs)


def build_graph(nodes: jnp.ndarray, size, k: int,
                bf: bloom_mod.BloomFilter, use_exact: bool = False,
                staged: bool = False) -> DBG:
    """Construct the full decomposition from a sorted canonical node table.

    ``nodes``: ``[M, L] uint32`` sorted unique solid canonical k-mers
    (padding rows of 0xFFFFFFFF past ``size``).

    ``staged=True`` runs the two pointer-doubling loops as HOST loops of
    short device executions instead of ``lax.fori/while_loop``, and must
    be called OUTSIDE jit (eager).  The pipeline selects it above a node
    count (``pipeline._STAGE2_STAGED_THRESHOLD``): each execution stays
    short, and once most states have converged the remaining rounds run
    over the still-active rows only (``_COMPACT_TIERS``).  Results are
    identical: the host loop applies the same round update and stops at
    the same fixpoint.
    """
    m, l = nodes.shape
    rounds = max(1, int(2 * m).bit_length())
    row_valid = jnp.arange(m, dtype=jnp.int32) < size

    lp, lid, lfw, rp, rid, rfw = _neighbor_info(nodes, size, k, bf, use_exact)
    # ---- successor states (one jitted program; see _successor_states) --
    (is_junction, chain_node, chain_state, nxt,
     state_next_id, state_next_o) = _successor_states(
        nodes, size, lp, lid, lfw, rp, rid, rfw, k=k)
    states = jnp.arange(2 * m, dtype=jnp.int32)

    # ---- cycle detection & breaking -------------------------------------
    # One fused doubling loop over the PRE-break map yields tail0 AND the
    # min reachable state id.  The min rides UNMASKED (every state id, not
    # just cyclic ones): at a cyclic state the reachable set is exactly
    # its cycle, so the value equals the old masked cyc_min wherever it is
    # read (cyc_head and the break test gate on ``cyclic`` first); at
    # acyclic states it is never consumed.
    if staged:
        # A few rounds per XLA execution (module-level jit, so simplify /
        # bloom-closure rebuilds at identical shapes reuse the compiled
        # executable instead of re-jitting, ADVICE r4).  Post-fixpoint
        # applications are identities, so batching rounds cannot change
        # the result (doubling past convergence leaves ptr/min/dist
        # unchanged).  Once the changed set fits a _COMPACT_TIERS
        # capacity, rounds run COMPACTED over the still-active rows only
        # (_staged_doubling).
        tail0, cyc_min = _staged_doubling(0, (nxt, states), rounds)
    else:
        tail0, cyc_min = jax.lax.fori_loop(0, rounds, _body0,
                                           (nxt, states))
    cyclic = (nxt[tail0] != tail0) & chain_state
    cyc_head = cyclic & (cyc_min == states)
    # Break each cycle just before its (min-state) head.
    nxt_orig = nxt
    nxt = jnp.where(cyclic & (nxt == cyc_min), states, nxt)
    del tail0, cyclic  # staged-mode hygiene (cyc_min still feeds keep)

    # ---- chains ----------------------------------------------------------
    # Second fused loop on the broken (acyclic) map: tail + distance +
    # min member state + min FLIPPED member state share one ptr-doubling
    # chain (4 gathers/round instead of 8 across separate loops), and the
    # loop exits as soon as every pointer is a fixpoint -- ~log2(longest
    # chain) rounds, not log2(2M) (a repeat-rich graph's chains are
    # hundreds of nodes while M is millions).
    flip = states ^ 1
    big = np.int32(2**30)

    def _cond1(c):
        return (c[0] < rounds) & ~c[3]

    carry1 = (jnp.zeros((), jnp.int32), nxt,
              (nxt != states).astype(jnp.int32),
              jnp.zeros((), bool))
    if staged:
        tail, d2t = _staged_doubling(
            1, (nxt, (nxt != states).astype(jnp.int32)), rounds)
    else:
        _, tail, d2t, _ = jax.lax.while_loop(_cond1, _body1, carry1)
    del carry1, nxt  # staged-mode hygiene
    (is_junction_final, is_joint, joint_uid, node_state_uid,
     node_state_pos, unitig_head, unitig_tail, unitig_len,
     unitig_circular, num_unitigs) = _finalize_chains(
        nxt_orig, chain_state, chain_node, is_junction, cyc_head,
        cyc_min, tail, d2t)
    del nxt_orig, cyc_head, cyc_min, tail, d2t, chain_state, states

    return DBG(
        nodes=nodes, size=jnp.asarray(size, jnp.int32),
        left_present=lp, right_present=rp,
        left_id=lid, right_id=rid,
        left_isfw=lfw, right_isfw=rfw,
        is_junction=is_junction,
        is_junction_final=is_junction_final,
        is_joint=is_joint, joint_uid=joint_uid,
        node_state_uid=node_state_uid, node_state_pos=node_state_pos,
        state_next_id=state_next_id, state_next_o=state_next_o,
        unitig_head=unitig_head, unitig_tail=unitig_tail,
        unitig_len=unitig_len, unitig_circular=unitig_circular,
        num_unitigs=num_unitigs,
    )
