"""Device-side emission packing: sequences + compact junction tables.

The naive output path pulls the ENTIRE graph pytree to the host
(O(node-capacity) arrays -- gigabytes at chromosome scale) and assembles
unitig strings in Python.  This module keeps output work on device and
transfers only what the GFA actually contains:

* ``materialize_sequences``: scatters every unitig's characters into one
  flat ``uint8`` code array (head k-mers expanded with a static k-step
  loop; one scatter for all member chars), with per-unitig offsets --
  total transfer = total sequence bytes, i.e. about genome size;

* ``pack_junctions``: gathers the reached-junction rows and everything
  their S/L lines need (k-mer lanes, coverage, tallies, per-direction
  neighbor ids/presence/orientation + neighbor role attributes) into
  ``[jun_cap, ...]`` arrays.

Host code (io/gfa.py) then renders strings from compact arrays only.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.graph.build import DBG
from platanus3_tpu.ops import kmer as kmer_mod

__all__ = ["SeqPack", "JunPack", "materialize_sequences", "pack_junctions"]


class SeqPack(NamedTuple):
    flat: jnp.ndarray      # [char_cap] uint8 base codes (0..3)
    offs: jnp.ndarray      # [ucap + 1] int32 exclusive offsets
    ulen: jnp.ndarray      # [ucap] int32 chain length (nodes)
    circular: jnp.ndarray  # [ucap] bool


class JunPack(NamedTuple):
    node_id: jnp.ndarray   # [jun_cap] node row (m = invalid)
    kmers: jnp.ndarray     # [jun_cap, L]
    cov: jnp.ndarray       # [jun_cap]
    tally: jnp.ndarray     # [jun_cap, 8]
    nbr_id: jnp.ndarray    # [jun_cap, 8] neighbor node id (-1 absent)
    nbr_present: jnp.ndarray  # [jun_cap, 8] membership (tally gate partner)
    nbr_isfw: jnp.ndarray  # [jun_cap, 8] neighbor encountered canonically
    nbr_isjun: jnp.ndarray  # [jun_cap, 8] neighbor is a junction
    nbr_joint_uid: jnp.ndarray  # [jun_cap, 8] neighbor's unitig (-1)
    nbr_joint_fw: jnp.ndarray   # [jun_cap, 8] queried neighbor state lies on
                                # the unitig's KEPT (stored) walk -- the
                                # GFA sign for Straight_* endpoints, matching
                                # the reference's joint-map orientation hit
                                # (src/DeBruijnGraph.cpp:480-505,520-541)


for _cls in (SeqPack, JunPack):
    jax.tree_util.register_pytree_node(
        _cls,
        lambda p: (tuple(p), None),
        (lambda cls: (lambda _, leaves: cls(*leaves)))(_cls),
    )


@partial(jax.jit, static_argnames=("k", "ucap", "char_cap"))
def materialize_sequences(dbg: DBG, chars, *, k: int, ucap: int,
                          char_cap: int) -> SeqPack:
    """Build the flat sequence-code array for the first ``ucap`` unitig
    slots (dense ids).  ``chars`` = member_chars(dbg, k) ``[2M]``."""
    m, l = dbg.nodes.shape
    head = dbg.unitig_head[:ucap]
    ulen = dbg.unitig_len[:ucap]
    circ = dbg.unitig_circular[:ucap]
    valid_u = jnp.arange(ucap) < dbg.num_unitigs
    seq_len = jnp.where(valid_u, ulen + (k - 1), 0)
    offs = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(seq_len).astype(jnp.int32)])

    flat = jnp.zeros((char_cap,), jnp.uint8)

    # Head k-mers: k static scatters of [ucap] chars each.
    hnode = jnp.clip(head >> 1, 0, m - 1)
    ho = head & 1
    hk = dbg.nodes[hnode]  # [ucap, L]
    base_off = offs[:ucap]
    for j in range(k):
        fw = kmer_mod.base_at(hk, j, k)
        rc = np.uint32(3) - kmer_mod.base_at(hk, k - 1 - j, k)
        ch = jnp.where(ho == 0, fw, rc).astype(jnp.uint8)
        tgt = jnp.where(valid_u, base_off + j, char_cap)
        flat = flat.at[tgt].set(ch, mode="drop")

    # Member chars: one scatter across all states (all flat [2M]).
    uid = dbg.node_state_uid
    pos = dbg.node_state_pos
    ch = chars.astype(jnp.uint8)
    memb = (uid >= 0) & (pos >= 1) & (uid < ucap)
    uidc = jnp.clip(uid, 0, ucap - 1)
    tgt = jnp.where(memb, offs[uidc] + pos + (k - 1), char_cap)
    flat = flat.at[tgt].set(ch, mode="drop")

    return SeqPack(flat=flat, offs=offs, ulen=ulen, circular=circ)


@partial(jax.jit, static_argnames=("jun_cap",))
def pack_junctions(dbg: DBG, cov, reach_jun, *, jun_cap: int) -> JunPack:
    m, l = dbg.nodes.shape
    emit = dbg.is_junction_final & reach_jun
    jidx = jnp.nonzero(emit, size=jun_cap, fill_value=m)[0].astype(jnp.int32)
    jc = jnp.clip(jidx, 0, m - 1)

    nid = jnp.concatenate([dbg.left_id, dbg.right_id], axis=1)[jc]
    pres = jnp.concatenate([dbg.left_present, dbg.right_present], axis=1)[jc]
    isfw = jnp.concatenate([dbg.left_isfw, dbg.right_isfw], axis=1)[jc]
    nidc = jnp.clip(nid, 0, m - 1)
    n_isjun = dbg.is_junction_final[nidc] & (nid >= 0)
    n_juid = jnp.where(nid >= 0, dbg.joint_uid[nidc], -1)
    # Straight-endpoint sign: the queried neighbor state (node, orientation)
    # is '+' iff it lies on the kept walk of its unitig (its k-mer then
    # appears AS WRITTEN at the stored sequence's facing end; a junction's
    # chain neighbor is always a chain end, so kept-side membership alone
    # decides the sign).  Mirrors the reference's direct-vs-complement
    # joint-map hit (src/DeBruijnGraph.cpp:480-505, 520-541).
    s_n = nidc * 2 + jnp.where(isfw, 0, 1)
    n_joint_fw = dbg.node_state_uid[s_n] >= 0

    return JunPack(
        node_id=jidx,
        kmers=dbg.nodes[jc],
        cov=cov.node_cov[jc],
        tally=cov.jun_tally[jc[:, None] * 8
                            + jnp.arange(8, dtype=jnp.int32)[None, :]],
        nbr_id=nid, nbr_present=pres, nbr_isfw=isfw,
        nbr_isjun=n_isjun, nbr_joint_uid=n_juid,
        nbr_joint_fw=n_joint_fw,
    )
