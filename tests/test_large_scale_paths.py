"""Chromosome-scale code paths, exercised at test scale (VERDICT r3 item 2).

Two code paths only trigger above multi-million-node graph sizes and had
never executed before a chr21-scale run depended on them:

* the chunked per-(side, base) neighbor join
  (``graph/build.py::_neighbor_info``, ``_NEIGHBOR_CHUNK_THRESHOLD``),
  which replaces the fused 8*M-row sort-join to bound peak memory;
* ``pipeline._graph_cap``'s 2^20-step rounding branch, which produces
  NON-power-of-two node capacities above 4M nodes.

These tests shrink the thresholds (module-level constants, monkeypatched)
so the same code runs on a repeat-rich test graph, and assert exact
equality against the small-graph paths -- no code path reachable at
chromosome scale stays test-virgin.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from platanus3_tpu import pipeline
from platanus3_tpu import sim
from platanus3_tpu.config import AssemblyConfig
from platanus3_tpu.graph import build as build_mod
from platanus3_tpu.ops import bloom as bloom_mod


def _repeat_reads(glen=6000, k=25, seed=31):
    """Repeat-rich genome: junction tangles + thousands of nodes."""
    g = sim.random_genome(glen, seed=seed)
    g = sim.plant_repeats(g, 80, 30, seed=seed + 1)
    g = sim.plant_repeats(g, 3 * k, 15, seed=seed + 2, min_gap=300)
    return [g[s:s + 400] for s in range(0, len(g) - 400 + 1, 80)]


def _node_table(reads, k):
    cfg = AssemblyConfig(k=k, log_path=None)
    tab, _ = pipeline._extra_solid_table(reads, cfg)
    return tab


def test_graph_cap_policy(monkeypatch):
    # Below the pow2 ceiling: next power of two.
    assert pipeline._graph_cap(1000) == 1024
    assert pipeline._graph_cap(1 << 22) == 1 << 22
    # Above: next multiple of the step (non-pow2 in general), never more
    # than the pow2.
    n = 5_300_000
    cap = pipeline._graph_cap(n)
    assert cap % (1 << 20) == 0 and cap >= n and cap < pipeline._next_pow2(n)
    # Shrunken policy mirrors the same shape at test scale.
    monkeypatch.setattr(pipeline, "_GRAPH_CAP_POW2_MAX", 512)
    monkeypatch.setattr(pipeline, "_GRAPH_CAP_STEP", 128)
    assert pipeline._graph_cap(700) == 768        # non-pow2 multiple of 128
    assert pipeline._graph_cap(500) == 512        # still within pow2 regime
    assert pipeline._graph_cap(1000) == 1024      # step rounding never > pow2


def test_chunked_neighbor_join_equals_fused(monkeypatch):
    """The per-(side, base) chunked join (>4M-node path) must produce a
    DBG identical to the fused 8*M join, leaf for leaf."""
    k = 25
    reads = _repeat_reads()
    tab = _node_table(reads, k)
    n = int(tab.size)
    assert n > 2000, f"graph not rich enough ({n} nodes)"
    cap = pipeline._graph_cap(n)
    nodes = pipeline._pad_table_keys(tab.keys, n, cap)
    size = jnp.asarray(n, jnp.int32)
    bf = bloom_mod.make_bloom(20, 4)

    assert cap <= build_mod._NEIGHBOR_CHUNK_THRESHOLD  # fused by default
    fused = build_mod.build_graph(nodes, size, k, bf, use_exact=True)
    monkeypatch.setattr(build_mod, "_NEIGHBOR_CHUNK_THRESHOLD", 64)
    chunked = build_mod.build_graph(nodes, size, k, bf, use_exact=True)

    for name, a, b in zip(fused._fields, fused, chunked):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"DBG leaf {name!r} differs between fused and "
                    f"chunked neighbor joins")


def test_chunked_join_bloom_membership_equal(monkeypatch):
    """Same equality under Bloom membership (the mode whose presence bits
    come from filter probes, not table hits)."""
    k = 25
    reads = _repeat_reads(glen=3000, seed=77)
    tab = _node_table(reads, k)
    n = int(tab.size)
    cap = pipeline._graph_cap(n)
    nodes = pipeline._pad_table_keys(tab.keys, n, cap)
    size = jnp.asarray(n, jnp.int32)
    bf = bloom_mod.make_bloom(22, 6)
    bf = pipeline._bloom_from_nodes(nodes, size, bf, k=k)

    fused = build_mod.build_graph(nodes, size, k, bf, use_exact=False)
    monkeypatch.setattr(build_mod, "_NEIGHBOR_CHUNK_THRESHOLD", 64)
    chunked = build_mod.build_graph(nodes, size, k, bf, use_exact=False)
    for name, a, b in zip(fused._fields, fused, chunked):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"DBG leaf {name!r} differs")


def test_staged_build_equals_jitted(monkeypatch):
    """The staged graph build (eager ops + host-looped pointer doubling,
    used above _STAGE2_STAGED_THRESHOLD to keep every XLA execution
    short) must produce a DBG identical to the fully-jitted build, leaf
    for leaf."""
    k = 25
    reads = _repeat_reads()
    tab = _node_table(reads, k)
    n = int(tab.size)
    cap = pipeline._graph_cap(n)
    nodes = pipeline._pad_table_keys(tab.keys, n, cap)
    size = jnp.asarray(n, jnp.int32)
    bf = bloom_mod.make_bloom(20, 4)

    jitted = pipeline._stage2(nodes, size, bf, k=k, use_exact=True)
    monkeypatch.setattr(pipeline, "_STAGE2_STAGED_THRESHOLD", 64)
    staged = pipeline.run_stage2(nodes, size, bf, k=k, use_exact=True)
    for name, a, b in zip(jitted._fields, jitted, staged):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"DBG leaf {name!r} differs between jitted and "
                    f"staged builds")


def test_staged_pipeline_gfa_equality(monkeypatch):
    """Full pipeline through the staged stage-2 path: byte-identical
    GFA (covers the cycle/mirror handling the host loops early-exit on)."""
    reads = _repeat_reads(glen=3000, seed=13)
    cfg = AssemblyConfig(k=25, filter_bits=1 << 22, log_path=None)
    base = pipeline.assemble(reads, cfg, write_output=False)
    monkeypatch.setattr(pipeline, "_STAGE2_STAGED_THRESHOLD", 64)
    staged = pipeline.assemble(reads, cfg, write_output=False)
    assert staged.gfa_lines == base.gfa_lines


def test_non_pow2_graph_cap_pipeline_equality(monkeypatch):
    """Full pipeline with the shrunken capacity policy (non-pow2 caps,
    the >4M-node regime) must emit byte-identical GFA lines."""
    reads = _repeat_reads(glen=3000, seed=55)
    cfg = AssemblyConfig(k=25, filter_bits=1 << 22, log_path=None)
    base = pipeline.assemble(reads, cfg, write_output=False)

    monkeypatch.setattr(pipeline, "_GRAPH_CAP_POW2_MAX", 256)
    monkeypatch.setattr(pipeline, "_GRAPH_CAP_STEP", 192)
    n = base.num_nodes
    assert pipeline._graph_cap(n) % 192 == 0  # really in the step regime
    assert pipeline._graph_cap(n) != pipeline._next_pow2(n)
    small = pipeline.assemble(reads, cfg, write_output=False)
    assert small.gfa_lines == base.gfa_lines
    assert small.num_nodes == base.num_nodes


def test_non_pow2_graph_cap_streaming_equality(monkeypatch):
    """Streaming mode (the chr21 driver) under the non-pow2 capacity
    policy: GFA equality vs the default-policy single-shot pipeline.
    ``streaming.assemble_streaming`` shares ``pipeline._graph_cap``."""
    from platanus3_tpu.streaming import assemble_streaming
    reads = _repeat_reads(glen=3000, seed=91)
    cfg = AssemblyConfig(k=25, filter_bits=1 << 22, log_path=None)
    base = pipeline.assemble(reads, cfg, write_output=False)

    monkeypatch.setattr(pipeline, "_GRAPH_CAP_POW2_MAX", 256)
    monkeypatch.setattr(pipeline, "_GRAPH_CAP_STEP", 192)
    res = assemble_streaming(reads, cfg, write_output=False,
                             slice_chunks=64)
    assert res.gfa_lines == base.gfa_lines


def test_non_pow2_cap_with_simplify(monkeypatch):
    """Simplification rebuilds re-enter _graph_cap with shrinking node
    counts; the non-pow2 policy must not change the final graph."""
    g = sim.random_genome(4000, seed=5)
    hap2 = sim.mutate_genome(g, 8, seed=6, min_gap=200)
    reads = (sim.simulate_reads(g, coverage=12, read_len=300, seed=7,
                                sub_rate=0.003)
             + sim.simulate_reads(hap2, coverage=12, read_len=300, seed=8,
                                  sub_rate=0.003))
    cfg = AssemblyConfig(k=25, filter_bits=1 << 22, log_path=None,
                         cov_threshold=3, clip_tips=True, pop_bubbles=True)
    base = pipeline.assemble(reads, cfg, write_output=False)
    monkeypatch.setattr(pipeline, "_GRAPH_CAP_POW2_MAX", 128)
    monkeypatch.setattr(pipeline, "_GRAPH_CAP_STEP", 96)
    small = pipeline.assemble(reads, cfg, write_output=False)
    assert small.gfa_lines == base.gfa_lines


def _synthetic_chain_map(n=4096):
    """Successor map with many short chains, a few long ones, and a
    5-cycle -- shaped to drive the staged doubling loops through BOTH
    the full-array and the compacted-active-set phases (the 5-cycle is
    the adversarial case: its pointers look unchanged across a 4-round
    batch at round 8 because 5 divides 2^8 * 15, yet keep rotating --
    only the per-single-round change test may retire states)."""
    nxt = np.arange(n, dtype=np.int32)
    pos = 0
    for length in [3] * 800 + [7] * 100 + [300, 500, 1000]:
        if pos + length >= n - 40:
            break
        for i in range(pos, pos + length - 1):
            nxt[i] = i + 1
        pos += length
    for i in range(n - 6, n - 1):
        nxt[i] = i + 1
    nxt[n - 2] = n - 6  # cycle of 5: states n-6 .. n-2
    return jnp.asarray(nxt)


def test_staged_doubling_compaction_bitexact():
    """_staged_doubling (batched rounds + active-set compaction) must be
    bit-identical to the plain synchronous doubling loops, including on
    cycles and through tier recompaction."""
    n = 4096
    nxt = _synthetic_chain_map(n)
    states = jnp.arange(n, dtype=jnp.int32)
    rounds = max(1, int(n).bit_length())

    engaged = []
    probe = lambda tag, *a: engaged.append(tag)

    ptr, minv = nxt, states
    for _ in range(rounds):
        ptr, minv = build_mod._body0(None, (ptr, minv))
    a0, b0 = build_mod._staged_doubling(0, (nxt, states), rounds, probe)
    np.testing.assert_array_equal(np.asarray(ptr), np.asarray(a0))
    np.testing.assert_array_equal(np.asarray(minv), np.asarray(b0))

    c = (jnp.zeros((), jnp.int32), nxt, (nxt != states).astype(jnp.int32),
         jnp.zeros((), bool))
    while int(c[0]) < rounds and not bool(c[3]):
        c = build_mod._body1(c)
    a1, b1 = build_mod._staged_doubling(
        1, (nxt, (nxt != states).astype(jnp.int32)), rounds, probe)
    np.testing.assert_array_equal(np.asarray(c[1]), np.asarray(a1))
    np.testing.assert_array_equal(np.asarray(c[2]), np.asarray(b1))

    # the shape above must actually ENGAGE compaction in both loops
    assert sum(t.startswith("compact@") for t in engaged) >= 2, engaged


def test_compact_select_rebase():
    """_compact_select maps active rows to state ids both from the full
    mask (engagement) and through a previous tier's idx (recompaction)."""
    m2 = 100
    mask = np.zeros(m2, bool)
    mask[[3, 7, 50, 99]] = True
    idx, a = build_mod._compact_select(
        jnp.asarray(mask), 8, m2, None, jnp.arange(m2, dtype=jnp.int32))
    assert list(np.asarray(idx[:4])) == [3, 7, 50, 99]
    assert np.all(np.asarray(idx[4:]) == m2)
    assert list(np.asarray(a[:4])) == [3, 7, 50, 99]

    cmask = np.zeros(8, bool)
    cmask[[1, 3]] = True
    idx2, a2 = build_mod._compact_select(jnp.asarray(cmask), 4, m2, idx, a)
    assert list(np.asarray(idx2[:2])) == [7, 99]
    assert np.all(np.asarray(idx2[2:]) == m2)
    assert list(np.asarray(a2[:2])) == [7, 99]
