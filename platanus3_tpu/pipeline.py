"""End-to-end assembly pipeline.

The array analog of ``Assemble<BITSET>`` (reference
``src/Assemble.cpp:6-28``), with the same six stage boundaries (SURVEY.md
§3) expressed as three jitted device programs plus a host output stage:

  stage 1 (device): short-k count -> window-min solidity -> Bloom build,
            solid node table, per-read seed k-mers
            (= CountShortKmer + MakeBF)
  stage 2 (device): graph decomposition -- degrees, junctions, chain
            contraction (= MakeDBG/SearchNode/Extend*)
  stage 3 (device): coverage + junction edge tallies (= CountNodeCoverage)
            and seed-component reachability (= the BFS's visited set)
  stage 4 (host):   unitig strings + GFA (= PrintGraph)

Between stage 1 and 2 the node table is compacted: the host reads the
unique-node count and re-jits stage 2 with a power-of-two capacity, so
graph arrays are sized to the actual graph, not to the read volume.

Stage boundaries are natural checkpoints (utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.config import AssemblyConfig
from platanus3_tpu.graph import build as build_mod
from platanus3_tpu.graph import coverage as cov_mod
from platanus3_tpu.graph import reach as reach_mod
from platanus3_tpu.graph import sequence as seq_mod
from platanus3_tpu.io import gfa as gfa_mod
from platanus3_tpu.io import reads as reads_mod
from platanus3_tpu.ops import bloom as bloom_mod
from platanus3_tpu.ops import count as count_mod
from platanus3_tpu.ops import kmer as kmer_mod
from platanus3_tpu.ops import solid as solid_mod
from platanus3_tpu.utils import compile_cache
from platanus3_tpu.utils.logging import PipelineLog
from platanus3_tpu.utils.profiling import StageTimer, device_trace

__all__ = ["assemble", "AssemblyResult"]

# Persistent compilation cache: shape-dependent XLA compiles at genome
# scale run minutes; cache them across processes (utils/compile_cache.py).
compile_cache.configure()


@dataclasses.dataclass
class AssemblyResult:
    gfa_lines: list
    straight_seqs: list          # unitig id -> sequence (kept orientation)
    dbg: object                  # DBG pytree (device)
    cov: object                  # CoverageResult
    reach_jun: object
    reach_uni: object
    num_nodes: int
    num_junctions: int
    num_straights: int
    stats: dict


@partial(jax.jit, static_argnames=("k", "short_k", "num_reads"))
def _stage1(packed, valid_len, read_id, start, read_len, cov_threshold, *,
            k, short_k, num_reads):
    # cov_threshold is a TRACED scalar: a threshold sweep (sweep.py) or a
    # re-run at a different solidity cutoff reuses the same executable.
    batch_arrays = (packed, valid_len, read_id, start, read_len)
    # The Bloom filter (when wanted at all) is built AFTER stage 1 from
    # the compacted distinct node set (_bloom_from_nodes): inserting each
    # read position here would be ~coverage-fold more probe traffic for
    # the identical membership set (Bloom insert is idempotent).
    result, _ = solid_mod.solid_kmers(
        batch_arrays, k, short_k, cov_threshold, None,
        add_to_bloom=False, need_short_table=False)
    seed_fw, has_seed = solid_mod.first_solid_per_read(
        result, read_id, start, num_reads)
    c, pk, l = result.canon.shape
    # One sort yields the node table AND every position's node id; the
    # coverage pass then needs no lookup at all (count_solid_with_ids).
    # want_counts=False: the node table's counts are never read (KC
    # comes from the stage-3 coverage pass) -- dropping the count
    # operand from the compaction sort is ~10% of stage-1 wall.
    node_table, nid = count_mod.count_solid_with_ids(
        result.canon.reshape(-1, l),
        result.owned.reshape(-1),
        (result.is_solid & result.owned).reshape(-1), k=k,
        want_counts=False)
    return (node_table, seed_fw, has_seed, result.short_table,
            nid.reshape(c, pk))


def _extra_solid_table(seqs, config):
    """K-mer table + seed k-mers of caller-guaranteed-solid sequences
    (multi-k re-seeding, graph/multik.py): every k-mer of ``seqs`` becomes
    a node regardless of read coverage.  Returns ``(KmerTable, seed_fw)``.
    """
    k = config.k
    eb = reads_mod.reads_from_strings(seqs, k, config.chunk_len)
    bases = kmer_mod.unpack_bases(jnp.asarray(eb.packed))
    fw, valid = kmer_mod.extract_kmers(bases, jnp.asarray(eb.valid_len), k)
    canon, _ = kmer_mod.canonical(fw, k)
    pk = fw.shape[1]
    owned = solid_mod.owned_mask(
        jnp.asarray(eb.start), jnp.asarray(eb.read_len),
        eb.stride, pk, k, k) & valid
    l = canon.shape[-1]
    tab = count_mod.count_kmers(canon.reshape(-1, l), owned.reshape(-1), k=k)
    seed = jnp.asarray(kmer_mod.encode_kmers_np(
        [s[:k] for s in seqs if len(s) >= k]))
    return tab, seed


@partial(jax.jit, static_argnames=("k",))
def _bloom_from_nodes(nodes, size, bf, *, k):
    """Insert the valid prefix of the compacted node table into the packed
    Bloom filter -- the production Bloom build (exactly the distinct solid
    canonical k-mers, the same set the reference's per-position ``BF::add``
    accumulates, ``src/MakeBloomFilter.cpp:75-77``)."""
    rows = nodes.shape[0]
    return bloom_mod.bloom_add(bf, nodes, k,
                               mask=jnp.arange(rows) < size)


@partial(jax.jit, static_argnames=("k", "use_exact"))
def _stage2(nodes, size, bf, *, k, use_exact):
    return build_mod.build_graph(nodes, size, k, bf, use_exact=use_exact)


# Above this node count stage 2 runs STAGED: eager ops + host-looped
# pointer doubling with active-set compaction, keeping every single XLA
# execution short (see build_graph docstring).  Whether staging still
# earns its place against the fused loops at chromosome scale is open
# (ROADMAP C1).  Module-level so tests can shrink it and assert staged ==
# jitted on small graphs.
_STAGE2_STAGED_THRESHOLD = 1 << 23


def run_stage2(nodes, size, bf, *, k, use_exact):
    if nodes.shape[0] > _STAGE2_STAGED_THRESHOLD:
        return build_mod.build_graph(nodes, jnp.asarray(size, jnp.int32),
                                     k, bf, use_exact=use_exact,
                                     staged=True)
    return _stage2(nodes, size, bf, k=k, use_exact=use_exact)


@partial(jax.jit, static_argnames=("k", "has_nid"))
def _stage3(dbg, packed, valid_len, start, read_len, prev_base, next_base,
            seed_fw, has_seed, nid, *, k, has_nid):
    bases = kmer_mod.unpack_bases(packed)
    cov = cov_mod.count_coverage(
        dbg, k, bases, valid_len, start, read_len, prev_base, next_base,
        nid=nid if has_nid else None)
    reach_jun, reach_uni = reach_mod.reachable(dbg, seed_fw, has_seed, k)
    chars = seq_mod.member_chars(dbg, k)
    return cov, reach_jun, reach_uni, chars


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


# Capacity policy thresholds, module-level so tests can shrink them and
# exercise the chromosome-scale (non-pow2 capacity) branch on small
# graphs (VERDICT r3 item 2).
_GRAPH_CAP_POW2_MAX = 1 << 22
_GRAPH_CAP_STEP = 1 << 20


def _graph_cap(n: int) -> int:
    """Node capacity for the graph stage.  Power-of-two below ~4M nodes
    (maximal executable reuse across runs); above that, the next multiple
    of 2^20 -- at chromosome scale the pow2 jump can waste ~2x of every
    per-node graph array (~100+ B/node), which is the difference between
    fitting in device memory and not (VERDICT r2 item 3)."""
    p = max(8, _next_pow2(n))
    if p <= _GRAPH_CAP_POW2_MAX:
        return p
    return min(p, -(-int(n) // _GRAPH_CAP_STEP) * _GRAPH_CAP_STEP)


@partial(jax.jit, static_argnames=("k",))
def _phantom_fn(dbg, *, k):
    return build_mod.phantom_neighbors(dbg, k)


def _pad_table_keys(keys, size: int, cap: int):
    rows, lanes = keys.shape
    if cap <= rows:
        return keys[:cap]
    pad = jnp.full((cap - rows, lanes), np.uint32(0xFFFFFFFF),
                   dtype=jnp.uint32)
    return jnp.concatenate([keys, pad], axis=0)


def _expand_bloom_closure(dbg, nodes, size, bf, config, log):
    """Bloom-membership closure: add filter-positive neighbor k-mers as
    nodes until fixpoint (or ``bloom_expand_rounds``), rebuilding the
    graph each round.  Reproduces the reference's traversal semantics
    where every Bloom hit is enqueued and materialized
    (``src/DeBruijnGraph.cpp:167-179, 248-258``) -- so false positives
    become coverage-0 nodes exactly like the reference's.

    Returns ``(dbg, nodes, size, changed)``.
    """
    changed = False
    for rnd in range(max(0, config.bloom_expand_rounds)):
        canon, mask = _phantom_fn(dbg, k=config.k)
        n_extra = int(jnp.sum(mask))
        if n_extra == 0:
            break
        changed = True
        extra = count_mod.count_kmers(canon, mask, k=config.k)
        base = count_mod.KmerTable(
            nodes, jnp.zeros((nodes.shape[0],), jnp.int32), size)
        merged = count_mod.merge_tables(base, extra)
        n_new = int(merged.size)
        cap2 = _graph_cap(n_new)
        nodes = _pad_table_keys(merged.keys, n_new, cap2)
        size = jnp.asarray(n_new, jnp.int32)
        dbg = run_stage2(nodes, size, bf, k=config.k, use_exact=False)
        log.write(f"bloom closure round {rnd + 1}: {n_extra} phantom "
                  f"neighbor k-mers -> {n_new} nodes")
    return dbg, nodes, size, changed


def _emit_output(dbg, cov, reach_jun, reach_uni, chars, k):
    """Stage 4: build compact emission packs on device, render GFA on
    host.  Transfer is proportional to output size (graph/emit.py)."""
    from platanus3_tpu.graph import emit as emit_mod

    num_u = int(dbg.num_unitigs)
    n_jun = int(jnp.sum(dbg.is_junction_final & reach_jun))
    m = dbg.nodes.shape[0]
    # Clamp to the node capacity m: _graph_cap can return a non-pow2 m
    # (>4M nodes), and _next_pow2(num_u) may then exceed m, which would
    # mismatch dbg.unitig_head[:ucap] (clamps to m rows) against
    # arange(ucap) inside materialize_sequences (ADVICE r3).
    ucap = min(max(1, _next_pow2(max(num_u, 1))), m)
    total_chars = int(jnp.sum(dbg.unitig_len[:ucap])) + num_u * (k - 1)
    char_cap = max(8, _next_pow2(total_chars + 1))
    jun_cap = max(1, _next_pow2(max(n_jun, 1)))

    seq_pack = emit_mod.materialize_sequences(
        dbg, chars, k=k, ucap=ucap, char_cap=char_cap)
    jun_pack = emit_mod.pack_junctions(dbg, cov, reach_jun,
                                       jun_cap=jun_cap)
    seq_np = jax.tree.map(np.asarray, seq_pack)
    jun_np = jax.tree.map(np.asarray, jun_pack)
    seqs = gfa_mod.sequences_from_pack(seq_np, num_u, k)
    lines = gfa_mod.gfa_lines(jun_np, seq_np,
                              np.asarray(reach_uni[:max(ucap, 1)]),
                              num_u, m, k, seqs=seqs)
    return seqs, lines


def hashlib_digest(arr) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def _save_stage3(ckpt, dbg, cov, reach_jun, reach_uni, chars):
    """Persist the post-simplify graph + coverage so a resume skips
    straight to emission (VERDICT r1 item 7)."""
    arrs = {f"dbg{i}": np.asarray(x) for i, x in enumerate(dbg)}
    arrs.update(node_cov=np.asarray(cov.node_cov),
                jun_tally=np.asarray(cov.jun_tally),
                reach_jun=np.asarray(reach_jun),
                reach_uni=np.asarray(reach_uni),
                chars=np.asarray(chars))
    ckpt.save("stage3", **arrs)


def _load_stage3(ckpt):
    d = ckpt.load("stage3")
    n_dbg = len(build_mod.DBG._fields)
    dbg = build_mod.DBG(*[jnp.asarray(d[f"dbg{i}"]) for i in range(n_dbg)])
    cov = cov_mod.CoverageResult(node_cov=jnp.asarray(d["node_cov"]),
                                 jun_tally=jnp.asarray(d["jun_tally"]))
    return (dbg, cov, jnp.asarray(d["reach_jun"]),
            jnp.asarray(d["reach_uni"]), jnp.asarray(d["chars"]))


def assemble(source, config: AssemblyConfig, log: Optional[PipelineLog] = None,
             write_output: bool = True, mesh=None,
             extra_solid=None) -> AssemblyResult:
    """Assemble reads -> GFA.

    ``source``: path to .fasta/.fastq, a list of sequence strings, or a
    prepared ``ReadBatch``.

    ``extra_solid``: optional sequences whose k-mers join the node set
    unconditionally (and seed reachability) -- the multi-k re-seeding
    hook (graph/multik.py): prior-round unitigs are retained at the new k
    without inflating the read volume or the coverage counts.

    ``mesh``: optional ``jax.sharding.Mesh`` with axis 'd'; stage 1 then
    runs data-parallel with a hash-prefix-sharded count table and
    allreduce-merged Bloom (parallel/sharded.py).  The result is
    bitwise-identical to the single-device path.

    Observability (SURVEY.md §5): ``config.trace_dir`` wraps the run in a
    ``jax.profiler`` trace (Perfetto/TensorBoard readable);
    ``config.profile_stages`` makes the per-stage wall-clock breakdown in
    ``result.stats['stages']`` barrier-exact.
    """
    with device_trace(config.trace_dir):
        return _assemble_impl(source, config, log, write_output, mesh,
                              extra_solid)


def _assemble_impl(source, config, log, write_output, mesh, extra_solid=None):
    log = log or PipelineLog(config.log_path, echo=False)
    t0 = time.time()
    timer = StageTimer(barriers=config.profile_stages)
    log.write("Assemble")

    # ---- load ----
    if isinstance(source, reads_mod.ReadBatch):
        batch = source
    elif isinstance(source, (list, tuple)):
        batch = reads_mod.reads_from_strings(list(source), config.k,
                                             config.chunk_len)
    else:
        batch = reads_mod.load_reads(source, config.k, config.chunk_len)
    log.write(f"read file loaded ({batch.num_reads} reads, "
              f"{batch.all_bases} bases, {batch.num_chunks} chunks, "
              f"{batch.parser} parser)")
    timer.mark("load")

    if batch.num_reads == 0:
        # All reads shorter than k (dropped, src/Load.cpp:59,86) or empty
        # input: the reference would emit a header-only GFA.
        lines = ["H\tVN:Z:1.0"]
        if write_output:
            with open(config.gfa_path, "w") as f:
                f.write("\n".join(lines) + "\n")
        log.write("finish (no reads >= k)")
        return AssemblyResult(
            gfa_lines=lines, straight_seqs=[], dbg=None, cov=None,
            reach_jun=None, reach_uni=None, num_nodes=0,
            num_junctions=0, num_straights=0,
            stats={"elapsed_s": time.time() - t0, "all_bases": 0,
                   "num_reads": 0, "solid_nodes": 0})

    need_bloom = (not config.use_exact_membership) or config.build_bloom
    if need_bloom:
        bits, hashes = config.auto_filter_bits(batch.all_bases)
        bf = bloom_mod.make_bloom(bits, hashes)
        log.metric("filter_bits", 1 << bf.log2_bits)
        log.metric("num_hashes", bf.num_hashes)
    else:
        bf = bloom_mod.make_bloom(8, 1)  # placeholder, never built/queried

    multiproc = False
    if mesh is not None:
        from platanus3_tpu.parallel import sharded as _sh
        multiproc = _sh._is_multiprocess(mesh)
    if multiproc:
        # Multi-controller run: every jit input must be a GLOBAL array.
        # Each process holds the same host data, so replicate explicitly
        # (stages 2-4 run replicated over the global mesh -- the v1
        # "graph stage replicated" design, parallel/sharded.py).
        from jax.sharding import PartitionSpec as _P
        dev = lambda x: _sh.to_global(mesh, np.asarray(x), _P())
    else:
        dev = lambda x: jnp.asarray(x)
    packed = dev(batch.packed)
    valid_len = dev(batch.valid_len)
    read_id = dev(batch.read_id)
    start = dev(batch.start)
    read_len = dev(batch.read_len)

    # ---- stage 1: count + solidity + Bloom + seeds ----
    ckpt = None
    if config.checkpoint_dir:
        from platanus3_tpu.utils.checkpoint import Checkpointer
        ckpt = Checkpointer(
            config.checkpoint_dir,
            # Format-version token FIRST (ADVICE r4): checkpoint layouts
            # have changed across rounds (DBG per-state leaves [M,2] ->
            # flat [2M], jun_tally [M,8] -> [M*8]); without a version in
            # the digest, an old-layout stage2/stage3 .npz would be
            # trusted on resume and its flat-index gathers would clamp
            # out of range, silently corrupting the emitted GFA.  Bump
            # whenever any checkpointed array layout changes.
            digest_parts=("fmt=2",
                          config.k, config.short_k, config.cov_threshold,
                          config.filter_policy, config.filter_bits,
                          config.chunk_len, need_bloom, batch.num_reads,
                          batch.all_bases,
                          # stage-2/3-relevant knobs (their outputs are
                          # checkpointed too):
                          config.use_exact_membership, config.clip_tips,
                          config.pop_bubbles, config.simplify_rounds,
                          config.tip_max_len, config.tip_cov_ratio,
                          config.bubble_len_ratio,
                          config.bloom_expand_rounds,
                          hashlib_digest(batch.packed),
                          hashlib_digest(np.frombuffer(
                              "\n".join(extra_solid).encode(), np.uint8))
                          if extra_solid else ""))
    bloom_pending = need_bloom  # rebuilt from the node set below; the
    # sharded path builds it during its all-to-all stage instead
    restored1 = False
    if ckpt is not None and ckpt.has("stage1"):
        d = ckpt.load("stage1")
        table = count_mod.KmerTable(
            jnp.asarray(d["keys"]), jnp.asarray(d["counts"]),
            jnp.asarray(d["size"]))
        seed_fw = jnp.asarray(d["seed_fw"])
        has_seed = jnp.asarray(d["has_seed"])
        short_table = None
        nid = None
        restored1 = True  # saved table/seeds already include extra_solid
        log.write("stage1 restored from checkpoint")
    elif mesh is not None:
        from platanus3_tpu.parallel import sharded as sharded_mod
        arrays = sharded_mod.pad_batch_to_devices(
            (batch.packed, batch.valid_len, batch.read_id, batch.start,
             batch.read_len), mesh.devices.size)
        table, bf, seed_fw, has_seed, ovf = sharded_mod.sharded_stage1(
            mesh, *arrays, bf,
            k=config.k, short_k=min(config.short_k, config.k),
            cov_threshold=config.cov_threshold, num_reads=batch.num_reads,
            add_to_bloom=need_bloom)
        if int(ovf) > 0:
            raise RuntimeError(
                f"all-to-all bucket overflow ({int(ovf)} k-mers dropped); "
                f"increase slack")
        short_table = None
        nid = None
        bloom_pending = False
    else:
        table, seed_fw, has_seed, short_table, nid = _stage1(
            packed, valid_len, read_id, start, read_len,
            jnp.asarray(config.cov_threshold, jnp.int32),
            k=config.k, short_k=min(config.short_k, config.k),
            num_reads=batch.num_reads)
    if extra_solid and not restored1:
        etab, eseed = _extra_solid_table(extra_solid, config)
        table = count_mod.merge_tables(table, etab)
        nid = None  # node ranks shifted; stage 3 re-resolves by sort-join
        seed_fw = jnp.concatenate([seed_fw, eseed], axis=0)
        has_seed = jnp.concatenate(
            [has_seed, jnp.ones((eseed.shape[0],), bool)])
        log.write(f"extra-solid merge: {len(extra_solid)} seqs")
    num_nodes = int(table.size)
    if ckpt is not None and not ckpt.has("stage1"):
        # Persist only the valid prefix of the table (cap is read-volume
        # sized; the compaction below re-pads).
        n_keep = max(num_nodes, 1)
        ckpt.save("stage1",
                  keys=np.asarray(table.keys[:n_keep]),
                  counts=np.asarray(table.counts[:n_keep]),
                  size=np.asarray(table.size),
                  seed_fw=np.asarray(seed_fw),
                  has_seed=np.asarray(has_seed))
        log.write("stage1 checkpoint saved")
    log.write(f"counted short kmer; bloom filter loaded; "
              f"solid nodes={num_nodes}")
    log.metric("seed kmer num", int(jnp.sum(has_seed)))
    timer.mark("stage1_count_solid", sync=(table.counts,))

    # ---- compact node table to a power-of-two capacity ----
    cap = _graph_cap(num_nodes)
    rows, lanes = table.keys.shape
    if cap <= rows:
        nodes = table.keys[:cap]
    else:  # restored checkpoint stores only the valid prefix
        pad = dev(np.full((cap - rows, lanes), np.uint32(0xFFFFFFFF)))
        nodes = jnp.concatenate([table.keys, pad], axis=0)
    size = dev(np.asarray(num_nodes, np.int32))

    if bloom_pending:
        bf = _bloom_from_nodes(nodes, size, bf, k=config.k)
        timer.mark("bloom_build", sync=(bf.bits,))

    # ---- stage 2: graph ----
    restored3 = ckpt is not None and ckpt.has("stage3")
    if restored3:
        dbg = None  # stage3 checkpoint carries the final (post-simplify)
        # graph; stage 2 is skipped entirely.
    elif ckpt is not None and ckpt.has("stage2"):
        d = ckpt.load("stage2")
        dbg = build_mod.DBG(
            *[jnp.asarray(d[f"leaf{i}"])
              for i in range(len(build_mod.DBG._fields))])
        log.write("stage2 restored from checkpoint")
    else:
        dbg = run_stage2(nodes, size, bf, k=config.k,
                         use_exact=config.use_exact_membership)
        if not config.use_exact_membership and config.bloom_expand_rounds:
            dbg, nodes, size, grew = _expand_bloom_closure(
                dbg, nodes, size, bf, config, log)
            if grew:
                # Node rows shifted; per-position ids from stage 1 are
                # stale -- stage 3 re-resolves them with a sort-join.
                nid = None
        if ckpt is not None:
            ckpt.save_pytree("stage2", dbg)
            log.write("stage2 checkpoint saved")
    log.write("de bruijn graph loaded")
    timer.mark("stage2_graph", sync=dbg)

    # ---- stage 3: coverage + reachability ----
    nid_dummy = dev(np.zeros((1, 1), np.int32))

    def run_stage3(dbg, nid):
        return _stage3(
            dbg, packed, valid_len, start, read_len,
            dev(batch.prev_base), dev(batch.next_base),
            seed_fw, has_seed, nid if nid is not None else nid_dummy,
            k=config.k, has_nid=nid is not None)

    if restored3:
        dbg, cov, reach_jun, reach_uni, chars = _load_stage3(ckpt)
        log.write("stage3 restored from checkpoint (skip to emission)")
    else:
        cov, reach_jun, reach_uni, chars = run_stage3(dbg, nid)
        log.write("count node coverage")
    timer.mark("stage3_coverage", sync=(cov, reach_jun))

    # ---- graph simplification rounds (tips / bubbles; new vs ref) ----
    if (config.clip_tips or config.pop_bubbles) and not restored3:
        from platanus3_tpu.graph import simplify as simp_mod
        rounds = config.simplify_rounds if config.simplify_rounds > 0 \
            else 100  # 0 = iterate to fixpoint
        for rnd in range(rounds):
            dbg_np = jax.tree.map(np.asarray, dbg)
            keep, n_drop = simp_mod.decide_drops(
                dbg_np, np.asarray(cov.node_cov), config)
            if keep is None:
                break
            kept_keys = np.asarray(dbg_np.nodes)[keep]
            n_keep = kept_keys.shape[0]
            cap2 = _graph_cap(n_keep)
            pad = np.full((cap2 - n_keep, kept_keys.shape[1]),
                          np.uint32(0xFFFFFFFF))
            nodes = dev(np.concatenate([kept_keys, pad]))
            size = dev(np.asarray(n_keep, np.int32))
            # Rebuild with EXACT membership: after deletion the Bloom
            # filter no longer describes the k-mer set.
            dbg = run_stage2(nodes, size, bf, k=config.k, use_exact=True)
            if nid is not None:
                # Kept rows keep their lexicographic order, so the old
                # node ids remap by rank among the keep mask.
                remap = dev(
                    np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32))
                nid = jnp.where(nid >= 0, remap[jnp.clip(nid, 0, None)], -1)
            cov, reach_jun, reach_uni, chars = run_stage3(dbg, nid)
            log.write(f"simplify round {rnd + 1}: dropped "
                      f"{n_drop} unitigs, {n_keep} nodes left")
        timer.mark("simplify", sync=(cov, reach_jun))

    if ckpt is not None and not restored3:
        _save_stage3(ckpt, dbg, cov, reach_jun, reach_uni, chars)
        log.write("stage3 checkpoint saved")

    if not config.restrict_to_seeds:
        reach_jun = jnp.ones_like(reach_jun)
        reach_uni = jnp.ones_like(reach_uni)

    # ---- stage 4: device emission packs -> host GFA rendering ----
    seqs, lines = _emit_output(dbg, cov, reach_jun, reach_uni, chars,
                               config.k)
    if write_output:
        with open(config.gfa_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    timer.mark("stage4_emit")
    n_s = sum(1 for ln in lines if ln.startswith("S\tStraight"))
    n_j = sum(1 for ln in lines if ln.startswith("S\tJunction"))
    log.write(f"finish ({time.time() - t0:.2f}s, {n_s} straights, "
              f"{n_j} junctions)")
    if timer.spans:
        log.write("stage breakdown: " + "; ".join(
            f"{name}={dt:.3f}s" for name, dt in timer.spans.items()))

    return AssemblyResult(
        gfa_lines=lines, straight_seqs=seqs, dbg=dbg, cov=cov,
        reach_jun=reach_jun, reach_uni=reach_uni,
        num_nodes=int(dbg.size) if dbg is not None else num_nodes,
        num_junctions=n_j, num_straights=n_s,
        stats={"elapsed_s": time.time() - t0,
               "all_bases": batch.all_bases,
               "num_reads": batch.num_reads,
               "solid_nodes": num_nodes,
               "stages": dict(timer.spans)},
    )
