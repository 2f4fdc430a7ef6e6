"""Streaming (bounded-memory) assembly for read sets larger than device
memory.

The single-shot pipeline (pipeline.py) holds every k-mer position of the
whole read set on device at once -- ideal up to tens of millions of
bases, impossible for a human-chromosome run (BASELINE config 5).  The
streaming mode processes the chunked read batch in fixed-size SLICES of
chunks with static shapes (one compile per stage regardless of input
size), in the classic two-pass counting layout (cf. KMC/Gerbil two-pass
disk counters, PAPERS.md -- here the "disk" is device HBM and the second
pass re-extracts from packed reads):

  pass 1: per slice, APPEND valid canonical short k-mers (with position
          ids) into hash-partitioned device buffers; then sort each
          partition ONCE and scatter run totals into a per-position
          counts array (ops/partitioned.py -- no per-slice full-table
          sorts; each position is sorted exactly once globally);
  pass 2: per slice, window-min solidity from a CONTIGUOUS slice of the
          counts array (no lookup) -> seed reduction (+ optional Bloom
          add) -> solid owned k-mers appended into node partition
          buffers; then dedup each partition once and lex-sort the
          disjoint uniques into the node table;
  graph:  single-shot on the merged node table (graph arrays scale with
          the genome, not the read volume);
  pass 3: per slice, coverage/tally accumulation into [M]-sized arrays.

``short_cap`` / ``node_cap``: optional declared bounds on distinct short
k-mers / solid nodes -- exceeding a positive bound raises with the
observed size (API-compatible with the round-4 fixed-capacity
accumulators, which REQUIRED them; the partitioned design sizes its
buffers from exact position totals instead).  The mesh path still uses
them as its sharded table capacities.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.config import AssemblyConfig
from platanus3_tpu.graph import coverage as cov_mod
from platanus3_tpu.graph import reach as reach_mod
from platanus3_tpu.graph import sequence as seq_mod
from platanus3_tpu.io import gfa as gfa_mod
from platanus3_tpu.io import reads as reads_mod
from platanus3_tpu.ops import bloom as bloom_mod
from platanus3_tpu.ops import count as count_mod
from platanus3_tpu.ops import kmer as kmer_mod
from platanus3_tpu.ops import solid as solid_mod
from platanus3_tpu.ops.windowmin import window_min
from platanus3_tpu.pipeline import (AssemblyResult, _graph_cap, _next_pow2,
                                    _stage3, run_stage2)
from platanus3_tpu.utils.logging import PipelineLog

__all__ = ["assemble_streaming"]


@partial(jax.jit, static_argnames=("k",))
def _reach_chars_jit(dbg, seed_fw, has_seed, *, k):
    """One jitted program for seed reachability + member chars instead
    of hundreds of eager per-op dispatches.  Chromosome-scale graphs
    instead run the STAGED flood (see reach._REACH_STAGED_THRESHOLD)."""
    rj, ru = reach_mod.reachable(dbg, seed_fw, has_seed, k)
    return rj, ru, seq_mod.member_chars(dbg, k)


@partial(jax.jit, static_argnames=("k",))
def _cov_slice(dbg, packed, valid_len, start, read_len, prev_base,
               next_base, node_cov, jun_tally, *, k):
    bases = kmer_mod.unpack_bases(packed)
    cov = cov_mod.count_coverage(
        dbg, k, bases, valid_len, start, read_len, prev_base, next_base)
    return node_cov + cov.node_cov, jun_tally + cov.jun_tally


def _slices(total: int, step: int):
    for lo in range(0, total, step):
        yield lo, min(lo + step, total)


def _make_mesh_slice_fns(mesh, *, k, short_k, chunk_len, slice_chunks,
                         num_reads, short_shard_cap, node_shard_cap,
                         add_to_bloom, bf_log2, bf_hashes, slack=1.5):
    """shard_map'd per-slice programs for streaming x mesh (BASELINE
    config 5: bounded memory AND hash-prefix table sharding at once).

    Accumulator tables live device-SHARDED: shard ``d`` owns the k-mers
    with ``h1 % n == d`` (keys/counts ``[n*cap]`` arrays with P('d')
    sharding, per-shard sizes ``[n]``).  Each slice routes its extracted
    k-mers to owners with one all_to_all (parallel/sharded.py helpers),
    owners merge into their shard (``merge_into``, overflow latched), and
    pass-2 count lookups ride the inverse all_to_all back to the reads'
    devices.  Results are bitwise-equal to single-device streaming.
    """
    import math as _math
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from platanus3_tpu.parallel import sharded as sh

    n = mesh.devices.size
    cl = slice_chunks // n
    stride = chunk_len - k + 1
    p_short = chunk_len - short_k + 1
    pk = stride
    nl_s = cl * p_short
    nl_k = cl * pk
    cap_s = int(_math.ceil(slack * nl_s / n))
    cap_k = int(_math.ceil(slack * nl_k / n))
    big = np.int32(2**30)

    def count_local(packed, vlen, start, rlen, keys, counts, size, ovf):
        bases = kmer_mod.unpack_bases(packed)
        s_canon, s_valid, s_owned = solid_mod.short_kmer_positions(
            bases, vlen, start, rlen, stride, short_k, k)
        ls = s_canon.shape[-1]
        routed = sh.route_to_owners(
            s_canon.reshape(-1, ls), s_owned.reshape(-1),
            s_owned.reshape(-1), n, cap_s, short_k)
        batch = count_mod.count_kmers(
            routed.recv_kmers, routed.recv_flags == 2, k=short_k)
        tbl = count_mod.KmerTable(keys, counts, size[0])
        merged = count_mod.merge_into(tbl, batch, short_shard_cap)
        over = routed.overflow + jnp.maximum(
            merged.size - short_shard_cap, 0)
        return (merged.keys, merged.counts, merged.size[None],
                ovf + jax.lax.psum(over, "d"))

    def solid_local(packed, vlen, rid, start, rlen,
                    skeys, scounts, ssize, nkeys, ncounts, nsize,
                    min_pos, seed_fw, bf_bits, cov_threshold, ovf):
        bases = kmer_mod.unpack_bases(packed)
        s_canon, s_valid, _ = solid_mod.short_kmer_positions(
            bases, vlen, start, rlen, stride, short_k, k)
        ls = s_canon.shape[-1]
        # per-position short counts: route queries to owners, look up the
        # owner's shard table, ride back.
        routed = sh.route_to_owners(
            s_canon.reshape(-1, ls), s_valid.reshape(-1),
            s_valid.reshape(-1), n, cap_s, short_k)
        stbl = count_mod.KmerTable(skeys, scounts, ssize[0])
        r_counts = count_mod.lookup_join(stbl, routed.recv_kmers)
        r_counts = jnp.where(routed.recv_flags > 0, r_counts, 0)
        per_pos = sh.route_values_back(routed, r_counts, nl_s)
        short_counts = per_pos.reshape(cl, p_short)

        w = k - short_k + 1
        cov_est = window_min(short_counts, w)
        fwk, valid_k = kmer_mod.extract_kmers(bases, vlen, k)
        canon_k, _ = kmer_mod.canonical(fwk, k)
        owned_k = solid_mod.owned_mask(start, rlen, stride, pk, k, k) & valid_k
        is_solid = (cov_est >= cov_threshold) & valid_k
        solid_owned = is_solid & owned_k

        lk = canon_k.shape[-1]
        routed_k = sh.route_to_owners(
            canon_k.reshape(-1, lk), solid_owned.reshape(-1),
            solid_owned.reshape(-1), n, cap_k, k)
        batch_nodes = count_mod.count_kmers(
            routed_k.recv_kmers, routed_k.recv_flags == 2, k=k)
        ntbl = count_mod.KmerTable(nkeys, ncounts, nsize[0])
        nmerged = count_mod.merge_into(ntbl, batch_nodes, node_shard_cap)
        # Latch overflow from ALL pass-2 routes: the short-count lookup
        # route above sends every valid position (a strict superset of
        # what pass 1 routed), so its buckets can overflow even when
        # pass 1 did not -- dropped queries would come back as count 0
        # and silently understate window-min coverage.
        over = (routed.overflow + routed_k.overflow
                + jnp.maximum(nmerged.size - node_shard_cap, 0))

        if add_to_bloom:
            bf_local = bloom_mod.BloomFilter(bf_bits, bf_log2, bf_hashes)
            bf_local = bloom_mod.bloom_add(
                bf_local, canon_k.reshape(-1, lk), k,
                mask=solid_owned.reshape(-1))
            bf_bits = sh.or_allreduce(bf_local.bits, n)

        # ---- seeds: first solid owned position per read, global ----
        local_pos = jnp.arange(pk, dtype=jnp.int32)[None, :]
        gpos = start[:, None] + local_pos
        gpos_m = jnp.where(solid_owned, gpos, big)
        chunk_min = jnp.min(gpos_m, axis=1)
        min_l = jax.ops.segment_min(chunk_min, rid, num_segments=num_reads)
        min_l = jnp.minimum(min_l, big)
        batch_min = jax.lax.pmin(min_l, "d")
        # local flat index of the winning position (if held locally)
        rid_b = jnp.broadcast_to(rid[:, None], (cl, pk))
        flat = (jnp.arange(cl, dtype=jnp.int32)[:, None] * pk + local_pos)
        cand = jnp.where(solid_owned & (gpos == batch_min[rid_b]), flat, big)
        cmin = jnp.min(cand, axis=1)
        fidx = jax.ops.segment_min(cmin, rid, num_segments=num_reads)
        have = fidx < big
        kmer_here = jnp.where(
            have[:, None],
            fwk.reshape(-1, lk)[jnp.clip(fidx, 0, nl_k - 1)], np.uint32(0))
        batch_seed = jax.lax.pmax(kmer_here, "d")
        upd = batch_min < min_pos
        seed_fw = jnp.where(upd[:, None], batch_seed, seed_fw)
        min_pos = jnp.minimum(min_pos, batch_min)

        return (nmerged.keys, nmerged.counts, nmerged.size[None],
                min_pos, seed_fw, bf_bits, ovf + jax.lax.psum(over, "d"))

    def cov_local(dbg, packed, vlen, start, rlen, pb, nb, node_cov,
                  jun_tally):
        bases = kmer_mod.unpack_bases(packed)
        cov = cov_mod.count_coverage(
            dbg, k, bases, vlen, start, rlen, pb, nb)
        return (node_cov + jax.lax.psum(cov.node_cov, "d"),
                jun_tally + jax.lax.psum(cov.jun_tally, "d"))

    Pd, Pr = P("d"), P()
    count_fn = jax.jit(shard_map(
        count_local, mesh=mesh,
        in_specs=(Pd, Pd, Pd, Pd, Pd, Pd, Pd, Pr),
        out_specs=(Pd, Pd, Pd, Pr), check_vma=False))
    solid_fn = jax.jit(shard_map(
        solid_local, mesh=mesh,
        in_specs=(Pd, Pd, Pd, Pd, Pd, Pd, Pd, Pd, Pd, Pd, Pd,
                  Pr, Pr, Pr, Pr, Pr),
        out_specs=(Pd, Pd, Pd, Pr, Pr, Pr, Pr), check_vma=False))

    def make_cov_fn(dbg):
        dbg_spec = jax.tree.map(lambda _: Pr, dbg)
        return jax.jit(shard_map(
            cov_local, mesh=mesh,
            in_specs=(dbg_spec, Pd, Pd, Pd, Pd, Pd, Pd, Pr, Pr),
            out_specs=(Pr, Pr), check_vma=False))

    return count_fn, solid_fn, make_cov_fn


def assemble_streaming(source, config: AssemblyConfig,
                       log: Optional[PipelineLog] = None,
                       write_output: bool = True,
                       short_cap: int = 0, node_cap: int = 0,
                       slice_chunks: int = 2048,
                       mesh=None, extra_solid=None) -> AssemblyResult:
    """Bounded-memory assembly.  ``slice_chunks`` chunks are resident per
    device step; ``short_cap``/``node_cap`` are optional declared bounds
    (exceeding one raises; the mesh path uses them as its sharded table
    capacities and defaults them to 4x/2x the slice position count).

    ``extra_solid``: sequences whose k-mers join the node set
    unconditionally (multi-k re-seeding, graph/multik.py) -- merged into
    the node table after pass 2, exactly like the single-shot pipeline's
    hook, so multi-k now composes with streaming (VERDICT r4 item 4).

    ``config.checkpoint_dir``: enables stage checkpoints -- "spass2"
    (node table + seeds + optional Bloom bits, saved after pass 2; a
    resume skips both streaming passes) and "stage3" (post-simplify
    graph + coverage + reachability; a resume skips to emission).
    Crash/resume is exercised by the P3_FAULT_AFTER hook like the
    single-shot pipeline (utils/checkpoint.py).

    ``mesh``: optional ``jax.sharding.Mesh`` with axis 'd' -- each slice
    is processed data-parallel across the mesh with the accumulated count
    and node tables HASH-PREFIX SHARDED over devices (all-to-all routing,
    ``_make_mesh_slice_fns``): BASELINE config 5's "chr21, sharded k-mer
    table, >=2 hosts, bounded memory" topology.  Output is bitwise-equal
    to the single-device streaming path."""
    log = log or PipelineLog(config.log_path, echo=False)
    t0 = time.time()
    from platanus3_tpu.utils.profiling import StageTimer
    timer = StageTimer(barriers=config.profile_stages)

    if isinstance(source, reads_mod.ReadBatch):
        batch = source
    elif isinstance(source, (list, tuple)):
        batch = reads_mod.reads_from_strings(list(source), config.k,
                                             config.chunk_len)
    else:
        batch = reads_mod.load_reads(source, config.k, config.chunk_len)
    c_total = batch.num_chunks
    log.write(f"[streaming] {batch.num_reads} reads, {batch.all_bases} "
              f"bases, {c_total} chunks, slice={slice_chunks}, "
              f"{batch.parser} parser")
    timer.mark("load")

    k = config.k
    short_k = min(config.short_k, k)
    p_short = config.chunk_len - short_k + 1
    n_dev = mesh.devices.size if mesh is not None else 1
    if mesh is not None and slice_chunks % n_dev:
        slice_chunks += n_dev - slice_chunks % n_dev
    if mesh is not None:
        # The mesh path accumulates into fixed-capacity sharded tables
        # and needs concrete caps; the single-device path auto-sizes its
        # partition buffers from exact position totals, so caps there
        # are optional declared bounds (checked, raise on excess).
        if short_cap <= 0:
            short_cap = _next_pow2(4 * slice_chunks * p_short)
        if node_cap <= 0:
            node_cap = _next_pow2(2 * slice_chunks * p_short)

    need_bloom = (not config.use_exact_membership) or config.build_bloom
    if need_bloom:
        bits, hashes = config.auto_filter_bits(batch.all_bases)
        bf = bloom_mod.make_bloom(bits, hashes)
    else:
        bf = bloom_mod.make_bloom(8, 1)

    l_s = kmer_mod.num_lanes(short_k)
    l_k = kmer_mod.num_lanes(k)

    ckpt = None
    if config.checkpoint_dir:
        from platanus3_tpu.pipeline import hashlib_digest
        from platanus3_tpu.utils.checkpoint import Checkpointer
        ckpt = Checkpointer(
            config.checkpoint_dir,
            # "fmt=2" versions the array layouts (ADVICE r4); the
            # "streaming" token keeps these stages apart from the
            # single-shot pipeline's (same results, different formats).
            # slice_chunks is EXCLUDED: results are slice-invariant.
            digest_parts=("fmt=2", "streaming",
                          config.k, config.short_k, config.cov_threshold,
                          config.filter_policy, config.filter_bits,
                          config.chunk_len, need_bloom, batch.num_reads,
                          batch.all_bases, config.use_exact_membership,
                          config.clip_tips, config.pop_bubbles,
                          config.simplify_rounds, config.tip_max_len,
                          config.tip_cov_ratio, config.bubble_len_ratio,
                          hashlib_digest(batch.packed),
                          hashlib_digest(np.frombuffer(
                              "\n".join(extra_solid).encode(), np.uint8))
                          if extra_solid else ""))

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        from platanus3_tpu.parallel.sharded import to_global

    def slice_arrays(lo, hi, step=None):
        pad = (step or slice_chunks) - (hi - lo)
        def cut(a, fill=0):
            s = np.asarray(a[lo:hi])
            if pad:
                s = np.concatenate(
                    [s, np.full((pad,) + s.shape[1:], fill, s.dtype)])
            return (jnp.asarray(s) if mesh is None
                    else to_global(mesh, s, P("d")))
        return (cut(batch.packed), cut(batch.valid_len), cut(batch.read_id),
                cut(batch.start), cut(batch.read_len),
                cut(batch.prev_base, 4), cut(batch.next_base, 4))

    # XLA:CPU's in-process collectives can DEADLOCK when two executions
    # of a collective program are in flight at once (async dispatch lets
    # the slice loop enqueue slice i+1 while slice i still runs; the
    # shared Eigen pool fills with rendezvous waits from both RunIds and
    # no thread remains to run the missing participants).  On GPUs each
    # collective is enqueued in order on every device's stream, so the
    # slice loop stays asynchronous there (chip_smoke.py --four runs it
    # on four GPUs without a per-slice barrier).
    sync_each_slice = (mesh is not None
                       and mesh.devices.flat[0].platform == "cpu")

    def _slice_barrier(x):
        if sync_each_slice:
            jax.block_until_ready(x)

    restored3 = ckpt is not None and ckpt.has("stage3")
    restored2 = (not restored3 and ckpt is not None
                 and ckpt.has("spass2"))
    make_cov_fn = None
    if restored3:
        node_table = None
        num_nodes = 0
        min_pos = seed_fw = has_seed = None
        log.write("[streaming] stage3 checkpoint found (skip to emission)")
    elif restored2:
        d = ckpt.load("spass2")
        node_table = count_mod.KmerTable(
            keys=jnp.asarray(d["keys"]),
            counts=jnp.zeros((d["keys"].shape[0],), jnp.int32),
            size=jnp.asarray(d["size"]))
        num_nodes = int(node_table.size)
        min_pos = jnp.asarray(d["min_pos"])
        seed_fw = jnp.asarray(d["seed_fw"])
        has_seed = jnp.asarray(d["has_seed"])
        if need_bloom:
            bf = bf._replace(bits=jnp.asarray(d["bf_bits"]))
        if mesh is not None:
            _, _, make_cov_fn = _make_mesh_slice_fns(
                mesh, k=k, short_k=short_k, chunk_len=config.chunk_len,
                slice_chunks=slice_chunks, num_reads=batch.num_reads,
                short_shard_cap=-(-short_cap // n_dev),
                node_shard_cap=-(-node_cap // n_dev),
                add_to_bloom=need_bloom, bf_log2=bf.log2_bits,
                bf_hashes=bf.num_hashes)
        timer.mark("restore_spass2")
        log.write("[streaming] passes 1+2 restored from checkpoint")
    elif mesh is not None:
        # ---- mesh passes 1+2: hash-prefix-sharded accumulators ----
        sscap = -(-short_cap // n_dev)
        nscap = -(-node_cap // n_dev)
        count_fn, solid_fn, make_cov_fn = _make_mesh_slice_fns(
            mesh, k=k, short_k=short_k, chunk_len=config.chunk_len,
            slice_chunks=slice_chunks, num_reads=batch.num_reads,
            short_shard_cap=sscap, node_shard_cap=nscap,
            add_to_bloom=need_bloom, bf_log2=bf.log2_bits,
            bf_hashes=bf.num_hashes)
        tgr = lambda x: to_global(mesh, np.asarray(x), P())
        tgd = lambda x: to_global(mesh, np.asarray(x), P("d"))

        skeys = tgd(np.full((n_dev * sscap, l_s), 0xFFFFFFFF, np.uint32))
        scounts = tgd(np.zeros(n_dev * sscap, np.int32))
        ssizes = tgd(np.zeros(n_dev, np.int32))
        ovf = tgr(np.zeros((), np.int32))
        for lo, hi in _slices(c_total, slice_chunks):
            packed, vlen, rid, start, rlen, _, _ = slice_arrays(lo, hi)
            skeys, scounts, ssizes, ovf = count_fn(
                packed, vlen, start, rlen, skeys, scounts, ssizes, ovf)
            _slice_barrier(ovf)
        if int(jax.device_get(ovf)):
            raise RuntimeError(
                f"sharded short-table overflow ({int(jax.device_get(ovf))}"
                f" rows); re-run with larger short_cap / slack")
        n_short = int(np.sum(np.asarray(ssizes)))
        log.write(f"[streaming] pass1 done (mesh {n_dev}): {n_short} "
                  f"distinct short k-mers")

        nkeys = tgd(np.full((n_dev * nscap, l_k), 0xFFFFFFFF, np.uint32))
        ncounts = tgd(np.zeros(n_dev * nscap, np.int32))
        nsizes = tgd(np.zeros(n_dev, np.int32))
        min_pos = tgr(np.full(batch.num_reads, 2**30, np.int32))
        seed_fw = tgr(np.zeros((batch.num_reads, l_k), np.uint32))
        bf_bits = tgr(np.asarray(bf.bits))
        cov_thr = tgr(np.asarray(config.cov_threshold, np.int32))
        ovf = tgr(np.zeros((), np.int32))
        for lo, hi in _slices(c_total, slice_chunks):
            packed, vlen, rid, start, rlen, _, _ = slice_arrays(lo, hi)
            (nkeys, ncounts, nsizes, min_pos, seed_fw, bf_bits,
             ovf) = solid_fn(packed, vlen, rid, start, rlen,
                             skeys, scounts, ssizes,
                             nkeys, ncounts, nsizes,
                             min_pos, seed_fw, bf_bits, cov_thr, ovf)
            _slice_barrier(ovf)
        if int(jax.device_get(ovf)):
            raise RuntimeError(
                f"sharded pass-2 overflow ({int(jax.device_get(ovf))} rows;"
                f" node-table merge, solid-kmer route, or short-count "
                f"lookup route); re-run with larger node_cap / slack")
        bf = bf._replace(bits=bf_bits)

        # Merge shard tables into one replicated lex-sorted node table.
        repl = jax.sharding.NamedSharding(mesh, P())
        @partial(jax.jit, static_argnames=("cap",), out_shardings=repl)
        def _merge_shards(keys, sizes, *, cap):
            row = jnp.arange(keys.shape[0])
            valid = (row % cap) < sizes[row // cap]
            return count_mod.count_kmers(keys, valid, k=k)
        node_table = _merge_shards(nkeys, nsizes, cap=nscap)
        num_nodes = int(node_table.size)
        has_seed = min_pos < np.int32(2**30)
        log.write(f"[streaming] pass2 done (mesh {n_dev}): {num_nodes} "
                  f"solid nodes")
    else:
        # ---- single-device streaming: partitioned collect -> count ----
        # (ops/partitioned.py -- NO per-slice full-table sorts; VERDICT
        # r4 item 1.  Each position is sorted once globally; per-slice
        # work is extraction + one slice-local sort + block appends.)
        from platanus3_tpu.ops import partitioned as part_mod
        parts = part_mod.NUM_PARTS
        pk = config.chunk_len - k + 1
        c_pad_total = -(-c_total // slice_chunks) * slice_chunks
        total_s = c_pad_total * p_short
        if total_s >= 2**31:
            raise ValueError(
                f"streaming position space {total_s} exceeds 2^31 "
                f"(position ids are 31-bit); split the input into "
                f"multiple batches or raise chunk_len")
        # pass 1 pre-pass: exact per-partition histograms (plan_caps
        # docstring: uniform slack is not composition-proof; repeat
        # families concentrate millions of rows on single partitions).
        h_tot = jnp.zeros((parts,), jnp.int32)
        h_max = jnp.zeros((parts,), jnp.int32)
        for lo, hi in _slices(c_total, slice_chunks):
            packed, vlen, rid, start, rlen, _, _ = slice_arrays(lo, hi)
            h_tot, h_max = part_mod.histogram_short_slice(
                h_tot, h_max, packed, vlen, start, rlen, k=k,
                short_k=short_k, parts=parts)
        s_blks_s, caps_s, bases_s, total_rows_s = part_mod.plan_caps(
            jax.device_get(h_tot), jax.device_get(h_max), parts)
        timer.mark("pass1_histogram")
        log.write(f"[streaming] pass1 plan: {total_rows_s} buffer rows x "
                  f"{l_s + 1} cols "
                  f"({total_rows_s * (l_s + 1) * 4 / 2**30:.2f} GiB), "
                  f"max partition {max(caps_s)}")

        # pass 1 collect: (short-kmer lanes, posid|owned) into P buffers
        import gc
        gc.collect()  # drop pre-pass slice buffers before the big alloc
        bufs = tuple(jnp.zeros((total_rows_s,), jnp.uint32)
                     for _ in range(l_s + 1))
        fills = jnp.zeros((parts,), jnp.int32)
        ovf = jnp.zeros((), bool)
        for lo, hi in _slices(c_total, slice_chunks):
            packed, vlen, rid, start, rlen, _, _ = slice_arrays(lo, hi)
            bufs, fills, ovf = part_mod.collect_short_slice(
                bufs, fills, ovf, packed, vlen, start, rlen,
                np.int32(lo * p_short), k=k, short_k=short_k,
                parts=parts, s_blks=s_blks_s, caps=caps_s, bases=bases_s)
        if bool(jax.device_get(ovf)):
            raise RuntimeError(
                "streaming pass-1 partition-buffer overflow -- "
                "impossible with histogram-planned capacities; "
                "indicates nondeterministic extraction (bug)")
        timer.mark("pass1_collect")

        # pass 1 count: one sort per partition, counts scattered to the
        # per-position array the window-min reads contiguously.
        counts = jnp.zeros((total_s,), jnp.int32)
        n_uni_parts = []
        for p in range(parts):
            counts, nu = part_mod.count_partition(
                counts, bufs, fills, np.int32(p), np.int32(bases_s[p]),
                short_k=short_k, cap_p=caps_s[p])
            n_uni_parts.append(nu)
        n_short = int(sum(int(x) for x in jax.device_get(n_uni_parts)))
        del bufs, fills
        timer.mark("pass1_count")
        if 0 < short_cap < n_short:
            raise RuntimeError(
                f"short_cap {short_cap} overflow: {n_short} distinct "
                f"short k-mers observed; re-run with larger short_cap")
        log.write(f"[streaming] pass1 done: {n_short} distinct short k-mers")

        # pass 2 pre-pass: exact histograms of the solid-owned rows.
        h_tot = jnp.zeros((parts,), jnp.int32)
        h_max = jnp.zeros((parts,), jnp.int32)
        for lo, hi in _slices(c_total, slice_chunks):
            packed, vlen, rid, start, rlen, _, _ = slice_arrays(lo, hi)
            h_tot, h_max = part_mod.histogram_solid_slice(
                h_tot, h_max, counts, packed, vlen, start, rlen,
                np.int32(lo * p_short), k=k, short_k=short_k,
                cov_threshold=config.cov_threshold, parts=parts)
        s_blks_k, caps_k, bases_k, total_rows_k = part_mod.plan_caps(
            jax.device_get(h_tot), jax.device_get(h_max), parts)
        timer.mark("pass2_histogram")
        log.write(f"[streaming] pass2 plan: {total_rows_k} buffer rows x "
                  f"{l_k} cols "
                  f"({total_rows_k * l_k * 4 / 2**30:.2f} GiB), "
                  f"max partition {max(caps_k)}")

        # pass 2 collect: contiguous counts slice -> window-min ->
        # solid owned canonical k-mers into node partition buffers
        # (+ seeds, + optional Bloom).
        bufs2 = tuple(jnp.zeros((total_rows_k,), jnp.uint32)
                      for _ in range(l_k))
        fills2 = jnp.zeros((parts,), jnp.int32)
        ovf = jnp.zeros((), bool)
        min_pos = jnp.full((batch.num_reads,), np.int32(2**30))
        seed_fw = jnp.zeros((batch.num_reads, l_k), jnp.uint32)
        bf_bits = bf.bits
        for lo, hi in _slices(c_total, slice_chunks):
            packed, vlen, rid, start, rlen, _, _ = slice_arrays(lo, hi)
            (bufs2, fills2, ovf, min_pos, seed_fw,
             bf_bits) = part_mod.solid_collect_slice(
                bufs2, fills2, ovf, min_pos, seed_fw, bf_bits, counts,
                packed, vlen, rid, start, rlen, np.int32(lo * p_short),
                k=k, short_k=short_k,
                cov_threshold=config.cov_threshold,
                num_reads=batch.num_reads, parts=parts, s_blks=s_blks_k,
                caps=caps_k, bases=bases_k, add_bloom=need_bloom,
                bf_log2=bf.log2_bits, bf_hashes=bf.num_hashes)
        if bool(jax.device_get(ovf)):
            raise RuntimeError(
                "streaming pass-2 partition-buffer overflow -- "
                "impossible with histogram-planned capacities; "
                "indicates nondeterministic extraction (bug)")
        timer.mark("pass2_collect")
        bf = bf._replace(bits=bf_bits)
        del counts

        # pass 2 count: dedup each partition once; partitions are
        # disjoint, one final sort gives the lex-sorted node table.
        outs, n_ps = [], []
        for p in range(parts):
            o, n_p = part_mod.dedup_partition(
                bufs2, fills2, np.int32(p), np.int32(bases_k[p]), k=k,
                cap_p=caps_k[p])
            outs.append(o)
            n_ps.append(n_p)
        n_ps = [int(x) for x in jax.device_get(n_ps)]
        del bufs2, fills2
        timer.mark("pass2_dedup")
        n_total = sum(n_ps)
        if 0 < node_cap < n_total:
            raise RuntimeError(
                f"node_cap {node_cap} overflow: {n_total} distinct solid "
                f"nodes observed; re-run with larger node_cap")
        dst_cap = n_total + max(caps_k)
        dst = tuple(jnp.full((dst_cap,), np.uint32(0xFFFFFFFF))
                    for _ in range(l_k))
        off = 0
        for o, n_p in zip(outs, n_ps):
            dst = part_mod.place_block(dst, o, np.int32(off))
            off += n_p
        del outs
        node_table = part_mod.finalize_table(dst, np.int32(n_total), k=k)
        del dst
        num_nodes = int(node_table.size)
        has_seed = min_pos < np.int32(2**30)
        timer.mark("pass2_table")
        log.write(f"[streaming] pass2 done: {num_nodes} solid nodes")

    if extra_solid and not restored2 and not restored3:
        # Multi-k re-seeding hook: prior-round unitigs' k-mers become
        # nodes unconditionally (pipeline._extra_solid_table contract).
        from platanus3_tpu.pipeline import _extra_solid_table
        etab, eseed = _extra_solid_table(extra_solid, config)
        node_table = count_mod.merge_tables(node_table, etab)
        num_nodes = int(node_table.size)
        seed_fw = jnp.concatenate([seed_fw, eseed], axis=0)
        has_seed = jnp.concatenate(
            [has_seed, jnp.ones((eseed.shape[0],), bool)])
        log.write(f"[streaming] extra-solid merge: {len(extra_solid)} seqs")

    if ckpt is not None and not restored2 and not restored3:
        n_keep = max(num_nodes, 1)
        extra_arrays = ({"bf_bits": np.asarray(bf.bits)}
                        if need_bloom else {})
        ckpt.save("spass2",
                  keys=np.asarray(node_table.keys[:n_keep]),
                  size=np.asarray(jnp.asarray(num_nodes, jnp.int32)),
                  min_pos=np.asarray(min_pos),
                  seed_fw=np.asarray(seed_fw),
                  has_seed=np.asarray(has_seed), **extra_arrays)
        log.write("[streaming] pass1+2 checkpoint saved")

    if restored3:
        from platanus3_tpu.pipeline import _load_stage3
        dbg, cov, reach_jun, reach_uni, chars = _load_stage3(ckpt)
        num_nodes = int(dbg.size)
        timer.mark("restore")
        log.write("[streaming] stage3 restored from checkpoint")
        # accumulate_coverage unused on this path (graph+coverage loaded)
        return _finish_streaming(
            config, log, timer, t0, batch, write_output, dbg, cov,
            reach_jun, reach_uni, chars, k, num_nodes)

    # ---- graph (genome-sized, single shot) ----
    cap = _graph_cap(num_nodes)
    rows = node_table.keys.shape[0]
    if cap <= rows:
        nodes = jax.block_until_ready(node_table.keys[:cap])
    else:
        nodes = jnp.concatenate([
            node_table.keys,
            jnp.full((cap - rows, l_k), np.uint32(0xFFFFFFFF))], axis=0)
    # Release the read-volume-sized accumulators before the graph stage --
    # the short table + node table caps are device memory the neighbor
    # joins need.
    del node_table
    if mesh is not None:
        del skeys, scounts, nkeys, ncounts
    dbg = run_stage2(nodes, jnp.asarray(num_nodes, jnp.int32), bf, k=k,
                     use_exact=config.use_exact_membership)
    timer.mark("graph", sync=dbg)
    log.write("[streaming] graph built")

    # ---- pass 3: coverage accumulation ----
    def accumulate_coverage(dbg):
        m = dbg.nodes.shape[0]
        if mesh is not None:
            cov_fn = make_cov_fn(dbg)
            node_cov = to_global(mesh, np.zeros(m, np.int32), P())
            jun_tally = to_global(mesh, np.zeros(m * 8, np.int32), P())
            for lo, hi in _slices(c_total, slice_chunks):
                packed, vlen, rid, start, rlen, pb, nb = slice_arrays(lo, hi)
                node_cov, jun_tally = cov_fn(
                    dbg, packed, vlen, start, rlen, pb, nb, node_cov,
                    jun_tally)
                _slice_barrier(node_cov)
            return cov_mod.CoverageResult(node_cov=node_cov,
                                          jun_tally=jun_tally)
        node_cov = jnp.zeros((m,), jnp.int32)
        jun_tally = jnp.zeros((m * 8,), jnp.int32)
        # Double-width coverage slices: each slice re-sorts the node
        # table in its id join (count_coverage), so fewer, larger
        # slices cut the dominant re-sort count in half for ~1 GB more
        # slice workspace.
        step2 = 2 * slice_chunks
        for lo, hi in _slices(c_total, step2):
            packed, vlen, rid, start, rlen, pb, nb = slice_arrays(
                lo, hi, step2)
            node_cov, jun_tally = _cov_slice(
                dbg, packed, vlen, start, rlen, pb, nb, node_cov,
                jun_tally, k=k)
        return cov_mod.CoverageResult(node_cov=node_cov,
                                      jun_tally=jun_tally)

    cov = accumulate_coverage(dbg)
    timer.mark("coverage", sync=cov)

    # ---- simplification rounds (tips / bubbles), streaming variant ----
    # Decisions run host-side on genome-sized graph arrays; each round's
    # coverage refresh is another slice-wise pass over the reads.
    if config.clip_tips or config.pop_bubbles:
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
            padk = np.full((cap2 - n_keep, kept_keys.shape[1]),
                           np.uint32(0xFFFFFFFF))
            nodes = jnp.asarray(np.concatenate([kept_keys, padk]))
            dbg = run_stage2(nodes, jnp.asarray(n_keep, jnp.int32), bf,
                             k=k, use_exact=True)
            cov = accumulate_coverage(dbg)
            log.write(f"[streaming] simplify round {rnd + 1}: dropped "
                      f"{n_drop} unitigs, {n_keep} nodes left")
        num_nodes = int(dbg.size)

    timer.mark("simplify", sync=cov)
    if dbg.nodes.shape[0] > reach_mod._REACH_STAGED_THRESHOLD:
        reach_jun, reach_uni = reach_mod.reachable(dbg, seed_fw, has_seed,
                                                   k, staged=True)
        chars = seq_mod.member_chars(dbg, k)
    else:
        reach_jun, reach_uni, chars = _reach_chars_jit(dbg, seed_fw,
                                                       has_seed, k=k)
    timer.mark("reach_chars", sync=(reach_jun, chars))

    if ckpt is not None:
        from platanus3_tpu.pipeline import _save_stage3
        _save_stage3(ckpt, dbg, cov, reach_jun, reach_uni, chars)
        log.write("[streaming] stage3 checkpoint saved")

    return _finish_streaming(config, log, timer, t0, batch, write_output,
                             dbg, cov, reach_jun, reach_uni, chars, k,
                             num_nodes)


def _finish_streaming(config, log, timer, t0, batch, write_output, dbg,
                      cov, reach_jun, reach_uni, chars, k, num_nodes):
    """Shared tail: seed-restriction override, device emission packs,
    host GFA rendering, result assembly (also the stage3-resume entry
    point)."""
    if not config.restrict_to_seeds:
        reach_jun = jnp.ones_like(reach_jun)
        reach_uni = jnp.ones_like(reach_uni)
    log.write("[streaming] coverage done")

    # ---- host output (compact device packs) ----
    from platanus3_tpu.pipeline import _emit_output
    seqs, lines = _emit_output(dbg, cov, reach_jun, reach_uni, chars, k)
    if write_output:
        with open(config.gfa_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    timer.mark("emit")
    n_s = sum(1 for ln in lines if ln.startswith("S\tStraight"))
    n_j = sum(1 for ln in lines if ln.startswith("S\tJunction"))
    log.write(f"[streaming] finish ({time.time() - t0:.2f}s, {n_s} "
              f"straights, {n_j} junctions)")
    return AssemblyResult(
        gfa_lines=lines, straight_seqs=seqs, dbg=dbg, cov=cov,
        reach_jun=reach_jun, reach_uni=reach_uni, num_nodes=num_nodes,
        num_junctions=n_j, num_straights=n_s,
        stats={"elapsed_s": time.time() - t0,
               "all_bases": batch.all_bases,
               "num_reads": batch.num_reads, "solid_nodes": num_nodes,
               "stages": dict(timer.spans)})
