"""Device-resident hash-partitioned k-mer accumulation for streaming.

Round-4 streaming merged every slice into a full-capacity global table
(``count.merge_into``) and answered pass-2 count queries with a sort-join
against that table (``count.lookup_join``) -- at chromosome scale that is
two FULL-TABLE sorts (2 x 134M rows) PER SLICE: ~0.4 Mbases/s through
stages the chip runs at ~50 Mbases/s resident (VERDICT r4 weak #1 -- the
~100x gap).

This module removes every per-slice full-table sort.  The key fact: the
positions only need to be sorted ONCE globally.  So the streaming passes
become *collect -> count*:

  pass 1 (collect): each slice extracts its canonical short k-mers and
      APPENDS them -- (key lanes, position-id | owned-flag) rows -- into
      P hash-partitioned device buffers.  Appending is one slice-local
      sort by partition id plus P fixed-size dynamic-update-slice block
      writes at per-partition fill offsets (the next slice's block
      overwrites the previous block's padding tail, so the buffers stay
      dense).  No global table is touched.
  pass 1 (count): each partition is sorted ONCE (`count.sort_kmers` +
      run-total scans), and every row's run total is scattered to a
      per-POSITION counts array via the carried position id.  Total sort
      work = one sort of every position, the information-theoretic floor
      of exact counting.
  pass 2 (collect): window-min solidity now reads per-position counts
      with a contiguous ``dynamic_slice`` -- NO lookup at all -- and
      appends the solid owned canonical k-mers into a second partitioned
      buffer set (plus the per-read seed reduction and optional Bloom
      insert, unchanged from the round-4 slice program).
  pass 2 (count): each partition is sorted once and deduplicated; the
      per-partition unique sets are disjoint (hash partitioning), so one
      final modest sort over their concatenation yields the globally
      lex-sorted node table -- identical to the single-shot pipeline's.

Buffers are DONATED through the jitted slice programs, so XLA updates
them in place (no copy, no device-memory growth).  Hash
partitioning (murmur lanes mix, ops/hashing.py) keeps partition loads
uniform even on skewed genome composition, unlike key-prefix splits
(canonical k-mers are lexicographically biased toward A/C starts).

Capacity model: a histogram PRE-PASS per pass (extract + hash +
bincount per slice; no buffers) measures the exact per-partition row
totals and per-(slice, partition) maxima, and capacities are planned
from those measurements (``plan_caps``) -- composition-proof by
construction (repeat families concentrate millions of occurrences of a
few k-mers onto single partitions; uniform-slack sizing overflowed on a
realistic chromosome).  A latched on-device overflow flag remains as an
invariant check.

Reference mapping: this is still ``CountShortKmer`` + ``MakeBF``'s
counting semantics (reference ``src/Load.cpp:105-127``,
``src/MakeBloomFilter.cpp:24-89``) -- exact canonical counts, window-min
solidity, first-solid seeds -- factored into collect/count phases like a
two-pass disk counter (KMC/Gerbil, PAPERS.md), with HBM as the "disk".
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.ops import bloom as bloom_mod
from platanus3_tpu.ops import count as count_mod
from platanus3_tpu.ops import hashing as hash_mod
from platanus3_tpu.ops import kmer as kmer_mod
from platanus3_tpu.ops import solid as solid_mod
from platanus3_tpu.ops.windowmin import window_min

__all__ = ["NUM_PARTS", "plan_caps", "histogram_short_slice",
           "histogram_solid_slice", "collect_short_slice",
           "count_partition", "solid_collect_slice", "dedup_partition",
           "place_block", "finalize_table"]

# Number of hash partitions.  16 keeps each chr21-scale partition sort
# at ~37M rows while the per-slice append loop stays 16 short
# dynamic-update-slice blocks.
NUM_PARTS = 16

_PART_SEED = 0x51C3A27D
_MSB = np.uint32(0x80000000)
_NOT_MSB = np.uint32(0x7FFFFFFF)


def _sort_cols(cols, invalid, payloads, kk):
    """Non-stable sort of COLUMN-TUPLE keys with invalids last -- the
    column-wise twin of ``count.sort_kmers``.  Never stacks the lanes
    into an [N, L] array (ROADMAP C4 re-tests whether the column form
    still earns its place).

    Returns ``(sorted_cols tuple, sorted_invalid, sorted_payloads
    tuple)``; same ordering contract as sort_kmers (invalid flag folded
    into lane 0's spare top bit when 2*kk mod 32 != 0, else a leading
    key operand)."""
    l = len(cols)
    top_bits = 2 * kk - 32 * (l - 1)
    if 0 < top_bits < 32:
        lane0 = jnp.where(invalid, cols[0] | _MSB, cols[0])
        ops = (lane0,) + tuple(cols[1:]) + tuple(payloads)
        out = jax.lax.sort(ops, num_keys=l, is_stable=False)
        s_inv = (out[0] & _MSB) > 0
        s_cols = ((out[0] & _NOT_MSB),) + tuple(out[1:l])
        return s_cols, s_inv, tuple(out[l:])
    ops = (invalid.astype(jnp.uint32),) + tuple(cols) + tuple(payloads)
    out = jax.lax.sort(ops, num_keys=l + 1, is_stable=False)
    return tuple(out[1:l + 1]), out[0] > 0, tuple(out[l + 1:])


def _is_first_cols(s_cols, s_inv):
    """Run starts over column-tuple sorted keys (twin of count._is_first)."""
    diff = s_inv[1:] != s_inv[:-1]
    for c in s_cols:
        diff = diff | (c[1:] != c[:-1])
    return jnp.concatenate([jnp.ones((1,), bool), diff])


def plan_caps(hist_total, hist_slice_max, parts: int):
    """EXACT buffer plan from measured per-partition loads (the KMC-style
    pre-statistics pass).

    Uniform-slack sizing is not composition-proof: every occurrence of a
    k-mer lands in its hash's partition, so a repeat family at chr21
    scale (60 distinct 21-mers x ~2M occurrences each) concentrates tens
    of millions of rows on whichever partitions its few k-mers hash to --
    the first realistic-chromosome run overflowed a 12% slack.  A cheap
    histogram pre-pass (extract + hash + bincount per slice, no buffers)
    measures the exact per-partition totals and the per-(slice,
    partition) maxima, and extraction is deterministic, so capacities
    planned from it can NEVER overflow.

    Returns ``(s_blks tuple, caps tuple, bases tuple, total_rows)``:
    per-partition per-slice block sizes (rounded up to 2^16) and
    capacities (rounded up to 2^21 so the partition-count programs
    compile for only a few distinct shapes), plus flat-buffer base
    offsets.
    """
    hist_total = np.asarray(hist_total)
    hist_slice_max = np.asarray(hist_slice_max)
    s_blks, caps = [], []
    for p in range(parts):
        sb = int(-(-int(hist_slice_max[p] + 1) // (1 << 16)) * (1 << 16))
        cap = int(hist_total[p]) + sb  # + one block of junk tail
        # Quantize capacities COARSELY (2^23 above 2^23, else 2^21): the
        # per-partition count/dedup programs compile once per distinct
        # cap, and fine 2^21 steps on a skewed realistic chromosome
        # produced 16 distinct shapes = ~320 s of compiles in pass-1
        # count alone.  2^23 steps cost <= parts * 2^22 rows of padding
        # (~0.8 GB at 3 columns) for ~4 distinct shapes.
        step = (1 << 23) if cap > (1 << 23) else (1 << 21)
        cap = -(-cap // step) * step
        s_blks.append(sb)
        caps.append(cap)
    bases = [0]
    for c in caps[:-1]:
        bases.append(bases[-1] + c)
    return (tuple(s_blks), tuple(caps), tuple(bases),
            bases[-1] + caps[-1])


def _append_partitioned(cols, part, bufs, fills, ovf, *, parts, s_blks,
                        caps, bases):
    """Append rows (tuple of [N] u32 ``cols``) into partitioned buffers.

    ``part [N] int32``: target partition per row; rows with ``part ==
    parts`` are dropped (invalid positions).  ``bufs``: tuple of flat
    column arrays; partition p occupies ``[bases[p], bases[p]+caps[p])``
    with per-slice block size ``s_blks[p]`` (all static, planned EXACTLY
    from the histogram pre-pass -- see plan_caps).  One slice-local
    1-key sort groups rows by partition, then each partition's
    contiguous range is block-copied to its fill offset; the block's
    padding tail is overwritten by the next slice's write, so buffers
    stay dense.  The overflow latch remains as a belts-and-braces
    invariant check (planned capacities cannot overflow).
    """
    max_blk = max(s_blks)
    srt = jax.lax.sort((part,) + tuple(cols), num_keys=1, is_stable=False)
    part_s = srt[0]
    cols_s = [jnp.concatenate([c, jnp.zeros((max_blk,), c.dtype)])
              for c in srt[1:]]
    offs = jnp.searchsorted(
        part_s, jnp.arange(parts + 1, dtype=part_s.dtype)).astype(jnp.int32)
    new_bufs = list(bufs)
    for p in range(parts):
        s_blk = s_blks[p]
        cap_p = caps[p]
        cnt = offs[p + 1] - offs[p]
        fill = fills[p]
        ovf = ovf | (cnt > s_blk) | (fill + cnt > cap_p - s_blk)
        base = bases[p] + jnp.minimum(fill, cap_p - s_blk)
        for j, c in enumerate(cols_s):
            blk = jax.lax.dynamic_slice(c, (offs[p],), (s_blk,))
            new_bufs[j] = jax.lax.dynamic_update_slice(
                new_bufs[j], blk, (base,))
        fills = fills.at[p].add(jnp.minimum(cnt, s_blk))
    return tuple(new_bufs), fills, ovf


def _part_of(canon, kk: int, valid, parts: int):
    """Hash partition id per row ([N] int32; ``parts`` = dropped)."""
    h = hash_mod.hash_kmers(canon, kk, seed=_PART_SEED)
    return jnp.where(valid, (h & np.uint32(parts - 1)).astype(jnp.int32),
                     np.int32(parts))


@partial(jax.jit, static_argnames=("k", "short_k", "parts"))
def histogram_short_slice(hist_total, hist_max, packed, vlen, start,
                          rlen, *, k, short_k, parts):
    """Pre-pass: per-partition valid-row counts of one slice.  Updates
    the running totals and per-slice maxima ([parts] int32 each)."""
    bases = kmer_mod.unpack_bases(packed)
    c, chunk_len = bases.shape
    stride = chunk_len - k + 1
    s_canon, s_valid, _ = solid_mod.short_kmer_positions(
        bases, vlen, start, rlen, stride, short_k, k)
    part = _part_of(s_canon, short_k, s_valid, parts).reshape(-1)
    h = jnp.zeros((parts + 1,), jnp.int32).at[part].add(1)[:parts]
    return hist_total + h, jnp.maximum(hist_max, h)


@partial(jax.jit,
         static_argnames=("k", "short_k", "cov_threshold", "parts"))
def histogram_solid_slice(hist_total, hist_max, counts, packed, vlen,
                          start, rlen, posbase_s, *, k, short_k,
                          cov_threshold, parts):
    """Pre-pass for the node buffers: per-partition SOLID-OWNED row
    counts of one slice (same solidity computation as the collect)."""
    bases = kmer_mod.unpack_bases(packed)
    c, chunk_len = bases.shape
    stride = chunk_len - k + 1
    p_short = chunk_len - short_k + 1
    pk = chunk_len - k + 1
    counts_slice = jax.lax.dynamic_slice(
        counts, (jnp.asarray(posbase_s, jnp.int32),), (c * p_short,))
    cov_est = window_min(counts_slice.reshape(c, p_short),
                         k - short_k + 1)
    fwk, valid_k = kmer_mod.extract_kmers(bases, vlen, k)
    canon_k, _ = kmer_mod.canonical(fwk, k)
    owned_k = solid_mod.owned_mask(start, rlen, stride, pk, k, k) & valid_k
    solid_owned = ((cov_est >= cov_threshold) & valid_k) & owned_k
    part = _part_of(canon_k, k, solid_owned, parts).reshape(-1)
    h = jnp.zeros((parts + 1,), jnp.int32).at[part].add(1)[:parts]
    return hist_total + h, jnp.maximum(hist_max, h)


@partial(jax.jit,
         static_argnames=("k", "short_k", "parts", "s_blks", "caps",
                          "bases"),
         donate_argnums=(0, 1, 2))
def collect_short_slice(bufs, fills, ovf, packed, vlen, start, rlen,
                        posbase, *, k, short_k, parts, s_blks, caps,
                        bases):
    """Pass-1 collect: append this slice's valid canonical short k-mers
    as (lanes..., posid | owned<<31) rows.  ``posbase`` = global position
    id of this slice's first chunk-local position."""
    bcodes = kmer_mod.unpack_bases(packed)
    c, chunk_len = bcodes.shape
    stride = chunk_len - k + 1
    s_canon, s_valid, s_owned = solid_mod.short_kmer_positions(
        bcodes, vlen, start, rlen, stride, short_k, k)
    l = s_canon.shape[-1]
    n = c * s_canon.shape[1]
    flat = [s_canon[..., j].reshape(n) for j in range(l)]
    owned = s_owned.reshape(n)
    pos = (jnp.asarray(posbase, jnp.int32)
           + jnp.arange(n, dtype=jnp.int32)).astype(jnp.uint32)
    pay = pos | jnp.where(owned, _MSB, np.uint32(0))
    part = _part_of(s_canon, short_k, s_valid, parts).reshape(n)
    return _append_partitioned(tuple(flat) + (pay,), part, bufs, fills,
                               ovf, parts=parts, s_blks=s_blks,
                               caps=caps, bases=bases)


@partial(jax.jit, static_argnames=("short_k", "cap_p"),
         donate_argnums=(0,))
def count_partition(counts, bufs, fills, pidx, pbase, *, short_k, cap_p):
    """Pass-1 count: sort one partition once, scatter every row's run
    total (count of OWNED copies of its k-mer) to ``counts[posid]``.
    ``pbase``: the partition's flat base offset (traced; ``cap_p`` is
    static and rounded so only a few shapes compile).
    Returns ``(counts, n_unique_in_partition)``."""
    l = len(bufs) - 1
    cols = [jax.lax.dynamic_slice(b, (jnp.asarray(pbase, jnp.int32),),
                                  (cap_p,))
            for b in bufs]
    pay = cols[l]
    invalid = jnp.arange(cap_p, dtype=jnp.int32) >= fills[pidx]
    s_cols, s_inv, (s_pay,) = _sort_cols(tuple(cols[:l]), invalid,
                                         (pay,), short_k)
    contrib = (s_pay >> 31).astype(jnp.int32)
    is_first = _is_first_cols(s_cols, s_inv)
    run_total = count_mod._run_totals(
        is_first, jnp.where(s_inv, 0, contrib))
    posid = (s_pay & count_mod._NOT_MSB).astype(jnp.int32)
    tgt = jnp.where(s_inv, np.int32(0x7FFFFFFF), posid)
    counts = counts.at[tgt].set(run_total, mode="drop")
    n_uni = jnp.sum((is_first & ~s_inv).astype(jnp.int32))
    return counts, n_uni


@partial(jax.jit,
         static_argnames=("k", "short_k", "cov_threshold", "num_reads",
                          "parts", "s_blks", "caps", "bases",
                          "add_bloom", "bf_log2", "bf_hashes"),
         donate_argnums=(0, 1, 2, 3, 4, 5))
def solid_collect_slice(bufs, fills, ovf, min_pos, seed_fw, bf_bits,
                        counts, packed, vlen, rid, start, rlen, posbase_s,
                        *, k, short_k, cov_threshold, num_reads, parts,
                        s_blks, caps, bases, add_bloom, bf_log2,
                        bf_hashes):
    """Pass-2 collect: per-position short counts via one CONTIGUOUS
    ``dynamic_slice`` of the global counts array (no lookup), window-min
    solidity, per-read first-solid seed reduction (identical to the
    round-4 slice program, byte-for-byte results), optional Bloom
    insert, and append of the solid owned canonical k-mers into the node
    partition buffers."""
    bcodes = kmer_mod.unpack_bases(packed)
    c, chunk_len = bcodes.shape
    stride = chunk_len - k + 1
    p_short = chunk_len - short_k + 1
    pk = chunk_len - k + 1
    n_s = c * p_short

    counts_slice = jax.lax.dynamic_slice(
        counts, (jnp.asarray(posbase_s, jnp.int32),), (n_s,))
    per_pos = counts_slice.reshape(c, p_short)
    w = k - short_k + 1
    cov_est = window_min(per_pos, w)

    fwk, valid_k = kmer_mod.extract_kmers(bcodes, vlen, k)
    canon_k, _ = kmer_mod.canonical(fwk, k)
    owned_k = solid_mod.owned_mask(start, rlen, stride, pk, k, k) & valid_k
    is_solid = (cov_est >= cov_threshold) & valid_k
    solid_owned = is_solid & owned_k
    lk = canon_k.shape[-1]

    if add_bloom:
        bf = bloom_mod.BloomFilter(bf_bits, bf_log2, bf_hashes)
        bf = bloom_mod.bloom_add(bf, canon_k.reshape(-1, lk), k,
                                 mask=solid_owned.reshape(-1))
        bf_bits = bf.bits

    # Seed reduction -- first solid owned position per read, forward
    # form.  Verbatim from the round-4 slice program so streaming output
    # stays byte-identical.
    local = jnp.arange(pk, dtype=jnp.int32)[None, :]
    gpos = start[:, None] + local
    big = np.int32(2**30)
    gpos_m = jnp.where(solid_owned, gpos, big)
    flat_rid = jnp.broadcast_to(rid[:, None], (c, pk)).reshape(-1)
    batch_min = jax.ops.segment_min(gpos_m.reshape(-1), flat_rid,
                                    num_segments=num_reads)
    new_min = jnp.minimum(min_pos, batch_min)
    is_first = solid_owned & (gpos == new_min[rid][:, None])
    rid_b = jnp.broadcast_to(rid[:, None], (c, pk))
    tgt = jnp.where(is_first, rid_b, num_reads).reshape(-1)
    batch_seed = jnp.stack(
        [jnp.zeros((num_reads,), dtype=jnp.uint32).at[tgt].max(
            fwk[..., j].reshape(-1), mode="drop") for j in range(lk)],
        axis=-1)
    seed_fw = jnp.where((batch_min < min_pos)[:, None] &
                        (batch_min <= new_min)[:, None],
                        batch_seed, seed_fw)
    min_pos = new_min

    flat_ck = [canon_k[..., j].reshape(-1) for j in range(lk)]
    part = _part_of(canon_k, k, solid_owned, parts).reshape(-1)
    bufs, fills, ovf = _append_partitioned(
        tuple(flat_ck), part, bufs, fills, ovf, parts=parts,
        s_blks=s_blks, caps=caps, bases=bases)
    return bufs, fills, ovf, min_pos, seed_fw, bf_bits


@partial(jax.jit, static_argnames=("k", "cap_p"))
def dedup_partition(bufs, fills, pidx, pbase, *, k, cap_p):
    """Pass-2 count: sort one node partition once, keep each distinct
    k-mer's first row, compacted to the front (padding 0xFFFFFFFF).
    Returns ``(out_cols, n_unique)``."""
    l = len(bufs)
    cols = [jax.lax.dynamic_slice(b, (jnp.asarray(pbase, jnp.int32),),
                                  (cap_p,))
            for b in bufs]
    invalid = jnp.arange(cap_p, dtype=jnp.int32) >= fills[pidx]
    s_cols, s_inv, _ = _sort_cols(tuple(cols), invalid, (), k)
    is_first = _is_first_cols(s_cols, s_inv)
    uniq = is_first & ~s_inv
    rank = jnp.cumsum(uniq.astype(jnp.int32)) - 1
    tgt = jnp.where(uniq, rank, np.int32(cap_p))
    outs = tuple(
        jnp.full((cap_p,), np.uint32(0xFFFFFFFF)).at[tgt].set(
            s_cols[j], mode="drop") for j in range(l))
    n_p = jnp.sum(uniq.astype(jnp.int32))
    return outs, n_p


@partial(jax.jit, donate_argnums=(0,))
def place_block(dst_cols, out_cols, offset):
    """Write one partition's compacted unique block into the concat
    buffer at ``offset`` (the block's padding tail is overwritten by the
    next partition's block -- same dense-append trick as the slices)."""
    off = jnp.asarray(offset, jnp.int32)
    return tuple(jax.lax.dynamic_update_slice(d, o, (off,))
                 for d, o in zip(dst_cols, out_cols))


@partial(jax.jit, static_argnames=("k",))
def finalize_table(dst_cols, n_total, *, k):
    """One global sort of the (disjoint) per-partition uniques ->
    lex-sorted node table, identical to the single-shot pipeline's."""
    kmers = jnp.stack(dst_cols, axis=-1)
    n = kmers.shape[0]
    valid = jnp.arange(n, dtype=jnp.int32) < jnp.asarray(n_total, jnp.int32)
    return count_mod.count_kmers(kmers, valid, k=k)
