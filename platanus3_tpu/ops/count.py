"""Exact k-mer counting via sort + segment reduction.

Array replacement for the reference's ``unordered_map``-based counter
(``ReadFile::CountShortKmer``, reference ``src/Load.cpp:105-127``) and for
the per-position count lookup inside ``MakeBF`` (reference
``src/MakeBloomFilter.cpp:46-58``).  Instead of a hash map, the
array-native equivalent is:

    flatten all canonical k-mers -> multi-key stable sort (lanes MSB-first)
    -> run-length boundaries -> segment ids -> counts per unique k-mer
    -> scatter counts back through the sort permutation to per-position
       counts.

One sort produces BOTH the global count table and the per-position counts
the solidity filter needs, replacing two hash-map passes.  All shapes are
static; invalid (padding) positions carry a dedicated sentinel key lane so
they sort to the end without colliding with real k-mers.

``KmerTable`` (sorted unique keys + counts + valid size) is this
framework's ``KmerCount`` (reference ``src/common.h:26``); lookups are
vectorized multiword binary searches (``lookup``), and tables support
padded concat-merge for streaming / sharded accumulation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["KmerTable", "sort_kmers", "count_kmers", "count_with_positions",
           "count_positions_table", "count_solid_with_ids", "lookup",
           "merge_tables"]


class KmerTable(NamedTuple):
    """Sorted unique canonical k-mers with counts.

    keys:   ``[cap, L] uint32`` lexicographically sorted; rows >= size are
            all-ones padding (sorts last, never matches a real query after
            size masking).
    counts: ``[cap] int32`` (0 beyond size)
    size:   scalar int32 array -- number of valid rows
    """

    keys: jnp.ndarray
    counts: jnp.ndarray
    size: jnp.ndarray


jax.tree_util.register_pytree_node(
    KmerTable,
    lambda t: ((t.keys, t.counts, t.size), None),
    lambda _, leaves: KmerTable(*leaves),
)


def _has_spare_msb(kmers: jnp.ndarray, k: int | None) -> bool:
    """True when lane 0 of a k-mer provably never uses bit 31, so the
    invalid flag can ride there instead of as a separate sort operand."""
    if k is None:
        return False
    l = kmers.shape[-1]
    top_bits = 2 * k - 32 * (l - 1)  # significant bits in lane 0
    return 0 < top_bits < 32


_MSB = np.uint32(0x80000000)
_NOT_MSB = np.uint32(0x7FFFFFFF)


def sort_kmers(kmers: jnp.ndarray, invalid: jnp.ndarray, *payloads,
               k: int | None = None, stable: bool = True):
    """Stable sort of ``[N, L]`` keys with invalids last.

    Returns ``(sorted_kmers [N, L], sorted_invalid [N], *sorted_payloads)``.
    Uses ``jax.lax.sort`` with the lanes MSB-first as keys -- this is the
    reference's canonical-k-mer ordering (``CompareBit``) lifted to a bulk
    sort.  The invalid flag is a leading extra key operand, EXCEPT when
    ``k`` is given and ``2k mod 32 != 0``: then lane 0's top bit is
    provably spare (the 2k-bit value is low-aligned, ops/kmer.py) and the
    flag is folded into it, saving one 4N-byte sort operand on the hot
    path.  Ordering is identical either way: valid keys in lex order,
    then invalid rows (by masked key bits, then input order).

    ``stable=False`` skips the stability guarantee (rows with fully equal
    keys may permute); the counting cores use it because they only consume
    run aggregates plus explicit per-row payload indices.
    """
    n, l = kmers.shape
    if _has_spare_msb(kmers, k):
        lane0 = jnp.where(invalid, kmers[:, 0] | _MSB, kmers[:, 0])
        ops = [lane0] + [kmers[:, j] for j in range(1, l)] + list(payloads)
        out = jax.lax.sort(tuple(ops), num_keys=l, is_stable=stable)
        s_invalid = (out[0] & _MSB) > 0
        s_kmers = jnp.stack((out[0] & _NOT_MSB,) + out[1:l], axis=-1)
        return (s_kmers, s_invalid) + tuple(out[l:])
    ops = [invalid.astype(jnp.uint32)] + [kmers[:, j] for j in range(l)]
    ops += list(payloads)
    out = jax.lax.sort(tuple(ops), num_keys=l + 1, is_stable=stable)
    s_invalid = out[0] > 0
    s_kmers = jnp.stack(out[1 : l + 1], axis=-1)
    return (s_kmers, s_invalid) + tuple(out[l + 1 :])


def _boundaries(s_kmers: jnp.ndarray, s_invalid: jnp.ndarray):
    """First-occurrence flags and segment ids over sorted keys."""
    n = s_kmers.shape[0]
    prev_diff = jnp.any(s_kmers[1:] != s_kmers[:-1], axis=-1)
    prev_diff = prev_diff | (s_invalid[1:] != s_invalid[:-1])
    is_first = jnp.concatenate([jnp.ones((1,), dtype=bool), prev_diff])
    seg_id = jnp.cumsum(is_first.astype(jnp.int32)) - 1  # [N]
    return is_first, seg_id


def _is_first(s_kmers: jnp.ndarray, s_invalid: jnp.ndarray):
    prev_diff = jnp.any(s_kmers[1:] != s_kmers[:-1], axis=-1)
    prev_diff = prev_diff | (s_invalid[1:] != s_invalid[:-1])
    return jnp.concatenate([jnp.ones((1,), dtype=bool), prev_diff])


_I32_MAX = np.int32(0x7FFFFFFF)


def _run_totals(is_first: jnp.ndarray, contrib: jnp.ndarray) -> jnp.ndarray:
    """Per-row sum of ``contrib`` over the row's run (runs delimited by
    ``is_first``), with NO segment_sum / gather / scatter.

    Scans read and write memory in order, where scatter-add and gather
    hit it at random; everything here is scan + elementwise:

      c          = inclusive cumsum of contrib
      start_excl = c just before my run's first row, broadcast into the run
                   via cummax (values at successive run starts are
                   nondecreasing because c is)
      end_c      = c at my run's last row, broadcast backwards via reversed
                   cummin (the nearest following run end has the smallest c
                   among following ends)
    """
    c = jnp.cumsum(contrib, dtype=jnp.int32)
    start_excl = jax.lax.cummax(jnp.where(is_first, c - contrib, -1))
    is_last = jnp.concatenate([is_first[1:], jnp.ones((1,), dtype=bool)])
    end_c = jax.lax.cummin(jnp.where(is_last, c, _I32_MAX), reverse=True)
    return end_c - start_excl


def count_kmers(kmers: jnp.ndarray, valid: jnp.ndarray,
                k: int | None = None) -> KmerTable:
    """Count unique canonical k-mers of a flat batch ``[N, L]``.

    Capacity of the returned table is N (static); ``size`` is the dynamic
    unique count.  Replaces hot loop #1 (``src/Load.cpp:118-124``).
    """
    t, _ = count_with_positions(kmers, valid, k=k)
    return t


def _scan_count(kmers, valid, contributes, k, include_zero: bool,
                want_nid: bool, want_table: bool = True,
                want_counts: bool = True):
    """Sort+scan core shared by the counting entry points.

    One non-stable forward sort (keys = lanes with the invalid flag folded
    into a spare bit where possible; single packed payload = input index
    with the contribution flag in its top bit), then pure scans over the
    sorted order (``_run_totals``) -- NO segment_sum, NO random gathers.
    Per-position results return to input order via a 1-key back-sort (an
    inverse-permutation apply with no random scatter), and the table is
    compacted to the front with a second 1-key sort whose key is the
    table rank.

    Returns ``(table | None, per_pos)`` where ``per_pos`` is the run total
    (count) per input row, or the table row id (-1 when absent) when
    ``want_nid``.  ``include_zero`` keeps zero-contribution (but valid)
    runs in the table.
    """
    n, l = kmers.shape
    contributes = contributes & valid
    idx = jnp.arange(n, dtype=jnp.uint32)
    idx_packed = idx | jnp.where(contributes, _MSB, np.uint32(0))
    s_kmers, s_invalid, s_idxp = sort_kmers(kmers, ~valid, idx_packed, k=k,
                                            stable=False)
    s_idx = s_idxp & _NOT_MSB
    s_contrib = (s_idxp >> 31).astype(jnp.int32)
    is_first = _is_first(s_kmers, s_invalid)
    run_total = _run_totals(is_first, jnp.where(s_invalid, 0, s_contrib))

    in_table = (~s_invalid) if include_zero else ((run_total > 0) & ~s_invalid)
    tab_first = is_first & in_table
    tab_rank = jnp.cumsum(tab_first.astype(jnp.int32)) - 1
    size = jnp.where(n > 0, tab_rank[-1] + 1, 0).astype(jnp.int32)

    if want_nid:
        # Broadcast each run's table rank from its first row (run starts
        # carry nondecreasing ranks, so cummax propagates within runs).
        rank_bcast = jax.lax.cummax(jnp.where(is_first, tab_rank, -1))
        value_sorted = jnp.where(in_table, rank_bcast, -1).astype(jnp.int32)
    else:
        value_sorted = jnp.where(s_invalid, 0, run_total)
    # Back-sort: input index is a unique 31-bit key, so one non-stable
    # 1-key sort restores input order (faster than an N-row scatter).
    back = jax.lax.sort((s_idx, value_sorted), num_keys=1, is_stable=False)
    per_pos = back[1]

    if not want_table:
        return None, per_pos
    # Table compaction: rank as key, lanes (+ count) as payloads.
    # ``want_counts=False`` drops the count operand from this sort --
    # the production node table's counts are never read (coverage is a
    # separate pass), so the sort carries one fewer 4N-byte operand.
    ckey = jnp.where(tab_first, tab_rank.astype(jnp.uint32),
                     np.uint32(0xFFFFFFFF))
    cops = (ckey,) + tuple(s_kmers[:, j] for j in range(l))
    if want_counts:
        cops = cops + (run_total,)
    cout = jax.lax.sort(cops, num_keys=1, is_stable=False)
    in_range = jnp.arange(n) < size
    keys = jnp.where(in_range[:, None], jnp.stack(cout[1 : 1 + l], axis=-1),
                     np.uint32(0xFFFFFFFF))
    counts = (jnp.where(in_range, cout[1 + l], 0) if want_counts
              else jnp.zeros((n,), jnp.int32))
    return KmerTable(keys=keys, counts=counts, size=size), per_pos


def count_with_positions(kmers: jnp.ndarray, valid: jnp.ndarray,
                         contributes: jnp.ndarray | None = None,
                         k: int | None = None):
    """Count AND return the count of each input position's k-mer.

    Returns ``(KmerTable, per_position_counts [N] int32)`` where invalid
    positions get count 0.  The per-position counts are what the solidity
    window-min consumes (reference ``src/MakeBloomFilter.cpp:46-62``).
    The table holds every unique VALID k-mer (counts may be 0 when no copy
    contributes).

    ``contributes`` (default ``valid``): positions that add +1 to their
    k-mer's count.  Chunked reads present overlap positions twice -- only
    the owning chunk's copy contributes, but BOTH copies still receive the
    k-mer's count in ``per_position_counts`` (they share a sort run).
    """
    if contributes is None:
        contributes = valid
    return _scan_count(kmers, valid, contributes, k,
                       include_zero=True, want_nid=False)


def count_positions_table(kmers: jnp.ndarray, valid: jnp.ndarray,
                          contributes: jnp.ndarray, k: int | None = None,
                          want_table: bool = True):
    """Per-position counts AND the contributing-unique table from ONE sort.

    Fuses what would be two sorts in the solidity stage
    (``count_with_positions`` for the per-position short-k counts feeding
    the window-min, plus ``count_kmers`` for the exact short-k table).

    Returns ``(KmerTable, per_position_counts [N] int32)``; the table is
    exactly ``count_kmers(kmers, contributes & valid)`` and the counts are
    exactly ``count_with_positions(kmers, valid, contributes)[1]``.
    ``want_table=False`` skips the table compaction sort (the production
    pipeline only consumes the per-position counts; returns ``(None, pp)``).
    """
    return _scan_count(kmers, valid, contributes, k,
                       include_zero=False, want_nid=False,
                       want_table=want_table)


def count_solid_with_ids(kmers: jnp.ndarray, valid: jnp.ndarray,
                         contributes: jnp.ndarray, k: int | None = None,
                         want_counts: bool = True):
    """Solid-node table AND per-position node ids from ONE sort.

    ``kmers [N, L]``: canonical k-mer at every read position;
    ``valid``: positions that should receive a node id (owned, in-read);
    ``contributes``: positions whose occurrence makes the k-mer a node and
    adds +1 to its count (solid & owned).

    Returns ``(KmerTable, per_pos_nid [N] int32)`` where the table holds
    the unique k-mers with >= 1 contribution (lexicographically sorted --
    the same table ``count_kmers(kmers, contributes)`` builds), and
    ``per_pos_nid[i]`` is the table row of position i's k-mer (-1 when the
    k-mer is not a node or the position is invalid).

    This makes the coverage pass (reference ``CountNodeCoverage``,
    ``src/DeBruijnGraph.cpp:393-449``) a pure scatter: the node-id
    resolution that previously needed a second full sort-join over all
    read positions (graph/coverage.py) falls out of the sort stage 1
    already performs to build the node table.
    """
    return _scan_count(kmers, valid, contributes, k,
                       include_zero=False, want_nid=True,
                       want_counts=want_counts)


def _lex_less_rows(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a < b lexicographic over last axis, elementwise on leading axes."""
    l = a.shape[-1]
    less = jnp.zeros(a.shape[:-1], dtype=bool)
    eq = jnp.ones(a.shape[:-1], dtype=bool)
    for j in range(l):
        less = less | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return less


def searchsorted_rows(table_keys: jnp.ndarray, size, queries: jnp.ndarray,
                      max_log2: int | None = None) -> jnp.ndarray:
    """Vectorized lower-bound binary search of ``[Q, L]`` queries in a
    ``[cap, L]`` sorted key table (first ``size`` rows valid).

    ~log2(cap) gather+compare rounds, all queries in parallel -- the bulk
    replacement for per-k-mer hash lookups.
    """
    cap = table_keys.shape[0]
    steps = max_log2 if max_log2 is not None else max(1, int(cap).bit_length())
    q = queries.shape[0]
    lo = jnp.zeros((q,), dtype=jnp.int32)
    hi = jnp.broadcast_to(jnp.asarray(size, jnp.int32), (q,))

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1
        mid_keys = table_keys[mid]
        go_right = _lex_less_rows(mid_keys, queries)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


def lookup(table: KmerTable, queries: jnp.ndarray) -> jnp.ndarray:
    """Counts for ``[Q, L]`` query k-mers (0 when absent)."""
    pos = searchsorted_rows(table.keys, table.size, queries)
    pos_c = jnp.minimum(pos, table.keys.shape[0] - 1)
    hit = jnp.all(table.keys[pos_c] == queries, axis=-1) & (pos < table.size)
    return jnp.where(hit, table.counts[pos_c], 0)


def lookup_id(table: KmerTable, queries: jnp.ndarray) -> jnp.ndarray:
    """Row index of each query in the table, or -1 when absent."""
    pos = searchsorted_rows(table.keys, table.size, queries)
    pos_c = jnp.minimum(pos, table.keys.shape[0] - 1)
    hit = jnp.all(table.keys[pos_c] == queries, axis=-1) & (pos < table.size)
    return jnp.where(hit, pos_c, -1)


def lookup_id_join(table: KmerTable, queries: jnp.ndarray,
                   k: int | None = None) -> jnp.ndarray:
    """Row index of each query in the table (-1 absent), via SORT-JOIN.

    Array alternative to the binary search in :func:`lookup_id`: the
    per-round gathers of a 20-round binary search are random-access and
    slow at tens of millions of queries; one multi-key sort of
    (table keys ++ queries) followed by segment-first propagation does the
    same join in a single sort pass.

    Operand economy (the sort is the whole cost): one PACKED payload rides
    as the last sort key -- table rows carry their row id (< m), query
    rows carry ``m + qidx`` -- so within an equal-key segment the table
    row sorts FIRST and the answer for every query is the payload at the
    segment start.  When ``k`` is given and lane 0 has a provably spare
    top bit (``_has_spare_msb``) the table-padding invalid flag folds into
    it, making the sort exactly ``L + 1`` operands; otherwise the flag is
    one extra leading key.

    Immune to the 0xFF..FF padding-collision edge either way: pad rows
    carry the invalid marker inside the key, so a query whose bit pattern
    equals the padding never joins to it.
    """
    m, l = table.keys.shape
    q = queries.shape[0]
    n = m + q
    keys = jnp.concatenate([table.keys, queries], axis=0)
    invalid = jnp.concatenate(
        [jnp.arange(m, dtype=jnp.int32) >= table.size,
         jnp.zeros((q,), bool)])
    pay = jnp.concatenate(
        [jnp.arange(m, dtype=jnp.uint32),
         jnp.arange(q, dtype=jnp.uint32) + np.uint32(m)])

    if _has_spare_msb(keys, k):
        lane0 = jnp.where(invalid, keys[:, 0] | _MSB, keys[:, 0])
        ops = (lane0,) + tuple(keys[:, j] for j in range(1, l)) + (pay,)
        out = jax.lax.sort(ops, num_keys=l + 1, is_stable=False)
        key_cols = out[:l]
        s_pay = out[l]
    else:
        ops = ((invalid.astype(jnp.uint32),)
               + tuple(keys[:, j] for j in range(l)) + (pay,))
        out = jax.lax.sort(ops, num_keys=l + 2, is_stable=False)
        key_cols = out[: l + 1]
        s_pay = out[l + 1]

    diff = key_cols[0][1:] != key_cols[0][:-1]
    for col in key_cols[1:]:
        diff = diff | (col[1:] != col[:-1])
    is_first = jnp.concatenate([jnp.ones((1,), bool), diff])
    # Index of each row's segment start (monotone cummax trick).
    seg_start = jax.lax.cummax(
        jnp.where(is_first, jnp.arange(n, dtype=jnp.int32), 0))
    candidate = s_pay[seg_start]       # a table row id iff < m
    is_q = s_pay >= np.uint32(m)
    qidx = (s_pay - np.uint32(m)).astype(jnp.int32)
    ans = jnp.where(candidate < np.uint32(m),
                    candidate.astype(jnp.int32), np.int32(-1))
    out_ids = jnp.full((q,), np.int32(-1))
    out_ids = out_ids.at[jnp.where(is_q, qidx, q)].set(ans, mode="drop")
    return out_ids


def lookup_join(table: KmerTable, queries: jnp.ndarray,
                k: int | None = None) -> jnp.ndarray:
    """Counts for each query (0 when absent), via sort-join (see
    :func:`lookup_id_join`)."""
    ids = lookup_id_join(table, queries, k=k)
    idc = jnp.clip(ids, 0, table.keys.shape[0] - 1)
    return jnp.where(ids >= 0, table.counts[idc], 0)


def merge_into(dst: KmerTable, src: KmerTable, cap: int) -> KmerTable:
    """Merge ``src`` into ``dst`` keeping a FIXED capacity ``cap``.

    Streaming accumulation: static shapes mean one XLA compile no matter
    how many batches are merged.  Returns the merged table truncated to
    ``cap`` rows; the caller must check ``size <= cap`` (overflow means
    the unique-k-mer estimate was too low -- counts would silently drop).
    """
    merged = merge_tables(dst, src)
    return KmerTable(keys=merged.keys[:cap], counts=merged.counts[:cap],
                     size=merged.size)


def merge_tables(a: KmerTable, b: KmerTable) -> KmerTable:
    """Merge two count tables (concat -> sort -> segment-sum).

    Capacity of the result is ``cap_a + cap_b``; used by the streaming
    counter and the all-to-all sharded reduction.
    """
    keys = jnp.concatenate([a.keys, b.keys], axis=0)
    counts = jnp.concatenate([a.counts, b.counts], axis=0)
    n = keys.shape[0]
    row = jnp.arange(n)
    invalid = ~((row < a.size) | ((row >= a.keys.shape[0]) &
                                  (row < a.keys.shape[0] + b.size)))
    s_keys, s_invalid, s_counts = sort_kmers(keys, invalid, counts)
    is_first, seg_id = _boundaries(s_keys, s_invalid)
    seg_count = jax.ops.segment_sum(
        jnp.where(s_invalid, 0, s_counts), seg_id, num_segments=n
    )
    pad = jnp.full_like(s_keys, np.uint32(0xFFFFFFFF))
    out_keys = pad.at[seg_id].set(s_keys)
    nvalid = jnp.sum((~s_invalid).astype(jnp.int32))
    size = jnp.where(nvalid > 0,
                     seg_id[jnp.maximum(nvalid - 1, 0)] + 1, 0).astype(jnp.int32)
    out_counts = jnp.where(jnp.arange(n) < size, seg_count, 0)
    out_keys = jnp.where((jnp.arange(n) < size)[:, None], out_keys, pad)
    return KmerTable(keys=out_keys, counts=out_counts, size=size)
