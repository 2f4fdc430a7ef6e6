"""Bloom filter over device arrays (packed uint32 words).

Array re-design of ``BF<Key>`` (reference ``src/bloomfilter.cpp``):
instead of one ``std::vector<bool>`` probed k-mer-at-a-time, the filter is
a device-resident PACKED bit array (32 bits per uint32 word) and add/query
are BULK operations over whole k-mer batches.  Membership semantics match
the reference exactly: ``num_hashes`` double-hash probes, no false
negatives, AND over probes for queries (``BF::possiblyContains``,
``src/bloomfilter.cpp:76-86``).

Build is fully VECTORIZED -- no scatter of individual probe bits (round 1
used a byte-per-bit array + scatter-max, 8x the memory).  The OR-scatter a
packed filter needs is
re-expressed as sort + dedup + scatter-ADD:

  1. probe bit positions for the whole batch (``ops/hashing.py``);
  2. one ``lax.sort`` of the positions;
  3. drop duplicate positions (compare-with-neighbor mask) -- after
     dedup every surviving (word, bit) pair is unique, so per-word SUM of
     ``1 << bit`` equals per-word OR;
  4. one scatter-add builds the delta word array, OR'd into the filter.

Duplicate k-mers in the batch are therefore free (idempotent), which the
pipeline exploits by inserting each stage's DISTINCT solid-k-mer table
instead of every read position (~coverage-fold less work).

The filter is a pytree, so it threads through ``jit``/``shard_map``; the
multi-host merge is a bitwise OR (``bloom_merge``; inside ``shard_map``
use ``parallel.sharded.or_allreduce``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.ops import hashing

__all__ = ["BloomFilter", "make_bloom", "bloom_add", "bloom_query",
           "bloom_merge", "log2_ceil"]


class BloomFilter(NamedTuple):
    """Pytree Bloom filter.

    bits:       ``[2^log2_bits / 32] uint32`` packed words (bit ``p`` of
                the filter is word ``p >> 5``, bit ``p & 31``)
    log2_bits:  static int (power-of-two size -> probe modulus is a mask)
    num_hashes: static int (reference default 10, ``src/Options.cpp:12``)
    """

    bits: jnp.ndarray
    log2_bits: int
    num_hashes: int


# log2_bits / num_hashes are static metadata, not leaves.
jax.tree_util.register_pytree_node(
    BloomFilter,
    lambda bf: ((bf.bits,), (bf.log2_bits, bf.num_hashes)),
    lambda aux, leaves: BloomFilter(leaves[0], aux[0], aux[1]),
)


def log2_ceil(n: int) -> int:
    return max(5, int(n - 1).bit_length())


def make_bloom(min_bits: int, num_hashes: int) -> BloomFilter:
    """Allocate an empty filter with at least ``min_bits`` bits (rounded up
    to a power of two; the reference size is used verbatim as a modulus,
    ``src/bloomfilter.cpp:66`` -- rounding up only lowers the FPR)."""
    lb = log2_ceil(min_bits)
    # <= 2^31 bits: single-u32 probe positions; (2^31, 2^35]: the wide
    # (hi, lo) two-lane path below.  2^35 bits = 4 GiB of filter words.
    assert lb <= 35, (
        f"filter of 2^{lb} bits (> 2^35 = 4 GiB) not supported single-chip;"
        f" pass filter_bits explicitly or shard the filter over a mesh")
    return BloomFilter(
        bits=jnp.zeros(((1 << lb) // 32,), dtype=jnp.uint32),
        log2_bits=lb,
        num_hashes=num_hashes,
    )


def _positions(bf: BloomFilter, kmers: jnp.ndarray, k: int) -> jnp.ndarray:
    h1, h2 = hashing.double_hash(kmers, k)
    return hashing.probe_positions(h1, h2, bf.num_hashes, bf.log2_bits)


_SENTINEL = np.uint32(0xFFFFFFFF)


def bloom_add(bf: BloomFilter, kmers: jnp.ndarray, k: int,
              mask: jnp.ndarray | None = None) -> BloomFilter:
    """Insert a batch of (canonical) k-mers ``[..., L]``.

    ``mask`` (``[...] bool``) drops masked k-mers.  Bulk analog of
    ``BF::add`` (reference ``src/bloomfilter.cpp:68-74``); duplicate
    k-mers / colliding probes are deduplicated by the sort (idempotent
    insert), see module docstring.
    """
    # Flatten batch dims: probe arrays are [H, N], not [H, ..., b].
    kmers = kmers.reshape(-1, kmers.shape[-1])
    if mask is not None:
        mask = mask.reshape(-1)
    if bf.log2_bits >= 32:
        return _bloom_add_wide(bf, kmers, k, mask)
    pos = _positions(bf, kmers, k)          # [H, N] probe-major
    if mask is not None:
        pos = jnp.where(mask[None], pos, _SENTINEL)
    pos = jnp.sort(pos.reshape(-1))
    prev = jnp.concatenate([jnp.full((1,), _SENTINEL, jnp.uint32), pos[:-1]])
    keep = (pos != prev) & (pos != _SENTINEL)
    # after dedup each (word, bit) pair appears once -> add == OR
    word = jnp.where(keep, (pos >> np.uint32(5)).astype(jnp.int32),
                     np.int32(1) << 30)
    bitv = jnp.uint32(1) << (pos & np.uint32(31))
    delta = jnp.zeros_like(bf.bits).at[word].add(bitv, mode="drop")
    return bf._replace(bits=bf.bits | delta)


def _bloom_add_wide(bf: BloomFilter, kmers: jnp.ndarray, k: int,
                    mask: jnp.ndarray | None, lo_bits: int = 32
                    ) -> BloomFilter:
    """Insert path for filters of 2^32..2^35 bits (ADVICE r2: the packed
    rewrite had capped the envelope at 2^31; this restores and extends
    the former 2^33-bit reach).

    Positions are (hi, lo) u32 pairs (``probe_positions_wide``); dedup is
    a two-key sort; the mask sentinel rides the hi lane (real hi
    < 2^(log2_bits-32) <= 8, so 0xFFFFFFFF is unreachable).  ``lo_bits``
    is 32 in production; tests shrink it to run this path on a tiny
    filter.
    """
    hi, lo = hashing.probe_positions_wide(kmers, k, bf.num_hashes,
                                          bf.log2_bits, lo_bits)
    if mask is not None:
        hi = jnp.where(mask[None], hi, _SENTINEL)
    hi, lo = jax.lax.sort((hi.reshape(-1), lo.reshape(-1)), num_keys=2)
    pad = jnp.full((1,), _SENTINEL, jnp.uint32)
    keep = ((hi != jnp.concatenate([pad, hi[:-1]]))
            | (lo != jnp.concatenate([pad, lo[:-1]]))) \
        & (hi != _SENTINEL)
    # word = full_pos >> 5 = hi * 2^(lo_bits-5) + (lo >> 5); fits int32
    # for log2_bits <= 35 (word < 2^30); dropped rows use the
    # out-of-range index 2^30 (word array length <= 2^30).
    word = (hi * np.uint32(1 << (lo_bits - 5))
            + (lo >> np.uint32(5))).astype(jnp.int32)
    word = jnp.where(keep, word, np.int32(1) << 30)
    bitv = jnp.uint32(1) << (lo & np.uint32(31))
    delta = jnp.zeros_like(bf.bits).at[word].add(bitv, mode="drop")
    return bf._replace(bits=bf.bits | delta)


def _bloom_query_wide(bf: BloomFilter, kmers: jnp.ndarray, k: int,
                      lo_bits: int = 32) -> jnp.ndarray:
    hi, lo = hashing.probe_positions_wide(kmers, k, bf.num_hashes,
                                          bf.log2_bits, lo_bits)
    w = (hi * np.uint32(1 << (lo_bits - 5))
         + (lo >> np.uint32(5))).astype(jnp.int32)
    probe = (bf.bits[w] >> (lo & np.uint32(31))) & np.uint32(1)
    return jnp.min(probe, axis=0) > 0


def bloom_query(bf: BloomFilter, kmers: jnp.ndarray, k: int) -> jnp.ndarray:
    """Batch membership query -> ``[...] bool``.

    AND over ``num_hashes`` gathered probe bits (``BF::possiblyContains``,
    reference ``src/bloomfilter.cpp:76-86``).
    """
    batch_shape = kmers.shape[:-1]
    kmers = kmers.reshape(-1, kmers.shape[-1])  # [H, N] probes -- trailing
    # batch dims would be tile-padded (see bloom_add)
    if bf.log2_bits >= 32:
        return _bloom_query_wide(bf, kmers, k).reshape(batch_shape)
    pos = _positions(bf, kmers, k)          # [H, N] probe-major
    w = (pos >> np.uint32(5)).astype(jnp.int32)
    probe = (bf.bits[w] >> (pos & np.uint32(31))) & np.uint32(1)
    return (jnp.min(probe, axis=0) > 0).reshape(batch_shape)


def bloom_merge(a: BloomFilter, b: BloomFilter) -> BloomFilter:
    """Bitwise-OR merge of two filters (for sharded construction)."""
    assert a.log2_bits == b.log2_bits and a.num_hashes == b.num_hashes
    return a._replace(bits=a.bits | b.bits)
