"""Vectorized k-mer hashing (uint32 lanes, murmur3-style mixing).

Array replacement of ``GetDoubleHash_64bit`` (reference
``src/MyHash.cpp:21-35``).  The reference hashes ``std::hash<bitset>`` output
through murmur3's finalizer; ``std::hash`` is implementation-defined, so the
exact hash values are NOT part of the behavioral contract -- only the Bloom
filter's no-false-negative property and tunable FPR are (SURVEY.md §7.3).

Here every k-mer is ``[..., L] uint32`` and we run a murmur3-32-like
per-lane mix entirely in uint32 (wrapping) arithmetic -- no 64-bit
arithmetic.  Two independently seeded hashes drive the double-hashing probe
sequence ``h1 + n*h2`` (reference ``src/bloomfilter.cpp:58-66``); filter
sizes are powers of two so the ``mod`` is a mask and the u32 wraparound of
``h1 + n*h2`` is exact modular arithmetic.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from platanus3_tpu.constants import num_lanes

__all__ = ["hash_kmers", "double_hash", "probe_positions",
           "probe_positions_wide"]

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_MIX1 = np.uint32(0x85EBCA6B)
_MIX2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)


def _rotl32(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix32(h: jnp.ndarray) -> jnp.ndarray:
    h = h ^ (h >> 16)
    h = h * _MIX1
    h = h ^ (h >> 13)
    h = h * _MIX2
    h = h ^ (h >> 16)
    return h


def hash_kmers(kmers: jnp.ndarray, k: int, seed: int) -> jnp.ndarray:
    """Hash ``[..., L] uint32`` k-mers to ``[...] uint32``.

    Murmur3-32 body over the lanes (static L-step unrolled loop -> pure
    elementwise integer ops, fuses into surrounding extraction/Bloom code
    under jit).
    """
    l = num_lanes(k)
    assert kmers.shape[-1] == l
    init = np.uint32((seed ^ (k * 0x9E3779B9)) & 0xFFFFFFFF)
    h = jnp.full(kmers.shape[:-1], init, dtype=jnp.uint32)
    for j in range(l):
        kx = kmers[..., j] * _C1
        kx = _rotl32(kx, 15) * _C2
        h = h ^ kx
        h = _rotl32(h, 13) * np.uint32(5) + np.uint32(0xE6546B64)
    return _fmix32(h ^ np.uint32(4 * l))


def double_hash(kmers: jnp.ndarray, k: int):
    """Two independent u32 hashes ``(h1, h2)``; ``h2`` forced odd so the
    double-hash probe sequence has full period in a power-of-two filter."""
    h1 = hash_kmers(kmers, k, seed=0x8C5FB1F7)
    h2 = hash_kmers(kmers, k, seed=0x27D4EB2F) | np.uint32(1)
    return h1, h2


def probe_positions(h1: jnp.ndarray, h2: jnp.ndarray, num_hashes: int,
                    log2_bits: int) -> jnp.ndarray:
    """Bloom probe bit positions ``[num_hashes, ...] uint32``.

    ``(h1 + n*h2) mod 2^log2_bits`` -- the reference's ``nthHash``
    (``src/bloomfilter.cpp:58-66``) with a power-of-two modulus so u32
    wraparound is exact.

    The probe axis LEADS: it is a short major dimension and the minor
    dims stay the large query axes.
    """
    n = jnp.arange(num_hashes, dtype=jnp.uint32).reshape(
        (num_hashes,) + (1,) * h1.ndim)
    pos = h1[None] + n * h2[None]
    mask = np.uint32((1 << log2_bits) - 1)
    return pos & mask


def probe_positions_wide(kmers: jnp.ndarray, k: int, num_hashes: int,
                         log2_bits: int, lo_bits: int = 32):
    """Probe positions for filters LARGER than 2^32 bits, as two u32
    lanes ``(hi, lo)``, each ``[num_hashes, ...]`` (probe axis leading,
    see :func:`probe_positions`), full position ``hi * 2^lo_bits + lo``.

    ``lo_bits`` is 32 in production; tests shrink it to drive this exact
    code path on a tiny filter.

    The low 32 bits follow the same double-hash sequence as
    :func:`probe_positions`; the high ``log2_bits - 32`` bits come from a
    second, independently seeded double-hash pair.  Probes ``n != m`` of
    one k-mer can never collide: equality would require
    ``(n - m) * h2 == 0 (mod 2^32)``, impossible for odd ``h2`` --
    so the num_hashes probes stay distinct, and uniformity of ``h1``/
    ``h3`` gives a uniform position, which is all the Bloom FPR
    analysis needs (the reference's ``nthHash`` contract,
    ``src/bloomfilter.cpp:58-66``, is a probe-sequence recipe, not a
    value contract).
    """
    assert log2_bits >= lo_bits
    h1, h2 = double_hash(kmers, k)
    h3 = hash_kmers(kmers, k, seed=0x94D049BB)
    h4 = hash_kmers(kmers, k, seed=0xBF58476D)
    n = jnp.arange(num_hashes, dtype=jnp.uint32).reshape(
        (num_hashes,) + (1,) * h1.ndim)
    lo = (h1[None] + n * h2[None]) \
        & np.uint32(((1 << lo_bits) - 1) & 0xFFFFFFFF)
    hi = (h3[None] + n * h4[None]) \
        & np.uint32((1 << (log2_bits - lo_bits)) - 1)
    return hi, lo
