"""Core k-mer bit primitives as vectorized JAX ops.

Array re-design of the reference's ``std::bitset``-based k-mer layer
(reference: ``src/BitCalc.cpp``).  Instead of one arbitrary-width bitset per
k-mer processed in a scalar loop, a batch of k-mers is a ``uint32`` array of
shape ``[..., L]`` with ``L = ceil(k/16)`` lanes:

* lane 0 holds the MOST significant bits (the first bases of the k-mer),
  matching the reference's MSB-first packing (``src/BitCalc.cpp:7-19``:
  first base ends up at the top after k-1 left shifts);
* the 2k-bit value is LOW-aligned inside the 32*L-bit multiword (the top
  ``32*L - 2k`` bits of lane 0 are always zero).

With this layout an unsigned lexicographic compare over lanes 0..L-1 is
exactly the reference's MSB-first ``CompareBit`` (``src/BitCalc.cpp:47-54``),
and reverse complement is bitwise NOT + 2-bit-group reversal
(``src/BitCalc.cpp:35-45``).

Everything here is shape-static and branch-free so it fuses under ``jit``
and vectorizes; the hot extraction path builds all k-mers of
a read batch with 16 slice-OR ops instead of a sequential rolling scan.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from platanus3_tpu.constants import BASES_PER_LANE, BASE_TO_BIT, BIT_TO_BASE, num_lanes

__all__ = [
    "num_lanes",
    "encode_kmers_np",
    "decode_kmers_np",
    "revcomp",
    "canonical",
    "lex_less",
    "lex_equal",
    "shift_in_right",
    "shift_in_left",
    "first_base",
    "last_base",
    "is_palindrome",
    "extract_kmers",
    "pack_bases_np",
    "unpack_bases",
]


def _top_lane_bits(k: int) -> int:
    """Significant bits in lane 0 (the partial, most-significant lane)."""
    l = num_lanes(k)
    return 2 * k - 32 * (l - 1)


def _top_mask(k: int) -> np.uint32:
    r = _top_lane_bits(k)
    if r >= 32:
        return np.uint32(0xFFFFFFFF)
    return np.uint32((1 << r) - 1)


# ---------------------------------------------------------------------------
# Host-side encode / decode (numpy; used for I/O, tests and GFA output)
# ---------------------------------------------------------------------------

def encode_kmers_np(strings) -> np.ndarray:
    """Encode a list of equal-length k-mer strings to ``[N, L] uint32``.

    Semantics of ``GetFirstKmerForward`` (reference ``src/BitCalc.cpp:7-19``):
    the first base occupies the most significant 2 bits.
    """
    if isinstance(strings, str):
        strings = [strings]
    k = len(strings[0])
    l = num_lanes(k)
    out = np.zeros((len(strings), l), dtype=np.uint32)
    for i, s in enumerate(strings):
        assert len(s) == k, "all k-mers must have equal length"
        v = 0
        for c in s:
            v = (v << 2) | BASE_TO_BIT[c]
        for j in range(l - 1, -1, -1):
            out[i, j] = v & 0xFFFFFFFF
            v >>= 32
    return out


_DECODE_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_kmers_np(kmers: np.ndarray, k: int):
    """Decode ``[N, L] uint32`` back to strings (``GetStringKmer``,
    reference ``src/BitCalc.cpp:56-65``).

    Vectorized: base ``i`` lives at bit offset ``q = 2*(k-1-i)`` of the
    low-aligned multiword, i.e. lane ``L-1 - q//32`` shifted by ``q%32``
    -- one fancy-indexed shift builds the whole ``[N, k]`` code matrix
    (the per-row Python bignum loop was the emission hot spot at
    millions of junctions, VERDICT r4 item 7)."""
    kmers = np.asarray(kmers, dtype=np.uint32)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    n, l = kmers.shape
    q = 2 * (k - 1 - np.arange(k))
    lane = l - 1 - q // 32
    shift = (q % 32).astype(np.uint32)
    codes = (kmers[:, lane] >> shift[None, :]) & np.uint32(3)
    chars = _DECODE_ASCII[codes]
    return [row.tobytes().decode() for row in chars]


# ---------------------------------------------------------------------------
# Device-side primitives
# ---------------------------------------------------------------------------

def _reverse_pairs_u32(v: jnp.ndarray) -> jnp.ndarray:
    """Reverse the order of the 16 2-bit groups inside each uint32."""
    v = ((v & np.uint32(0x33333333)) << 2) | ((v >> 2) & np.uint32(0x33333333))
    v = ((v & np.uint32(0x0F0F0F0F)) << 4) | ((v >> 4) & np.uint32(0x0F0F0F0F))
    v = ((v & np.uint32(0x00FF00FF)) << 8) | ((v >> 8) & np.uint32(0x00FF00FF))
    v = (v << 16) | (v >> 16)
    return v


def revcomp(kmers: jnp.ndarray, k: int) -> jnp.ndarray:
    """Reverse complement of packed k-mers ``[..., L] -> [..., L]``.

    Matches ``GetComplementKmer`` (reference ``src/BitCalc.cpp:35-45``):
    complement of a 2-bit code is its bitwise NOT; reversal of base order is
    a bit-group reversal.  O(log) lane-local ops + a static lane flip; no
    per-base loop.
    """
    l = num_lanes(k)
    assert kmers.shape[-1] == l
    # Mask to the 2k significant bits, then complement.
    top = kmers[..., 0] & _top_mask(k)
    comp = jnp.concatenate(
        [(~top & _top_mask(k))[..., None], (~kmers[..., 1:])], axis=-1
    ) if l > 1 else (~top & _top_mask(k))[..., None]
    # Reverse 2-bit groups within lanes, then reverse lane order.  The value
    # is now HIGH-aligned in the multiword.
    rev = _reverse_pairs_u32(comp)[..., ::-1]
    # Re-align low: shift the whole multiword right by s = 32*L - 2k bits.
    s = 32 * l - 2 * k
    if s == 0:
        return rev
    lo = rev >> s
    hi = jnp.concatenate(
        [jnp.zeros_like(rev[..., :1]), rev[..., :-1] << (32 - s)], axis=-1
    )
    return lo | hi


def lex_less(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unsigned lexicographic ``a < b`` over the lane axis (MSB lane first).

    Equivalent to the reference's MSB-first bit loop ``CompareBit``
    (``src/BitCalc.cpp:47-54``) but O(L) vector ops.
    """
    l = a.shape[-1]
    less = jnp.zeros(a.shape[:-1], dtype=bool)
    eq = jnp.ones(a.shape[:-1], dtype=bool)
    for j in range(l):
        aj, bj = a[..., j], b[..., j]
        less = less | (eq & (aj < bj))
        eq = eq & (aj == bj)
    return less


def lex_equal(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=-1)


def canonical(kmers: jnp.ndarray, k: int):
    """Canonical form + orientation flag.

    Returns ``(canon, is_fw)`` where ``canon = min(kmer, revcomp(kmer))``
    with forward winning ties (reference ``CompareBit`` returns the forward
    form on equality, ``src/BitCalc.cpp:47-54``) and ``is_fw`` is True when
    the forward form was kept.
    """
    rc = revcomp(kmers, k)
    rc_less = lex_less(rc, kmers)  # strict: tie keeps forward
    is_fw = ~rc_less
    canon = jnp.where(rc_less[..., None], rc, kmers)
    return canon, is_fw


def is_palindrome(kmers: jnp.ndarray, k: int) -> jnp.ndarray:
    return lex_equal(kmers, revcomp(kmers, k))


def shift_in_right(kmers: jnp.ndarray, base: jnp.ndarray, k: int) -> jnp.ndarray:
    """Append ``base`` at the right end: ``(kmer << 2 | base) mod 4^k``.

    The right-neighbor step of the de Bruijn walk (reference
    ``src/DeBruijnGraph.cpp:325-345``, ``front_shifted_kmer``).
    ``base`` broadcasts against ``kmers[..., 0]``.
    """
    l = num_lanes(k)
    base = jnp.asarray(base, dtype=jnp.uint32)
    hi = kmers << 2
    lo = jnp.concatenate(
        [kmers[..., 1:] >> 30, jnp.broadcast_to(base, kmers.shape[:-1])[..., None]],
        axis=-1,
    )
    out = hi | lo
    return out.at[..., 0].set(out[..., 0] & _top_mask(k)) if l >= 1 else out


def shift_in_left(kmers: jnp.ndarray, base: jnp.ndarray, k: int) -> jnp.ndarray:
    """Prepend ``base`` at the left end: ``(kmer >> 2) | base << (2k-2)``.

    The left-neighbor step (reference ``src/DeBruijnGraph.cpp:325-345``,
    ``back_shifted_kmer``).
    """
    l = num_lanes(k)
    base = jnp.asarray(base, dtype=jnp.uint32)
    lo = kmers >> 2
    hi = jnp.concatenate(
        [jnp.zeros_like(kmers[..., :1]), kmers[..., :-1] << 30], axis=-1
    )
    out = lo | hi
    top_shift = _top_lane_bits(k) - 2
    return out.at[..., 0].set(
        out[..., 0] | (jnp.broadcast_to(base, kmers.shape[:-1]) << top_shift)
    )


def base_at(kmers: jnp.ndarray, j: int, k: int) -> jnp.ndarray:
    """2-bit code of base ``j`` (0 = leftmost) of packed k-mers.

    Static ``j``: the low-aligned layout places bit position ``2*(k-1-j)``
    in lane ``L-1 - q//32`` at offset ``q%32``.
    """
    q = 2 * (k - 1 - j)
    lane = num_lanes(k) - 1 - q // 32
    return (kmers[..., lane] >> np.uint32(q % 32)) & np.uint32(3)


def first_base(kmers: jnp.ndarray, k: int) -> jnp.ndarray:
    """2-bit code of the first (leftmost / most significant) base."""
    return (kmers[..., 0] >> (_top_lane_bits(k) - 2)) & np.uint32(3)


def last_base(kmers: jnp.ndarray, k: int) -> jnp.ndarray:
    """2-bit code of the last (rightmost) base."""
    return kmers[..., -1] & np.uint32(3)


# ---------------------------------------------------------------------------
# Packed read storage and k-mer extraction
# ---------------------------------------------------------------------------

def pack_bases_np(bases: np.ndarray) -> np.ndarray:
    """Pack ``[C, N] uint8`` base codes (0..3) into ``[C, N/16] uint32``,
    16 bases per lane, first base of each group most significant.  ``N``
    must be a multiple of 16 (pad with zeros).  Vectorized numpy; this is
    the host-side analog of the reference's rolling 2-bit packing
    (``src/Load.cpp:105-127``) done once at load time.
    """
    c, n = bases.shape
    assert n % BASES_PER_LANE == 0
    b = bases.astype(np.uint32).reshape(c, n // BASES_PER_LANE, BASES_PER_LANE)
    shifts = np.arange(30, -2, -2, dtype=np.uint32)  # 30, 28, ..., 0
    return (b << shifts[None, None, :]).sum(axis=-1, dtype=np.uint32)


def unpack_bases(packed: jnp.ndarray) -> jnp.ndarray:
    """Unpack ``[C, W] uint32`` -> ``[C, W*16] uint32`` base codes (0..3).

    Cheap in-jit expansion: static shifts + reshape, fully fused by XLA.
    """
    c, w = packed.shape
    shifts = jnp.arange(30, -2, -2, dtype=jnp.uint32)  # [16]
    bases = (packed[:, :, None] >> shifts[None, None, :]) & np.uint32(3)
    return bases.reshape(c, w * BASES_PER_LANE)


def sliding_words(bases: jnp.ndarray) -> jnp.ndarray:
    """``W16[c, p]`` = bases ``p..p+15`` of row ``c`` packed MSB-first.

    Built with 16 static slice-ORs -- the parallel-friendly replacement for
    the reference's sequential rolling window (``src/Load.cpp:118-124``).
    Output shape ``[C, N-15]``.
    """
    c, n = bases.shape
    p = n - (BASES_PER_LANE - 1)
    b = bases.astype(jnp.uint32)
    w = jnp.zeros((c, p), dtype=jnp.uint32)
    for t in range(BASES_PER_LANE):
        w = w | (b[:, t : t + p] << np.uint32(30 - 2 * t))
    return w


def extract_kmers(bases: jnp.ndarray, lengths: jnp.ndarray, k: int):
    """All forward k-mers of a base matrix, plus validity.

    Args:
      bases:   ``[C, N]`` base codes 0..3 (padding arbitrary), ``N % 16 == 0``
               and ``N >= k + 15``.
      lengths: ``[C]`` number of valid bases per row.
      k:       k-mer length (static).

    Returns:
      ``(fw, valid)`` with ``fw: [C, P, L] uint32`` (``P = N - k + 1``) and
      ``valid: [C, P] bool`` (position ``p`` valid iff ``p + k <= length``).

    This is the array replacement for the reference's per-position rolling
    loop (hot loops #1-#3, ``src/Load.cpp:118-124`` /
    ``src/MakeBloomFilter.cpp:52-74``): one ``sliding_words`` pass then
    ``L`` static slices per lane -- O(1) work per (position, lane) with no
    sequential dependence.
    """
    c, n = bases.shape
    l = num_lanes(k)
    p = n - k + 1
    assert p >= 1, f"chunk width {n} too small for k={k}"
    # Pad 16 zero bases so every needed 16-wide window exists even for k<16.
    padded = jnp.concatenate(
        [bases, jnp.zeros((c, BASES_PER_LANE), dtype=bases.dtype)], axis=1
    )
    w16 = sliding_words(padded)  # [C, N+1]
    r = k - 16 * (l - 1)  # bases in the partial top lane, 1..16
    lanes = []
    # Top (most significant) lane: bases [p, p+r).
    top = w16[:, 0:p]
    if r < 16:
        top = top >> np.uint32(32 - 2 * r)
    lanes.append(top)
    # Full lanes j >= 1: bases [p + r + 16*(j-1), ... + 16).
    for j in range(1, l):
        o = r + 16 * (j - 1)
        lanes.append(w16[:, o : o + p])
    fw = jnp.stack(lanes, axis=-1)
    pos = jnp.arange(p, dtype=jnp.int32)[None, :]
    valid = pos + k <= lengths[:, None]
    return fw, valid
