"""Tests for counting (sort/segment), window-min, and Bloom layers.

Oracle: Python ``collections.Counter`` over canonical k-mer strings --
exactly the reference's ``unordered_map`` counting semantics
(``src/Load.cpp:105-127``).
"""

from collections import Counter

import numpy as np
import pytest
import jax.numpy as jnp

from platanus3_tpu.constants import BASES, canonical_str
from platanus3_tpu.ops import bloom as B
from platanus3_tpu.ops import count as C
from platanus3_tpu.ops import kmer as K
from platanus3_tpu.ops.windowmin import window_min

RNG = np.random.default_rng(1)


def random_seq(n):
    return "".join(RNG.choice(list(BASES), size=n))


def all_canonical(seqs, k):
    cnt = Counter()
    for s in seqs:
        for i in range(len(s) - k + 1):
            cnt[canonical_str(s[i : i + k])] += 1
    return cnt


def canon_kmers_of(seqs, k):
    """Flat [N, L] canonical k-mers + validity via the device path."""
    n = max(len(s) for s in seqs)
    n = ((n + 15) // 16) * 16
    bases = np.zeros((len(seqs), n), dtype=np.uint32)
    for i, s in enumerate(seqs):
        bases[i, : len(s)] = [{"A": 0, "C": 1, "G": 2, "T": 3}[c] for c in s]
    lengths = jnp.asarray([len(s) for s in seqs], dtype=jnp.int32)
    fw, valid = K.extract_kmers(jnp.asarray(bases), lengths, k)
    canon, _ = K.canonical(fw, k)
    l = canon.shape[-1]
    return canon.reshape(-1, l), valid.reshape(-1)


@pytest.mark.parametrize("k", [5, 21, 32])
def test_count_matches_counter(k):
    # Repetitive sequences so duplicate k-mers actually occur.
    core = random_seq(40)
    seqs = [core + random_seq(30), random_seq(25) + core, core]
    want = all_canonical(seqs, k)

    kmers, valid = canon_kmers_of(seqs, k)
    table = C.count_kmers(kmers, valid)
    size = int(table.size)
    assert size == len(want)
    keys = K.decode_kmers_np(np.asarray(table.keys[:size]), k)
    counts = np.asarray(table.counts[:size])
    got = dict(zip(keys, counts.tolist()))
    assert got == dict(want)
    # Sorted order
    assert keys == sorted(keys)


def test_count_with_positions_matches_counter():
    k = 21
    core = random_seq(50)
    seqs = [core + random_seq(20), core]
    want = all_canonical(seqs, k)

    kmers, valid = canon_kmers_of(seqs, k)
    table, per_pos = C.count_with_positions(kmers, valid)
    strs = K.decode_kmers_np(np.asarray(kmers), k)
    pp = np.asarray(per_pos)
    v = np.asarray(valid)
    for i in range(len(strs)):
        if v[i]:
            assert pp[i] == want[canonical_str(strs[i])]
        else:
            assert pp[i] == 0


def test_phantom_positions_get_counts_but_do_not_contribute():
    k = 5
    seqs = ["ACGTACGTAC"]
    kmers, valid = canon_kmers_of(seqs, k)
    # Duplicate the batch: second copy is "phantom" (valid for reporting,
    # not contributing) -- emulates chunk-overlap positions.
    kmers2 = jnp.concatenate([kmers, kmers], axis=0)
    valid2 = jnp.concatenate([valid, valid])
    contrib = jnp.concatenate([valid, jnp.zeros_like(valid)])
    table, per_pos = C.count_with_positions(kmers2, valid2, contrib)
    want = all_canonical(seqs, k)
    size = int(table.size)
    keys = K.decode_kmers_np(np.asarray(table.keys[:size]), k)
    got = dict(zip(keys, np.asarray(table.counts[:size]).tolist()))
    assert got == dict(want)  # phantoms added nothing
    pp = np.asarray(per_pos)
    n = kmers.shape[0]
    # ...but phantom copies still see the true counts.
    assert np.array_equal(pp[:n], pp[n:])


def test_lookup_and_lookup_id():
    k = 21
    seqs = [random_seq(60), random_seq(45)]
    kmers, valid = canon_kmers_of(seqs, k)
    table = C.count_kmers(kmers, valid)

    got = np.asarray(C.lookup(table, kmers))
    want_cnt = all_canonical(seqs, k)
    strs = K.decode_kmers_np(np.asarray(kmers), k)
    v = np.asarray(valid)
    for i, s in enumerate(strs):
        if v[i]:
            assert got[i] == want_cnt[canonical_str(s)]

    # Absent queries -> 0 / -1.
    absent = jnp.asarray(K.encode_kmers_np(["A" * k]))
    assert ("A" * k) not in want_cnt
    assert int(C.lookup(table, absent)[0]) == 0
    assert int(C.lookup_id(table, absent)[0]) == -1

    ids = np.asarray(C.lookup_id(table, table.keys[: int(table.size)]))
    assert np.array_equal(ids, np.arange(int(table.size)))


def test_merge_tables():
    k = 21
    seqs1 = [random_seq(60)]
    seqs2 = [seqs1[0][:40] + random_seq(20)]  # overlapping content
    k1, v1 = canon_kmers_of(seqs1, k)
    k2, v2 = canon_kmers_of(seqs2, k)
    t1 = C.count_kmers(k1, v1)
    t2 = C.count_kmers(k2, v2)
    merged = C.merge_tables(t1, t2)
    want = all_canonical(seqs1 + seqs2, k)
    size = int(merged.size)
    assert size == len(want)
    keys = K.decode_kmers_np(np.asarray(merged.keys[:size]), k)
    got = dict(zip(keys, np.asarray(merged.counts[:size]).tolist()))
    assert got == dict(want)


@pytest.mark.parametrize("w", [1, 2, 5, 11])
def test_window_min_vs_naive(w):
    v = RNG.integers(0, 100, size=(3, 40)).astype(np.int32)
    got = np.asarray(window_min(jnp.asarray(v), w))
    want = np.stack(
        [[v[r, j : j + w].min() for j in range(40 - w + 1)] for r in range(3)]
    )
    assert np.array_equal(got, want)


def test_bloom_no_false_negatives_and_fpr():
    k = 25
    strs = [random_seq(k) for _ in range(500)]
    enc = jnp.asarray(K.encode_kmers_np(strs))
    canon, _ = K.canonical(enc, k)
    bf = B.make_bloom(1 << 16, num_hashes=6)
    bf = B.bloom_add(bf, canon, k)
    assert bool(jnp.all(B.bloom_query(bf, canon, k)))

    # Fresh random canonical k-mers: FPR should be tiny at this load factor.
    probe = [canonical_str(random_seq(k)) for _ in range(2000)]
    probe = [p for p in probe if p not in {canonical_str(s) for s in strs}]
    q = B.bloom_query(bf, jnp.asarray(K.encode_kmers_np(probe)), k)
    assert float(jnp.mean(q.astype(jnp.float32))) < 0.01


def test_bloom_mask_drops_and_merge():
    k = 25
    strs = [random_seq(k) for _ in range(64)]
    enc = jnp.asarray(K.encode_kmers_np(strs))
    mask = jnp.asarray(np.arange(64) < 32)
    bf = B.make_bloom(1 << 14, num_hashes=4)
    bf = B.bloom_add(bf, enc, k, mask=mask)
    q = np.asarray(B.bloom_query(bf, enc, k))
    assert q[:32].all()
    # Masked-out kmers should (almost surely) be absent.
    assert q[32:].sum() <= 2

    bf2 = B.make_bloom(1 << 14, num_hashes=4)
    bf2 = B.bloom_add(bf2, enc, k, mask=~mask)
    merged = B.bloom_merge(bf, bf2)
    assert bool(jnp.all(B.bloom_query(merged, enc, k)))


def test_bloom_wide_path_no_false_negatives_and_mask():
    """The >2^31-bit (hi, lo) two-lane filter path (ADVICE r2 item 3),
    driven at tiny scale via lo_bits=16: identical code, 2^20-bit array."""
    import jax
    k = 25
    strs = [random_seq(k) for _ in range(500)]
    enc = jnp.asarray(K.encode_kmers_np(strs))
    canon, _ = K.canonical(enc, k)
    # log2_bits=20 with lo_bits=16 -> hi has 4 bits, exercising the
    # two-lane sort-dedup + word packing exactly as a 2^36-ish filter
    # with lo_bits=32 would.
    bf = B.BloomFilter(bits=jnp.zeros(((1 << 20) // 32,), jnp.uint32),
                       log2_bits=20, num_hashes=6)
    mask = jnp.asarray(np.arange(500) < 400)
    bf = B._bloom_add_wide(bf, canon, k, mask, lo_bits=16)
    q = np.asarray(B._bloom_query_wide(bf, canon, k, lo_bits=16))
    assert q[:400].all()          # no false negatives
    assert q[400:].sum() <= 3     # masked-out k-mers absent (mod FP)

    # idempotence: re-adding the same set changes nothing
    bf2 = B._bloom_add_wide(bf, canon, k, mask, lo_bits=16)
    assert np.array_equal(np.asarray(bf.bits), np.asarray(bf2.bits))

    # fresh canonical k-mers: FPR tiny at this load factor
    probe = [canonical_str(random_seq(k)) for _ in range(2000)]
    probe = [p for p in probe if p not in {canonical_str(s) for s in strs}]
    pq = B._bloom_query_wide(
        bf, jnp.asarray(K.encode_kmers_np(probe)), k, lo_bits=16)
    assert float(jnp.mean(pq.astype(jnp.float32))) < 0.01

    # production dispatch: bloom_add/query route >=2^32 bits through the
    # wide path (abstract eval only -- a 2^33-bit array is too big for
    # CI), and make_bloom admits up to 2^35 but no further.
    big = B.BloomFilter(
        jax.ShapeDtypeStruct(((1 << 33) // 32,), jnp.uint32), 33, 4)
    jax.eval_shape(lambda b, kk: B.bloom_add(b, kk, k), big, canon)
    jax.eval_shape(lambda b, kk: B.bloom_query(b, kk, k), big, canon)
    import pytest
    with pytest.raises(AssertionError):
        B.make_bloom(1 << 36, num_hashes=4)


def test_count_solid_with_ids_matches_composition():
    # count_solid_with_ids == count_kmers(contributes) + lookup_id_join
    k = 11
    n = 400
    strs = [random_seq(k) for _ in range(40)]
    picks = RNG.integers(0, len(strs), size=n)
    kmers = jnp.asarray(K.encode_kmers_np([strs[i] for i in picks]))
    canon, _ = K.canonical(kmers, k)
    valid = jnp.asarray(RNG.random(n) < 0.9)
    solid = jnp.asarray(RNG.random(n) < 0.5) & valid

    table, nid = C.count_solid_with_ids(canon, valid, solid)
    ref_table = C.count_kmers(canon, solid)
    sz, ref_sz = int(table.size), int(ref_table.size)
    assert sz == ref_sz
    assert np.array_equal(np.asarray(table.keys[:sz]),
                          np.asarray(ref_table.keys[:sz]))
    assert np.array_equal(np.asarray(table.counts[:sz]),
                          np.asarray(ref_table.counts[:sz]))

    ref_nid = np.asarray(C.lookup_id_join(ref_table, canon))
    got = np.asarray(nid)
    v = np.asarray(valid)
    assert np.array_equal(got[v], ref_nid[v])
    assert (got[~v] == -1).all()


def test_count_solid_with_ids_empty_and_all_solid():
    k = 9
    kmers = jnp.asarray(K.encode_kmers_np([random_seq(k) for _ in range(16)]))
    canon, _ = K.canonical(kmers, k)
    none = jnp.zeros(16, bool)
    t, nid = C.count_solid_with_ids(canon, none, none)
    assert int(t.size) == 0
    assert (np.asarray(nid) == -1).all()

    ones = jnp.ones(16, bool)
    t2, nid2 = C.count_solid_with_ids(canon, ones, ones)
    uniq = {s for s in K.decode_kmers_np(np.asarray(canon), k)}
    assert int(t2.size) == len(uniq)
    assert (np.asarray(nid2) >= 0).all()


# ---- oracle cases for the plain counter and the packed Bloom build ----

def _decode_table(table, k):
    size = int(table.size)
    keys = K.decode_kmers_np(np.asarray(table.keys[:size]), k)
    return dict(zip(keys, np.asarray(table.counts[:size]).tolist()))


@pytest.mark.parametrize("k", [11, 25, 40])
def test_count_kmers_sampled_multiset_matches_counter(k):
    # 60 distinct k-mers sampled 500 times, ~80% contributing: heavy
    # duplication at single- and multi-lane widths.
    uniq = [random_seq(k) for _ in range(60)]
    picks = RNG.integers(0, len(uniq), size=500)
    strs = [uniq[i] for i in picks]
    contrib = RNG.random(500) < 0.8
    kmers = jnp.asarray(K.encode_kmers_np(strs))
    canon, _ = K.canonical(kmers, k)
    table = C.count_kmers(canon, jnp.asarray(contrib), k=k)
    want = Counter(canonical_str(s) for s, c in zip(strs, contrib) if c)
    assert _decode_table(table, k) == dict(want)


def test_count_kmers_all_duplicates_single_row():
    k = 25
    s = random_seq(k)
    canon, _ = K.canonical(jnp.asarray(K.encode_kmers_np([s] * 300)), k)
    table = C.count_kmers(canon, jnp.ones(300, bool), k=k)
    assert _decode_table(table, k) == {canonical_str(s): 300}


def test_count_kmers_empty_input():
    k = 17
    kmers = jnp.asarray(K.encode_kmers_np([random_seq(k) for _ in range(8)]))
    canon, _ = K.canonical(kmers, k)
    table = C.count_kmers(canon, jnp.zeros(8, bool), k=k)
    assert int(table.size) == 0
    assert int(jnp.sum(table.counts)) == 0


def test_count_kmers_allones_palindrome_lane():
    # T*16 A*16 is its own reverse complement and encodes as an all-ones
    # lane: the counter must count it, not take it for padding.
    k = 32
    s = "T" * 16 + "A" * 16
    canon, _ = K.canonical(jnp.asarray(K.encode_kmers_np([s] * 5)), k)
    assert int(np.asarray(canon)[0, 0]) == 0xFFFFFFFF
    table = C.count_kmers(canon, jnp.ones(5, bool), k=k)
    assert _decode_table(table, k) == {s: 5}


def _canon_batch(n, k):
    strs = [random_seq(k) for _ in range(n)]
    canon, _ = K.canonical(jnp.asarray(K.encode_kmers_np(strs)), k)
    return canon


def _numpy_bloom_words(canon, k, mask, log2_bits, hashes):
    """Plain bit-set reference: set every probe bit one at a time."""
    from platanus3_tpu.ops import hashing
    h1, h2 = hashing.double_hash(canon, k)
    pos = np.asarray(hashing.probe_positions(h1, h2, hashes, log2_bits))
    words = np.zeros((1 << log2_bits) // 32, np.uint32)
    for n in np.flatnonzero(np.asarray(mask)):
        for p in pos[:, n].tolist():
            words[p >> 5] |= np.uint32(1 << (p & 31))
    return words


@pytest.mark.parametrize("k,log2_bits,hashes", [(25, 18, 6), (32, 20, 10)])
def test_bloom_add_packed_words_match_numpy_bitset(k, log2_bits, hashes):
    canon = _canon_batch(3000, k)
    mask = jnp.asarray(RNG.random(3000) < 0.8)
    bf = B.bloom_add(B.make_bloom(1 << log2_bits, hashes), canon, k,
                     mask=mask)
    want = _numpy_bloom_words(canon, k, mask, log2_bits, hashes)
    assert np.array_equal(np.asarray(bf.bits), want)


def test_bloom_no_false_negatives_multi_block_filter():
    k = 25
    canon = _canon_batch(4000, k)
    bf = B.bloom_add(B.make_bloom(1 << 23, 8), canon, k)
    assert bf.bits.shape == ((1 << 23) // 32,)
    assert bool(jnp.all(B.bloom_query(bf, canon, k)))


def test_bloom_fpr_bound_and_masked_rows_absent():
    k = 25
    canon = _canon_batch(4000, k)
    mask = jnp.asarray(np.arange(4000) < 3000)
    bf = B.bloom_add(B.make_bloom(1 << 21, 8), canon, k, mask=mask)
    q = np.asarray(B.bloom_query(bf, canon, k))
    assert q[:3000].all()
    # 3000 keys x 8 probes in 2^21 bits: theoretical FPR ~1e-8.
    assert q[3000:].mean() < 0.05
    fresh = np.asarray(B.bloom_query(bf, _canon_batch(4000, k), k))
    assert fresh.mean() < 0.05


def test_bloom_duplicates_idempotent_and_all_masked_empty():
    k = 32
    canon = _canon_batch(64, k)
    once = B.bloom_add(B.make_bloom(1 << 19, 6), canon, k)
    dup = B.bloom_add(B.make_bloom(1 << 19, 6),
                      jnp.concatenate([canon] * 4, axis=0), k)
    assert np.array_equal(np.asarray(once.bits), np.asarray(dup.bits))
    assert bool(jnp.all(B.bloom_query(dup, canon, k)))

    empty = B.bloom_add(B.make_bloom(1 << 19, 6), canon, k,
                        mask=jnp.zeros(64, bool))
    assert int(jnp.sum(empty.bits)) == 0
