"""Benchmark: canonical k-mers/s through the counting hot path on one GPU.

BASELINE metric: "k-mers/sec/chip (count+Bloom)".  The production
configuration uses exact membership -- the sorted solid-node table IS the
membership structure, no separate Bloom build needed (see
AssemblyConfig.use_exact_membership; `--membership bloom` builds the
packed filter from the distinct node set, benchmarks/bloom_mode_bench.py
measures that mode's full-pipeline ratio).  The hot path benchmarked here
is: 2-bit unpack -> canonical extraction (21-mers and k-mers) -> sort+scan
count -> window-min solidity -> solid-node table build.  That is
everything the reference's stages A+B do (count + membership-structure
construction), hence the metric name `..._count_solid`.  ``vs_baseline``
is the ratio against the reference's measured ~1.9e5 canonical-k-mer
ops/s (BASELINE.md).

Each program is compiled and run once before timing; a timed run ends in
``jax.block_until_ready`` and the minimum over ``P3_BENCH_ITERS`` runs is
kept.  Fails without a GPU.  Prints the device and the card's power limit
on stderr and exactly one JSON line on stdout; a per-stage breakdown
(cumulative prefixes of the program) goes to stderr.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"# {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"{card}", file=sys.stderr, flush=True)

    import jax.numpy as jnp
    from platanus3_tpu.io import reads as reads_mod
    from platanus3_tpu.ops import count as count_mod
    from platanus3_tpu.ops import solid as solid_mod

    k, short_k, cov_threshold = 25, 21, 2
    chunk_len = 1024

    # ~10M bases of synthetic 20x reads over a 500 kb genome.
    rng = np.random.default_rng(0)
    glen = int(os.environ.get("P3_BENCH_GENOME", "500000"))
    genome = "".join(rng.choice(list("ACGT"), size=glen))
    read_len, coverage = 2000, 20
    n_reads = len(genome) * coverage // read_len
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, len(genome) - read_len))
        reads.append(genome[s : s + read_len])
    batch = reads_mod.reads_from_strings(reads, k, chunk_len)

    from platanus3_tpu.ops import kmer as kmer_mod
    stride = chunk_len - k + 1

    def prefix_extract(packed, valid_len, read_id, start, read_len_a):
        bases = kmer_mod.unpack_bases(packed)
        s_canon, s_valid, s_owned = solid_mod.short_kmer_positions(
            bases, valid_len, start, read_len_a, stride, short_k, k)
        fw, valid_k = kmer_mod.extract_kmers(bases, valid_len, k)
        canon, _ = kmer_mod.canonical(fw, k)
        return s_canon[0, 0], s_owned, canon

    def prefix_count(packed, valid_len, read_id, start, read_len_a):
        bases = kmer_mod.unpack_bases(packed)
        s_canon, s_valid, s_owned = solid_mod.short_kmer_positions(
            bases, valid_len, start, read_len_a, stride, short_k, k)
        l_s = s_canon.shape[-1]
        _, per_pos = count_mod.count_positions_table(
            s_canon.reshape(-1, l_s), s_valid.reshape(-1),
            s_owned.reshape(-1), k=short_k, want_table=False)
        return per_pos[0], per_pos

    def stage1(packed, valid_len, read_id, start, read_len_a):
        result, _ = solid_mod.solid_kmers(
            (packed, valid_len, read_id, start, read_len_a),
            k, short_k, cov_threshold, None, add_to_bloom=False,
            need_short_table=False)
        l = result.canon.shape[-1]
        # Same one-sort node-table+ids build the production pipeline's
        # stage 1 performs (pipeline._stage1).
        table, _nid = count_mod.count_solid_with_ids(
            result.canon.reshape(-1, l),
            result.owned.reshape(-1),
            (result.is_solid & result.owned).reshape(-1), k=k,
            want_counts=False)  # mirrors pipeline._stage1
        return table.size, table.keys

    # count+Bloom variant (BASELINE's literal "count+Bloom" wording): the
    # same stage-1 pass PLUS the packed Bloom filter built from the
    # distinct solid-node table, exactly as pipeline bloom-mode does --
    # i.e. on the COMPACTED table (pipeline._bloom_from_nodes).
    from platanus3_tpu.config import AssemblyConfig
    from platanus3_tpu.ops import bloom as bloom_mod
    from platanus3_tpu.pipeline import _graph_cap
    _cfg = AssemblyConfig(k=k)
    _bits, _hashes = _cfg.auto_filter_bits(
        sum(len(r) for r in reads))
    bf0 = bloom_mod.make_bloom(_bits, _hashes)

    def bloom_build(nodes_c, size, bits):
        bf_in = bloom_mod.BloomFilter(bits, bf0.log2_bits, bf0.num_hashes)
        rows = jnp.arange(nodes_c.shape[0], dtype=jnp.int32)
        bf_out = bloom_mod.bloom_add(bf_in, nodes_c, k, mask=rows < size)
        return size, bf_out.bits

    args = [
        jnp.asarray(batch.packed), jnp.asarray(batch.valid_len),
        jnp.asarray(batch.read_id), jnp.asarray(batch.start),
        jnp.asarray(batch.read_len),
    ]
    iters = int(os.environ.get("P3_BENCH_ITERS", "10"))

    def measure(fn, fn_args):
        f = jax.jit(fn)
        jax.block_until_ready(f(*fn_args))  # compile + warm-up
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(f(*fn_args))
            best = min(best, time.perf_counter() - t0)
        return best

    dt = measure(stage1, args)

    # Bloom-build leg, production path: host-compact the node table
    # (pipeline.py does this between stage 1 and the Bloom build), then
    # time bloom_add alone.
    _sz, _keys = jax.jit(stage1)(*args)
    num_nodes = int(_sz)
    capn = _graph_cap(num_nodes)
    nodes_c = jnp.asarray(np.asarray(_keys)[:capn])
    size_a = jnp.asarray(num_nodes, jnp.int32)
    dt_bloom = dt + measure(bloom_build, (nodes_c, size_a, bf0.bits))

    t_e = measure(prefix_extract, args)
    t_c = measure(prefix_count, args)
    print(f"# breakdown: extract+canon {t_e*1e3:.1f} ms | short-count "
          f"sort+scan +{(t_c-t_e)*1e3:.1f} ms | windowmin+node-table+seeds "
          f"+{(dt-t_c)*1e3:.1f} ms | full stage1 {dt*1e3:.1f} ms",
          file=sys.stderr, flush=True)

    c = batch.num_chunks
    kmer_positions = c * (chunk_len - short_k + 1) + c * (chunk_len - k + 1)
    value = kmer_positions / dt
    value_bloom = kmer_positions / dt_bloom
    baseline = 1.9e5  # reference: canonical-kmer ops/s, 2 CPU cores
    print(json.dumps({
        "metric": "kmers_per_sec_per_chip_count_solid",
        "value": round(value, 1),
        "unit": "canonical kmers/s",
        "vs_baseline": round(value / baseline, 2),
        # same pass + packed Bloom build from the distinct node table
        "count_bloom_value": round(value_bloom, 1),
        "count_bloom_vs_baseline": round(value_bloom / baseline, 2),
        "bloom_over_exact_ratio": round(dt_bloom / dt, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
