"""Generate the golden-run input FASTAs ahead of time (numpy only, no jax).

The reference binary (2 CPU cores, mostly serial) is the wall-clock
bottleneck of every golden comparison, so the benchmark drivers decouple
"generate input" / "run reference" / "run ours" / "compare": this script
writes byte-identical read sets to what the benchmark scripts generate
internally, so the reference runs can start first and proceed in the
background while this framework runs.

  megabase : benchmarks/megabase_golden.py input (seed 99, 1 Mb, 8 kb
             reads step 400)
  repeat   : benchmarks/repeat_golden.py input (default args: 2 Mb,
             planted repeats + SNP haplotype)
  largek   : k=2001 golden input (60 kb genome, 6 kb reads step 300)

Usage: python tools/gen_golden_inputs.py <megabase|repeat|largek> <out.fasta>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def write_fasta(path, reads):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for i, s in enumerate(reads):
            f.write(f">r{i}\n{s}\n")
    os.rename(tmp, path)
    print(f"{path}: {len(reads)} reads, "
          f"{sum(len(r) for r in reads)/1e6:.1f} Mbases")


def tiled(genome, read_len, step):
    return [genome[s:s + read_len]
            for s in range(0, len(genome) - read_len + 1, step)]


def megabase_reads(glen=1_000_000):
    # Must match benchmarks/megabase_golden.py exactly.
    rng = np.random.default_rng(99)
    genome = "".join(rng.choice(list("ACGT"), size=glen))
    return [genome[s:s + 8000] for s in range(0, glen - 8000 + 1, 400)]


def repeat_reads(glen=2_000_000, k=25, repeat_len=200, n_copies=1500,
                 n_snps=400):
    # Must match benchmarks/repeat_golden.py (default args) exactly.
    from platanus3_tpu import sim
    base = sim.random_genome(glen, seed=1234)
    base = sim.plant_repeats(base, repeat_len, n_copies, seed=7)
    base = sim.plant_repeats(base, 3 * k, n_copies // 2, seed=8,
                             min_gap=5 * repeat_len)
    hap2 = sim.mutate_genome(base, n_snps, seed=9, min_gap=1000)
    return tiled(base, 3000, 400) + tiled(hap2, 3000, 600)


def largek_reads(glen=60_000):
    # k=2001 golden input (VERDICT r2 item 7); must match
    # tests/test_large_k.py::test_golden_k2001 generation.
    from platanus3_tpu import sim
    genome = sim.random_genome(glen, seed=4242)
    return tiled(genome, 6000, 300)


def realistic_reads(glen=2_000_000, k=25, repeat_len=200, n_copies=1500,
                    n_snps=400):
    # Must match benchmarks/repeat_golden.py --realistic (default args).
    from platanus3_tpu import sim
    base = sim.realistic_genome(glen, seed=1234)
    base = sim.plant_repeats(base, repeat_len, n_copies, seed=7)
    base = sim.plant_repeats(base, 3 * k, n_copies // 2, seed=8,
                             min_gap=5 * repeat_len)
    hap2 = sim.mutate_genome(base, n_snps, seed=9, min_gap=1000)
    return tiled(base, 3000, 400) + tiled(hap2, 3000, 600)


# (k, m_bits) each input kind is golden-compared with; the fingerprint
# written next to the FASTA binds the cached reference GFA to these
# exact parameters (ADVICE r3 -- stale caches must never be trusted).
PARAMS = {"megabase": (25, 1 << 30), "repeat": (25, 1 << 30),
          "largek": (2001, 1 << 22), "realistic": (25, 1 << 30)}

if __name__ == "__main__":
    which, out = sys.argv[1], sys.argv[2]
    reads = {"megabase": megabase_reads, "repeat": repeat_reads,
             "largek": largek_reads, "realistic": realistic_reads}[which]()
    write_fasta(out, reads)
    from platanus3_tpu.utils.goldencache import write_fingerprint
    k, m_bits = PARAMS[which]
    write_fingerprint(os.path.dirname(os.path.abspath(out)), reads, k, m_bits)
