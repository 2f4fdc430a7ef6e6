"""BASELINE config 3: assembly with tip clipping + bubble popping.

Simulates the two graph artifacts the simplification stages exist for:

  * TIPS: read errors create low-coverage dead-end spurs when an error
    k-mer sneaks past the solidity threshold;
  * BUBBLES: a diploid genome (two haplotypes differing by isolated SNPs)
    creates parallel paths between the same junction pair.

Reads are drawn from BOTH haplotypes with substitution errors, then the
assembly is run raw and with --clip-tips --pop-bubbles; the report shows
the graph collapsing toward one unitig per chromosome arm.

Usage: python benchmarks/simplify_bench.py [--genome-mb 2.0] [--snps 200]
       [--coverage 30] [--sub 0.003] [--k 25]
(12 Mb ~ S. cerevisiae scale: --genome-mb 12 --snps 1200.)
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def stats(res):
    from platanus3_tpu.sweep import n50
    lens = [len(s) for s in res.straight_seqs if s]
    return {
        "straights": res.num_straights,
        "junctions": res.num_junctions,
        "n50": n50(lens),
        "max_unitig": max(lens) if lens else 0,
        "total_unitig_bases": sum(lens),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=2.0)
    ap.add_argument("--snps", type=int, default=200)
    ap.add_argument("--coverage", type=float, default=30)
    ap.add_argument("--read-len", type=int, default=6000)
    ap.add_argument("--sub", type=float, default=0.003)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--cov-threshold", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from platanus3_tpu import sim
    from platanus3_tpu.config import AssemblyConfig
    from platanus3_tpu.pipeline import assemble

    glen = int(args.genome_mb * 1e6)
    hap1 = sim.random_genome(glen, seed=args.seed)
    hap2 = sim.mutate_genome(hap1, args.snps, seed=args.seed + 1,
                             min_gap=4 * args.k)
    reads = []
    for i, hap in enumerate((hap1, hap2)):
        reads += sim.simulate_reads(
            hap, coverage=args.coverage / 2, read_len=args.read_len,
            seed=args.seed + 2 + i, sub_rate=args.sub)
    nbases = sum(len(r) for r in reads)
    print(f"# diploid {glen/1e6:.1f} Mb x2, {args.snps} SNPs, "
          f"{len(reads)} reads, {nbases/1e6:.1f} Mbases, sub={args.sub}",
          flush=True)

    base_cfg = AssemblyConfig(
        k=args.k, cov_threshold=args.cov_threshold, log_path=None,
        gfa_path="/tmp/simplify_bench.gfa")

    t0 = time.time()
    raw = assemble(reads, base_cfg, write_output=False)
    t_raw = time.time() - t0
    raw_stats = stats(raw)
    print(f"# raw:        {raw_stats} ({t_raw:.1f}s)", flush=True)

    cfg = dataclasses.replace(base_cfg, clip_tips=True, pop_bubbles=True,
                              simplify_rounds=args.rounds)
    t0 = time.time()
    simp = assemble(reads, cfg, write_output=True)
    t_simp = time.time() - t0
    simp_stats = stats(simp)
    print(f"# simplified: {simp_stats} ({t_simp:.1f}s)", flush=True)

    print(json.dumps({
        "config": "baseline-3-simplify",
        "genome_mb": args.genome_mb, "snps": args.snps,
        "coverage": args.coverage, "sub_rate": args.sub, "k": args.k,
        "raw": raw_stats, "simplified": simp_stats,
        "raw_wall_s": round(t_raw, 1),
        "simplified_wall_s": round(t_simp, 1),
        "n50_gain": (round(simp_stats["n50"] / max(1, raw_stats["n50"]), 2)),
    }))


if __name__ == "__main__":
    main()
