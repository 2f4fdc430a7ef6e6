"""BASELINE config 2: error-prone long reads -> solid-k-mer threshold sweep.

Simulates a PacBio/ONT-like read set (substitution + indel errors) over a
random genome, then sweeps the solidity threshold in ONE counting pass
(platanus3_tpu/sweep.py) and reports, per threshold: solid-set size,
precision/recall/F1 vs the genome's true canonical k-mer set, and full
assembly statistics (unitig count, N50, largest unitig).

The reference cannot run this experiment: its threshold is hardcoded
(``src/MakeBloomFilter.cpp:28``) and every re-run would re-count from
scratch.

Usage:
    python benchmarks/threshold_sweep.py [--genome-mb 1.0] [--coverage 20]
        [--sub 0.02] [--ins 0.005] [--del 0.005] [--k 25]
        [--thresholds 2,3,4,5,6,8] [--assemble] [--bloom]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=1.0)
    ap.add_argument("--coverage", type=float, default=20)
    ap.add_argument("--read-len", type=int, default=8000)
    ap.add_argument("--sub", type=float, default=0.02)
    ap.add_argument("--ins", type=float, default=0.005)
    ap.add_argument("--del", dest="dele", type=float, default=0.005)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--thresholds", type=str, default="2,3,4,5,6,8")
    ap.add_argument("--assemble", action="store_true",
                    help="run the full assembly per threshold")
    ap.add_argument("--bloom", action="store_true",
                    help="assemble with the Bloom membership pre-filter "
                         "instead of exact membership")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--realistic", action="store_true",
                    help="GC-skewed genome with homopolymers, tandem "
                         "tracts, and dispersed repeats "
                         "(sim.realistic_genome) instead of uniform-random")
    args = ap.parse_args()

    from platanus3_tpu import sim
    from platanus3_tpu.config import AssemblyConfig
    from platanus3_tpu.sweep import solid_threshold_sweep

    glen = int(args.genome_mb * 1e6)
    t0 = time.time()
    genome = (sim.realistic_genome(glen, seed=args.seed) if args.realistic
              else sim.random_genome(glen, seed=args.seed))
    reads = sim.simulate_reads(
        genome, coverage=args.coverage, read_len=args.read_len,
        seed=args.seed + 1, sub_rate=args.sub, ins_rate=args.ins,
        del_rate=args.dele)
    n_bases = sum(len(r) for r in reads)
    print(f"# genome {glen/1e6:.2f} Mb, {len(reads)} reads, "
          f"{n_bases/1e6:.1f} Mbases, err sub={args.sub} ins={args.ins} "
          f"del={args.dele} (gen {time.time()-t0:.1f}s)")

    cfg = AssemblyConfig(
        k=args.k, log_path=None, gfa_path="/tmp/sweep_out.gfa",
        use_exact_membership=not args.bloom)
    try:
        thresholds = [int(t) for t in args.thresholds.split(",")]
    except ValueError:
        ap.error(f"--thresholds must be comma-separated ints, "
                 f"got {args.thresholds!r}")

    t1 = time.time()
    rows = solid_threshold_sweep(reads, cfg, thresholds,
                                 truth_genome=genome,
                                 assemble_each=args.assemble)
    sweep_s = time.time() - t1

    hdr = ["t", "n_solid", "precision", "recall", "f1"]
    if args.assemble:
        hdr += ["straights", "junctions", "n50", "max_unitig"]
    print("# " + "\t".join(hdr))
    for r in rows:
        cells = [str(r["threshold"]), str(r["n_solid"]),
                 f"{r['precision']:.4f}", f"{r['recall']:.4f}",
                 f"{r['f1']:.4f}"]
        if args.assemble:
            cells += [str(r["straights"]), str(r["junctions"]),
                      str(r["n50"]), str(r["max_unitig"])]
        print("\t".join(cells))

    best = max(rows, key=lambda r: r["f1"])
    print(json.dumps({
        "config": "baseline-2-threshold-sweep",
        "genome": "realistic" if args.realistic else "uniform",
        "genome_mb": args.genome_mb, "coverage": args.coverage,
        "error_rates": [args.sub, args.ins, args.dele],
        "k": args.k, "membership": "bloom" if args.bloom else "exact",
        "sweep_wall_s": round(sweep_s, 2),
        "thresholds": thresholds,
        "best_threshold": best["threshold"],
        "best_f1": round(best["f1"], 4),
        "best_precision": round(best["precision"], 4),
        "best_recall": round(best["recall"], 4),
        **({"best_n50": best["n50"],
            "best_max_unitig": best["max_unitig"]} if args.assemble else {}),
    }))


if __name__ == "__main__":
    main()
