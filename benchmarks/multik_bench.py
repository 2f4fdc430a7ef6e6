"""BASELINE config 4: multi-k iterative assembly (k=32 -> 64 -> 128).

A genome with planted repeat elements longer than the small k but shorter
than the large k: at k=32 every repeat copy collapses into one junction
tangle that fragments the assembly; re-seeding the graph with the
previous round's unitigs at k=64 then k=128 (graph/multik.py) walks
straight through the repeats.  The reference supports neither multi-k
nor k=32/64/128 at all (template whitelist, ``src/Assemble.cpp:31-53``).

Usage: python benchmarks/multik_bench.py [--genome-mb 1.0] [--repeats 40]
       [--repeat-len 100] [--coverage 25] [--k-list 32,64,128]
       [--streaming [--slice-chunks 4096]]   # bounded-memory executor:
       multi-k at read volumes the single-shot pipeline cannot hold in
       HBM (VERDICT r4 item 4; e.g. --genome-mb 10 --coverage 12
       --streaming is a >=100 Mbase multi-k run)
"""

import argparse
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
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=1.0)
    ap.add_argument("--repeats", type=int, default=40)
    ap.add_argument("--repeat-len", type=int, default=100)
    ap.add_argument("--coverage", type=float, default=25)
    ap.add_argument("--read-len", type=int, default=4000)
    ap.add_argument("--sub", type=float, default=0.0)
    ap.add_argument("--k-list", type=str, default="32,64,128")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streaming", action="store_true",
                    help="run every round through assemble_streaming")
    ap.add_argument("--slice-chunks", type=int, default=4096)
    ap.add_argument("--skip-single", action="store_true",
                    help="skip the single-k baseline round (it may not "
                         "fit in HBM at streaming scales)")
    args = ap.parse_args()

    import dataclasses
    from platanus3_tpu import sim
    from platanus3_tpu.config import AssemblyConfig
    from platanus3_tpu.graph.multik import assemble_multik
    from platanus3_tpu.pipeline import assemble

    k_list = tuple(int(x) for x in args.k_list.split(","))
    glen = int(args.genome_mb * 1e6)
    genome = sim.plant_repeats(
        sim.random_genome(glen, seed=args.seed),
        args.repeat_len, args.repeats, seed=args.seed + 1)
    reads = sim.simulate_reads(genome, coverage=args.coverage,
                               read_len=args.read_len, seed=args.seed + 2,
                               sub_rate=args.sub)
    nbases = sum(len(r) for r in reads)
    print(f"# genome {glen/1e6:.1f} Mb with {args.repeats} x "
          f"{args.repeat_len} bp repeats, {len(reads)} reads, "
          f"{nbases/1e6:.1f} Mbases", flush=True)

    cfg = AssemblyConfig(k=k_list[0], log_path=None,
                         gfa_path="/tmp/multik_bench.gfa")

    if args.skip_single:
        s_single, t_single = {"n50": 0}, 0.0
    else:
        t0 = time.time()
        if args.streaming:
            from platanus3_tpu.streaming import assemble_streaming
            single = assemble_streaming(reads, cfg, write_output=False,
                                        slice_chunks=args.slice_chunks)
        else:
            single = assemble(reads, cfg, write_output=False)
        t_single = time.time() - t0
        s_single = stats(single)
        print(f"# single k={k_list[0]}: {s_single} ({t_single:.1f}s)",
              flush=True)

    t0 = time.time()
    multi = assemble_multik(
        reads, dataclasses.replace(cfg, k_list=k_list), write_output=True,
        streaming=args.streaming, slice_chunks=args.slice_chunks)
    t_multi = time.time() - t0
    s_multi = stats(multi)
    print(f"# multi-k {k_list}: {s_multi} ({t_multi:.1f}s)", flush=True)

    print(json.dumps({
        "config": "baseline-4-multik",
        "streaming": bool(args.streaming),
        "read_mbases": round(nbases / 1e6, 1),
        "genome_mb": args.genome_mb, "repeats": args.repeats,
        "repeat_len": args.repeat_len, "k_list": list(k_list),
        "single_k": s_single, "multi_k": s_multi,
        "single_wall_s": round(t_single, 1),
        "multi_wall_s": round(t_multi, 1),
        "n50_gain": round(s_multi["n50"] / max(1, s_single["n50"]), 2),
    }))


if __name__ == "__main__":
    main()
