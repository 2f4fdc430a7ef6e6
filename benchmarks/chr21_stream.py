"""BASELINE config 5 (single-chip leg): human-chr21-scale streaming run.

Assembles a simulated chromosome-21-sized read set (46.7 Mb genome,
long reads) through the bounded-memory streaming pipeline on ONE chip --
the read volume exceeds what the single-shot pipeline can hold in HBM.
The multi-host leg of config 5 (hash-prefix-sharded count table,
all-to-all shuffle, >80% efficiency gate) is measured by
benchmarks/scaling.py and parallel/multihost.py; this script produces the
wall-clock + throughput headline for the largest single-device problem.

Reference comparison: the reference binary counts+assembles at ~92 kbases/s
on 2 CPU cores (BASELINE.md), i.e. a 560 Mbase read set would take ~1.7 h;
it also holds every read and k-mer count in RAM simultaneously.

Usage: python benchmarks/chr21_stream.py [--genome-mb 46.7] [--coverage 12]
       [--sub 0.002] [--slice-chunks 4096] [--short-cap-log2 27]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=46.7)
    ap.add_argument("--coverage", type=float, default=12)
    ap.add_argument("--read-len", type=int, default=8000)
    ap.add_argument("--sub", type=float, default=0.002)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--cov-threshold", type=int, default=3)
    ap.add_argument("--chunk-len", type=int, default=4096)
    ap.add_argument("--slice-chunks", type=int, default=4096)
    ap.add_argument("--short-cap-log2", type=int, default=27)
    ap.add_argument("--node-cap-log2", type=int, default=27)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--realistic", action="store_true",
                    help="chr21-like composition instead of uniform "
                         "random: GC skew, homopolymer + tandem tracts, "
                         "plus TWO dispersed repeat families (the 200 kb "
                         "dryrun recipe scaled to genome size; ~45%% of "
                         "the genome becomes repeat sequence, like a "
                         "real chr21)")
    ap.add_argument("--clip-tips", action="store_true")
    ap.add_argument("--pop-bubbles", action="store_true")
    ap.add_argument("--checkpoint-dir", type=str, default="")
    ap.add_argument("--mesh", action="store_true",
                    help="shard each slice + the count/node tables over "
                         "all visible devices (config 5's multi-device "
                         "leg: streaming x hash-prefix sharding)")
    args = ap.parse_args()

    import jax
    from platanus3_tpu import sim
    from platanus3_tpu.config import AssemblyConfig
    from platanus3_tpu.streaming import assemble_streaming
    from platanus3_tpu.sweep import n50
    from platanus3_tpu.utils.logging import PipelineLog

    glen = int(args.genome_mb * 1e6)
    t0 = time.time()
    if args.realistic:
        # __graft_entry__.dryrun recipe scaled: realistic composition +
        # two dispersed repeat families at the dryrun's per-base density
        # (700 x 80 bp + 500 x 75 bp per 200 kb).
        genome = sim.realistic_genome(glen, seed=args.seed + 1, gc=0.58)
        genome = sim.plant_repeats(genome, 80, int(700 * glen / 200_000),
                                   seed=args.seed + 2)
        genome = sim.plant_repeats(genome, 75, int(500 * glen / 200_000),
                                   seed=args.seed + 3, min_gap=120)
    else:
        genome = sim.random_genome(glen, seed=args.seed)
    reads = sim.simulate_reads(genome, coverage=args.coverage,
                               read_len=args.read_len, seed=args.seed + 1,
                               sub_rate=args.sub)
    nbases = sum(len(r) for r in reads)
    t_gen = time.time() - t0
    print(f"# backend={jax.default_backend()} genome {glen/1e6:.1f} Mb, "
          f"{len(reads)} reads, {nbases/1e6:.0f} Mbases at "
          f"{args.coverage}x, sub={args.sub} (gen {t_gen:.0f}s)", flush=True)

    cfg = AssemblyConfig(k=args.k, cov_threshold=args.cov_threshold,
                         chunk_len=args.chunk_len, log_path=None,
                         clip_tips=args.clip_tips,
                         pop_bubbles=args.pop_bubbles,
                         checkpoint_dir=args.checkpoint_dir,
                         profile_stages=True,
                         gfa_path="/tmp/chr21_stream.gfa")
    mesh = None
    if args.mesh:
        from platanus3_tpu.parallel import sharded
        mesh = sharded.make_mesh(jax.devices())
        print(f"# mesh: {mesh.devices.size} devices", flush=True)

    log = PipelineLog(None, echo=True)
    t0 = time.time()
    res = assemble_streaming(
        reads, cfg, log=log, write_output=True,
        short_cap=1 << args.short_cap_log2,
        node_cap=1 << args.node_cap_log2,
        slice_chunks=args.slice_chunks, mesh=mesh)
    wall = time.time() - t0

    lens = [len(s) for s in res.straight_seqs if s]
    mem = jax.local_devices()[0].memory_stats() or {}
    out = {
        "realistic": bool(args.realistic),
        "clip_tips": bool(args.clip_tips),
        "pop_bubbles": bool(args.pop_bubbles),
        "stages_s": {kk: round(v, 1)
                     for kk, v in res.stats.get("stages", {}).items()},
        "peak_hbm_gib": round(mem.get("peak_bytes_in_use", 0) / 2**30, 2),
        "hbm_limit_gib": round(mem.get("bytes_limit", 0) / 2**30, 2),
        "config": "baseline-5-chr21-stream",
        "genome_mb": args.genome_mb, "coverage": args.coverage,
        "read_mbases": round(nbases / 1e6, 1), "sub_rate": args.sub,
        "k": args.k, "wall_s": round(wall, 1),
        "mbases_per_s": round(nbases / wall / 1e6, 3),
        "straights": res.num_straights, "junctions": res.num_junctions,
        "n50": n50(lens), "max_unitig": max(lens) if lens else 0,
        "solid_nodes": res.num_nodes,
        "ref_2core_est_s": round(nbases / 92_000),
        "speedup_vs_ref_est": round((nbases / 92_000) / wall, 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
