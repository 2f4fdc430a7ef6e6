"""Repeat-rich megabase golden parity + at-scale graph-stage evidence.

VERDICT r2 item 2: every earlier perf golden assembled a repeat-free
random genome whose graph is ONE unitig -- the easiest case.  Here the
genome is deliberately nasty: thousands of copies of shared repeat
elements plus a mixed-in SNP haplotype, so the de Bruijn graph has
thousands of unitigs and junction tangles, and the DEEP golden contract
(S multiset, junction (kmer, KC) multiset, canonicalized L multiset --
reference ``src/DeBruijnGraph.cpp:451-544``) is checked at that scale.

Also records per-stage wall-clock and peak device memory (device
``memory_stats``) for the graph stage at-scale evidence.

Usage:  python benchmarks/repeat_golden.py [--glen 2000000] [--no-ref]
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def p(*a):
    print(*a, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--glen", type=int, default=2_000_000)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--no-ref", action="store_true",
                    help="skip the reference-binary comparison run")
    ap.add_argument("--ref-dir", default="/tmp/p3bench/repeatref",
                    help="reference run directory; when it already holds a "
                         "de_bruijn_graph.gfa (e.g. pre-run in the "
                         "background via tools/gen_golden_inputs.py), the "
                         "binary is not re-run")
    ap.add_argument("--repeat-len", type=int, default=200)
    ap.add_argument("--n-copies", type=int, default=1500)
    ap.add_argument("--n-snps", type=int, default=400)
    ap.add_argument("--realistic", action="store_true",
                    help="base genome via sim.realistic_genome (GC skew + "
                         "homopolymers + tandem tracts) instead of "
                         "uniform-random; pair with --ref-dir "
                         "/tmp/p3bench/realref (tools/gen_golden_inputs.py "
                         "'realistic')")
    args = ap.parse_args()

    import jax
    from platanus3_tpu import sim
    from platanus3_tpu.config import AssemblyConfig
    from platanus3_tpu.pipeline import assemble
    from platanus3_tpu.utils.logging import PipelineLog
    p("backend:", jax.default_backend())

    # ---- genome: planted repeats + SNP haplotype ----
    t0 = time.time()
    base = (sim.realistic_genome(args.glen, seed=1234) if args.realistic
            else sim.random_genome(args.glen, seed=1234))
    base = sim.plant_repeats(base, args.repeat_len, args.n_copies, seed=7)
    # second repeat family at a different length for junction diversity
    base = sim.plant_repeats(base, 3 * args.k, args.n_copies // 2, seed=8,
                             min_gap=5 * args.repeat_len)
    hap2 = sim.mutate_genome(base, args.n_snps, seed=9, min_gap=1000)

    def tiled(genome, read_len, step):
        return [genome[s:s + read_len]
                for s in range(0, len(genome) - read_len + 1, step)]

    reads = tiled(base, 3000, 400) + tiled(hap2, 3000, 600)
    nbases = sum(len(r) for r in reads)
    p(f"genome {args.glen} (x2 haplotypes), {len(reads)} reads, "
      f"{nbases/1e6:.1f} Mbases  [gen {time.time()-t0:.1f}s]")

    m_bits = 1 << 30
    cfg = AssemblyConfig(k=args.k, filter_bits=m_bits, chunk_len=4096,
                         log_path=None, profile_stages=True)

    log = PipelineLog(None, echo=False)
    t0 = time.time()
    res = assemble(reads, cfg, write_output=False, log=log)
    t_cold = time.time() - t0
    t0 = time.time()
    res = assemble(reads, cfg, write_output=False, log=PipelineLog(None))
    t_warm = time.time() - t0
    p(f"OURS cold {t_cold:.1f}s / warm {t_warm:.1f}s  "
      f"({nbases/t_warm/1e6:.2f} Mbases/s warm)")
    p(f"graph: {res.num_nodes} nodes, {res.num_straights} straights, "
      f"{res.num_junctions} junctions")
    for name, dt in res.stats.get("stages", {}).items():
        p(f"  stage {name}: {dt:.2f}s")
    stats = jax.local_devices()[0].memory_stats() or {}
    if stats:
        p(f"  device memory: peak {stats.get('peak_bytes_in_use', 0)/2**30:.2f}"
          f" GiB, in-use {stats.get('bytes_in_use', 0)/2**30:.2f} GiB, "
          f"limit {stats.get('bytes_limit', 0)/2**30:.2f} GiB")

    if args.no_ref:
        return

    # ---- reference run + deep comparison ----
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from tests.test_golden_deep import parse_gfa_deep
    from tests.test_golden import _ensure_ref, REF_BIN

    from platanus3_tpu.utils.goldencache import (cached_ref_gfa,
                                                 write_fingerprint)
    refdir = args.ref_dir
    ref_gfa = os.path.join(refdir, "de_bruijn_graph.gfa")
    if cached_ref_gfa(refdir, reads, args.k, m_bits):
        # Pre-run reference (tools/gen_golden_inputs.py wrote the identical
        # read set + fingerprint; the binary ran in the background).  A
        # cached GFA whose golden.fp mismatches these reads/k/m is never
        # trusted (ADVICE r3).  Wall from run.log.
        t_ref = None
        runlog = os.path.join(refdir, "run.log")
        if os.path.exists(runlog):
            for ln in open(runlog):
                if "WALL=" in ln:
                    t_ref = float(ln.split("WALL=")[1].rstrip("s\n"))
    else:
        assert _ensure_ref(), "reference binary unavailable"
        os.makedirs(refdir, exist_ok=True)
        fasta = os.path.join(refdir, "reads.fasta")
        with open(fasta, "w") as f:
            for i, s in enumerate(reads):
                f.write(f">r{i}\n{s}\n")
        t0 = time.time()
        subprocess.run(
            [REF_BIN, "-i", fasta, "-k", str(args.k), "-m", str(m_bits),
             "-t", "4"],
            cwd=refdir, check=True, capture_output=True, timeout=14400)
        t_ref = time.time() - t0
        write_fingerprint(refdir, reads, args.k, m_bits)
    if t_ref is not None:
        p(f"reference: {t_ref:.1f}s  (speedup cold {t_ref/t_cold:.1f}x / "
          f"warm {t_ref/t_warm:.1f}x)")

    with open(ref_gfa) as f:
        ref = parse_gfa_deep(f.readlines())
    ours = parse_gfa_deep(res.gfa_lines)
    n_uni = sum(ref[0].values())
    p(f"reference graph: {n_uni} straights, {sum(ref[1].values())} "
      f"junctions, {sum(ref[2].values())} links")
    eq_s = ours[0] == ref[0]
    eq_j = ours[1] == ref[1]
    eq_l = ours[2] == ref[2]
    p(f"straight multiset equal: {eq_s}")
    p(f"junction (kmer, KC) multiset equal: {eq_j}")
    p(f"canonicalized L multiset equal: {eq_l}")
    assert n_uni >= 1000, f"graph not repeat-rich enough ({n_uni} unitigs)"
    assert eq_s and eq_j and eq_l, "DEEP GOLDEN MISMATCH"
    p("DEEP GOLDEN OK at >= 1000 unitigs")


if __name__ == "__main__":
    main()
