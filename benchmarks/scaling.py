"""Counting scaling-efficiency harness (BASELINE scaling gate).

Measures sharded stage-1 throughput at 1, 2, 4, ... devices over whatever
mesh is available and reports weak-scaling efficiency of the k-mer
counting path (extract -> all-to-all shuffle -> sort-count -> solidity).

On a real pod slice, run one process per host (parallel/multihost.py)
and this script measures the true >80%-efficiency gate.  On the CI
container it runs on virtual CPU devices, which validates the MECHANICS
(the collective program compiles and the work partitions) but not
hardware speedup -- virtual devices share the same cores.  It prints one
JSON line per device count.

Usage:  python benchmarks/scaling.py [--bases 10000000]
"""

import argparse
import json
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bases", type=int, default=4_000_000)
    ap.add_argument("--cpu", action="store_true",
                    help="force 8 virtual CPU devices")
    ap.add_argument("--multiproc", action="store_true",
                    help="also run a 2-process jax.distributed datapoint")
    args = ap.parse_args()

    import os
    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from platanus3_tpu.io import reads as reads_mod
    from platanus3_tpu.ops import bloom as bloom_mod
    from platanus3_tpu.parallel import sharded

    k, short_k, chunk_len = 25, 21, 1024
    rng = np.random.default_rng(0)
    glen = max(100_000, args.bases // 20)
    genome = "".join(rng.choice(list("ACGT"), size=glen))
    reads = []
    total = 0
    while total < args.bases:
        s = int(rng.integers(0, glen - 2000))
        reads.append(genome[s : s + 2000])
        total += 2000
    batch = reads_mod.reads_from_strings(reads, k, chunk_len)
    bf = bloom_mod.make_bloom(8, 1)

    devs = jax.devices()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    base_rate = None
    for n in counts:
        mesh = sharded.make_mesh(devs[:n])
        arrays = sharded.pad_batch_to_devices(
            (batch.packed, batch.valid_len, batch.read_id, batch.start,
             batch.read_len), n)

        def run(ablate=False):
            t0 = time.time()
            table, _, seed, has, ovf = sharded.sharded_stage1(
                mesh, *arrays, bf, k=k, short_k=short_k, cov_threshold=2,
                num_reads=batch.num_reads, add_to_bloom=False,
                ablate_collectives=ablate)
            _ = int(table.size) + int(ovf)  # completion barrier
            return time.time() - t0

        run()                      # compile
        dt = min(run() for _ in range(2))
        # Collective share (VERDICT r3 item 8): re-run with every
        # collective identity-routed (same per-device compute, zero
        # communication) and difference the walls.  A statement about the
        # PROGRAM's communication fraction that stands in for the
        # unmeasurable pod-hardware gate; results of the ablated run are
        # discarded (they are numerically wrong by construction).
        coll_pct = None
        if n > 1:
            run(ablate=True)       # compile
            dt_abl = min(run(ablate=True) for _ in range(2))
            coll_pct = max(0.0, round(100 * (dt - dt_abl) / dt, 1))
        rate = batch.all_bases / dt
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "devices": n,
            "bases_per_s": round(rate),
            "seconds": round(dt, 3),
            "efficiency_vs_1dev": round(rate / (base_rate * n), 3),
            "collective_pct": coll_pct,
        }), flush=True)

    if args.multiproc:
        print(json.dumps(run_two_process_datapoint()), flush=True)


def run_two_process_datapoint():
    """2-PROCESS datapoint: the same sharded stage 1 with the mesh split
    across two ``jax.distributed`` CPU processes (4 devices each) --
    validates that the collective program crosses process boundaries
    (tools/multihost_worker.py); wall-clock includes both workers'
    startup, so it is a mechanics datapoint, not a speedup claim."""
    import socket
    import subprocess
    import sys as _sys
    import tempfile

    from platanus3_tpu import sim

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tools", "multihost_worker.py")
    s = socket.socket(); s.bind(("localhost", 0))
    port = s.getsockname()[1]; s.close()

    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "reads.fasta")
        genome = sim.random_genome(5000, seed=71)
        rs = sim.simulate_reads(genome, coverage=20, read_len=500, seed=72)
        with open(fasta, "w") as f:
            for i, r in enumerate(rs):
                f.write(f">r{i}\n{r}\n")
        env = dict(os.environ)
        env.update(JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        t0 = time.time()
        procs = [subprocess.Popen(
            [_sys.executable, worker, "--pid", str(p), "--nprocs", "2",
             "--port", str(port), "--fasta", fasta,
             "--out", os.path.join(td, f"o{p}.npz")], env=env, cwd=repo)
            for p in range(2)]
        rcs = [p.wait(timeout=900) for p in procs]
        dt = time.time() - t0
        size = int(np.load(os.path.join(td, "o0.npz"))["size"])
        return {"processes": 2, "devices": 8, "ok": rcs == [0, 0],
                "nodes": size, "wall_s": round(dt, 2)}


if __name__ == "__main__":
    main()
