"""Real multi-PROCESS execution of the sharded stage 1 (VERDICT r1 #3).

Launches 2 ``jax.distributed`` CPU processes on localhost (4 forced host
devices each -> one 8-device global mesh spanning both processes), runs
``tools/multihost_worker.py`` in each, and asserts the replicated results
are identical across processes AND equal to a single-process run of the
same sharded stage 1 on this test's own 8-device mesh.  The all-to-all
k-mer routing and allreduce-OR Bloom merge therefore demonstrably cross
process boundaries -- ``parallel/multihost.py`` is no longer untested.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _make_fasta(path):
    from platanus3_tpu import sim
    genome = sim.random_genome(1200, seed=61)
    reads = sim.simulate_reads(genome, coverage=20, read_len=200, seed=62)
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    return reads


def _run_two_procs(tmp_path, fasta, extra_args=()):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"       # the workers run on the CPU backend
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_NUM_CPU_DEVICES", None)

    procs = []
    for pid in range(2):
        out = str(tmp_path / f"out{pid}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, WORKER, "--pid", str(pid), "--nprocs", "2",
             "--port", str(port), "--fasta", fasta, "--out", out,
             *extra_args],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    results = []
    for out, p in procs:
        stdout, _ = p.communicate(timeout=600)
        assert p.returncode == 0, stdout.decode()[-4000:]
        results.append(dict(np.load(out)))
    return results


def test_two_process_full_pipeline(tmp_path):
    """FULL pipeline (graph -> coverage -> GFA emission) under 2
    ``jax.distributed`` processes (VERDICT r2 item 8): GFA equality with
    a meshless single-process run, and ``gather_to_host0`` exercised
    (the worker all-gathers per-process GFA digests through it)."""
    fasta = str(tmp_path / "reads.fasta")
    reads = _make_fasta(fasta)
    r0, r1 = _run_two_procs(tmp_path, fasta, extra_args=("--full",))

    assert int(r0["nprocs"]) == 2 and int(r0["ndevices"]) == 8
    np.testing.assert_array_equal(r0["gfa"], r1["gfa"])
    np.testing.assert_array_equal(r0["digest"], r1["digest"])
    # gather_to_host0 carried both processes' digests
    assert r0["all_digests"].size == 2 * 32

    # equality with a meshless single-process assembly of the same reads
    from platanus3_tpu.config import AssemblyConfig
    from platanus3_tpu.pipeline import assemble
    cfg = AssemblyConfig(k=25, chunk_len=512, log_path=None)
    base = assemble(reads, cfg, write_output=False)
    got = bytes(r0["gfa"]).decode().split("\n")
    assert sorted(got) == sorted(base.gfa_lines)
    assert int(r0["num_straights"]) == base.num_straights
    assert int(r0["num_junctions"]) == base.num_junctions


def test_two_process_sharded_stage1(tmp_path):
    fasta = str(tmp_path / "reads.fasta")
    reads = _make_fasta(fasta)
    port = _free_port()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"       # the workers run on the CPU backend
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_NUM_CPU_DEVICES", None)

    procs = []
    for pid in range(2):
        out = str(tmp_path / f"out{pid}.npz")
        procs.append((out, subprocess.Popen(
            [sys.executable, WORKER, "--pid", str(pid), "--nprocs", "2",
             "--port", str(port), "--fasta", fasta, "--out", out],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    results = []
    for out, p in procs:
        stdout, _ = p.communicate(timeout=600)
        assert p.returncode == 0, stdout.decode()[-4000:]
        results.append(dict(np.load(out)))

    r0, r1 = results
    assert int(r0["nprocs"]) == 2 and int(r0["ndevices"]) == 8
    assert int(r0["ovf"]) == 0
    # Replicated outputs identical across the two processes.
    for key in ("keys", "counts", "size", "bloom_bits", "seed_fw",
                "has_seed"):
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)

    # Equal to a single-process sharded run on this test's own 8 CPU
    # devices (conftest forces 8): process boundaries must not change
    # results.
    from platanus3_tpu.io import reads as reads_mod
    from platanus3_tpu.ops import bloom as bloom_mod
    from platanus3_tpu.parallel import sharded

    batch = reads_mod.reads_from_strings(reads, 25, 512)
    mesh = sharded.make_mesh(jax.devices()[:8])
    arrays = sharded.pad_batch_to_devices(
        (batch.packed, batch.valid_len, batch.read_id, batch.start,
         batch.read_len), 8)
    bf = bloom_mod.make_bloom(1 << 16, 4)
    table, bf2, seed_fw, has_seed, ovf = sharded.sharded_stage1(
        mesh, *arrays, bf, k=25, short_k=21, cov_threshold=2,
        num_reads=batch.num_reads, add_to_bloom=True)
    size = int(table.size)
    assert size == int(r0["size"])
    np.testing.assert_array_equal(np.asarray(table.keys)[:size], r0["keys"])
    np.testing.assert_array_equal(np.asarray(table.counts)[:size],
                                  r0["counts"])
    np.testing.assert_array_equal(np.asarray(bf2.bits), r0["bloom_bits"])
    np.testing.assert_array_equal(np.asarray(seed_fw), r0["seed_fw"])
    np.testing.assert_array_equal(np.asarray(has_seed), r0["has_seed"])
