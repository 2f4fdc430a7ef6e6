"""Bring-up check: the assembler's main path on one GPU, end to end.

    python chip_smoke.py [--seed 0] [--out DIR]
    python chip_smoke.py --four          # the sharded path on 4 GPUs

Runs the user entry point (``platanus3_tpu.cli``: single-shot, then
``--streaming``) in this process on the first GPU and checks every result
by the repository's own means:

  ecoli            an error-free random genome of E. coli K-12 MG1655's
                   length (4,641,652 bp, BASELINE.json config 1) cut into
                   10 kb reads every 333 bp (30x, ~139 Mbases), k=32,
                   assembled cold and warm.  Known answer: one Straight
                   segment spelling the genome between the two coverage-
                   thin ends (checked as a substring, either strand), two
                   Junction segments and two links.
  ecoli_streaming  the same FASTA through ``--streaming`` in at least four
                   slices; its GFA line multiset must equal ``ecoli``'s.
  cross            a repeat-rich 200 kb genome with 1% substitution reads
                   (30x, 2 kb), assembled on the GPU and on the CPU backend
                   of the same process: default, ``--clip-tips
                   --pop-bubbles``, ``--k-list 25,41`` and ``--streaming``.
                   The pipeline is integer-only, so the GFA line multisets
                   must be equal, with no tolerance.

``--four`` runs only the sharded path: the ``ecoli`` input meshless on
one GPU, then ``--streaming --mesh`` and ``--mesh`` over four GPUs; the
three GFA line multisets must be equal.

Exits non-zero, printing no result line, when JAX finds no GPU, when the
repository is not beside this file, or when any phase fails.  The last line
of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# E. coli K-12 MG1655 genome length (BASELINE.json config 1).
ECOLI_LEN = 4_641_652
ECOLI_READ_LEN = 10_000
ECOLI_STEP = 333
ECOLI_K = 32


def log(*a):
    print(*a, flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---- inputs ---------------------------------------------------------------

def tiled_reads(genome: str, read_len: int, step: int) -> list:
    """Error-free reads of ``read_len`` starting every ``step`` bases."""
    return [genome[s:s + read_len]
            for s in range(0, len(genome) - read_len + 1, step)]


def write_fasta(path: str, reads: list) -> None:
    with open(path, "w") as f:
        f.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))


def cross_input(seed: int, genome_len: int = 200_000):
    """Repeat-rich genome with error-prone reads (``__graft_entry__``'s
    multichip oracle genome, reads at 1% substitutions)."""
    from platanus3_tpu import sim
    g = sim.realistic_genome(genome_len, seed=seed + 1, gc=0.58)
    g = sim.plant_repeats(g, 80, 700, seed=seed + 2)
    g = sim.plant_repeats(g, 75, 500, seed=seed + 3, min_gap=120)
    return sim.simulate_reads(g, coverage=30, read_len=2000, seed=seed + 4,
                              sub_rate=0.01)


def num_chunks(reads: list, k: int, chunk_len: int = 1024) -> int:
    """Chunk count of the read batch (io/reads.py layout)."""
    stride = chunk_len - k + 1
    return sum((len(r) - k) // stride + 1 for r in reads if len(r) >= k)


# ---- checks ---------------------------------------------------------------

def expected_straight_len(genome_len: int, read_len: int, step: int) -> int:
    """Length of the one unitig of a repeat-free genome cut into tiled
    reads.  With reads starting every ``step`` bases up to ``last``, a
    k-mer at position p has every short k-mer seen at least twice (the
    solidity threshold) iff ``step <= p <= last - step + read_len - k``;
    the first and last of those k-mers are the two junctions, and the
    straight spells the ones between: ``last + read_len - 2*step - 2``
    bases (checked on the CPU at 60 kb: 59,282 bp).  Independent of k."""
    last = (genome_len - read_len) // step * step
    return last + read_len - 2 * step - 2


def check_known_answer(lines: list, genome: str, read_len: int,
                       step: int) -> int:
    """One Straight spelling the genome (either strand) over all but the
    coverage-thin ends, two Junctions, two links.  Returns the straight's
    length."""
    from platanus3_tpu.sim import revcomp
    straights = [ln.split("\t") for ln in lines
                 if ln.startswith("S\tStraight")]
    n_jun = sum(1 for ln in lines if ln.startswith("S\tJunction"))
    n_link = sum(1 for ln in lines if ln.startswith("L\t"))
    assert (len(straights), n_jun, n_link) == (1, 2, 2), (
        f"expected 1 straight, 2 junctions, 2 links; got "
        f"{len(straights)}, {n_jun}, {n_link}")
    seq = straights[0][2]
    want = expected_straight_len(len(genome), read_len, step)
    assert len(seq) == want, f"straight of {len(seq)} bp, expected {want}"
    assert seq in genome or revcomp(seq) in genome, (
        "straight is not a substring of the genome on either strand")
    return len(seq)


def digest(lines: list) -> str:
    """Order-free digest of a GFA line multiset (comparable across runs
    and machines)."""
    import hashlib
    return hashlib.sha256("\n".join(sorted(lines)).encode()).hexdigest()[:16]


def check_same_lines(name: str, got: list, want: list) -> None:
    if sorted(got) == sorted(want):
        return
    a, b = set(got), set(want)
    raise AssertionError(
        f"{name}: GFA line multisets differ ({len(got)} vs {len(want)} "
        f"lines; {len(a - b)} only here, {len(b - a)} only in the "
        f"reference; e.g. {sorted(a - b)[:2]} / {sorted(b - a)[:2]})")


def on_device(res, device) -> bool:
    """Whether the result's graph arrays sit on ``device``."""
    import jax
    leaves = jax.tree.leaves((res.dbg, res.cov))
    return all(leaf.devices() == {device} for leaf in leaves)


# ---- runs -----------------------------------------------------------------

def run_cli(argv: list, device=None):
    """``cli.run`` on ``device`` (JAX's default placement when None);
    returns (result, wall seconds, GFA lines as written)."""
    import jax
    from platanus3_tpu import cli
    t0 = time.perf_counter()
    if device is None:
        res = cli.run(argv)
    else:
        with jax.default_device(device):
            res = cli.run(argv)
    jax.block_until_ready(jax.tree.leaves((res.dbg, res.cov)))
    wall = time.perf_counter() - t0
    out = argv[argv.index("-o") + 1]
    with open(out) as f:
        lines = f.read().splitlines()
    assert sorted(lines) == sorted(res.gfa_lines), "written GFA differs"
    return res, wall, lines


def memory(device) -> str:
    st = device.memory_stats() or {}
    return (f"peak_bytes_in_use={st.get('peak_bytes_in_use', 'n/a')} "
            f"bytes_limit={st.get('bytes_limit', 'n/a')}")


def phase_ecoli(devices, out, seed, card, genome_len=ECOLI_LEN,
                read_len=ECOLI_READ_LEN, step=ECOLI_STEP, k=ECOLI_K,
                repeats=2):
    """Single-shot assembly of the tiled genome, cold then warm, on
    ``devices[0]``.  Returns (fasta path, GFA lines, genome, reads)."""
    from platanus3_tpu import sim
    dev = devices[0]
    genome = sim.random_genome(genome_len, seed=seed)
    reads = tiled_reads(genome, read_len, step)
    fasta = os.path.join(out, "ecoli.fasta")
    write_fasta(fasta, reads)
    bases = sum(len(r) for r in reads)
    log(f"[ecoli] genome {genome_len} bp, {len(reads)} reads x {read_len} "
        f"bp every {step} bp = {bases} bases, k={k}")
    lines = None
    for i in range(repeats):
        gfa = os.path.join(out, f"ecoli_{i}.gfa")
        res, wall, got = run_cli(
            ["-i", fasta, "-k", str(k), "-o", gfa,
             "--log", os.path.join(out, "ecoli.log"), "--profile-stages"],
            dev)
        tag = "cold" if i == 0 else "warm"
        log(f"[ecoli] {tag}: wall {wall:.3f} s, "
            f"{bases / wall / 1e6:.3f} Mbases/s, "
            f"{res.num_nodes} nodes ({card})")
        log(f"[ecoli] {tag} stages (s): " + ", ".join(
            f"{n}={t:.3f}" for n, t in res.stats["stages"].items()))
        if lines is not None:
            check_same_lines("ecoli warm vs cold", got, lines)
        lines = got
    slen = check_known_answer(lines, genome, read_len, step)
    log(f"[ecoli] known answer ok: 1 straight of {slen} bp "
        f"(genome {genome_len}), 2 junctions, 2 links; GFA digest "
        f"{digest(lines)}")
    log(f"[ecoli] device memory: {memory(dev)}")
    return fasta, lines, genome, reads


def phase_ecoli_streaming(devices, out, fasta, reads, want, card,
                          k=ECOLI_K, min_slices=4):
    dev = devices[0]
    chunks = num_chunks(reads, k)
    slice_chunks = max(1, -(-chunks // (min_slices + 2)))
    n_slices = -(-chunks // slice_chunks)
    assert n_slices >= min_slices, (chunks, slice_chunks)
    gfa = os.path.join(out, "ecoli_streaming.gfa")
    res, wall, got = run_cli(
        ["-i", fasta, "-k", str(k), "-o", gfa, "--streaming",
         "--slice-chunks", str(slice_chunks),
         "--log", os.path.join(out, "ecoli_streaming.log"),
         "--profile-stages"], dev)
    bases = sum(len(r) for r in reads)
    log(f"[ecoli_streaming] {n_slices} slices of {slice_chunks} chunks: "
        f"wall {wall:.3f} s, {bases / wall / 1e6:.3f} Mbases/s ({card})")
    log("[ecoli_streaming] stages (s): " + ", ".join(
        f"{n}={t:.3f}" for n, t in res.stats["stages"].items()))
    check_same_lines("ecoli_streaming vs ecoli", got, want)
    log(f"[ecoli_streaming] GFA equal to ecoli ({len(got)} lines); "
        f"device memory: {memory(dev)}")


CROSS_RUNS = (
    ("default", []),
    ("simplify", ["--clip-tips", "--pop-bubbles"]),
    ("multik", ["--k-list", "25,41"]),
    ("streaming", ["--streaming", "--slice-chunks", "64"]),
)


def phase_cross(device, ref_device, out, seed, card, genome_len=200_000,
                runs=CROSS_RUNS):
    """Every run of ``runs`` on ``device`` and on ``ref_device`` in this
    process; GFA line multisets must be equal."""
    reads = cross_input(seed, genome_len)
    fasta = os.path.join(out, "cross.fasta")
    write_fasta(fasta, reads)
    log(f"[cross] {len(reads)} reads, {sum(map(len, reads))} bases; "
        f"{device.platform} vs {ref_device.platform}")
    for name, extra in runs:
        got = {}
        for dev in (device, ref_device):
            tag = f"{name}_{dev.platform}{dev.id}"
            res, wall, lines = run_cli(
                ["-i", fasta, "-k", "25", "-o",
                 os.path.join(out, f"cross_{tag}.gfa"),
                 "--log", os.path.join(out, "cross.log"), *extra], dev)
            assert on_device(res, dev), f"{tag}: outputs not on {dev}"
            got[dev] = lines
            log(f"[cross] {name} on {dev}: wall {wall:.3f} s, "
                f"{res.num_straights} straights, {res.num_junctions} "
                f"junctions" + (f" ({card})" if dev.platform == "gpu"
                                else ""))
        check_same_lines(f"cross {name}", got[device], got[ref_device])
        log(f"[cross] {name}: {len(got[device])} GFA lines equal")


def phase_four(devices, out, seed, card, genome_len=ECOLI_LEN,
               read_len=ECOLI_READ_LEN, step=ECOLI_STEP, k=ECOLI_K):
    """Meshless on one device, then ``--streaming --mesh`` and ``--mesh``
    over all of ``devices``; the three GFA line multisets must be equal.

    The streaming mesh path accumulates into fixed-capacity sharded
    tables; its default capacities follow the slice size (2^22 nodes at
    the default slice), below this genome's 4.6M nodes, so the run
    declares capacities for the genome as a user would
    (``--short-cap-log2`` / ``--node-cap-log2``: at least twice the
    genome length, the most distinct canonical k-mers an error-free
    genome has)."""
    import jax
    from platanus3_tpu import sim
    genome = sim.random_genome(genome_len, seed=seed)
    reads = tiled_reads(genome, read_len, step)
    fasta = os.path.join(out, "ecoli.fasta")
    write_fasta(fasta, reads)
    base = ["-i", fasta, "-k", str(k),
            "--log", os.path.join(out, "four.log")]
    cap_log2 = str((2 * genome_len - 1).bit_length())
    want = None
    for name, extra in (("meshless", []),
                        ("streaming_mesh", ["--streaming", "--mesh",
                                            "--short-cap-log2", cap_log2,
                                            "--node-cap-log2", cap_log2]),
                        ("mesh", ["--mesh"])):
        gfa = os.path.join(out, f"four_{name}.gfa")
        res, wall, lines = run_cli(base + ["-o", gfa] + extra,
                                   devices[0] if want is None else None)
        log(f"[four] {name}: wall {wall:.3f} s, {res.num_nodes} nodes, "
            f"GFA digest {digest(lines)} ({card})")
        for d in devices:
            log(f"[four]   {d}: {memory(d)}")
        if want is None:
            check_known_answer(lines, genome, read_len, step)
            want = lines
        else:
            check_same_lines(f"four {name} vs meshless", lines, want)
            log(f"[four] {name} == meshless ({len(lines)} GFA lines)")
    log(f"[four] meshless == streaming_mesh == mesh on {len(devices)} "
        f"{jax.devices()[0].device_kind}")


# ---- driver ---------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(HERE, ".smoke"),
                    help="directory for the generated FASTA and GFA files")
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "platanus3_tpu")):
        log(f"chip_smoke: the platanus3_tpu package is not beside "
            f"{__file__}")
        return 2
    sys.path.insert(0, HERE)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        log(f"chip_smoke: needs a GPU; JAX found "
            f"{devices[0].platform} ({devices[0].device_kind})")
        return 2
    want = 4 if args.four else 1
    if args.four and len(devices) < 4:
        log(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}")
        return 2
    devices = devices[:want]
    from platanus3_tpu import native
    from platanus3_tpu.utils import compile_cache
    card = gpu_info()
    log(f"device_kind: {devices[0].device_kind}, count: {len(devices)}")
    log(f"nvidia-smi name, power.limit: {card}")
    log(f"jax {jax.__version__}, compile cache: "
        f"{compile_cache.configure()}")
    log("FASTA loader: " + (f"native, {native.lib_path()}"
                            if native.get_lib() is not None
                            else "numpy (native build failed)"))
    card = card.splitlines()[0]
    os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    if args.four:
        phase_four(devices, args.out, args.seed, card)
    else:
        fasta, lines, _, reads = phase_ecoli(devices, args.out, args.seed,
                                             card)
        phase_ecoli_streaming(devices, args.out, fasta, reads, lines, card)
        phase_cross(devices[0], jax.devices("cpu")[0], args.out, args.seed,
                    card)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s ({card})")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
