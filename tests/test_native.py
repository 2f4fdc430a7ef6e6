"""Native C++ loader vs numpy loader: identical ReadBatch contract."""

import os
import time

import numpy as np
import pytest

from platanus3_tpu import native
from platanus3_tpu.constants import BASES
from platanus3_tpu.io import reads as reads_mod

RNG = np.random.default_rng(61)

needs_native = pytest.mark.skipif(native.get_lib() is None,
                                  reason="no C++ toolchain")


def write_fasta(path, seqs, wrap=0):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">read{i} extra header stuff\n")
            if wrap:
                for j in range(0, len(s), wrap):
                    f.write(s[j : j + wrap] + "\n")
            else:
                f.write(s + "\n")


def write_fastq(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@read{i}\n{s}\n+\n{'I' * len(s)}\n")


def random_seqs(n, lo, hi):
    return ["".join(RNG.choice(list(BASES), size=int(RNG.integers(lo, hi))))
            for _ in range(n)]


def assert_batches_equal(a, b):
    assert a.num_reads == b.num_reads
    assert a.all_bases == b.all_bases
    for field in ("packed", "valid_len", "read_id", "start", "read_len",
                  "prev_base", "next_base"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field


@needs_native
@pytest.mark.parametrize("fmt,wrap", [("fasta", 0), ("fasta", 60),
                                      ("fastq", 0)])
def test_native_matches_numpy(tmp_path, fmt, wrap):
    # Mix of long reads, short (dropped) reads, lowercase and N characters.
    seqs = random_seqs(30, 30, 700)
    seqs += ["ACGT" * 3]            # shorter than k -> dropped
    seqs += ["acgtNNNacgt" * 10]    # lowercase + N -> 0-coded
    path = str(tmp_path / f"reads.{fmt}")
    (write_fasta if fmt == "fasta" else write_fastq)(
        path, seqs, *( [wrap] if fmt == "fasta" else [] ))

    k, chunk_len = 25, 256
    nat = native.load_reads_native(path, k, chunk_len)
    ref = reads_mod.reads_from_strings(reads_mod.parse_reads(path),
                                       k, chunk_len)
    assert nat is not None
    assert_batches_equal(nat, ref)


@needs_native
def test_native_is_faster_on_bulk(tmp_path):
    seqs = random_seqs(300, 1500, 2500)
    path = str(tmp_path / "bulk.fasta")
    write_fasta(path, seqs)
    k, chunk_len = 25, 1024

    t0 = time.time()
    nat = native.load_reads_native(path, k, chunk_len)
    t_nat = time.time() - t0
    t0 = time.time()
    ref = reads_mod.reads_from_strings(reads_mod.parse_reads(path),
                                       k, chunk_len)
    t_py = time.time() - t0
    assert_batches_equal(nat, ref)
    # Not a strict perf gate (CI noise), but native should never be slower
    # by more than 2x; typically it is several times faster.
    assert t_nat < max(t_py * 2.0, 0.5), (t_nat, t_py)


def test_lib_path_is_source_digest_named():
    path = native.lib_path()
    assert os.path.dirname(path) == os.path.dirname(native.__file__)
    name = os.path.basename(path)
    assert name.startswith("libp3native-") and name.endswith(".so")
    assert native.lib_path() == path  # stable for an unchanged source


@pytest.mark.parametrize("use_native", [True, False])
def test_load_reads_reports_parser(tmp_path, use_native):
    path = str(tmp_path / "reads.fasta")
    write_fasta(path, random_seqs(5, 100, 200))
    batch = reads_mod.load_reads(path, 25, 256, use_native=use_native)
    want = "native" if use_native and native.get_lib() is not None \
        else "numpy"
    assert batch.parser == want
