"""Rehearsals of ``chip_smoke.py`` on the CPU at tiny sizes.

The script's phases take their devices as arguments, so the known-answer
check and the device-against-device equality run here CPU against CPU;
``main()`` itself must refuse a machine without a GPU.  The real run is
``python chip_smoke.py`` on the card (the ``gpu``-marked test below).
"""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_main_refuses_without_gpu(tmp_path, capsys):
    rc = cs.main(["--out", str(tmp_path)])
    assert rc != 0
    out = capsys.readouterr().out
    assert "needs a GPU" in out
    assert '"ok"' not in out


def test_script_alone_refuses(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_expected_straight_len_matches_calibration():
    # 60 kb genome, 10 kb reads every 333 bp: measured 59,282 bp.
    assert cs.expected_straight_len(60_000, 10_000, 333) == 59_282
    # the full-size phase
    last = (cs.ECOLI_LEN - cs.ECOLI_READ_LEN) // 333 * 333
    assert cs.expected_straight_len(cs.ECOLI_LEN, cs.ECOLI_READ_LEN, 333) \
        == last + cs.ECOLI_READ_LEN - 668


@pytest.fixture(scope="module")
def small_ecoli(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ecoli"))
    fasta, lines, genome, reads = cs.phase_ecoli(
        jax.devices()[:1], out, 3, "cpu", genome_len=12_000, read_len=3_000,
        step=333, repeats=1)
    return out, fasta, lines, genome, reads


def test_phase_ecoli_known_answer(small_ecoli):
    _, _, lines, genome, _ = small_ecoli
    assert cs.check_known_answer(lines, genome, 3_000, 333) \
        == cs.expected_straight_len(12_000, 3_000, 333)


@pytest.mark.parametrize("tamper", ["drop_link", "extra_junction",
                                    "short_straight", "foreign_straight"])
def test_known_answer_rejects(small_ecoli, tamper):
    _, _, lines, genome, _ = small_ecoli
    lines = list(lines)
    i = next(j for j, ln in enumerate(lines) if ln.startswith("S\tStraight"))
    f = lines[i].split("\t")
    if tamper == "drop_link":
        lines.remove(next(ln for ln in lines if ln.startswith("L\t")))
    elif tamper == "extra_junction":
        lines.append("S\tJunction_9\t" + "A" * 32 + "\tKC:i:2")
    elif tamper == "short_straight":
        f[2] = f[2][1:]
        lines[i] = "\t".join(f)
    else:
        f[2] = f[2][:100] + ("A" if f[2][100] != "A" else "C") + f[2][101:]
        lines[i] = "\t".join(f)
    with pytest.raises(AssertionError):
        cs.check_known_answer(lines, genome, 3_000, 333)


def test_phase_ecoli_streaming_equals_single_shot(small_ecoli):
    out, fasta, lines, _, reads = small_ecoli
    cs.phase_ecoli_streaming(jax.devices()[:1], out, fasta, reads, lines,
                             "cpu")


@pytest.mark.parametrize("run", cs.CROSS_RUNS, ids=[r[0] for r in
                                                    cs.CROSS_RUNS])
def test_phase_cross_cpu_against_cpu(tmp_path, run):
    d0, d1 = jax.devices()[:2]
    cs.phase_cross(d0, d1, str(tmp_path), 5, "cpu", genome_len=12_000,
                   runs=(run,))


def test_check_same_lines_reports_difference():
    cs.check_same_lines("same", ["a", "b", "a"], ["a", "a", "b"])
    with pytest.raises(AssertionError, match="multisets differ"):
        cs.check_same_lines("dup", ["a", "b", "a"], ["a", "b", "b"])


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                        "--out", str(tmp_path)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
