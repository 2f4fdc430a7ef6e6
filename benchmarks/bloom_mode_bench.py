"""Bloom-membership mode vs exact-membership mode wall-clock (VERDICT r1
item 6 gate: bloom-mode run within 1.3x of exact mode).

Exact mode answers adjacency by binary search in the sorted node table;
bloom mode builds the packed Bloom filter (ops/bloom.py sort+dedup+
scatter-add over the DISTINCT node set) and answers adjacency by filter
probes with FP-closure rounds, like the reference's traversal
(src/DeBruijnGraph.cpp:317-345).  Prints cold + warm wall for both modes
and the warm ratio.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from platanus3_tpu.config import AssemblyConfig
from platanus3_tpu.pipeline import assemble


def p(*a):
    print(*a, flush=True)


GLEN = int(os.environ.get("GLEN", "4000000"))
rng = np.random.default_rng(99)
genome = "".join(rng.choice(list("ACGT"), size=GLEN))
reads = [genome[s:s + 8000] for s in range(0, GLEN - 8000 + 1, 400)]
nbases = sum(len(r) for r in reads)
p(f"backend: {jax.default_backend()}  genome {GLEN}, {len(reads)} reads, "
  f"{nbases/1e6:.1f} Mbases")

m_bits = 1 << 30
results = {}
for mode in ("exact", "bloom"):
    cfg = AssemblyConfig(
        k=25, filter_bits=m_bits, chunk_len=4096, log_path=None,
        use_exact_membership=(mode == "exact"))
    walls = []
    for rep in range(3):
        t0 = time.time()
        res = assemble(reads, cfg, write_output=False)
        walls.append(time.time() - t0)
    results[mode] = min(walls[1:])
    p(f"{mode}: cold {walls[0]:.2f}s  warm {min(walls[1:]):.2f}s  "
      f"straights={res.num_straights} junctions={res.num_junctions}")

ratio = results["bloom"] / results["exact"]
p(f'{{"metric": "bloom_vs_exact_warm_ratio", "value": {ratio:.3f}, '
  f'"unit": "x", "vs_baseline": {ratio:.3f}}}')
