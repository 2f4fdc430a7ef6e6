"""Multi-k iterative assembly (BASELINE config 4).

NEW capability with no reference counterpart: assemble at increasing k
(e.g. 32 -> 64 -> 128), re-seeding each round's graph with the previous
round's unitigs.  Small k recovers low-coverage regions; large k resolves
repeats -- the standard IDBA/SPAdes-style multi-k scheme.

Re-seeding rides the pipeline's ``extra_solid`` hook: prior unitigs'
k-mers are merged straight into the next round's node table (and their
first k-mers into the seed set), bypassing the solidity filter without
touching the read batch.  Reads are parsed/packed from source ONCE, the
read volume never inflates (round 1 injected every unitig as
``cov_threshold`` pseudo-read copies -- re-counted, re-sorted, and
coverage-inflating every round), and coverage/KC values stay purely
read-derived.
"""

from __future__ import annotations

import dataclasses

from platanus3_tpu.config import AssemblyConfig
from platanus3_tpu.io import reads as reads_mod
from platanus3_tpu.pipeline import assemble, AssemblyResult

__all__ = ["assemble_multik"]


def assemble_multik(source, config: AssemblyConfig, log=None, mesh=None,
                    write_output: bool = True, streaming: bool = False,
                    slice_chunks: int = 2048) -> AssemblyResult:
    """Iterate assembly over ``config.k_list``, re-seeding each round
    with the previous round's unitigs via ``extra_solid``.

    ``streaming=True`` runs every round through the bounded-memory
    streaming pipeline (VERDICT r4 item 4) -- multi-k at read volumes the
    single-shot pipeline cannot hold in device memory; results at any
    given k are byte-identical between the two executors
    (tests/test_simplify_multik).
    """
    ks = tuple(config.k_list) or (config.k,)
    if isinstance(source, (list, tuple)):
        reads = list(source)
    else:
        reads = reads_mod.parse_reads(source)

    if streaming:
        from platanus3_tpu.streaming import assemble_streaming

    res = None
    for i, k in enumerate(ks):
        cfg_k = dataclasses.replace(config, k=k, k_list=())
        extra = None
        if res is not None:
            extra = [s for s in res.straight_seqs if len(s) >= k]
        last = i == len(ks) - 1
        if streaming:
            res = assemble_streaming(reads, cfg_k, log=log, mesh=mesh,
                                     write_output=write_output and last,
                                     slice_chunks=slice_chunks,
                                     extra_solid=extra or None)
        else:
            res = assemble(reads, cfg_k, log=log, mesh=mesh,
                           write_output=write_output and last,
                           extra_solid=extra or None)
        if log:
            log.write(f"multi-k round k={k}: {res.num_straights} straights, "
                      f"{res.num_junctions} junctions")
    return res
