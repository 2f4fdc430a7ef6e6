"""Multi-host (multi-process) execution support.

On a multi-host cluster each host runs one process and sees only its
local devices; ``jax.distributed`` links them into one global runtime and
``jax.sharding.Mesh`` spans all devices.  This module wraps that setup for
the assembler:

* :func:`initialize` -- bring up the global runtime (idempotent; no-op
  for single-process runs);
* :func:`global_mesh` -- a 1-D ``('d',)`` mesh over ALL devices of
  every process; ``parallel/sharded.py`` then shards chunks over hosts
  AND devices uniformly (the all-to-all count shuffle rides the
  intra-host interconnect within a host and the network across hosts,
  the BASELINE north-star layout);
* :func:`host_local_batch` -- slice a globally-loaded ReadBatch to this
  process's shard (each host parses only its slice of the read file in a
  real deployment; for moderate inputs every host may parse the whole
  file and keep its slice);
* :func:`gather_to_host0` -- ``process_allgather`` wrapper for the final
  stitch step ("unitig traversal results are gathered and stitched on
  host 0", BASELINE.json north star).

The logic is identical to the single-process mesh path (which IS tested,
on 8 virtual CPU devices -- results are bitwise-equal to 1 device); this
layer only changes who owns which rows.  ``tests/test_multihost.py``
runs it with several CPU processes; it is kept thin and dependency-free.
"""

from __future__ import annotations

import numpy as np
import jax

from platanus3_tpu.parallel.sharded import make_mesh

__all__ = ["initialize", "global_mesh", "host_local_batch",
           "gather_to_host0"]

_initialized = False


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Start the multi-process runtime.  With no arguments JAX tries to
    discover the topology from a cluster environment it recognizes (a
    single machine with no cluster environment stays single-process)."""
    global _initialized
    if _initialized:
        return
    if coordinator_address is None and num_processes is None:
        # NB: jax.process_count() initializes the backend, which forbids a
        # later distributed.initialize() -- only consult it on this
        # auto-discovery path, never before an explicit initialize.
        if jax.process_count() > 1:
            _initialized = True
            return
        try:
            jax.distributed.initialize()
        except Exception:
            return  # single-process environment
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    _initialized = True


def global_mesh():
    """1-D mesh over every device of every process."""
    return make_mesh(jax.devices())


def host_local_batch(batch, n_hosts=None, host_id=None):
    """Slice a ReadBatch's chunk arrays to this host's contiguous shard
    (chunk rows are self-contained; any partition is valid)."""
    n = n_hosts if n_hosts is not None else jax.process_count()
    h = host_id if host_id is not None else jax.process_index()
    c = batch.packed.shape[0]
    per = -(-c // n)
    lo, hi = h * per, min((h + 1) * per, c)
    import dataclasses
    return dataclasses.replace(
        batch,
        packed=batch.packed[lo:hi], valid_len=batch.valid_len[lo:hi],
        read_id=batch.read_id[lo:hi], start=batch.start[lo:hi],
        read_len=batch.read_len[lo:hi], prev_base=batch.prev_base[lo:hi],
        next_base=batch.next_base[lo:hi])


def gather_to_host0(tree):
    """All-gather host-sharded arrays so host 0 can stitch/emit."""
    if jax.process_count() == 1:
        return tree
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(tree)
