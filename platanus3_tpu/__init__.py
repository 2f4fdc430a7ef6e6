"""platanus3-tpu: a de Bruijn assembly framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference C++ assembler taichimai/platanus3 (see SURVEY.md): FASTA/FASTQ
loading, exact short-k-mer counting, window-min solidity filtering, Bloom
membership, implicit de Bruijn graph construction with
junction/joint/unitig decomposition, coverage annotation and GFA 1.0
output -- plus graph simplification, multi-k iteration, checkpointing and
multi-host sharding the reference lacks.

Everything on the compute path is bulk array transformation: sort +
segment-reduce instead of hash maps, pointer doubling instead of BFS,
masks instead of branches.
"""

__version__ = "0.1.0"

from platanus3_tpu.config import AssemblyConfig

__all__ = ["AssemblyConfig"]
