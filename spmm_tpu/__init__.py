"""spmm_tpu — a sparse linear-algebra framework on JAX.

Built from scratch (JAX / XLA / Pallas / shard_map) with the capabilities of the
reference XaryLee/spmm preprocessing pipeline (see SURVEY.md):

- ``formats``    — COO / CSR / BSR / BlockedCSR containers (jax pytrees) + .mtx ingest
- ``preprocess`` — the reference's locality pipeline as vectorized ops:
                   bitmap dominant-section row reorder, panel-budgeted region split,
                   nnz-balanced panelization, 8-row (v8) vector-group packing,
                   first-touch column relabeling, permutation algebra
- ``ops``        — SpMV / SpMM / SpGEMM kernels (XLA formulations + a Pallas GPU kernel)
- ``parallel``   — multi-chip partitioning via Mesh + shard_map, halo/ring collectives
- ``utils``      — timing/benchmark harness, rooflines, config
"""

from spmm_tpu.config import Config, default_config
from spmm_tpu.formats import COO, CSR, BlockedCSR, read_mtx, to_csr, to_coo
from spmm_tpu import ops

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "BlockedCSR",
    "Config",
    "default_config",
    "read_mtx",
    "to_csr",
    "to_coo",
    "ops",
]
