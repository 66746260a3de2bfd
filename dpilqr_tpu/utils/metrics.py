"""Structured metrics and logging.

Two sinks:

- CSV rows with the reference's exact schema (scripts/analysis.py:120-123):
  ``dynamics,n_agents,trial,centralized,last,t,J,horizon,dt,converged,ids,
  times,subgraphs,dist_left`` -- so the reference's analysis notebooks keep
  working against our logs.
- JSON-lines records carrying the solver's own counters (per-solve wall time,
  iLQR iterations, subproblem sizes, Riccati block-nnz throughput).
"""

from __future__ import annotations

import json
import logging
from dataclasses import asdict, dataclass
from pathlib import Path

CSV_SCHEMA = (
    "dynamics,n_agents,trial,centralized,last,t,J,horizon,dt,converged,"
    "ids,times,subgraphs,dist_left"
)


def setup_csv_logger(path, name: str = "dpilqr_tpu.analysis"):
    """File logger emitting the reference CSV schema
    (reference analysis.py:110-124)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    handler = logging.FileHandler(path, mode="w")
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
    logger.propagate = False
    logger.info(CSV_SCHEMA)
    return logger


def csv_row(
    model_name: str,
    n_agents: int,
    trial,
    centralized: bool,
    last: bool,
    t: float,
    J: float,
    horizon: int,
    dt: float,
    converged: bool,
    ids,
    times,
    subgraphs,
    dist_left,
) -> str:
    """One reference-schema row (reference distributed.py:190-194)."""
    return (
        f'"{model_name}",{n_agents},{trial},{centralized},{last},{t},{J},'
        f'{horizon},{dt},{converged},"{ids}","{times}","{subgraphs}",'
        f'"{dist_left}"'
    )


@dataclass
class SolveMetrics:
    """Per-solve counters (the BASELINE.md north-star measurements)."""

    n_agents: int
    horizon: int
    wall_time_s: float
    iters: int
    converged: bool
    mode: str  # "centralized" | "distributed"
    subproblem_sizes: list | None = None
    # Riccati throughput: nonzero blocks processed per second.  Per timestep
    # and iteration the block backward pass touches n^2 (nx*nx) P-coupling
    # blocks plus n each of A, B blocks.
    block_nnz_per_s: float | None = None

    def finalize(self, nx: int):
        n, N = self.n_agents, self.horizon
        blocks_per_iter = N * (n * n + 2 * n)
        total = blocks_per_iter * max(self.iters, 1)
        self.block_nnz_per_s = total / self.wall_time_s if self.wall_time_s else None
        return self


def riccati_block_nnz(n_agents: int, nx: int, nu: int, N: int) -> int:
    """Nonzero block ENTRIES touched by one Riccati backward sweep
    (BASELINE.md north-star counter): per timestep the block backward pass
    touches the n^2 (nx, nx) P-coupling blocks plus n (nx, nx) A-blocks and
    n (nx, nu) B-blocks."""
    n = n_agents
    return N * (n * n * nx * nx + n * nx * nx + n * nx * nu)


class JsonlWriter:
    """Append-only JSON-lines metrics sink."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record):
        if hasattr(record, "__dataclass_fields__"):
            record = asdict(record)
        elif hasattr(record, "to_dict"):
            record = record.to_dict()
        with self.path.open("a") as f:
            f.write(json.dumps(record) + "\n")
