"""Balanced graph-coloring framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``Topopiccione/MCMC_Colorer`` (the reference): a balanced
graph-coloring MCMC sampler plus Luby-MIS, Greedy First-Fit and
Vertex-centric First-Fit colorers, an Erdős–Rényi simulator, edge-list
importers, per-run statistics with the reference's log field names, and a
multi-device (chains × vertex-shards) scaling path over a
`jax.sharding.Mesh`.

The compute path is pure functional JAX (`lax.while_loop` keeps whole
colorer runs on-device — the counterpart of the reference's CUDA
dynamic-parallelism driver, reference coloringLubyFast.cu:51-107).
"""

from mcmc_colorer_tpu.config import (
    ColorerKind,
    InitKind,
    MCMCParams,
    ProposalKind,
    RunConfig,
)
from mcmc_colorer_tpu.graph.container import Graph
from mcmc_colorer_tpu.models.base import Coloring

__version__ = "0.1.0"

__all__ = [
    "Graph",
    "Coloring",
    "MCMCParams",
    "RunConfig",
    "ColorerKind",
    "ProposalKind",
    "InitKind",
    "__version__",
]
