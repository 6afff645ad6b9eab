"""Runtime configuration.

Replaces BOTH configuration layers of the reference with runtime dataclasses:
the getopt_long CLI (reference src/utils/ArgHandle.cpp:31-58) and the
compile-time ``#define`` matrix selecting MCMC proposal/init variants
(reference src/graph_coloring/coloringMCMC.h:20-41).  No compile-time forks:
every variant is a runtime enum and every hard-coded constant of the
reference (epsilon/lambda/maxRip, src/main.cu:160-168) is a field here.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from dataclasses import dataclass, field


class ColorerKind(str, enum.Enum):
    """Algorithm selection — the five CLI-reachable colorers of the reference
    (README.md:111-115) plus the sequential greedy (reference
    colorer.cpp:135-208, not CLI-reachable there; exposed here)."""

    MCMC = "mcmc"            # fully-parallel MCMC balanced colorer (--mcmcgpu)
    MCMC_SEQ = "mcmc_seq"    # sequential-semantics MCMC (--mcmccpu)
    LUBY = "luby"            # Luby-inspired greedy MIS colorer (--lubygpu)
    GREEDY_FF = "greedy_ff"  # Greedy First-Fit (--grdffgpu)
    VFF = "vff"              # Greedy FF + vertex-centric rebalancing (--vffgpu)
    GREEDY_SEQ = "greedy_seq"  # sequential degree-sorted first-fit


class ProposalKind(str, enum.Enum):
    """MCMC proposal-distribution variant.

    Mirrors the reference's compile-time selection
    (coloringMCMC.h:34-39): STANDARD, COLOR_DECREASE_{LINE,EXP},
    COLOR_BALANCE_{LINE,EXP}, COLOR_BALANCE_DYNAMIC_DISTR (shipped default).
    """

    STANDARD = "standard"
    DECREASE_LINE = "decrease_line"
    DECREASE_EXP = "decrease_exp"
    BALANCE_LINE = "balance_line"
    BALANCE_EXP = "balance_exp"
    BALANCE_DYNAMIC = "balance_dynamic"


class InitKind(str, enum.Enum):
    """Initial-coloring distribution (coloringMCMC.h:27-29)."""

    UNIFORM = "uniform"            # STANDARD_INIT
    DISTRIBUTION_LINE = "line"     # DISTRIBUTION_LINE_INIT
    DISTRIBUTION_EXP = "exp"       # DISTRIBUTION_EXP_INIT


@dataclass(frozen=True)
class MCMCParams:
    """Parameters of the MCMC balanced colorer.

    Counterpart of ``ColoringMCMCParams`` (reference coloring.h:65-74) with
    the hard-coded values of main.cu:160-168 as defaults.  All are runtime
    values; ``proposal``/``init``/``hastings`` replace #define forks.
    """

    n_colors: int
    max_iterations: int = 250          # maxRip, main.cu:166
    epsilon: float = 1e-8              # main.cu:163
    lambda_: float = 1.0               # main.cu:164 (Hastings temperature)
    ratio_freezed: float = 1e-2        # main.cu:165 (kept for parity; unused
                                       # in the reference's active code too)
    taboo_iterations: int = 0          # --tabooIterations, default 0
    tailcut: bool = False              # --tailcut
    proposal: ProposalKind = ProposalKind.BALANCE_DYNAMIC
    init: InitKind = InitKind.UNIFORM
    seq_stall_escape: bool = False     # opt-in: back the sequential
                                       # tailcut with the reference's own
                                       # (dead-code) unlock_stall — random
                                       # re-color of conflicting nodes when
                                       # a greedy pass makes no progress
                                       # (coloringMCMC_CPUutils.cpp:49-67).
                                       # Default off: the faithful chain
                                       # stalls exactly where the
                                       # reference's would.
    hastings: bool = False             # reference ships with HASTINGS off
                                       # (coloringMCMC.h:41); here a runtime
                                       # option implementing the paper's
                                       # lambda-weighted acceptance.
    # Conflict metric: the reference CPU counts violating *nodes*
    # (coloringMCMC_CPU.cpp:329-351) while the GPU counts conflicting *edges*
    # (coloringMCMC_utils.cu:113-116).  We standardise on edges (SURVEY §9.4)
    # but keep the node metric for the sequential-semantics colorer.
    count_edges: bool = True

    def tailcut_threshold(self, n_nodes: int) -> int:
        """z = max(50, n/2000) when tailcut is enabled, else 0
        (reference coloringMCMC_CPU.cpp:89-97, coloringMCMC_main.cu:151)."""
        if not self.tailcut:
            return 0
        return max(50, n_nodes // 2000)

    def replace(self, **kw) -> "MCMCParams":
        return dataclasses.replace(self, **kw)


def default_n_colors(max_degree: int, num_color_ratio: float = 1.0) -> int:
    """nCol default = maxDeg / numColRatio.  The reference inverts the
    CLI flag first (``numColorRatio = 1.0f / commandLine.numColRatio``,
    main.cu:53) and then multiplies (``params.nCol = maxNodeDeg *
    numColorRatio``, main.cu:162) — net effect: the flag DIVIDES the
    palette.  numColRatio is validated into [1, 16]
    (ArgHandle.cpp:148-156).  (A round-3 commit briefly flipped this to
    multiply after reading :162 without :53; reverted same round.)"""
    return max(1, int(max_degree / num_color_ratio))


@dataclass
class RunConfig:
    """Full run description — the counterpart of the reference CLI surface
    (ArgHandle.cpp:31-58; README.md:105-123)."""

    colorer: ColorerKind = ColorerKind.MCMC_SEQ  # reference default when no
                                                 # flag given (ArgHandle.cpp:247-249)
    # graph source: either simulate (ER) or an edge-list file
    graph_path: str | None = None
    simulate_p: float | None = None
    n_nodes: int = 0
    # coloring parameters
    n_colors: int = 0                   # 0 → maxDeg / num_color_ratio
    num_color_ratio: float = 1.0        # clamped to [1, 16] like ArgHandle.cpp:148-156
    taboo_iterations: int = 0
    tailcut: bool = False
    repetitions: int = 1
    seed: int = field(default_factory=lambda: int(time.time()))
    out_dir: str | None = None
    # extensions with no reference counterpart
    n_chains: int = 1                   # independent chains (vmapped/sharded)
    mesh_chains: int = 1                # mesh axis sizes for multi-device runs
    mesh_shards: int = 1
    proposal: ProposalKind = ProposalKind.BALANCE_DYNAMIC
    hastings: bool = False

    @property
    def graph_name(self) -> str:
        """Derived name, mirroring ArgHandle.cpp:285-306."""
        if self.graph_path is not None:
            import os

            base = os.path.basename(self.graph_path)
            return base.rsplit(".", 1)[0] if "." in base else base
        return f"{self.n_nodes}_{self.simulate_p}_{self.num_color_ratio}"

    @property
    def output_dir(self) -> str:
        return self.out_dir if self.out_dir else f"{self.graph_name}_out"

    def mcmc_params(self, max_degree: int) -> MCMCParams:
        ratio = min(16.0, max(1.0, float(self.num_color_ratio)))
        n_col = self.n_colors or default_n_colors(max_degree, ratio)
        return MCMCParams(
            n_colors=n_col,
            taboo_iterations=self.taboo_iterations,
            tailcut=self.tailcut,
            proposal=self.proposal,
            hastings=self.hastings,
        )
