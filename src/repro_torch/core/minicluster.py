"""MiniCluster custom resource + validation (the operator's CRD)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class MiniClusterSpec:
    """Declarative spec a user applies; the reconciler makes it real.

    Mirrors the Flux Operator CRD: size / maxSize (elasticity head-room
    is REGISTERED up front — absent ranks are simply DOWN), the
    container/application, tasks per node, interactive mode, users for
    multi-tenancy, and bursting plugins.
    """

    name: str = "mini"
    size: int = 4
    max_size: int = 0                 # 0 -> same as size (no elasticity)
    tasks_per_node: int = 4
    command: str = "lammps-proxy"     # workload id the executor understands
    interactive: bool = False
    users: List[str] = field(default_factory=lambda: ["flux"])
    bursting: List[str] = field(default_factory=list)   # plugin names
    tbon_fanout: int = 2
    # exactly-once queue transfer (beyond-paper improvement; the paper's
    # at-most-once behaviour loses ~1-2 in-flight jobs per migration)
    exactly_once_state: bool = False

    def validate(self) -> "MiniClusterSpec":
        if self.size < 1:
            raise ValueError("MiniCluster size must be >= 1 "
                             "(the lead broker cannot be deleted)")
        if self.max_size and self.max_size < self.size:
            raise ValueError("maxSize must be >= size")
        if self.tasks_per_node < 1:
            raise ValueError("tasksPerNode must be >= 1")
        return self

    @property
    def effective_max(self) -> int:
        return self.max_size or self.size


@dataclass
class MiniClusterStatus:
    phase: str = "Pending"            # Pending | Ready | Scaling | Deleted
    ready_ranks: int = 0
    size: int = 0
    conditions: List[str] = field(default_factory=list)
