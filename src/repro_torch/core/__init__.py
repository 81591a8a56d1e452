"""The paper's contribution: an on-demand workload manager (Flux) as an
operator over a GPU fleet, with TBON broker overlay, Fluxion graph
scheduling, elasticity, autoscaling, bursting, queue state migration,
and fault tolerance — plus the MPI Operator baseline it is evaluated
against.  A copy of the JAX package's ``core`` whose executors
(``executor``, all seven of the reference's) run the port."""
from repro_torch.core.autoscaler import (Autoscaler, FleetDemandPolicy,  # noqa: F401
                                         FluxMetricsPolicy, HPAPolicy)
from repro_torch.core.broker import BrokerPool, BrokerState, TBON  # noqa: F401
from repro_torch.core.burst import BurstService, make_plugin  # noqa: F401
from repro_torch.core.executor import (ElasticFleetServeExecutor,  # noqa: F401
                                       ElasticServeExecutor,
                                       ElasticTrainExecutor,
                                       FleetServeExecutor, ServeExecutor,
                                       SubmeshExecutor,
                                       TorchWorkloadExecutor)
from repro_torch.core.fault import StragglerMitigator, kill_node, make_straggler  # noqa: F401
from repro_torch.core.instance import FluxInstance  # noqa: F401
from repro_torch.core.jobspec import Job, JobSpec, JobState  # noqa: F401
from repro_torch.core.minicluster import MiniClusterSpec  # noqa: F401
from repro_torch.core.mpi_operator import MPIJob  # noqa: F401
from repro_torch.core.queue import JobQueue  # noqa: F401
from repro_torch.core.reconciler import FluxMiniCluster  # noqa: F401
from repro_torch.core.resource_graph import ResourceGraph, ResourceSet  # noqa: F401
from repro_torch.core.sim import NetModel, SimClock  # noqa: F401
from repro_torch.core.state import Archive, restore_state, save_state  # noqa: F401
