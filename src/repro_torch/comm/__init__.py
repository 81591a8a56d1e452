"""Topology-aware collective communication: the port of the JAX
package's ``comm/``.

* ``topology``    — ``CommTopology.from_mesh`` derives axis tiers +
                    the reference's per-tier bandwidth model from mesh
                    axis names; ``estimate_sync_bytes`` prices a sync;
* ``collectives`` — ``sync_grads``: the two-phase hierarchical gradient
                    sync over the mesh's process groups (reduce-scatter
                    intra-pod, all-reduce shards cross-pod, all-gather
                    back), with ``resolve_policy`` as the single
                    warn-or-strict fallback gate;
* ``compress``    — int8 per-block-scale quantization with
                    error-feedback residuals on the cross-pod phase,
                    the residual living in the train state so
                    checkpoints carry it;
* ``bucketing``   — partition the param tree into ~byte-balanced
                    buckets in reverse-layer order;
* ``overlap``     — the event model that prices how much of the
                    bucketed cross-pod sync hides behind backward.
"""
from repro_torch.comm import (  # noqa: F401
    bucketing, collectives, compress, overlap, topology,
)
from repro_torch.comm.bucketing import (  # noqa: F401
    GradBucket, partition_buckets,
)
from repro_torch.comm.collectives import (  # noqa: F401
    CommFallbackWarning, CommPolicy, CommTopologyError, degrade,
    grad_rules, resolve_policy, sync_grads, sync_grads_bucketed,
)
from repro_torch.comm.compress import (  # noqa: F401
    EF_POD_AXIS, compress_payload, ef_defs,
)
from repro_torch.comm.overlap import (  # noqa: F401
    OverlapSchedule, schedule_overlap,
)
from repro_torch.comm.topology import (  # noqa: F401
    CommTopology, estimate_a2a_bytes, estimate_sync_bytes, payload_bytes,
)
