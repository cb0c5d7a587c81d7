"""Online retrieval serving of the port: sharded cluster functions, the
fault-tolerant replicated mesh, request micro-batching and the versioned
ψ table."""
from repro_torch.serve.batcher import MicroBatcher  # noqa: F401
from repro_torch.serve.cluster import (  # noqa: F401
    PsiShardSet,
    TopKResult,
    cluster_topk,
    shard_psi,
)
from repro_torch.serve.mesh import (  # noqa: F401
    FaultInjector,
    FaultTolerantRetrievalMesh,
    ReplicaSet,
    RetryPolicy,
    ShardHealthMonitor,
)
from repro_torch.serve.publish import VersionedTable  # noqa: F401
