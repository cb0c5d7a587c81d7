"""Online retrieval serving of the port: the single-device engine, the
sharded cluster, the fault-tolerant replicated mesh, request
micro-batching, live ψ publish from training, and the IVF approximate tier
with quantized ψ storage."""
from repro_torch.serve.ann import (  # noqa: F401
    AnnConfig,
    PsiIndex,
    build_shard_indexes,
    fold_delta_indexes,
    index_from_numpy,
    ivf_cluster_topk,
    kmeans,
)
from repro_torch.serve.batcher import MicroBatcher  # noqa: F401
from repro_torch.serve.cluster import (  # noqa: F401
    PsiShardSet,
    ShardedRetrievalCluster,
    TopKResult,
    cluster_topk,
    shard_map_topk,
    shard_psi,
)
from repro_torch.serve.engine import (  # noqa: F401
    RetrievalEngine,
    exclude_ids_from_lists,
    exclude_mask_from_lists,
)
from repro_torch.serve.mesh import (  # noqa: F401
    FaultInjector,
    FaultTolerantRetrievalMesh,
    ReplicaSet,
    RetryPolicy,
    ShardHealthMonitor,
)
from repro_torch.serve.publish import (  # noqa: F401
    PsiPublisher,
    StagedRollout,
    VersionedTable,
    apply_delta,
    dense_table,
)
