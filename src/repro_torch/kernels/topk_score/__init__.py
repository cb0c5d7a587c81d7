from repro_torch.kernels.topk_score.ops import topk_merge_shards, topk_score  # noqa: F401
from repro_torch.kernels.topk_score.ref import topk_score_ref  # noqa: F401
