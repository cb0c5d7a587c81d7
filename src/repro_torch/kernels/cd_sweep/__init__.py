from repro_torch.kernels.cd_sweep.ops import (  # noqa: F401
    cd_block_sweep,
    cd_block_sweep_gather,
    cd_block_sweep_rowpatch,
    cd_block_sweep_rowpatch_gather,
    cd_resid_patch,
    cd_resid_patch_gather,
    cd_slab_reduce,
    cd_slab_reduce_gather,
)
