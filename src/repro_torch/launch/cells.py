"""(architecture × input-shape) cell builders for the dry run (port of
``repro.launch.cells``).

A cell packages what ``dryrun.py`` needs to trace one entry of the
assignment matrix as ONE RANK of a production mesh: a step closure, its
abstract inputs (``device="meta"`` tensors: shapes, never allocated) at
that rank's shapes, and the reference's in/out specs for the mesh.

The reference lowers one SPMD program over the whole mesh; the port's
programs are written a rank at a time (``torch.distributed``), so a cell's
step is what one rank runs, its collectives on the mesh's groups. Called
with tensors that hold data (on a world of one, ``mesh.make_mesh_of_one``),
the same step runs the cell for real.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs import get_config, get_shapes
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import dp_axes, n_chips
from repro_torch.launch.sharding import P

# the retrieval cell's K, as the reference's ``top_k(scores, 100)``
RETRIEVAL_K = 100


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    abstract_args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Any
    skip: Optional[str] = None
    notes: str = ""


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ===========================================================================
# iCD cells — the paper's own model at production scale
# ===========================================================================
def _retrieval_cell(arch: str, shape_spec, mesh, cfg) -> Cell:
    from repro_torch.serve.cluster import PsiShardSet, shard_map_topk

    dp = dp_axes(mesh)
    model = mesh["model"]
    n_model = model.size()
    n_cand = shape_spec.extra("n_candidates")
    rows_per = -(-n_cand // n_model)
    n_dp = math.prod(mesh.shape[mesh.mesh_dim_names.index(a)] for a in dp)
    b_rank = -(-shape_spec.global_batch // n_dp)

    def step(phi, psi_shard):
        # each rank holds its own shard only, and shard_map_topk reads
        # table.shards[rank] alone: the other entries name the same tensor
        table = PsiShardSet((psi_shard,) * n_model, n_items=n_cand,
                            rows_per=rows_per)
        return tuple(shard_map_topk(model, table, phi, RETRIEVAL_K))

    return Cell(
        arch, shape_spec.name, "retrieval", step,
        (_meta((b_rank, cfg.k)), _meta((rows_per, cfg.k))),
        (P(dp, None), P("model", None)),
        (P(dp, None), P(dp, None)),
        notes=("paper-native separable retrieval: one matvec per query. "
               f"Port: one rank's shard_map_topk over mesh['model'] "
               f"({n_model} shards of {rows_per} psi rows, {b_rank} phi "
               f"rows a rank of dp): the top-K kernel (row 10) over its "
               f"shard, one all-gather of the candidates, the cross-shard "
               f"merge; the reference scores w_users @ h_items.T and takes "
               f"top_k. On meta tensors the kernel's plain version traces"),
    )


def _train_cell(arch: str, shape_spec, mesh, cfg) -> Cell:
    from repro_torch.core.models import mf_dist
    from repro_torch.core.models.mf import MFHyperParams

    dp = dp_axes(mesh)
    d = n_chips(mesh)
    n_ctx = shape_spec.extra("n_ctx")
    n_items = shape_spec.extra("n_items")
    nnz = shape_spec.extra("nnz")
    c_per, i_per = -(-n_ctx // d), -(-n_items // d)
    # a balanced log: every rank holds ⌈nnz/D⌉ observations on each side,
    # and every (source, destination) pair of the residual route ⌈p/D⌉
    p = -(-nnz // d)
    blk = -(-p // d)
    hp = MFHyperParams(k=cfg.k, alpha0=cfg.alpha0, l2=cfg.l2, unroll=True,
                       implementation="pallas")
    idx, val = (lambda n: _meta((n,), torch.int64)), (lambda n: _meta((n,)))
    template = mf_dist.ShardedMF(
        ctx_l=idx(p), item_g=idx(p), y_c=val(p), alpha_c=val(p),
        item_l=idx(p), ctx_g=idx(p), y_i=val(p), alpha_i=val(p),
        send_idx=_meta((d, blk), torch.int64),
        recv_pos=_meta((d, blk), torch.int64),
        c_per=c_per, i_per=i_per, n_shards=d)
    shards = mf_dist.make_shard_mesh(d, device_type=mesh.device_type)
    step = mf_dist.build_epoch(shards, hp, template, variant="gather")

    p_specs, d_specs = sh.icd_mf_specs(mesh)
    return Cell(
        arch, shape_spec.name, "train", step,
        (_meta((c_per, cfg.k)), _meta((i_per, cfg.k)), template, _meta((p,))),
        (p_specs.w, p_specs.h, d_specs, P(dp)),
        (p_specs.w, p_specs.h, P(dp)),
        notes=("one full iCD epoch; cross-shard traffic = k² Gram all-reduce. "
               f"Port: one rank's explicit mf_dist.build_epoch (gather "
               f"variant) over one flat ('shards',) mesh of all {d} ranks, "
               f"not a pjit mf.epoch under GSPMD: a rank makes 2 k² "
               f"all-reduces, 2k column all-gathers and 2 residual "
               f"all-to-alls; W {c_per} and H {i_per} rows a rank; the nnz "
               f"block balanced, ⌈nnz/D⌉ = {p} a side, the routing blocks "
               f"⌈{p}/D⌉ = {blk} a peer (a real log's blocks are its "
               f"fullest shard's); the Gram through row 1's kernel on the "
               f"card, its plain version on meta tensors"),
    )


def _icd_cell(arch: str, shape_spec, mesh, cfg) -> Cell:
    if shape_spec.kind == "retrieval":
        return _retrieval_cell(arch, shape_spec, mesh, cfg)
    return _train_cell(arch, shape_spec, mesh, cfg)


# ===========================================================================
# registry
# ===========================================================================
ICD_ARCHS = ("icd-mf",)


def all_cell_ids(include_icd: bool = True):
    out = []
    for arch in ICD_ARCHS if include_icd else ():
        for shape_name in get_shapes(arch):
            out.append((arch, shape_name))
    return out


def build_cell(arch: str, shape_name: str, mesh, cfg_override=None,
               probe: bool = False, shape_override=None) -> Cell:
    """The cell of (``arch``, ``shape_name``) as one rank of ``mesh``, in
    the ``torch.distributed`` world the mesh spans. ``cfg_override`` (an
    ``ICDConfig``) replaces the arch's config, which the reference
    ignores; ``probe`` is kept for the reference's signature."""
    shape_spec = shape_override or get_shapes(arch)[shape_name]
    if arch in ICD_ARCHS or arch.startswith("icd"):
        return _icd_cell(arch, shape_spec, mesh, cfg_override or get_config(arch))
    raise KeyError(arch)
