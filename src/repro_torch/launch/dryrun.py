"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace every
(architecture × input-shape) cell as one rank of the production meshes and
derive its roofline terms.

Each cell runs as rank 0 of a world of torch's ``fake`` backend with as
many ranks as the mesh has chips (256 on 16 × 16, 512 on 2 × 16 × 16), on
``meta`` tensors at that rank's shapes: no device allocates anything and
no byte moves, so it runs on a machine without a card. Its collectives
are counted and their payloads summed (``runtime.collectives``), its
FLOPs and bytes counted op by op (``launch.hlo_analysis``). PyTorch runs
eagerly: there is no lowering or compile step, only the trace.

Usage:
  python -m repro_torch.launch.dryrun --mesh both --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --arch icd-mf --shape epoch_youtube --mesh single
  python -m repro_torch.launch.dryrun --list

``--save-hlo X`` (any non-empty value, as the reference's) writes, beside
each cell's JSON, the op log the byte counter saw (``<tag>.ops``: one op
a line, with its bytes), in place of the reference's HLO text.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.launch import hlo_analysis
from repro_torch.launch.cells import all_cell_ids, build_cell

NO_COMPILE = ("none: PyTorch runs eagerly; the step is traced once on meta "
              "tensors (trace_s)")


def run_cell(arch: str, shape: str, multi_pod: bool, save_hlo: str = "") -> dict:
    """One cell's JSON record: the reference's keys, with ``trace_s`` for
    its ``lower_s``/``compile_s``, the rank's collective counts and
    payload bytes by kind, and what each roofline term counts."""
    from repro_torch.launch.mesh import make_production_mesh, n_chips
    from repro_torch.runtime import collectives

    with collectives.fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        cell = build_cell(arch, shape, mesh)
        result = {
            "arch": arch, "shape": shape,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "chips": n_chips(mesh), "kind": cell.kind, "notes": cell.notes,
        }
        if cell.skip:
            result["status"] = "skipped"
            result["skip_reason"] = cell.skip
            return result
        trace = hlo_analysis.trace_step(cell.step_fn, cell.abstract_args)
    roof = trace.roofline.to_dict()
    result.update(
        status="ok",
        trace_s=trace.trace_s,
        compile=NO_COMPILE,
        memory=hlo_analysis.memory_stats(cell.abstract_args, trace.outputs),
        roofline_raw=roof,
        roofline=roof,
        roofline_counted={"flops": hlo_analysis.FLOPS_COUNTED,
                          "bytes": hlo_analysis.BYTES_COUNTED,
                          "collective": hlo_analysis.COLLECTIVES_COUNTED},
        counts=trace.counts,
        bytes=trace.payload,
    )
    if save_hlo:
        with open(save_hlo, "w") as f:
            f.writelines(f"{op} {n}\n" for op, n in trace.op_log)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--save-hlo", default="",
                    help="any value: write each cell's op log beside its JSON")
    args = ap.parse_args(argv)

    cells = all_cell_ids()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    if args.list:
        for a, s in cells:
            print(f"{a} × {s}")
        return

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch, shape in cells:
        for multi_pod in meshes:
            tag = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[skip-cached] {tag}")
                    continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                res = run_cell(arch, shape, multi_pod, save_hlo=args.save_hlo and
                               os.path.join(args.out, tag + ".ops"))
            except Exception as e:  # noqa: BLE001 — record and continue
                res = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if multi_pod else "16x16",
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-3000:]}
                n_fail += 1
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            status = res["status"]
            extra = ""
            if status == "ok":
                r = res["roofline"]
                extra = (f" dominant={r['dominant']}"
                         f" compute={r['compute_s']:.3e}s"
                         f" memory={r['memory_s']:.3e}s"
                         f" coll={r['collective_s']:.3e}s"
                         f" trace={res['trace_s']:.1f}s"
                         f" collectives={res['counts']}")
            print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    print(f"[dryrun] done, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
