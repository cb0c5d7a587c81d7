"""A toy checkout for CPU runs of the harness: a copy of ``bench/`` and
``BENCHMARK.json`` beside a ``src`` link, with each cell's configuration
cut to the port's smoke sizes (``configs/icd_mf.SMOKE_CONFIG``,
``icd_fm.SMOKE_CONFIG``) and a toy traffic mix, added as new files and new
entries the way a later cell is added.

    python3 bench/tools/toy.py DIR

Toy cells are named ``<cell>-toy`` and run with ``device="cpu"`` through
``harness.cell.run_cell`` (the kernels' plain versions). Their loss limits
are the toy's: a toy objective of ≈ 10³ reads float32's rounding of the
loss itself, ≈ 1e-8 relative (the cells' ≈ 10⁸ read ≤ 2e-10), where the
control reads ≈ 1e-4; every other limit is the cell's own."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TOY_LOSS_LIMIT = 1e-6

SMOKE = {
    "mf": dict(n_ctx=60, n_items=40, k=8),
    "fm": dict(n_ctx=50, n_items=30, k=6, p_ctx=117, p_item=30,
               context_fields=[["user", 50], ["age", 4], ["gender", 3],
                               ["prev_video", 30], ["history", 30]],
               item_fields=[["video", 30]]),
}


def make(dest: Path, root: Path = ROOT) -> list:
    """Build the toy checkout at ``dest``; returns the toy cells' names."""
    dest = Path(dest)
    shutil.copytree(root / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "src").symlink_to(root / "src")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = {}
    for entry in list(bench["configs"]):
        cfg = json.loads((root / entry["file"]).read_text())
        cfg.update(SMOKE[cfg["model"]])
        name = f"{entry['name']}-toy"
        path = f"bench/configs/{name}.json"
        (dest / path).write_text(json.dumps(cfg, indent=1))
        bench["configs"].append(dict(entry, name=name, file=path))
    for entry in list(bench["workloads"]):
        mix = f"{entry['traffic']}-toy"
        if mix not in traffic:
            t = json.loads((root / "bench/traffic" / f"{entry['traffic']}.json").read_text())
            t["log"].update(min_degree=3, mean_excess=5)
            t["context_fields"] = {k: v for k, v in t["context_fields"].items()
                                   if k in ("user", "age", "gender", "prev_video", "history")}
            traffic[mix] = t
            (dest / "bench/traffic" / f"{mix}.json").write_text(json.dumps(t, indent=1))
        name = f"{entry['name']}-toy"
        wl = json.loads((root / "bench/workloads" / f"{entry['name']}.json").read_text())
        wl["checks"] = {k: TOY_LOSS_LIMIT if k.startswith("loss_gap") else v
                        for k, v in wl["checks"].items()}
        (dest / "bench/workloads" / f"{name}.json").write_text(json.dumps(wl, indent=1))
        bench["workloads"].append(dict(entry, name=name, traffic=mix,
                                       config=f"{entry['config']}-toy"))
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if entry["name"] in metric.get("workloads", []):
                metric["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    cells = json.loads((root / "BENCHMARK.json").read_text())["workloads"]
    return [f"{w['name']}-toy" for w in cells]


if __name__ == "__main__":
    print(make(Path(sys.argv[1])))
