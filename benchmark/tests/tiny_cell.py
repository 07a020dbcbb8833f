"""A tiny cell for the harness's CPU tests: a copy of benchmark/ in a
temporary root with its own BENCHMARK.json, a small kitchen_stress (grid
2: 8,070 triangles, still the sorted-wavefront driver) at 16x16, and
whatever configuration, mix or metric a test adds as files."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WORKLOAD = "tiny_kitchen.tiny"
TRAFFIC = {"width": 16, "height": 16, "spp_per_call": 1, "warmup_calls": 1, "trace_calls": 2,
           "idle_calls": 2, "check_calls": 2, "check_pixels": 96}
LIMITS = {"tables_off": 0, "pixels_off_pct": 1.0}


def make_root(tmp, config: dict | None = None, traffic: dict | None = None,
              metrics: dict | None = None, workload: str = WORKLOAD) -> str:
    """A root holding BENCHMARK.json and benchmark/ with the tiny cell
    added as files: its configuration, mix and limits, and per-layer
    metrics {name: source of metrics/<name>.py}."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    conf_name, traffic_name = workload.split(".")
    if config is None:
        with open(os.path.join(REPO, "benchmark", "configs", "kitchen.json")) as f:
            config = json.load(f)
        config.update(scene_args={"grid": 2}, attr_fmt="f32")
    _write(root, f"benchmark/configs/{conf_name}.json", config)
    _write(root, f"benchmark/traffic/{traffic_name}.json", traffic or TRAFFIC)
    _write(root, f"benchmark/limits/{workload}.json", LIMITS)
    spec["configs"].append({"name": conf_name, "source": "test", "reduced": [],
                            "file": f"benchmark/configs/{conf_name}.json", "why": "test"})
    spec["workloads"].append({"name": workload, "config": conf_name, "traffic": traffic_name,
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:  # the tiny cell is a 1024-like cell
        if "kitchen.pt_1024" in m.get("workloads", []):
            m["workloads"].append(workload)
    for name, src in (metrics or {}).items():
        with open(os.path.join(root, "benchmark", "metrics", f"{name}.py"), "w") as f:
            f.write(src)
        spec["per_layer"].append({"name": name, "unit": "calls", "better": "higher",
                                  "source": "program_counter", "layer": "api pass",
                                  "moves": "msamples_per_s", "workloads": [workload]})
    _write(root, "BENCHMARK.json", spec)
    return root


def _write(root: str, rel: str, obj):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
