"""The readings the check's limits are set from (check.py): for one cell,
on the card, at the cell's own size, in one process,

- the program's: the window's compared calls through Renderer.render on
  each of a dozen seeds or more, judged against the reference as a run
  judges them (the lower readings);
- the control's: the reference with its state planes in bf16
  (plain_render, precision "bf16") in the program's place, against the
  reference in f32, on three seeds or more (the upper readings).

    python3 benchmark/calibrate.py --workload kitchen.pt_1024 --seeds 1-12 --control 13-15

Prints one JSON line per seed and writes them all to
chiprun_out/calibrate_<workload>.json. The benchmark's own runs never run
this.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main() -> int:
    import argparse
    import json

    import numpy as np
    import torch

    from benchmark import check, harness
    from benchmark.reference import plain_render

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="the program's seeds, e.g. 1-12")
    ap.add_argument("--control", required=True, help="the control's seeds, e.g. 13-15")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("calibrate.py runs on a CUDA card")
    dev = torch.device("cuda", 0)
    spec = harness.load_spec()
    _, cfg, traffic = harness.cell(spec, args.workload)
    spp, calls = traffic["spp_per_call"], traffic["check_calls"]
    n_pix = traffic["width"] * traffic["height"]
    r, _ = harness.make_renderer(cfg, traffic, 0, dev)
    for _ in range(traffic["warmup_calls"]):
        r.render(spp)
    prog = {}
    for seed in _seeds(args.seeds):
        r.set_seed_offset(seed)
        r.reset_out_buffer()
        pix = check.sample_pixels(seed, n_pix, traffic["check_pixels"])
        prog[seed] = (pix, [np.asarray(r.render(spp)).reshape(-1, 3)[pix]
                            for _ in range(calls)])
    tables = plain_render.scene_tables(r.scene)
    del r
    torch.cuda.empty_cache()
    rs, tables_off = plain_render.make_scene(cfg, traffic["width"], traffic["height"], dev,
                                             tables)
    rows = []
    for seed, (pix, got) in prog.items():
        t0 = time.perf_counter()
        row = {"who": "program", "seed": seed, "tables_off": tables_off,
               **check.compare(got, check.reference_means(rs, traffic, seed, pix, dev)),
               "reference_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for seed in _seeds(args.control):
        pix = check.sample_pixels(seed, n_pix, traffic["check_pixels"])
        row = {"who": "control_bf16", "seed": seed, "tables_off": 0,
               **check.compare(check.reference_means(rs, traffic, seed, pix, dev, "bf16"),
                               check.reference_means(rs, traffic, seed, pix, dev))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = os.path.join(ROOT, "chiprun_out", f"calibrate_{args.workload}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"workload": args.workload, "card": torch.cuda.get_device_name(dev),
                   "rows": rows}, f, indent=1)
    for who in ("program", "control_bf16"):
        sel = [x for x in rows if x["who"] == who]
        print(f"{who}: pixels_off_pct max {max(x['pixels_off_pct'] for x in sel)!r} min "
              f"{min(x['pixels_off_pct'] for x in sel)!r}; mean_gap_pct max "
              f"{max(x['mean_gap_pct'] for x in sel)!r} min "
              f"{min(x['mean_gap_pct'] for x in sel)!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
