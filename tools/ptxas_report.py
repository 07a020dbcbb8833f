"""Registers and spills per kernel instantiation of one or more checkouts'
CUDA builds, as ptxas reports them (nvcc -Xptxas -v). Card machine only
(it needs nvcc):

    python tools/ptxas_report.py [TREE ...]

TREE defaults to this checkout; another checkout (an earlier commit, say)
is unpacked under the git-ignored build/ with `git archive`. Each tree's
library is built by that tree's own ops/cuda_build.py, in a process run
from the tree; the log is read with this checkout's
cuda_build.ptxas_report. Prints one JSON line per tree: {"tree", "build_s",
"kernels": [[kernel<flags>, registers, spill store B, spill load B], ...]}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_BUILD = ("import json, time; from cuda_pt_torch.ops import cuda_build as cb; "
          "t0 = time.perf_counter(); cb.build(); "
          "print(json.dumps({'log': cb.library_path()[:-3] + '.log', "
          "'build_s': time.perf_counter() - t0}))")


def report(tree: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _BUILD], cwd=tree, capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    res = json.loads(out)
    from cuda_pt_torch.ops import cuda_build as cb

    with open(res["log"]) as f:
        rows = cb.ptxas_report(f.read())
    return {"tree": tree, "build_s": res["build_s"], "kernels": [list(r) for r in rows]}


def main() -> int:
    for tree in sys.argv[1:] or [REPO]:
        print(json.dumps(report(os.path.abspath(tree))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
