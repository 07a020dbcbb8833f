"""Entry point of the benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload kitchen.pt_1024 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cell's CUDA
card(s). The last line of standard output is the result (harness.py);
the numbers the check compares are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the program and of torch at a fixed place inside the
# checkout, so that only a checkout's first run builds and compiles
_CACHE = os.path.join(ROOT, "build", "bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(_CACHE, "torch_kernels")
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
