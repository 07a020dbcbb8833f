"""The benchmark of the PyTorch and CUDA port (cuda_pt_torch): the
harness (harness.py, entry run.py), its frozen yardstick (yardstick.py,
trace_reduce.py, check.py, reference/) and the cells' data (configs/,
traffic/, metrics/, limits/), found by the names in BENCHMARK.json."""
