"""Device timing and the shared command line of the micro-kernel entries
(ops/extract_ab.py, ops/lanegather.py, ops/mxuleaf.py).

Times come from CUDA events and exist only on a card: on the CPU an entry
runs its plain versions, prints their outputs and checks, and writes None
where a time would stand.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import torch


def entry_parser(description: str) -> argparse.ArgumentParser:
    """The entries' common options: --device (cuda unless cpu is asked
    for) and --reps (timed calls per measurement)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: launch the kernels; cpu: run the plain versions")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per measurement")
    return ap


def device_of(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available (pass --device cpu)")
    return torch.device(name)


def card(dev: torch.device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them; None on the
    CPU."""
    if dev.type != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


# the device sleep before each timed launch: 0.5 ms at the H100's highest SM
# clock (1.98 GHz), longer at lower clocks; it only has to outlast the host's
# launch path, so that the events bracket the device's work alone
SETTLE_CYCLES = 1_000_000


# bytes written before a cold launch (events_ms(flush=flush_buffer(dev))):
# past the H100's 50 MB L2, so that the launch finds none of its inputs there
FLUSH_BYTES = 128 << 20


def flush_buffer(device) -> torch.Tensor:
    """A buffer of FLUSH_BYTES on device, for events_ms(flush=...)."""
    return torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)


def events_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median device ms of one fn() (a kernel launch) over reps calls, after
    one warm-up call: each call starts after a device sleep of SETTLE_CYCLES
    and runs between two CUDA events. flush (flush_buffer): written before
    each sleep, outside the events, so that each call starts with its
    inputs out of L2 (a cold launch); None leaves L2 as the last call left
    it (warm)."""
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for t0, t1 in pairs:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SETTLE_CYCLES)
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return statistics.median(t0.elapsed_time(t1) for t0, t1 in pairs)
