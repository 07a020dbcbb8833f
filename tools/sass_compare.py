"""Compare the machine code (SASS) of the trace kernel's instantiations in
two builds of csrc/megakernel.cu.

    python3 tools/sass_compare.py LIB_A LIB_B

LIB_A and LIB_B are built libraries (build/cuda_pt_torch/libmegakernel_*.so
of two checkouts; tools/ab_main_path.py builds one per tree). Runs
cuobjdump -sass on each and, for every trace_kernel instantiation present
in both (keyed by its K3 / ALL / MED template flags; a build without the
MED flag counts as MED = false), and for every other function both hold
under one symbol, prints one line: the instruction count of each, how
many instructions differ position by position, and how many still differ
once constant-bank offsets (c[0x0][...], the kernel parameters) and branch
targets are masked. Needs the CUDA toolkit's
cuobjdump.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

_FUNC = re.compile(r"Function : (.+?)\s*$")
_FLAGS = re.compile(r"trace_kernel\w*?I((?:Lb[01]E)+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*/\*")
_DEMANGLED = re.compile(r"trace_kernel<(\w+), (\w+)(?:, (\w+))?>")
_CBANK = re.compile(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]")
_TARGET = re.compile(r"`?\(?\.L_x_\d+\)?|0x[0-9a-f]+")
_BRANCH = ("BRA", "BRX", "BSSY", "CALL", "JMP", "JMX", "RET", "SSY", "PBK", "BREAK", "WARPSYNC")


def _cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(path):
        raise SystemExit("cuobjdump not found: run where the CUDA toolkit is")
    return path


def _flags(name: str):
    """(K3, ALL, MED) of a trace_kernel symbol, mangled or not; else None."""
    f = _FLAGS.search(name)
    if f:
        flags = tuple(int(b) for b in re.findall(r"Lb([01])E", f.group(1)))
    else:
        f = _DEMANGLED.search(name)
        if not f:
            return None
        flags = tuple(int(v == "true") for v in f.groups() if v is not None)
    return flags + (0,) * (3 - len(flags))


def _mask(insn: str) -> str:
    """The instruction with kernel-parameter offsets and, for a branch,
    its target masked."""
    insn = _CBANK.sub("C", insn)
    op = insn.split()[1] if insn.startswith("@") and len(insn.split()) > 1 else insn.split()[0]
    return _TARGET.sub("T", insn) if op.split(".")[0] in _BRANCH else insn


def trace_kernels(lib: str) -> dict:
    """(K3, ALL, MED) -> the instruction lines of that trace_kernel; every
    other function under its symbol (name#2, ... for a symbol that several
    modules of the library hold)."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name, body = {}, None, []
    for line in out.splitlines() + ["Function : <end>"]:
        m = _FUNC.search(line)
        if m:
            if name is not None:
                key = _flags(name) or name
                n = sum(1 for k in funcs if k == key or str(k).startswith(f"{key}#"))
                funcs[key if n == 0 else f"{key}#{n + 1}"] = body
            name, body = m.group(1), []
            continue
        m = _INSN.search(line)
        if m and name is not None:
            body.append(m.group(1))
    return funcs


def main():
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    a, b = (trace_kernels(p) for p in sys.argv[1:])
    common = set(a) & set(b)
    for key in sorted(k for k in common if isinstance(k, tuple)) + sorted(
            k for k in common if isinstance(k, str)):
        ia, ib = a[key], b[key]
        n = min(len(ia), len(ib))
        raw = sum(x != y for x, y in zip(ia, ib)) + abs(len(ia) - len(ib))
        masked = sum(_mask(x) != _mask(y) for x, y in zip(ia[:n], ib[:n])) + abs(len(ia) - len(ib))
        if isinstance(key, tuple):
            name = "trace_kernel " + ("+".join(f for f, on in zip(("K3", "ALL", "MED"), key) if on)
                                      or "K2")
        else:
            name = key
        print(f"{name}: {len(ia)} vs {len(ib)} instructions, {raw} differ, "
              f"{masked} differ with parameter offsets and branch targets masked", flush=True)
    only = sorted(str(k) for k in set(a) ^ set(b))
    if only:
        print(f"in one build only: {only}", flush=True)


if __name__ == "__main__":
    main()
