"""Opcode counts of kernels in a built library's machine code (SASS), as
cuobjdump -sass prints it. Card machine only (it needs the CUDA toolkit):

    python3 tools/sass_ops.py PATTERN [PATTERN ...] [--lib LIB]

LIB defaults to the library ops/cuda_build.load() builds from this
checkout. Prints one JSON line per kernel whose mangled symbol contains a
PATTERN: {"function": name<template args>, "instructions": n, "opcodes":
{opcode: count}} (the opcode without its modifiers: HMMA, FADD, FSEL,
...).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_FUNC = re.compile(r"Function : (.+?)\s*$")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*/\*")


def start_dump(lib: str, path: str) -> subprocess.Popen:
    """Start cuobjdump -sass of lib into the file at path (the whole
    library's dump takes about 20 s); read it with opcodes_of."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    with open(path, "w") as f:
        return subprocess.Popen([tool, "-sass", lib], stdout=f, stderr=subprocess.PIPE)


def opcodes(lib: str, patterns: list) -> dict:
    """name<args> -> Counter of opcodes, for the library's kernels whose
    symbol contains one of patterns."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    return opcodes_of(out, patterns)


def opcodes_of(sass: str, patterns: list) -> dict:
    """opcodes of a cuobjdump -sass text."""
    from cuda_pt_torch.ops import cuda_build as cb

    funcs, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            cur = None
            if any(p in name for p in patterns):
                cur = funcs.setdefault(cb._demangle(name), collections.Counter())
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            words = m.group(1).split()
            op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
            cur[op.split(".")[0]] += 1
    return funcs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("patterns", nargs="+")
    ap.add_argument("--lib", default=None)
    args = ap.parse_args()
    from cuda_pt_torch.ops import cuda_build as cb

    lib = args.lib or cb.finish_build(*cb.start_build())
    for name, ops in opcodes(lib, args.patterns).items():
        print(json.dumps({"function": name, "instructions": sum(ops.values()),
                          "opcodes": dict(ops.most_common())}), flush=True)


if __name__ == "__main__":
    main()
