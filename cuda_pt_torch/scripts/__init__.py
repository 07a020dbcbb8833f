"""The repo's command-line tools on the port, one module per script of
scripts/ that drives the JAX package, under the script's name:

  python -m cuda_pt_torch.scripts.<name> [--device cpu] ...

scene_info, serial_render, analyze_rays, showcase, quality_bench,
guiding_study, compaction_sweep, sbvh_budget_sweep, packet_divergence,
profile_render and interactive_probe. Each takes the script's arguments,
defaults and output schema, with ``--device`` in place of ``--cpu``: the
tools run on CUDA unless ``--device cpu`` is given, and raise where CUDA is
absent. Their default output files go to the current directory, named as
the script's with ``_torch`` before the extension. scenes.py holds the
scenes they share.

The scripts that read the reference renderer's own scene files (whiskey,
bunny, medium-cbox) look for them in REFERENCE_XML_DIR, the directory named
by CUDA_PT_REFERENCE_XML; where it is unset there are none.
"""

from __future__ import annotations

import os

REFERENCE_XML_DIR = os.environ.get("CUDA_PT_REFERENCE_XML")


def add_device_arg(ap) -> None:
    """--device: cuda (the default; utils/timing.device_of raises where CUDA
    is absent) or cpu (the plain versions)."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: run on the CPU (the plain versions; default: CUDA)")


def reference_xml(name: str, required: bool = True) -> str | None:
    """The reference renderer's scene file name (e.g. "whiskey.xml") in
    REFERENCE_XML_DIR; where it is absent or the directory is unset,
    SystemExit naming the path (None if not required)."""
    path = os.path.join(REFERENCE_XML_DIR or "$CUDA_PT_REFERENCE_XML", name)
    if REFERENCE_XML_DIR is not None and os.path.exists(path):
        return path
    if not required:
        return None
    raise SystemExit(f"{path}: no such scene file (the reference renderer's scenes; set "
                     f"CUDA_PT_REFERENCE_XML to their directory)")

