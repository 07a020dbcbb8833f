"""Launch the interactive viewer (port of scripts/viewer.py; the
reference's ./cpt scene.xml):

  python -m cuda_pt_torch.viewer --xml scene.xml --port 8000

then open http://127.0.0.1:8000. Renders on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse

from .server import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--xml", required=True)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--device", default=None, help="cpu: render on the CPU (default: CUDA)")
    args = ap.parse_args(argv)
    serve(args.xml, port=args.port, override_res=(args.width, args.height), device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
