"""Write cuda_pt_torch/utils/colormap_tables.npy: the plasma, jet and
viridis colormaps at 256 entries (3 x 256 x 3 float32), sampled from
matplotlib as the reference's utils/colormap.py samples them. The port
reads the file and never imports matplotlib, so a machine without it
renders the same colours.

    python tools/make_colormap_tables.py
"""

from __future__ import annotations

import os

import matplotlib
import numpy as np

N = 256
NAMES = ("plasma", "jet", "viridis")  # the reference's map ids 0, 1, 2
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cuda_pt_torch",
                   "utils", "colormap_tables.npy")


def main():
    tables = np.stack([matplotlib.colormaps[n](np.linspace(0, 1, N))[:, :3].astype(np.float32)
                       for n in NAMES])
    np.save(OUT, tables)
    print(f"wrote {OUT}: {tables.shape} {tables.dtype}")


if __name__ == "__main__":
    main()
