"""The benchmark's frozen yardstick: the card's published peaks and the
bytes a kernel has to move, from the shapes and the launch grids the trace
records. Later changes to the program do not move these numbers.

Peaks: NVIDIA's data sheet for the H100 SXM (dense rates at the 700 W
limit; the card's own power limit is recorded beside every run).
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12  # HBM3 bandwidth
PEAK_F32_S = 67e12  # float32 outside the tensor cores

# The pack tables K5 reads (the program's pack keys as they stand:
# nodes, prims, attrs, emitters, emitter prims, BSDF rows; the texture and
# envmap tables; the media row). A table absent from a pack counts 0.
PACK_KEYS = ("nodes", "prims", "attrs", "erow", "eprims", "brows",
             "uvs", "texels", "tinfo", "tdiff", "envrow", "mrow")


def k5_lane_bytes(has_media: bool, textured: bool, has_grid: bool = False,
                  tri_only: bool = True) -> tuple:
    """(bytes read, bytes written) per launched lane of the segment kernel
    K5, as its state planes stand: each lane reads planes 0-20 and the
    medium stack (5 planes with media), and in the split form the hit and
    flight planes it uses; it writes planes 0-20, the medium stack, the
    texture record (6 planes, textured) and the grid NEE record (9, grid).
    The envmap miss record (24 B on a miss) is left out, so the bound this
    gives is a lower one."""
    med = 5 if has_media else 0
    shade = 0
    if has_grid:
        shade = (10 + (0 if tri_only else 1) + 1 + (2 if textured else 0) + 1) + 5
    reads = (21 + med + shade) * 4
    writes = (21 + med + (6 if textured else 0) + (9 if has_grid else 0)) * 4
    return reads, writes


def k5_bound_s(pack_bytes: int, passes: int, lanes: list, lane_bytes: tuple) -> float:
    """The least time K5 could take over a traced stretch, by bytes: the
    pack once a pass, plus every launch's lanes times the plane bytes each
    lane reads and writes, over the peak bandwidth. Its float32 operations
    (the walk's work) are not counted: they need the walk counters, which
    the program does not expose on its main path."""
    nbytes = pack_bytes * passes + sum(lanes) * (lane_bytes[0] + lane_bytes[1])
    return nbytes / PEAK_BYTES_S
