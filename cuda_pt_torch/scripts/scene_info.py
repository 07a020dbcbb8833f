"""Print a scene summary and BVH metrics (port of scripts/scene_info.py;
the reference's Scene::print(), src/impl/scene.cu:1301-1356, and its
TreeMetrics dump).

  python -m cuda_pt_torch.scripts.scene_info --xml scene.xml [--device cpu]

The scene is parsed at 8x8 and its tables placed on the device; the tree
metrics (accel/bvh_build.tree_metrics) are computed on the host. No kernel
runs.
"""

from __future__ import annotations

import argparse
import json
import os

from ..utils.timing import device_of
from . import add_device_arg


def scene_info(xml: str, device=None) -> dict:
    """The summary scene_info prints, as a dict."""
    from ..accel import bvh_build
    from ..scene import types as T
    from ..scene.xml_parser import load_xml

    ps = load_xml(xml, override_res=(8, 8))
    s = T.to_device(ps.scene, device or "cpu")
    nodes = {k: getattr(s.bvh, k).cpu().numpy()
             for k in ("node_min", "node_max", "node_skip", "node_base", "node_count")}
    md = ps.config.md
    return {
        "scene": os.path.basename(xml),
        "renderer": ps.config.renderer.value,
        "spp": ps.config.spp,
        "film": [ps.config.width, ps.config.height],
        "num_prims": int(s.geom.num_prims),
        "num_objects": int(s.objects.bsdf_id.shape[0]),
        "num_bsdfs": int(s.bsdfs.btype.shape[0]),
        "present_bsdf_types": list(s.present_bsdfs),
        "num_emitters": int(s.num_emitters),
        "has_envmap": bool(int(s.env_emitter) > 0),
        "env_importance_tables": bool(s.env_importance.enabled),
        "num_media": int(s.media.mtype.shape[0]),
        "num_textures": int(s.textures.offset.shape[0]),
        "max_depths": {"total": md.max_depth, "diffuse": md.max_diffuse,
                       "specular": md.max_specular, "transmit": md.max_transmit},
        "bvh": bvh_build.tree_metrics(nodes),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--xml", required=True)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    print(json.dumps(scene_info(args.xml, dev), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
