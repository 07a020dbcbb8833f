"""Parsed-scene bundle (port of the ParsedScene type of
cuda_pt_tpu/scene/xml_parser.py). The Mitsuba XML parser itself waits for
ROADMAP Queue 1 item 6; scenes reach the Renderer as a ParsedScene built
from a compiled Scene and Camera (scene/testscenes.py, scene/bridge.py)."""

from __future__ import annotations

import dataclasses

from ..core.camera import Camera
from ..core.config import RenderingConfig
from .types import Scene


@dataclasses.dataclass
class ParsedScene:
    scene: Scene
    camera: Camera
    config: RenderingConfig
    builder: object = None


def load_xml(path: str, override_res=None) -> ParsedScene:
    raise NotImplementedError(
        f"{path}: the XML scene parser waits for ROADMAP Queue 1 item 6; "
        "pass a ParsedScene(scene, camera, RenderingConfig(...)) instead")
