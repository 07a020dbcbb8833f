"""cuda_pt_torch: the PyTorch + CUDA port of the cuda_pt_tpu path tracer.

The JAX package (``cuda_pt_tpu``) is the reference; this package mirrors its
layout (core/, scene/, accel/, bsdf/, emitters/, ops/, models/, api.py) and
renders the same scenes with the same estimator and the same pcg streams.
The path loop runs on the GPU through one hand-written CUDA megakernel
(``ops/megakernel.py`` + ``csrc/``); every kernel keeps a plain PyTorch
version beside it, which is what runs on CPU tensors.

Entry points: ``cuda_pt_torch.Renderer`` (api.py), ``PythonRenderer``
(pyrender.py) and ``load_xml`` (scene/xml_parser.py), imported on first
use; the viewer: ``python -m cuda_pt_torch.viewer``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level exports: `import cuda_pt_torch` imports no torch
    if name == "Renderer":
        from .api import Renderer

        return Renderer
    if name == "PythonRenderer":
        from .pyrender import PythonRenderer

        return PythonRenderer
    if name == "load_xml":
        from .scene.xml_parser import load_xml

        return load_xml
    raise AttributeError(name)
