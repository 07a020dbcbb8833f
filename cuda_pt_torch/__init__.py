"""cuda_pt_torch: the PyTorch + CUDA port of the cuda_pt_tpu path tracer.

The JAX package (``cuda_pt_tpu``) is the reference; this package mirrors its
layout (core/, scene/, accel/, bsdf/, emitters/, ops/, models/, api.py) and
renders the same scenes with the same estimator and the same pcg streams.
The path loop runs on the GPU through one hand-written CUDA megakernel
(``ops/megakernel.py`` + ``csrc/``); every kernel keeps a plain PyTorch
version beside it, which is what runs on CPU tensors.

Entry point: ``cuda_pt_torch.api.Renderer``.
"""
