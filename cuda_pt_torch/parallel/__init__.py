"""Multi-process rendering on torch.distributed (port of cuda_pt_tpu/parallel)."""
