"""Kernel S1: the node-cost micro-kernel of the binary skip walk (port of
the TPU micro-kernel _node_bench_kernel, scripts/roofline.py:34, pallas_call
in _time_node_bench :116).

``node_bench`` runs n_iters serial steps of the binary walk's interior node
step per ray on binary f32 node rows (ops/traverse_kernel.pack_nodes): fetch
the node, slab-test it against [HIT_EPS, 1e30), go to ptr + 1 on a box hit at
an interior node and to the skip otherwise, wrap to 0 at the rows' slot
count; it returns per ray the sum of tn over the box hits. Timed at N and
N / 2 steps, (t(N) - t(N / 2)) / (N - N / 2) is the cost of one step of the
whole launch (the reference's c_node); over the launch's rays, the cost of
one node fetch, which with the megakernel's count_stats models a kernel's
time as its walk work. Each ray steps its own pointer; the TPU kernel
stepped a tile of rays with one pointer, which is the same walk where the
rays are equal (the reference's rays: o = (0.1, 0.2, 0.3), d = (0.5, 0.6,
0.7) on every lane).

On a CUDA tensor ``node_bench`` launches the kernel (csrc/node_bench.cu) or
raises; on a CPU tensor it runs the plain version ``node_bench_reference``,
and only there. Each launch adds one to ``LAUNCHES["node_bench"]`` (the
package's one launch dict, ops/traverse_kernel.LAUNCHES).
"""

from __future__ import annotations

import torch

from . import cuda_build
from . import intersect as isect
from . import traverse_kernel as tk

LAUNCHES = tk.LAUNCHES
LAUNCHES.setdefault("node_bench", 0)
T_BEST = 1e30  # the reference's t_best: every box in front of the ray counts
REF_O = (0.1, 0.2, 0.3)
REF_D = (0.5, 0.6, 0.7)


def reference_rays(n: int, device="cpu"):
    """The reference's rays, the same on every one of n lanes: (o, d) (n, 3)."""
    o = torch.tensor(REF_O, dtype=torch.float32, device=device).expand(n, 3).contiguous()
    d = torch.tensor(REF_D, dtype=torch.float32, device=device).expand(n, 3).contiguous()
    return o, d


def _check(nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    if nodes.dtype != torch.float32 or nodes.dim() != 2 or nodes.shape[1] != 128:
        raise ValueError("expected binary f32 node rows (R, 128) float32")
    if o.dtype != torch.float32 or o.shape != d.shape or o.dim() != 2 or o.shape[1] != 3:
        raise ValueError("expected o, d (n, 3) float32")


def node_bench_reference(nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                         n_iters: int) -> torch.Tensor:
    """Plain version: the same steps on every ray at once, in the kernel's
    operation order -> (n,) float32."""
    _check(nodes, o, d)
    slots = nodes.reshape(-1, tk.SLOT_F)
    m_pad = slots.shape[0]
    inv = 1.0 / torch.where(torch.abs(d) < 1e-8, torch.where(d < 0, -1e-8, 1e-8), d)
    ptr = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    acc = torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    for _ in range(n_iters):
        nd = slots[ptr]
        t0 = (nd[:, 0:3] - o) * inv
        t1 = (nd[:, 3:6] - o) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        box = (tn <= tf) & (tf > isect.HIT_EPS) & (tn < T_BEST)
        nxt = torch.where(box & ~(nd[:, 8] > 0.0), ptr + 1, nd[:, 6].to(torch.int64))
        ptr = torch.where(nxt >= m_pad, 0, nxt)
        acc = acc + torch.where(box, tn, 0.0)
    return acc


def node_bench(nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
               n_iters: int) -> torch.Tensor:
    """n_iters node steps per ray over binary f32 node rows (R, 128) ->
    (n,) float32: the plain version on CPU tensors, kernel S1 on CUDA ones."""
    if o.device.type == "cpu":
        return node_bench_reference(nodes, o, d, n_iters)
    _check(nodes, o, d)
    cuda_build.check_inputs(o, d, nodes)
    out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    rc = cuda_build.load().s1_node_bench(
        nodes.data_ptr(), nodes.shape[0] * tk.SLOTS, int(n_iters), o.data_ptr(), d.data_ptr(),
        out.data_ptr(), o.shape[0], torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"s1_node_bench launch failed: cudaError {rc}")
    LAUNCHES["node_bench"] += 1
    return out
