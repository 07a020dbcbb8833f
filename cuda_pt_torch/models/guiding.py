"""Neural path guiding (port of cuda_pt_tpu/models/guiding.py, flax and
optax replaced by torch.nn and torch.optim; a runnable counterpart of the
reference's NASG skeleton shaders, src/pt_impl/wavefront_pt.cu:324-474).

A small MLP (GuideNet) maps a hit's scene-normalized position and its
surface normal to a von Mises-Fisher lobe (axis, sharpness) and a
selection probability. The scatter step mixes the lobe with BSDF sampling
by one-sample MIS (path_tracer.shade_stage(guide=...)), so an untrained or
badly trained guide stays unbiased; only the variance changes.

Training data are the renderer's own (position, normal, direction,
luminance) samples (collect_samples); fit runs Adam steps on the
luminance-weighted negative log-likelihood. The network is plain
torch.nn: the reference has no kernel for it. The guide's walks
(collect_samples, the guided wavefront) run on the scene's walk, kernel K1
under traversal "pallas" on the card.

A guide is a dict {"net": GuideNet, "lo": (3,), "ext": (3,)} on the
scene's device; guide_from_numpy carries a JAX guide's weights over.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..core import math as vm

# flax's lecun_normal: a normal truncated at two standard deviations, its
# scale divided by the truncated normal's standard deviation
_TRUNC_STD = 0.87962566103423978


class GuideNet(nn.Module):
    """Dense(hidden), ReLU, Dense(hidden), ReLU, Dense(5): axis (3),
    log-sharpness, selection logit."""

    def __init__(self, hidden: int = 32, generator: torch.Generator | None = None):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(6, hidden), nn.Linear(hidden, hidden),
                                     nn.Linear(hidden, 5)])
        with torch.no_grad():  # flax Dense's init: LeCun normal kernels, zero biases
            for lin in self.layers:
                std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.layers[0](x))
        h = torch.relu(self.layers[1](h))
        return self.layers[2](h)


def init_guide(generator: torch.Generator | None = None, hidden: int = 32) -> GuideNet:
    """A fresh GuideNet on the CPU, initialised from generator."""
    return GuideNet(hidden, generator)


def lobe_params(net: GuideNet, p_norm: torch.Tensor, n: torch.Tensor):
    """(axis (B, 3) unit, kappa (B,), select_prob (B,)) from the network."""
    out = net(torch.cat([p_norm, n], dim=-1))
    axis = vm.normalize(out[..., :3] + n)  # biased toward the normal
    kappa = torch.exp(torch.clamp(out[..., 3], -2.0, 4.0)) + 1.0
    sel = torch.sigmoid(out[..., 4]) * 0.5  # the guide takes at most half the samples
    return axis, kappa, sel


def vmf_pdf(axis: torch.Tensor, kappa: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """von Mises-Fisher density on the sphere."""
    cos_t = vm.dot(axis, d)
    c = kappa / (2.0 * math.pi * (1.0 - torch.exp(-2.0 * kappa)) + 1e-9)
    return c * torch.exp(kappa * (cos_t - 1.0))


def vmf_sample(axis: torch.Tensor, kappa: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF vMF sample around axis from uniforms u2 (B, 2)."""
    w = 1.0 + torch.log(u2[..., 0] + (1.0 - u2[..., 0]) * torch.exp(-2.0 * kappa)
                        + 1e-12) / torch.clamp(kappa, min=1e-6)
    w = torch.clamp(w, -1.0, 1.0)
    r = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), w], dim=-1)
    return vm.to_world(local, axis)


def guided_mix_pdf(net: GuideNet, p_norm, n, bsdf_pdf, d) -> torch.Tensor:
    """The one-sample-MIS mixture pdf (1 - sel) bsdf + sel vmf."""
    axis, kappa, sel = lobe_params(net, p_norm, n)
    return (1.0 - sel) * bsdf_pdf + sel * vmf_pdf(axis, kappa, d)


# ---------------------------------------------------------------------------
# renderer integration (the wavefront's and the composed tracer's scatter)
# ---------------------------------------------------------------------------

def make_guide(scene, generator: torch.Generator | None = None) -> dict:
    """The guide of a scene: {"net", "lo", "ext"} on its device, the inputs
    normalized by the root box. Pass it as ``guide=`` to wavefront.render or
    path_tracer.shade_stage."""
    lo = scene.bvh.node_min[0]
    hi = scene.bvh.node_max[0]
    return {"net": init_guide(generator).to(scene.device), "lo": lo,
            "ext": torch.clamp(hi - lo, min=1e-6)}


def guide_from_numpy(tree) -> dict:
    """The port's guide from a JAX guide as numpy arrays: {"params":
    {"params": {"Dense_i": {"kernel" (in, out), "bias"}}}, "lo", "ext"}
    (each kernel becomes a weight (out, in)), on the CPU."""
    dense = tree["params"]["params"]
    hidden = int(np.asarray(dense["Dense_0"]["kernel"]).shape[1])
    net = GuideNet(hidden)
    with torch.no_grad():
        for i, lin in enumerate(net.layers):
            lin.weight.copy_(torch.tensor(np.asarray(dense[f"Dense_{i}"]["kernel"]).T))
            lin.bias.copy_(torch.tensor(np.asarray(dense[f"Dense_{i}"]["bias"])))
    return {"net": net, "lo": torch.tensor(np.asarray(tree["lo"], np.float32)),
            "ext": torch.tensor(np.asarray(tree["ext"], np.float32))}


def guide_lobe(guide: dict, p: torch.Tensor, n: torch.Tensor):
    """(axis, kappa, sel) at world positions p with normals n. A sampling
    decision: evaluated without autograd (the estimator detaches every pdf
    and sampled direction)."""
    with torch.no_grad():
        p_norm = (p.detach() - guide["lo"]) / guide["ext"]
        return lobe_params(guide["net"], p_norm, n.detach())


def collect_samples(scene, cam, md, seed: int, use_bvh: bool, spp: int = 4):
    """Training tuples from the renderer's own paths: at each primary hit
    one BSDF direction is scattered and the rest of the path traced; the
    tuple (hit position, normal, direction, path luminance) says which
    directions carried light (the reference NASG data flow). Returns
    (p, n, d, lum), spp x W x H rows each."""
    from ..bsdf import eval as bsdf_eval
    from ..core import camera as cam_mod
    from ..core import rng as prng
    from ..ops import intersect as isect
    from . import path_tracer as pt

    B = cam.width * cam.height
    lane = torch.arange(B, device=scene.device)
    live = torch.ones(B, dtype=torch.bool, device=scene.device)
    md2 = dataclasses.replace(md, max_depth=max(md.max_depth - 1, 1))
    outs = []
    with torch.no_grad():
        for i in range(spp):
            rng = prng.seed((int(seed) + i * 7919) & prng.MASK32, lane)
            o, d, rng = cam_mod.generate_rays(cam, lane, rng)
            hit = pt.closest_hit(scene, o, d, live, use_bvh)
            prim = torch.clamp(hit["prim"], min=0)
            t_safe = torch.where(hit["hit"], hit["t"], 1.0)
            p = o + t_safe[:, None] * d
            inter = isect.surface_interaction(scene.geom, prim, hit["b1"], hit["b2"], p, d)
            bid = torch.clamp(scene.objects.bsdf_id[inter["obj"]], min=0)
            ctx = bsdf_eval.make_ctx(scene, bid, inter["uv"], inter["n_s"])
            bs, rng = bsdf_eval.sample_bsdf(ctx, -d, rng)
            o2 = p + inter["n_g"] * torch.sign(vm.dot(inter["n_g"], bs["wi"], keepdim=True)) * 1e-3
            L = pt.trace_paths(scene, md2, o2, bs["wi"], rng, use_bvh)
            lum = torch.sum(L * bs["weight"], dim=-1) / 3.0
            ok = hit["hit"] & ~bs["is_delta"] & (lum > 0.0)
            outs.append((p, ctx["n"], bs["wi"], torch.where(ok, lum, 0.0)))
    return tuple(torch.cat([o[j] for o in outs]) for j in range(4))


def train_guide(scene, cam, md, seed: int = 0, use_bvh: bool = True, spp: int = 6,
                steps: int = 50, lr: float = 1e-2):
    """Init, collect and fit: returns (guide, final loss). The network is
    initialised from torch.Generator().manual_seed(seed). The defaults are
    the reference's (its slot-scene schedule: spp 6, 50 steps)."""
    guide = make_guide(scene, torch.Generator().manual_seed(int(seed)))
    p, n, d, lum = collect_samples(scene, cam, md, seed, use_bvh, spp)
    p_norm = (p - guide["lo"]) / guide["ext"]
    _, loss = fit(guide["net"], p_norm, n, d, lum, steps=steps, lr=lr)
    return guide, loss


def fit(net: GuideNet, p_norm, n, d, radiance_lum, steps: int = 100, lr: float = 1e-2):
    """Fit the lobe to the observed bright directions (luminance-weighted
    NLL) by torch.optim.Adam (optax.adam's defaults: betas 0.9 / 0.999, eps
    1e-8 outside the square root, bias correction). Trains net in place;
    returns (net, the last step's loss)."""
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    w = radiance_lum / torch.clamp(torch.mean(radiance_lum), min=1e-6)
    loss = torch.zeros(())
    for _ in range(steps):
        axis, kappa, _ = lobe_params(net, p_norm, n)
        nll = -torch.log(vmf_pdf(axis, kappa, d) + 1e-6)
        loss = torch.mean(w * nll)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return net, float(loss.detach())
