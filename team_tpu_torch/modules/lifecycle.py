"""Lifecycle-model secondary paths (counterpart of ``team_tpu/modules/lifecycle.py``).

The live evolution path is :mod:`team_tpu_torch.modules.evolution`. Here:
one class's evolution graph, the per-transition evolution projectors (their dict is never filled in the
reference, so this path is dead there; fix mode uses it), the
evolution-trajectory simulation, the lifecycle-type detector MLP, and the
bias scaling by state similarity.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from team_tpu_torch.modules.evolution import LARVA_TO_ADULT, NYMPH_TO_ADULT
from team_tpu_torch.utils.jmath import l2_normalize


def _linear(gen: torch.Generator, d_in: int, d_out: int) -> Dict[str, torch.Tensor]:
    bound = d_in ** -0.5
    return {"w": (torch.rand((d_in, d_out), generator=gen) * 2 - 1) * bound,
            "b": (torch.rand((d_out,), generator=gen) * 2 - 1) * bound}


def init_evolution_projectors(gen: torch.Generator, feature_dim: int) -> Dict[str, Dict]:
    """Projectors of the two supported transitions, larva→adult and nymph→adult."""
    return {"1-4": _linear(gen, feature_dim, feature_dim),
            "3-4": _linear(gen, feature_dim, feature_dim)}


def class_evolution_graph(proto_mask_row: torch.Tensor, lifecycle_type: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One class's evolution edges as a dense ``[S, S]`` matrix (the
    reference's ``_build_evolution_graph``): larva→adult or nymph→adult with
    weight 1 at ``[dst, src]`` where the lifecycle type names that
    transition and the class has both stages. Returns (adj, whether an edge
    exists)."""
    s = proto_mask_row.shape[0]
    has = proto_mask_row > 0
    lifecycle_type = torch.as_tensor(lifecycle_type, device=proto_mask_row.device)
    larva_edge = (lifecycle_type == LARVA_TO_ADULT) & has[1] & has[4]
    nymph_edge = (lifecycle_type == NYMPH_TO_ADULT) & has[3] & has[4]
    adj = torch.zeros((s, s), device=proto_mask_row.device)
    adj[4, 1] = larva_edge.float()
    adj[4, 3] = nymph_edge.float()
    return adj, larva_edge | nymph_edge


def evolution_trajectory(projectors: Dict[str, Dict], src_state: int, src_feat: torch.Tensor,
                         dst_state: int = 4, num_steps: int = 10
                         ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The feature trajectory src→adult: step i moves the previous step's
    feature to ``feat + projector(feat)·(α/2)`` with α = i/(n − 1),
    re-normalized (step 0 keeps the source feature). Returns
    (``[num_steps, D]``, the αs)."""
    if dst_state != 4 or src_state not in (1, 3):
        return None
    p = projectors.get(f"{src_state}-{dst_state}")
    if p is None:
        return None
    alphas = torch.arange(num_steps, dtype=torch.float32, device=src_feat.device) / (num_steps - 1)
    feat, feats = src_feat, [src_feat]
    for i in range(1, num_steps):
        feat = l2_normalize(feat + (feat @ p["w"] + p["b"]) * (alphas[i] / 2.0), dim=None,
                            keepdim=False)
        feats.append(feat)
    return torch.stack(feats), alphas


def init_evolution_detector(gen: torch.Generator, feature_dim: int, hidden_dim: int) -> Dict:
    """Lifecycle-type detector MLP: Linear(2D→H) → LayerNorm → ReLU →
    Linear(H→3) → Softmax."""
    return {"fc1": _linear(gen, 2 * feature_dim, hidden_dim),
            "ln": {"scale": torch.ones(hidden_dim), "bias": torch.zeros(hidden_dim)},
            "fc2": _linear(gen, hidden_dim, 3)}


def evolution_detector_forward(params: Dict, feat_pair: torch.Tensor) -> torch.Tensor:
    """``[B, 2D]`` early/late-stage feature pairs -> lifecycle-type probabilities."""
    h = feat_pair @ params["fc1"]["w"] + params["fc1"]["b"]
    mu = h.mean(dim=-1, keepdim=True)
    var = h.var(dim=-1, keepdim=True, correction=0)
    h = (h - mu) * torch.rsqrt(var + 1e-5) * params["ln"]["scale"] + params["ln"]["bias"]
    return torch.softmax(torch.relu(h) @ params["fc2"]["w"] + params["fc2"]["b"], dim=-1)


def integrate_with_state_distance(projectors: Dict[str, Dict], distance_matrix: torch.Tensor,
                                  scale: float = 0.1) -> Dict[str, Dict]:
    """Scale each projector's bias by ``1 − scale·similarity`` of its
    transition's endpoints, similarity = 1 − clip(distance / max distance)."""
    sim = 1.0 - torch.clamp(distance_matrix / distance_matrix.max(), 0.0, 1.0)
    out = {}
    for name, p in projectors.items():
        src, dst = map(int, name.split("-"))
        factor = 1.0 - scale * sim[src, dst].to(p["b"].device)
        out[name] = {"w": p["w"], "b": p["b"] * factor}
    return out
