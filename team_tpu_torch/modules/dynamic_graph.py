"""The dynamic multimodal relation graph (counterpart of
``team_tpu/modules/dynamic_graph.py``).

* the relation modeler (the reference's ``DynamicRelationModeler``,
  ``models/dynamic_modal_graph.py:5-106``): four relation-scoring MLPs over
  every ordered node pair, the strongest score above a threshold an edge;
  every pair is scored in one pass, since each MLP is linear in
  ``[x_src ; x_dst]`` before its layer norm, so the pair tensor is the sum
  of two ``[N, H]`` products;
* ``DynamicGCN`` (``:108-163``): per layer ReLU(W x), the weighted messages
  ``h_dst += Σ_src adj[dst, src] · h_src``, a layer norm;
* the global connectivity extractor (``:165-208``): a post-LN transformer
  encoder (8 heads, 2 layers) over the nodes, mean-pooled and projected,
  its attention on the plain route
  (:func:`team_tpu_torch.ops.attention.multi_head_attention`, ``impl="xla"``);
* DMIG, which chains them (``models/proof.py:686-702``; defined and never
  instantiated there, and no learner of the port calls it either).

Functions over parameter dicts; the inits draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from team_tpu_torch.ops.attention import multi_head_attention


def _linear(gen: torch.Generator, d_in: int, d_out: int) -> Dict[str, torch.Tensor]:
    bound = d_in ** -0.5
    return {"w": (torch.rand((d_in, d_out), generator=gen) * 2 - 1) * bound,
            "b": (torch.rand((d_out,), generator=gen) * 2 - 1) * bound}


def _ln_init(d: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def _ln(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _mlp2(gen: torch.Generator, d_in: int, d_h: int, d_out: int) -> Dict:
    return {"fc1": _linear(gen, d_in, d_h), "ln": _ln_init(d_h), "fc2": _linear(gen, d_h, d_out)}


def _mlp2_fwd(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(_ln(p["ln"], x @ p["fc1"]["w"] + p["fc1"]["b"]))
    return h @ p["fc2"]["w"] + p["fc2"]["b"]


# ---------------------------------------------------------------------------
# the relation modeler
# ---------------------------------------------------------------------------

def init_relation_modeler(gen: torch.Generator, feature_dim: int, hidden_dim: int,
                          num_relations: int = 4) -> Dict:
    return {
        "relation_projectors": [_mlp2(gen, 2 * feature_dim, hidden_dim, 1)
                                for _ in range(num_relations)],
        "topology_gate": _mlp2(gen, 2 * feature_dim, hidden_dim, 1),
        "global_aggregator": _mlp2(gen, feature_dim, hidden_dim, feature_dim),
    }


def relation_graph(params: Dict, node_features: torch.Tensor,
                   node_mask: Optional[torch.Tensor] = None,
                   relation_threshold: float = 0.2
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score every ordered node pair; returns ``(adj [N, N], edge_type [N,
    N], edge_mask [N, N])``, each indexed ``[dst, src]``. The strongest of
    the relations' scores is an edge where it exceeds ``relation_threshold``;
    no self edges, none from or to a node that ``node_mask`` drops."""
    n, d = node_features.shape
    scores = []
    for proj in params["relation_projectors"]:
        w = proj["fc1"]["w"]
        src_part = node_features @ w[:d]
        dst_part = node_features @ w[d:]
        pre = src_part[:, None, :] + dst_part[None, :, :] + proj["fc1"]["b"]
        h = torch.relu(_ln(proj["ln"], pre))
        scores.append((h @ proj["fc2"]["w"] + proj["fc2"]["b"])[..., 0])  # [N_src, N_dst]
    stacked = torch.stack(scores, dim=-1)
    best, best_type = stacked.max(dim=-1)
    mask = (best > relation_threshold) & ~torch.eye(n, dtype=torch.bool, device=best.device)
    if node_mask is not None:
        keep = node_mask > 0
        mask = mask & keep[:, None] & keep[None, :]
    adj = torch.where(mask, best, torch.zeros_like(best)).T
    return adj, best_type.T, mask.T


def global_feature(params: Dict, node_features: torch.Tensor) -> torch.Tensor:
    """Mean-pooled nodes through the aggregator MLP: ``[1, D]``."""
    return _mlp2_fwd(params["global_aggregator"], node_features.mean(dim=0, keepdim=True))


# ---------------------------------------------------------------------------
# DynamicGCN
# ---------------------------------------------------------------------------

def init_dynamic_gcn(gen: torch.Generator, in_dim: int, hidden_dim: int, out_dim: int,
                     num_layers: int = 2) -> Dict:
    if num_layers == 1:
        dims: List[Tuple[int, int]] = [(in_dim, out_dim)]
    else:
        dims = ([(in_dim, hidden_dim)] + [(hidden_dim, hidden_dim)] * (num_layers - 2)
                + [(hidden_dim, out_dim)])
    return {"layers": [{"lin": _linear(gen, a, b), "ln": _ln_init(b)} for a, b in dims]}


def dynamic_gcn_forward(params: Dict, x: torch.Tensor,
                        adj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per layer ``h = ReLU(W x + b)``, ``h += adj @ h`` (``adj`` indexed
    ``[dst, src]``; None: no messages), then the layer norm."""
    for layer in params["layers"]:
        h = torch.relu(x @ layer["lin"]["w"] + layer["lin"]["b"])
        if adj is not None:
            h = h + adj @ h
        x = _ln(layer["ln"], h)
    return x


# ---------------------------------------------------------------------------
# the global connectivity extractor
# ---------------------------------------------------------------------------

def init_connectivity_extractor(gen: torch.Generator, feature_dim: int, n_heads: int = 8,
                                num_layers: int = 2) -> Dict:
    d, ff = feature_dim, feature_dim * 4

    def enc_layer():
        return {"qkv_w": torch.randn((d, 3 * d), generator=gen) * d ** -0.5,
                "qkv_b": torch.zeros(3 * d),
                "out_w": torch.randn((d, d), generator=gen) * d ** -0.5,
                "out_b": torch.zeros(d),
                "ln1": _ln_init(d),
                "ff1": _linear(gen, d, ff),
                "ff2": _linear(gen, ff, d),
                "ln2": _ln_init(d)}

    return {"layers": [enc_layer() for _ in range(num_layers)], "n_heads": n_heads,
            "output": {"lin": _linear(gen, d, d), "ln": _ln_init(d)}}


def connectivity_forward(params: Dict, node_features: torch.Tensor) -> torch.Tensor:
    """``[N, D]`` -> ``[1, D]``: the post-LN encoder layers (the layout of
    torch's ``nn.TransformerEncoderLayer``), the mean over the nodes, the
    projection and its layer norm."""
    x = node_features[None]
    heads = int(params["n_heads"])
    b, s, d = x.shape

    def split(t):
        return t.reshape(b, s, heads, d // heads).permute(0, 2, 1, 3)

    for layer in params["layers"]:
        q, k, v = (x @ layer["qkv_w"] + layer["qkv_b"]).split(d, dim=-1)
        o = multi_head_attention(split(q), split(k), split(v), s, impl="xla")
        o = o.permute(0, 2, 1, 3).reshape(b, s, d)
        x = _ln(layer["ln1"], x + o @ layer["out_w"] + layer["out_b"])
        ff = torch.relu(x @ layer["ff1"]["w"] + layer["ff1"]["b"])
        x = _ln(layer["ln2"], x + ff @ layer["ff2"]["w"] + layer["ff2"]["b"])
    out = x.mean(dim=1) @ params["output"]["lin"]["w"] + params["output"]["lin"]["b"]
    return _ln(params["output"]["ln"], out)


# ---------------------------------------------------------------------------
# DMIG
# ---------------------------------------------------------------------------

def init_dmig(gen: torch.Generator, feature_dim: int, hidden_dim: int) -> Dict:
    return {"relation_modeler": init_relation_modeler(gen, feature_dim, hidden_dim),
            "graph_network": init_dynamic_gcn(gen, feature_dim, hidden_dim, feature_dim),
            "global_extractor": init_connectivity_extractor(gen, feature_dim)}


def dmig_forward(params: Dict, features: Dict[str, torch.Tensor],
                 relation_threshold: float = 0.2) -> torch.Tensor:
    """The modal feature sets as one node list, their relation graph, the GCN
    over it, and the pooled global feature ``[1, D]``."""
    nodes = torch.cat(list(features.values()), dim=0)
    adj, _, _ = relation_graph(params["relation_modeler"], nodes,
                               relation_threshold=relation_threshold)
    return connectivity_forward(params["global_extractor"],
                                dynamic_gcn_forward(params["graph_network"], nodes, adj))
