"""Secondary classifier heads and incremental-net utilities (counterpart of
``team_tpu/modules/heads.py``).

* ``SimpleLinear`` (the reference's ``convs/linears.py:7-28``);
* the cosine head with per-class proxies and ``reduce_proxies``
  (``convs/linears.py:31-61``, ``:97-108``);
* ``SplitCosineLinear`` (``convs/linears.py:64-94``);
* weight alignment (``utils/inc_net.py:103-111``);
* the ``BiasLayer`` correction (``utils/inc_net.py:176-188``).

Functions over parameter dicts; the inits draw from an explicit
``torch.Generator``. No learner of the protocol calls them, as in team_tpu.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from team_tpu_torch.modules.linears import NEG_INF
from team_tpu_torch.utils.jmath import l2_normalize


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


def init_simple_linear(gen: torch.Generator, in_features: int, out_features: int) -> Dict:
    """Kaiming-uniform weight ``[out, in]`` (gain 1: bound sqrt(3 / in)), zero bias."""
    return {"weight": _uniform(gen, (out_features, in_features), (3.0 / in_features) ** 0.5),
            "bias": torch.zeros(out_features)}


def simple_linear_forward(params: Dict, x: torch.Tensor,
                          class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ Wᵀ + b``; columns where ``class_mask`` is 0 set to -1e30."""
    logits = x @ params["weight"].T + params["bias"]
    if class_mask is not None:
        logits = torch.where(class_mask[None, :] > 0, logits, torch.full_like(logits, NEG_INF))
    return logits


def reduce_proxies(out: torch.Tensor, nb_proxy: int) -> torch.Tensor:
    """``[B, C·P]`` proxy similarities -> ``[B, C]``: each class's proxies
    summed under their softmax weights."""
    if nb_proxy == 1:
        return out
    simi = out.reshape(out.shape[0], out.shape[1] // nb_proxy, nb_proxy)
    return (torch.softmax(simi, dim=-1) * simi).sum(dim=-1)


def init_cosine_proxy_linear(gen: torch.Generator, in_features: int, out_classes: int,
                             nb_proxy: int = 1) -> Dict:
    """Uniform(±1/sqrt(in)) ``[C·P, in]`` weight, sigma 1, ``nb_proxy`` kept as an int."""
    return {"weight": _uniform(gen, (out_classes * nb_proxy, in_features), in_features ** -0.5),
            "sigma": torch.ones(()), "nb_proxy": nb_proxy}


def cosine_proxy_forward(params: Dict, x: torch.Tensor, to_reduce: bool = True) -> torch.Tensor:
    """``sigma · cos(x, W)``, proxy-reduced when ``to_reduce``."""
    out = l2_normalize(x) @ l2_normalize(params["weight"]).T
    if to_reduce:
        out = reduce_proxies(out, int(params["nb_proxy"]))
    return params["sigma"] * out


def split_cosine_forward(old_params: Dict, new_params: Dict, sigma: torch.Tensor,
                         x: torch.Tensor, nb_proxy: int = 1) -> Dict[str, torch.Tensor]:
    """The old and new class banks' cosines, each proxy-reduced, and the
    joint logits ``sigma · reduce([old, new])``."""
    xn = l2_normalize(x)
    out1 = xn @ l2_normalize(old_params["weight"]).T
    out2 = xn @ l2_normalize(new_params["weight"]).T
    joint = reduce_proxies(torch.cat([out1, out2], dim=1), nb_proxy)
    return {"old_scores": reduce_proxies(out1, nb_proxy),
            "new_scores": reduce_proxies(out2, nb_proxy),
            "logits": sigma * joint}


def weight_align(weight: torch.Tensor, increment: int) -> torch.Tensor:
    """The last ``increment`` rows scaled so that their mean norm is the
    other rows' (a new tensor)."""
    new_norm = torch.linalg.vector_norm(weight[-increment:], dim=1)
    old_norm = torch.linalg.vector_norm(weight[:-increment], dim=1)
    gamma = old_norm.mean() / new_norm.mean()
    return torch.cat([weight[:-increment], weight[-increment:] * gamma])


def init_bias_layer() -> Dict:
    return {"alpha": torch.ones(1), "beta": torch.zeros(1)}


def bias_layer_forward(params: Dict, logits: torch.Tensor, low: int, high: int) -> torch.Tensor:
    """``alpha · logits + beta`` on the columns ``[low, high)`` (one task's
    classes), the rest as they are (a new tensor)."""
    out = logits.clone()
    out[:, low:high] = params["alpha"] * logits[:, low:high] + params["beta"]
    return out
