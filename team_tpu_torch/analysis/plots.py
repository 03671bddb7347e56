"""Host-side plots (counterpart of ``team_tpu/analysis/plots.py``), drawn
under ``enable_plots`` and never on the training path:

* the state-distance heatmap (the trainer, after each task);
* the t-SNE atlas of the (class, state) prototypes with lifecycle arrows
  (PROOF, after the rehearsal memory);
* each class's PCA path over its state prototypes (PROOF, at the last epoch).

matplotlib and scikit-learn are imported inside each function; a caller
logs a failure and training goes on."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

STATE_NAMES = {0: "egg", 1: "larva", 2: "pupa", 3: "nymph", 4: "adult", 5: "other"}
STATE_MARKERS = {1: "o", 2: "s", 3: "^", 4: "*", 5: "D"}


def visualize_distance_matrix(state_distance, save_path: Optional[str] = None) -> None:
    """Heatmap of ``state_distance.get_distance_matrix()`` with its values."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mat = np.asarray(state_distance.get_distance_matrix().cpu())
    n = mat.shape[0]
    fig, ax = plt.subplots(figsize=(8, 6))
    fig.colorbar(ax.imshow(mat, cmap="viridis"))
    names = [STATE_NAMES.get(i, str(i)) for i in range(n)]
    ax.set_xticks(np.arange(n), names, rotation=45)
    ax.set_yticks(np.arange(n), names)
    for i in range(n):
        for j in range(n):
            if i != j:
                ax.text(j, i, f"{mat[i, j]:.2f}", ha="center", va="center",
                        color="white" if mat[i, j] > 1.5 else "black", fontsize=6)
    ax.set_title("state distance matrix")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=150)
    plt.close(fig)


def _prototypes(buffers):
    """PROOF's ``[C, S, D]`` state prototypes and their ``[C, S]`` mask on the host."""
    return (np.asarray(buffers.proto_state.detach().float().cpu()),
            np.asarray(buffers.proto_mask.detach().cpu()) > 0)


def analyze_state_evolution(buffers, class_to_label,
                            save_dir: str = "./results/analysis") -> str:
    """t-SNE scatter of every (class, state) prototype, coloured by class and
    marked by state, with larva→adult and nymph→adult arrows; returns the
    file written (``state_evolution_tsne.png``), or "" under three points."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    os.makedirs(save_dir, exist_ok=True)
    protos, mask = _prototypes(buffers)
    points, classes, states = [], [], []
    for c in range(protos.shape[0]):
        for s in range(protos.shape[1]):
            if mask[c, s]:
                points.append(protos[c, s])
                classes.append(c)
                states.append(s)
    if len(points) < 3:
        return ""
    pts = np.stack(points)
    emb = TSNE(n_components=2, perplexity=min(30, max(2, len(pts) - 1)),
               init="pca", random_state=0).fit_transform(pts)

    fig, ax = plt.subplots(figsize=(10, 8))
    cmap = plt.cm.tab20
    for i, (c, s) in enumerate(zip(classes, states)):
        ax.scatter(emb[i, 0], emb[i, 1], color=cmap(c % 20),
                   marker=STATE_MARKERS.get(s, "o"), s=80, alpha=0.8)
    index = {(c, s): i for i, (c, s) in enumerate(zip(classes, states))}
    for c in set(classes):
        for src, dst in ((1, 4), (3, 4)):
            if (c, src) in index and (c, dst) in index:
                i, j = index[(c, src)], index[(c, dst)]
                ax.annotate("", xy=emb[j], xytext=emb[i],
                            arrowprops=dict(arrowstyle="->", alpha=0.4, color=cmap(c % 20)))
    ax.set_title("state-evolution prototype atlas (t-SNE)")
    path = os.path.join(save_dir, "state_evolution_tsne.png")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def visualize_evolution_path(buffers, save_dir: str = "./results/evolution") -> None:
    """Per class with two or more states: the PCA path over its state
    prototypes, ``class_{c}_evolution.png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.decomposition import PCA

    os.makedirs(save_dir, exist_ok=True)
    protos, mask = _prototypes(buffers)
    for c in range(protos.shape[0]):
        states = np.where(mask[c])[0]
        if len(states) < 2:
            continue
        red = PCA(n_components=2).fit_transform(protos[c, states])
        fig, ax = plt.subplots(figsize=(8, 6))
        for xy, s in zip(red, states):
            ax.scatter(xy[0], xy[1], s=100, alpha=0.8)
            ax.text(xy[0], xy[1], STATE_NAMES.get(int(s), str(s)), fontsize=11)
        for i in range(len(red) - 1):
            ax.annotate("", xy=red[i + 1], xytext=red[i],
                        arrowprops=dict(arrowstyle="->", color="blue", alpha=0.5))
        ax.set_title(f"evolution path - class {c}")
        fig.tight_layout()
        fig.savefig(os.path.join(save_dir, f"class_{c}_evolution.png"), dpi=120)
        plt.close(fig)
