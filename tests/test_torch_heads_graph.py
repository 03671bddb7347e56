"""The port's secondary heads, dynamic relation graph, DMIG, Cutout over a
batch, one class's evolution graph and the toolkit helpers against
team_tpu's (tests/test_heads_and_graph.py holds team_tpu's own).

Parameters come from team_tpu's inits and cross through the bridge
(``module_params_from_numpy``), inputs are numpy from a seed, and both
sides run on the CPU in float32: outputs agree within 1e-5 (the sums run in
another order), masks, edge types and integer results exactly. The port's
own inits draw from a ``torch.Generator``; they are held to team_tpu's
shapes and constants, not its random bits (ROADMAP fault 3.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.data import augment as jaug
from team_tpu.modules import dynamic_graph as jdg
from team_tpu.modules import heads as jheads
from team_tpu.modules import lifecycle as jlife
from team_tpu.utils import toolkit as jtool
from team_tpu_torch.bridge import module_params_from_numpy
from team_tpu_torch.data import augment as taug
from team_tpu_torch.modules import dynamic_graph as tdg
from team_tpu_torch.modules import heads as theads
from team_tpu_torch.modules import lifecycle as tlife
from team_tpu_torch.utils import toolkit as ttool

TOL = dict(atol=1e-5, rtol=1e-5)


def _bridge(tree):
    return module_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_simple_linear_matches_team_tpu(masked):
    jp = jheads.init_simple_linear(jax.random.PRNGKey(0), 8, 5)
    x = _x(0, 3, 8)
    mask = np.asarray([1, 1, 1, 0, 0], np.float32) if masked else None
    want = jheads.simple_linear_forward(jp, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    got = theads.simple_linear_forward(_bridge(jp), torch.from_numpy(x),
                                       None if mask is None else torch.from_numpy(mask))
    _close(got, want)


@pytest.mark.parametrize("nb_proxy", [1, 2, 3])
def test_reduce_proxies_and_cosine_proxy_match_team_tpu(nb_proxy):
    out = _x(1, 4, 3 * nb_proxy)
    _close(theads.reduce_proxies(torch.from_numpy(out), nb_proxy),
           jheads.reduce_proxies(jnp.asarray(out), nb_proxy))
    jp = jheads.init_cosine_proxy_linear(jax.random.PRNGKey(1), 8, 3, nb_proxy=nb_proxy)
    tp = _bridge(jp)
    assert tp["nb_proxy"] == nb_proxy and isinstance(tp["nb_proxy"], int)
    x = _x(2, 4, 8)
    for reduce in (True, False):
        _close(theads.cosine_proxy_forward(tp, torch.from_numpy(x), to_reduce=reduce),
               jheads.cosine_proxy_forward(jp, jnp.asarray(x), to_reduce=reduce))


@pytest.mark.parametrize("nb_proxy", [1, 2])
def test_split_cosine_matches_team_tpu(nb_proxy):
    old = jheads.init_cosine_proxy_linear(jax.random.PRNGKey(2), 8, 2, nb_proxy=nb_proxy)
    new = jheads.init_cosine_proxy_linear(jax.random.PRNGKey(3), 8, 3, nb_proxy=nb_proxy)
    x = _x(3, 4, 8)
    want = jheads.split_cosine_forward(old, new, jnp.asarray(1.7), jnp.asarray(x), nb_proxy)
    got = theads.split_cosine_forward(_bridge(old), _bridge(new), torch.tensor(1.7),
                                      torch.from_numpy(x), nb_proxy)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key])


def test_weight_align_and_bias_layer_match_team_tpu():
    w = np.concatenate([_x(4, 4, 8), 5.0 * _x(5, 2, 8)])
    _close(theads.weight_align(torch.from_numpy(w), 2), jheads.weight_align(jnp.asarray(w), 2))
    p = {"alpha": np.asarray([2.0], np.float32), "beta": np.asarray([1.0], np.float32)}
    logits = _x(6, 2, 6)
    _close(theads.bias_layer_forward(_bridge(p), torch.from_numpy(logits), 2, 4),
           jheads.bias_layer_forward(p, jnp.asarray(logits), 2, 4))
    init = theads.init_bias_layer()
    assert {k: v.tolist() for k, v in init.items()} == {
        k: np.asarray(v).tolist() for k, v in jheads.init_bias_layer().items()}


def test_port_inits_have_team_tpus_shapes_and_constants():
    gen = torch.Generator().manual_seed(0)
    pairs = [(theads.init_simple_linear(gen, 8, 5), jheads.init_simple_linear(jax.random.PRNGKey(0), 8, 5)),
             (theads.init_cosine_proxy_linear(gen, 8, 3, 2),
              jheads.init_cosine_proxy_linear(jax.random.PRNGKey(0), 8, 3, 2)),
             (tdg.init_dmig(gen, 16, 8), jdg.init_dmig(jax.random.PRNGKey(0), 16, 8))]
    for got, want in pairs:
        g_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda t: np.asarray(t) if isinstance(t, torch.Tensor) else t, got))
        w_leaves = jax.tree_util.tree_leaves(want)
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape
            if w.dtype.kind == "i" or (w.size > 1 and (w == w.flat[0]).all()):
                assert (g == w.flat[0]).all()  # ones, zeros, the static ints
            elif w.size > 1:  # a random draw: random in the port too
                assert g.std() > 0


# ---------------------------------------------------------------------------
# the dynamic relation graph, DynamicGCN, the connectivity extractor, DMIG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold,masked", [(-1e9, False), (0.2, False), (0.0, True), (1e9, False)])
def test_relation_graph_matches_team_tpu(threshold, masked):
    jp = jdg.init_relation_modeler(jax.random.PRNGKey(0), 8, 16)
    nodes = _x(7, 5, 8)
    mask = np.asarray([1, 1, 0, 1, 1], np.float32) if masked else None
    want = jdg.relation_graph(jp, jnp.asarray(nodes), None if mask is None else jnp.asarray(mask),
                              relation_threshold=threshold)
    got = tdg.relation_graph(_bridge(jp), torch.from_numpy(nodes),
                             None if mask is None else torch.from_numpy(mask),
                             relation_threshold=threshold)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(tdg.global_feature(_bridge(jp), torch.from_numpy(nodes)),
           jdg.global_feature(jp, jnp.asarray(nodes)))


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_dynamic_gcn_matches_team_tpu(layers):
    jp = jdg.init_dynamic_gcn(jax.random.PRNGKey(1), 8, 16, 8, num_layers=layers)
    x = _x(8, 4, 8)
    adj = np.zeros((4, 4), np.float32)
    adj[1, 0], adj[2, 3] = 0.7, 0.4
    for a in (None, adj):
        want = jdg.dynamic_gcn_forward(jp, jnp.asarray(x), None if a is None else jnp.asarray(a))
        got = tdg.dynamic_gcn_forward(_bridge(jp), torch.from_numpy(x),
                                      None if a is None else torch.from_numpy(a))
        _close(got, want)


def test_connectivity_and_dmig_match_team_tpu():
    jp = jdg.init_connectivity_extractor(jax.random.PRNGKey(2), 16)
    tp = _bridge(jp)
    assert tp["n_heads"] == 8
    nodes = _x(9, 6, 16)
    _close(tdg.connectivity_forward(tp, torch.from_numpy(nodes)),
           jdg.connectivity_forward(jp, jnp.asarray(nodes)))
    jd = jdg.init_dmig(jax.random.PRNGKey(3), 16, 8)
    feats = {"image": nodes[:3], "text": nodes[3:5], "state": nodes[5:]}
    for threshold in (-1e9, 0.2):
        want = jdg.dmig_forward(jd, {k: jnp.asarray(v) for k, v in feats.items()},
                                relation_threshold=threshold)
        got = tdg.dmig_forward(_bridge(jd), {k: torch.from_numpy(v) for k, v in feats.items()},
                               relation_threshold=threshold)
        assert got.shape == (1, 16)
        _close(got, want)


# ---------------------------------------------------------------------------
# Cutout over a batch, one class's evolution graph, the toolkit helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,lengths", [(16, 16, [4, 4]), (12, 20, [5, 8]), (9, 9, [18, 1])])
def test_cutout_square_for_team_tpus_centres(h, w, lengths):
    """team_tpu's centres (its jax.random draws for seed 0) through the
    port's mask: the same zeroed squares, clipped at the borders."""
    b = len(lengths)
    imgs = 1.0 + np.abs(_x(10, b, h, w, 3))
    want = np.asarray(jaug.cutout_batch(jnp.asarray(imgs), np.asarray(lengths), seed=0))
    ky, kx = jax.random.split(jax.random.PRNGKey(0))
    ys = torch.tensor(np.asarray(jax.random.randint(ky, (b,), 0, h)))
    xs = torch.tensor(np.asarray(jax.random.randint(kx, (b,), 0, w)))
    mask = taug.cutout_mask(h, w, ys, xs, lengths)
    got = torch.where(mask[..., None], 0.0, torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cutout_batch_draws_from_its_seed():
    imgs = torch.ones((3, 16, 16, 3))
    a, b = taug.cutout_batch(imgs, [6, 6, 6], seed=1), taug.cutout_batch(imgs, [6, 6, 6], seed=1)
    assert torch.equal(a, b) and (a == 0).any() and (a == 1).any()
    assert a.dtype == imgs.dtype and a.shape == imgs.shape


@pytest.mark.parametrize("stages,ltype", [((1, 4), 0), ((3, 4), 1), ((1, 3, 4), 1), ((4,), 2),
                                          ((1,), 0), ((1, 4), 3)])
def test_class_evolution_graph_matches_team_tpu(stages, ltype):
    mask = np.zeros(10, np.float32)
    mask[list(stages)] = 1.0
    adj, valid = tlife.class_evolution_graph(torch.from_numpy(mask), torch.tensor(ltype))
    jadj, jvalid = jlife.class_evolution_graph(jnp.asarray(mask), jnp.asarray(ltype))
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    assert bool(valid) == bool(jvalid)


def test_toolkit_helpers_match_team_tpu():
    np.testing.assert_array_equal(ttool.target2onehot([0, 2, 1], 3), jtool.target2onehot([0, 2, 1], 3))
    assert ttool.target2onehot(torch.tensor([1, 0]), 2).dtype == np.float32
    t = torch.ones(3, requires_grad=True) * 2
    np.testing.assert_array_equal(ttool.tensor2numpy(t), jtool.tensor2numpy(jnp.ones(3) * 2))
    items = [("a.jpg", 0), ("b.jpg", 1)]
    for got, want in zip(ttool.split_images_labels(items), jtool.split_images_labels(items)):
        np.testing.assert_array_equal(got, want)
