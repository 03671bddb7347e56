"""The port's Grad-CAM (team_tpu_torch/analysis/gradcam.py) against
team_tpu's, on the tiny CLIP tower with team_tpu's init carried across by
the bridge, float32: on the plain route, and on the kernel routes, where
the gradient goes through the kernels' autograd Functions (their plain
forward on the CPU, their backward rule) against team_tpu's kernels in
interpret mode through their custom VJPs. The [0, 1] maps agree within
1e-4 (the towers' sums run in another order; the packed kernel scales q
before QKᵀ, the plain route after). On the card
``tests/test_torch_card_paths.py`` holds Grad-CAM on each kernel route to
the plain route at full ViT-B/16 width."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.analysis.gradcam import grad_cam as jax_grad_cam
from team_tpu.backbone.clip import CLIPConfig, init_clip_params
from team_tpu.ops import mha_short as jms
from team_tpu_torch.analysis.gradcam import grad_cam
from team_tpu_torch.backbone.clip import CLIPConfig as TorchCLIPConfig
from team_tpu_torch.bridge import params_from_numpy

ROUTES = ["xla", "mha_packed", "mha_short", "attn_block"]


@pytest.fixture(scope="module")
def setup():
    cfg = CLIPConfig.tiny()
    jp = init_clip_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    images = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    target = rng.standard_normal((cfg.embed_dim,)).astype(np.float32)
    targets = rng.standard_normal((2, cfg.embed_dim)).astype(np.float32)
    return cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)), images, target, \
        targets


@pytest.fixture
def jax_interpret(monkeypatch):
    """team_tpu's attention kernels in interpret mode (the CPU lowers no
    compiled Pallas), as tests/test_torch_fused_block.py runs them."""
    for name in ("fused_mha_packed", "fused_mha_short", "fused_attn_block"):
        monkeypatch.setattr(jms, name, functools.partial(getattr(jms, name), interpret=True))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("per_image", [False, True])
def test_grad_cam_matches_team_tpu(setup, jax_interpret, route, per_image):
    cfg, jp, tp, images, target, targets = setup
    tgt = targets if per_image else target
    want = np.asarray(jax_grad_cam(jp, jnp.asarray(images), jnp.asarray(tgt), cfg, attn_impl=route))
    got = grad_cam(tp, torch.from_numpy(images), torch.from_numpy(tgt), TorchCLIPConfig.tiny(),
                   attn_impl=route)
    g = cfg.vision.grid
    assert got.shape == (2, g, g) and got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0 + 1e-6
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_grad_cam_on_the_flash_route_matches_the_plain_route(setup):
    """``pallas`` (#14's Function; team_tpu's flash kernel cannot lower on the
    CPU outside interpret mode, and its front end passes no interpret flag)
    against the port's own plain route, 1e-4."""
    cfg, _, tp, images, target, _ = setup
    tcfg = TorchCLIPConfig.tiny()
    want = grad_cam(tp, torch.from_numpy(images), torch.from_numpy(target), tcfg)
    got = grad_cam(tp, torch.from_numpy(images), torch.from_numpy(target), tcfg,
                   attn_impl="pallas")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_grad_cam_needs_no_grad_mode_and_leaves_the_params_alone(setup):
    cfg, _, tp, images, target, _ = setup
    with torch.no_grad():
        cam = grad_cam(tp, torch.from_numpy(images), torch.from_numpy(target),
                       TorchCLIPConfig.tiny(), attn_impl="mha_packed")
    assert not cam.requires_grad
    assert all(not t.requires_grad for t in jax.tree_util.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor)))
