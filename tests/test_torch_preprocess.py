"""The port's preprocess against team_tpu on the CPU: the bicubic resize of
``preprocess_batch`` (fault 3.2), and the one-pass u8 normalize (kernel #26's
plain version) against ``normalize_uint8_kernel(interpret=True)``.

Tolerances: the resize 1e-5 absolute on the normalised output (the port
contracts in full float32; XLA's CPU contraction and its fused weight
arithmetic round elsewhere, ~1e-6 at these sizes); its weight matrices 1e-6
of ``compute_weight_mat`` (XLA contracts the Keys polynomial into FMAs); the
normalize bit for bit over every u8 value of every channel; the runtime's
encode of a 48x40 dataset through the resize against team_tpu's 1e-4
absolute, 1e-4 relative (float32 towers, the 1e-5 inputs' difference carried
through two blocks); the target-size path stays bit for bit
(tests/test_torch_clip.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from team_tpu.ops import preprocess as jpre
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
from team_tpu_torch.ops import preprocess as tpre

RESIZE_TOL = 1e-5


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape,size", [((2, 16, 16, 3), 32), ((2, 48, 40, 3), 32),
                                        ((2, 32, 20, 3), 32), ((1, 12, 56, 3), 24)],
                         ids=["up16to32", "down48x40to32", "width_only", "up_and_down"])
def test_resize_matches_team_tpu(shape, size, flip):
    u8 = _u8(shape, seed=sum(shape))
    want = np.asarray(jpre.preprocess_batch(jnp.asarray(u8), size, flip=flip))
    got = tpre.preprocess_batch(torch.from_numpy(u8), size, flip=flip).numpy()
    assert got.dtype == np.float32 and got.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("in_size,out_size", [(16, 32), (48, 32), (40, 32), (256, 224), (32, 224)])
def test_resize_weights_match_compute_weight_mat(in_size, out_size):
    want = np.asarray(jscale.compute_weight_mat(in_size, out_size, jnp.float32(out_size / in_size),
                                                jnp.float32(0.0), jscale._fill_keys_cubic_kernel,
                                                True))
    got = tpre.resize_weights(in_size, out_size).numpy()
    assert got.dtype == np.float32 and got.shape == (in_size, out_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resize_is_not_torch_bicubic():
    """ROADMAP 3.2: F.interpolate's bicubic (a = -0.75, no antialias) is
    another filter; the port's resize is team_tpu's, not torch's."""
    u8 = _u8((1, 48, 40, 3), seed=7)
    x = torch.from_numpy(u8).float() / 255.0
    port = tpre.resize_bicubic(x, 32, 32)
    torch_bicubic = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(32, 32), mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(x.numpy()), (1, 32, 32, 3), "bicubic"))
    assert np.abs(port.numpy() - want).max() <= 1e-6
    assert np.abs(torch_bicubic.numpy() - want).max() > 1e-2


def test_normalize_plain_version_is_bit_equal_to_the_pallas_kernel():
    u8 = np.zeros((2, 16, 16, 3), dtype=np.uint8)
    u8[0] = np.arange(256, dtype=np.uint8).reshape(16, 16, 1)  # every value in every channel
    u8[1] = _u8((16, 16, 3), seed=3)
    want = np.asarray(jpre.normalize_uint8_kernel(jnp.asarray(u8), interpret=True))
    for fn in (tpre.normalize_uint8_plain, tpre.normalize_uint8_kernel):
        got = fn(torch.from_numpy(u8)).numpy()
        assert got.dtype == np.float32 and got.shape == u8.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_normalize_and_preprocess_keep_their_own_arithmetic():
    """The kernel's reciprocal of std comes from float64, preprocess_batch's
    from float32: each is bit-equal to its own team_tpu function, and the two
    differ by a few ulp on some values (so neither stands in for the other)."""
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    kernel = tpre.normalize_uint8_plain(torch.from_numpy(u8)).numpy()
    batch = tpre.preprocess_batch(torch.from_numpy(u8), 16).numpy()
    np.testing.assert_array_equal(
        batch.view(np.uint32), np.asarray(jpre.preprocess_batch(jnp.asarray(u8), 16)).view(np.uint32))
    differ = kernel.view(np.uint32) != batch.view(np.uint32)
    assert differ.any() and np.abs(kernel - batch).max() < 5e-7


def test_normalize_wrapper_rejects_what_it_does_not_take():
    with pytest.raises(TypeError):
        tpre.normalize_uint8_kernel(torch.zeros((1, 4, 4, 3), dtype=torch.float32))
    with pytest.raises(ValueError):
        tpre.normalize_uint8_kernel(torch.zeros((1, 4, 4, 4), dtype=torch.uint8))
    assert tpre.normalize_uint8_kernel.launches == 0  # the CPU path launches nothing


def test_runtime_encodes_a_dataset_of_another_size_as_team_tpu():
    """A dataset whose img_size (48x40) differs from the tower's (32): the
    port's runtime raised here before; it now resizes as team_tpu's does and
    encodes the same features (float32 towers, JAX init carried across)."""
    from team_tpu.config import Config as JConfig
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime

    kw = dict(convnet_type="clip", compute_dtype="float32", attention_impl="xla",
              extras={"tiny_backbone": True})
    jrt = JaxRuntime(JConfig(**kw))
    rt = BackboneRuntime(Config(device=["cpu"], **kw),
                         params=params_from_numpy(jax.tree_util.tree_map(np.asarray, jrt.params)))
    u8 = _u8((4, 48, 40, 3), seed=11)
    want = np.asarray(jrt.encode_image(jnp.asarray(u8)))
    got = rt.encode_image(torch.from_numpy(u8)).numpy()
    assert got.shape == want.shape == (4, rt.out_dim)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
