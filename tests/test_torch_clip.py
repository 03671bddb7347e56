"""The port's CLIP towers and preprocess against team_tpu on the CPU.

The JAX init is carried across by the bridge and both packages get the same
numpy inputs. JAX runs ``attn_impl="xla"`` (its CPU route); the port runs
``auto`` (the packed attention wrapper, whose CPU path is the plain version)
and ``xla``. Towers agree to atol 1e-5 / rtol 1e-4 in float32: the sums run
in another order, nothing else differs. Preprocess is bit-equal at the
target size, and its resize within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.backbone import clip as jclip
from team_tpu.backbone.tokenizer import Tokenizer
from team_tpu.ops import preprocess as jpre
from team_tpu_torch.backbone import clip as tclip
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.ops import preprocess as tpre

TOL = dict(rtol=1e-4, atol=1e-5)
IMPLS = ["auto", "xla"]


def _tiny():
    return jclip.CLIPConfig.tiny(), tclip.CLIPConfig.tiny()


def _full_width_one_layer():
    # ViT-B/16 widths, heads and sequence lengths; depth cut to one block per tower
    j = jclip.CLIPConfig()
    j = dataclasses.replace(j, vision=dataclasses.replace(j.vision, layers=1),
                            text=dataclasses.replace(j.text, layers=1))
    t = tclip.CLIPConfig()
    t = dataclasses.replace(t, vision=dataclasses.replace(t.vision, layers=1),
                            text=dataclasses.replace(t.text, layers=1))
    return j, t


CONFIGS = [pytest.param(_tiny, id="tiny"), pytest.param(_full_width_one_layer, id="vitb16-1layer")]


def _both_params(jcfg):
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


# the port's fields that say what kind of tower it is (SigLIP's tower sets
# them), at open_clip's values for the CLIP configurations
PORT_ONLY = {"vision": {"gelu": "none", "ln_eps": 1e-5,
                        "mlp_width": 0, "pool": "cls_proj",
                        "pixel_mean": (0.48145466, 0.4578275, 0.40821073),
                        "pixel_std": (0.26862954, 0.26130258, 0.27577711)},
             "text_tower": True}


def _split_port_only(t, only):
    """``t`` without the keys of ``only`` (nested), and those keys' values."""
    shared, extra = {}, {}
    for k, v in t.items():
        if isinstance(only.get(k), dict):
            shared[k], extra[k] = _split_port_only(v, only[k])
        elif k in only:
            extra[k] = v
        else:
            shared[k] = v
    return shared, extra


def test_config_dataclasses_match():
    for name in ("vit_b16", "tiny"):
        shared, extra = _split_port_only(dataclasses.asdict(getattr(tclip.CLIPConfig, name)()),
                                         PORT_ONLY)
        assert dataclasses.asdict(getattr(jclip.CLIPConfig, name)()) == shared
        assert extra == PORT_ONLY
    v = tclip.CLIPConfig().vision
    assert v.seq_len == 197 and v.class_token and v.ln_pre and not v.patch_bias


def test_init_distributions_match_jax():
    cfg = tclip.CLIPConfig.tiny()
    tp = tclip.init_clip_params(torch.Generator().manual_seed(0), cfg)
    jp = jclip.init_clip_params(jax.random.PRNGKey(0), jclip.CLIPConfig.tiny())
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: t.numpy(), tp))
    for path in (("vision", "patch_w"), ("text", "token_embedding")):
        a, b = np.asarray(jp[path[0]][path[1]]), tp[path[0]][path[1]].numpy()
        assert a.shape == b.shape and b.dtype == np.float32
        assert abs(a.std() - b.std()) < 0.05 * a.std()
    assert float(tp["logit_scale"]) == pytest.approx(float(jp["logit_scale"]))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("configs", CONFIGS)
def test_encode_image_matches_jax(configs, impl):
    jcfg, tcfg = configs()
    jp, tp = _both_params(jcfg)
    s = jcfg.vision.image_size
    x = np.random.default_rng(0).standard_normal((2, s, s, 3)).astype(np.float32)
    want = np.asarray(jclip.encode_image(jp, jnp.asarray(x), jcfg, attn_impl="xla"))
    got = tclip.encode_image(tp, torch.from_numpy(x), tcfg, attn_impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_image_patches_u8_matches_jax(impl):
    jcfg, tcfg = _tiny()
    jp, tp = _both_params(jcfg)
    g2, pd = jcfg.vision.grid ** 2, 3 * jcfg.vision.patch_size ** 2
    px = np.random.default_rng(1).integers(0, 256, (3, g2, pd), dtype=np.uint8)
    want = np.asarray(jclip.encode_image_patches_u8(jp, jnp.asarray(px), jcfg, attn_impl="xla"))
    got = tclip.encode_image_patches_u8(tp, torch.from_numpy(px), tcfg, attn_impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("configs", CONFIGS)
def test_encode_text_matches_jax(configs, impl):
    jcfg, tcfg = configs()
    jp, tp = _both_params(jcfg)
    toks = Tokenizer()(["a photo of a larva", "an adult insect species 3", "egg"])
    want = np.asarray(jclip.encode_text(jp, jnp.asarray(toks), jcfg, attn_impl="xla"))
    got = tclip.encode_text(tp, torch.from_numpy(toks), tcfg, attn_impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_patch_pixels_matches_jax():
    jcfg, tcfg = _tiny()
    s = jcfg.vision.image_size
    x = np.random.default_rng(2).standard_normal((2, s, s, 3)).astype(np.float32)
    np.testing.assert_array_equal(tclip.patch_pixels(torch.from_numpy(x), tcfg).numpy(),
                                  np.asarray(jclip.patch_pixels(jnp.asarray(x), jcfg)))


@pytest.mark.parametrize("flip", [False, True])
def test_preprocess_batch_bit_equal(flip):
    u8 = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    u8[0, :16, :16] = np.arange(256, dtype=np.uint8).reshape(16, 16, 1)  # every value, every channel
    want = np.asarray(jpre.preprocess_batch(jnp.asarray(u8), 32, flip=flip))
    got = tpre.preprocess_batch(torch.from_numpy(u8), 32, flip=flip).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_patch_norm_consts_bit_equal():
    for j, t in zip(jpre.patch_norm_consts(16), tpre.patch_norm_consts(16)):
        np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j).view(np.uint32))


def test_preprocess_refuses_a_resize():
    """It refused one until fault 3.2 was repaired; a resize now returns
    team_tpu's bicubic resize (within 1e-5, tests/test_torch_preprocess.py)."""
    u8 = np.random.default_rng(4).integers(0, 256, (1, 40, 40, 3), dtype=np.uint8)
    want = np.asarray(jpre.preprocess_batch(jnp.asarray(u8), 32))
    got = tpre.preprocess_batch(torch.from_numpy(u8), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["attn_block", "mha_packed_proj", "mha_packed_tp", "pallas", "mha_short"])
def test_ported_attention_routes_match_plain(impl):
    """Every route gives the plain route's features in float32, where the
    kernels' single roundings and the plain route's agree to the sums'
    order: flash, pre-split, fused out-projection, fused sub-block (their
    plain versions on the CPU), and ``mha_packed_tp`` with no
    tensor-parallel layout registered, which runs the packed kernel, as
    team_tpu's ``fused_mha_packed_tp`` falls back (``mha_short.py:1258``)."""
    _, tcfg = _tiny()
    tp = tclip.init_clip_params(torch.Generator().manual_seed(0), tcfg)
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(tclip.encode_image(tp, images, tcfg, attn_impl=impl),
                               tclip.encode_image(tp, images, tcfg, attn_impl="xla"),
                               rtol=1e-5, atol=1e-5)
