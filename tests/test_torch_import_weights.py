"""The port's open_clip loader and the runtime's checkpoint path (ROADMAP item
1.2, fault 3.8) against team_tpu on the CPU.

No checkpoint is downloaded: each test builds a synthetic open_clip-format
state dict at the tiny config (every array drawn from a seeded numpy
generator, so no two entries share values and a swapped or untransposed
leaf shows) and saves it as ``.npz`` or ``.pt``. Tolerances: the loaded
trees equal team_tpu's leaf by leaf, bit for bit (team_tpu's carried
across by the bridge); the runtimes' float32 encodes as in
tests/test_torch_clip.py (atol 1e-5, rtol 1e-4: sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.backbone import import_weights as jiw
from team_tpu.backbone import tokenizer as jtok
from team_tpu.backbone.clip import CLIPConfig as JCLIPConfig
from team_tpu_torch.backbone import import_weights as tiw
from team_tpu_torch.backbone import tokenizer as ttok
from team_tpu_torch.backbone.clip import CLIPConfig
from team_tpu_torch.bridge import params_from_numpy
from team_tpu_torch.config import Config
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime

TOL = dict(rtol=1e-4, atol=1e-5)


def openclip_shapes(cfg) -> dict:
    """The key and shape of every array that ``convert_openclip_state_dict``
    reads from an open_clip checkpoint of ``cfg``'s towers (a
    ``team_tpu_torch`` ``CLIPConfig``)."""
    v, t = cfg.vision, cfg.text

    def blocks(prefix: str, layers: int, w: int) -> dict:
        shapes = {}
        for i in range(layers):
            p = f"{prefix}{i}."
            shapes.update({
                p + "ln_1.weight": (w,), p + "ln_1.bias": (w,),
                p + "attn.in_proj_weight": (3 * w, w), p + "attn.in_proj_bias": (3 * w,),
                p + "attn.out_proj.weight": (w, w), p + "attn.out_proj.bias": (w,),
                p + "ln_2.weight": (w,), p + "ln_2.bias": (w,),
                p + "mlp.c_fc.weight": (4 * w, w), p + "mlp.c_fc.bias": (4 * w,),
                p + "mlp.c_proj.weight": (w, 4 * w), p + "mlp.c_proj.bias": (w,)})
        return shapes

    return {
        "visual.conv1.weight": (v.width, 3, v.patch_size, v.patch_size),
        "visual.class_embedding": (v.width,),
        "visual.positional_embedding": (v.seq_len, v.width),
        "visual.ln_pre.weight": (v.width,), "visual.ln_pre.bias": (v.width,),
        **blocks("visual.transformer.resblocks.", v.layers, v.width),
        "visual.ln_post.weight": (v.width,), "visual.ln_post.bias": (v.width,),
        "visual.proj": (v.width, cfg.embed_dim),
        "token_embedding.weight": (t.vocab_size, t.width),
        "positional_embedding": (t.context_length, t.width),
        **blocks("transformer.resblocks.", t.layers, t.width),
        "ln_final.weight": (t.width,), "ln_final.bias": (t.width,),
        "text_projection": (t.width, cfg.embed_dim),
        "logit_scale": (),
    }


def _state_dict(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(shape) * 0.05).astype(np.float32)
          for k, shape in openclip_shapes(CLIPConfig.tiny()).items()}
    for k in sd:
        if k.endswith(("ln_1.weight", "ln_2.weight")):
            sd[k] += 1.0
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07), dtype=np.float32)
    return sd


def _save(sd: dict, path, fmt: str) -> str:
    if fmt == "npz":
        np.savez(path, **sd)
    else:  # a data-parallel save: wrapped in "state_dict", keys under "module."
        torch.save({"state_dict": {"module." + k: torch.from_numpy(v) for k, v in sd.items()}},
                   path)
    return str(path)


def _flat(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, treedef


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_loaded_tree_equals_team_tpu(tmp_path, fmt):
    path = _save(_state_dict(), tmp_path / f"clip.{fmt}", fmt)
    want = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jiw.load_clip_checkpoint(path, JCLIPConfig.tiny())))
    got = tiw.load_clip_checkpoint(path, CLIPConfig.tiny())
    (wl, wd), (gl, gd) = _flat(want), _flat(got)
    assert wd == gd and len(gl) == 62
    for w, g in zip(wl, gl):
        assert g.dtype == torch.float32 and g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)


def test_loaded_tree_has_the_layout_of_the_random_init(tmp_path):
    """The tree is the one ``init_clip_params`` returns: same keys, shapes and
    dtypes, weights in [in, out]."""
    got = tiw.load_clip_checkpoint(_save(_state_dict(), tmp_path / "c.npz", "npz"),
                                   CLIPConfig.tiny())
    from team_tpu_torch.backbone.clip import init_clip_params

    init = init_clip_params(torch.Generator().manual_seed(0), CLIPConfig.tiny())
    (il, idef), (gl, gdef) = _flat(init), _flat(got)
    assert idef == gdef
    assert [(t.shape, t.dtype) for t in il] == [(t.shape, t.dtype) for t in gl]


def test_load_state_dict_unwraps_and_strips_module(tmp_path):
    sd = _state_dict(1)
    got = tiw.load_state_dict(_save(sd, tmp_path / "c.pt", "pt"))
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k], v)


def _configs(**extras):
    kw = dict(convnet_type="clip", compute_dtype="float32", attention_impl="xla",
              extras={"tiny_backbone": True, **extras})
    from team_tpu.config import Config as JConfig

    return JConfig(**kw), Config(device=["cpu"], **kw)


def _no_bpe(monkeypatch, tmp_path):
    """Point both tokenizers' BPE search at a file that does not exist."""
    missing = (str(tmp_path / "no_bpe_vocab.txt.gz"),)
    monkeypatch.setattr(jtok, "DEFAULT_BPE_PATHS", missing)
    monkeypatch.setattr(ttok, "DEFAULT_BPE_PATHS", missing)


def test_runtime_under_the_checkpoint_encodes_as_team_tpu(tmp_path, monkeypatch):
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime

    _no_bpe(monkeypatch, tmp_path)
    monkeypatch.setenv("TEAM_CLIP_CHECKPOINT", _save(_state_dict(2), tmp_path / "c.npz", "npz"))
    jcfg, tcfg = _configs(allow_byte_tokenizer=True)
    jrt, rt = JaxRuntime(jcfg), BackboneRuntime(tcfg)
    u8 = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_allclose(rt.encode_image(torch.from_numpy(u8)).numpy(),
                               np.asarray(jrt.encode_image(jnp.asarray(u8))), **TOL)
    prompts = ["a photo of a larva.", "a photo of an adult beetle."]
    np.testing.assert_allclose(rt.encode_texts(prompts).numpy(),
                               np.asarray(jrt.encode_texts(prompts)), **TOL)
    # an explicit tree still wins over the variable (the bridge tests pass one)
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, jrt.params))
    init["logit_scale"] = torch.tensor(1.5)
    assert float(BackboneRuntime(tcfg, params=init).logit_scale) == 1.5


@pytest.mark.parametrize("allow", [False, True])
def test_require_bpe_as_team_tpu(tmp_path, monkeypatch, allow):
    """With a checkpoint file and no BPE vocabulary, both runtimes raise
    FileNotFoundError, or with allow_byte_tokenizer both fall back to the byte
    tokenizer; without a checkpoint file both take the byte tokenizer."""
    from team_tpu.learners.backbone_runtime import BackboneRuntime as JaxRuntime

    _no_bpe(monkeypatch, tmp_path)
    jcfg, tcfg = _configs(allow_byte_tokenizer=allow)
    monkeypatch.setenv("TEAM_CLIP_CHECKPOINT", str(tmp_path / "absent.npz"))
    assert isinstance(JaxRuntime(jcfg).tokenizer, jtok.ByteTokenizer)
    assert isinstance(BackboneRuntime(tcfg).tokenizer, ttok.ByteTokenizer)
    monkeypatch.setenv("TEAM_CLIP_CHECKPOINT", _save(_state_dict(), tmp_path / "c.npz", "npz"))
    if allow:
        assert isinstance(JaxRuntime(jcfg).tokenizer, jtok.ByteTokenizer)
        assert isinstance(BackboneRuntime(tcfg).tokenizer, ttok.ByteTokenizer)
    else:
        with pytest.raises(FileNotFoundError):
            JaxRuntime(jcfg)
        with pytest.raises(FileNotFoundError):
            BackboneRuntime(tcfg)


def test_pickled_objects_beside_the_weights_load_only_in_team_tpu(tmp_path):
    """team_tpu unpickles the whole file (``weights_only=False``); the port
    loads tensors only (``weights_only=True``) and refuses a file that
    pickles another object beside them."""
    import argparse
    import pickle

    sd = _state_dict(4)
    path = str(tmp_path / "c.pt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": argparse.Namespace(lr=0.1)}, path)
    got = jiw.load_state_dict(path)
    assert sorted(got) == sorted(sd)
    with pytest.raises(pickle.UnpicklingError):
        tiw.load_state_dict(path)
