"""The params bridge between team_tpu (JAX) and team_tpu_torch: a JAX CLIP
init goes to torch and back bit for bit, and the frozen-weight cast gives
the bits of JAX's per-use ``.astype``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from team_tpu.backbone.clip import CLIPConfig, init_clip_params
from team_tpu_torch.backbone.clip import cast_frozen_params
from team_tpu_torch.bridge import params_from_numpy, params_to_numpy


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, init_clip_params(jax.random.PRNGKey(0), CLIPConfig.tiny()))


def test_clip_params_round_trip_bitwise(jax_params):
    tp = params_from_numpy(jax_params)
    back = params_to_numpy(tp)
    a, b = list(_leaves(jax_params)), list(_leaves(back))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x.view(np.uint32) if x.dtype == np.float32 else x,
                                      y.view(np.uint32) if y.dtype == np.float32 else y,
                                      err_msg=path)
    # weights keep the [in, out] layout
    assert tuple(tp["vision"]["blocks"][0]["attn"]["qkv_w"].shape) == (64, 192)


def test_frozen_cast_matches_jax_astype(jax_params):
    tp = cast_frozen_params(params_from_numpy(jax_params), torch.bfloat16, torch.device("cpu"))
    blk, tblk = jax_params["vision"]["blocks"][0], tp["vision"]["blocks"][0]
    for name in ("qkv_w", "out_w"):
        want = np.asarray(jnp.asarray(blk["attn"][name]).astype(jnp.bfloat16).astype(jnp.float32))
        got = tblk["attn"][name]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    # layer-norm affines and logit_scale stay float32, as the JAX forward uses them
    assert tblk["ln_1"]["scale"].dtype == torch.float32
    assert tp["logit_scale"].dtype == torch.float32


def test_bridge_rejects_unsupported_dtype():
    with pytest.raises(TypeError):
        params_from_numpy({"w": np.zeros(3, np.float16)})
