"""One rank of ``tests/test_torch_card_paths.py::test_parallel_paths_on_one_card``:
``world`` ranks share card 0 (device list ``[0, 0]``), so the layout gives
gloo and host staging. It writes ``rank<r>.json``, the data-parallel run's
first gradients and the tensor-parallel features to ``out_dir``; the test
checks them. It imports the port only, never jax or team_tpu.

Usage: python torch_card_parallel_worker.py <rank> <world> <init_file> <out_dir>
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

rank, world, init, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                  LOCAL_WORLD_SIZE=str(world))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from team_tpu_torch.backbone.clip import CLIPConfig, cast_frozen_params, encode_image  # noqa: E402
from team_tpu_torch.learners.backbone_runtime import BackboneRuntime  # noqa: E402
from team_tpu_torch.ops import mha_short as ms  # noqa: E402
from team_tpu_torch.ops.preprocess import preprocess_batch  # noqa: E402
from team_tpu_torch.parallel import collectives  # noqa: E402
from team_tpu_torch.parallel.mesh import (make_mesh, maybe_init_distributed,  # noqa: E402
                                          shard_clip_params)
from card_helpers import (FLAGSHIP_BATCH, proof_config, smoke_config,  # noqa: E402
                          tp_weights_and_images, train_recording)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
devices = [0] * world
maybe_init_distributed(devices, init_method=f"file://{init}", world_size=world, rank=rank)
ms.build()
res = {}
# data parallel: PROOF over a [world] mesh through the trainer
res["dp"] = train_recording(proof_config(os.path.join(out_dir, "proof_dp"), mesh_shape=[world],
                                         device=devices),
                            os.path.join(out_dir, f"dp_grads_rank{rank}.pkl"))
# tensor parallel: the bf16 image tower under a [1, world] layout, weights split
mesh = make_mesh([1, world], ("data", "model"), device=devices)
dev = mesh.device
params, images = tp_weights_and_images()
if rank == 0:
    np.save(os.path.join(out_dir, "tp_images.npy"), images)
clip_cfg = CLIPConfig.vit_b16()
layers = clip_cfg.vision.layers
split = shard_clip_params(cast_frozen_params(params, torch.bfloat16, dev), mesh)
ms.reset_launch_counts()
ms.set_tp_mesh(mesh)
try:
    with torch.no_grad():
        x = preprocess_batch(torch.from_numpy(images).to(dev), clip_cfg.vision.image_size)
        feats = encode_image(split, x, clip_cfg, compute_dtype=torch.bfloat16,
                             attn_impl="mha_packed_tp")
        torch.cuda.synchronize()
    launches_tp = ms.fused_mha_packed_tp.launches
    np.save(os.path.join(out_dir, f"tp_image_rank{rank}.npy"), feats.float().cpu().numpy())
    assert launches_tp == layers, f"mha_packed_tp launches {launches_tp}, want one a block"
    # the int8 static3d_qi tower: calibrate, gate, then one committed encode
    qrt = BackboneRuntime(smoke_config("simplecil", "bfloat16", "", attention_impl="mha_packed_tp",
                                       encoder_quant="int8_static", device=devices),
                          params=params)
    ms.reset_launch_counts()
    for i in (0, FLAGSHIP_BATCH):
        qrt.encode_image(qrt.to_device(images[i:i + FLAGSHIP_BATCH]))
    q_feats = qrt.encode_image(qrt.to_device(images))
    torch.cuda.synchronize()
    launches_q = ms.fused_mha_packed_q3i_tp.launches
    launches_tp += ms.fused_mha_packed_tp.launches
finally:
    ms.set_tp_mesh(None)
# the same payload on one device (whole-head kernels, the CLS kernel last)
whole = qrt.encode_image(qrt.to_device(images)).double()
cos = torch.nn.functional.cosine_similarity(whole, q_feats.double(), dim=-1).min().item()
assert qrt.int8_committed and launches_q == 2 * layers and cos >= 0.99999, \
    (qrt.int8_committed, launches_q, cos)
res["int8"] = {"gate_cosine": qrt.gate_cosine, "committed": qrt.int8_committed}
res["launches"] = {"fused_mha_packed_tp": launches_tp, "fused_mha_packed_q3i_tp": launches_q}
collectives.barrier()
with open(os.path.join(out_dir, f"rank{rank}.json"), "w", encoding="utf-8") as f:
    json.dump(res, f)
torch.distributed.destroy_process_group()
