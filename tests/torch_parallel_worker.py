"""One rank of the port's parallel tests (tests/test_torch_parallel.py): it
joins a gloo world over ``file://`` rendezvous, runs the cases the test asks
for on the CPU, and pickles each case's results for the test to compare with
team_tpu. It imports the port only, never jax or team_tpu, and says so in
its results.

Usage: python torch_parallel_worker.py <rank> <world> <init_file> <inputs.pkl> <out.pkl>
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

rank, world, init_file, in_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                             sys.argv[4], sys.argv[5])
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                  LOCAL_WORLD_SIZE=str(world))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from team_tpu_torch.parallel import collectives  # noqa: E402
from team_tpu_torch.parallel import mesh as tmesh  # noqa: E402

torch.set_num_threads(1)


def collectives_case(inp):
    """Each collective on this rank's float32 and bfloat16 values."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(inp["values"][rank]).to(dtype)
        out[str(dtype)] = {
            "gather": collectives.all_gather(x).float().numpy(),
            "gather_cols": collectives.all_gather(x, dim=-1).float().numpy(),
            **{op: collectives.all_reduce(x, op).float().numpy() for op in ("sum", "max", "min")},
            "broadcast": collectives.broadcast(x).float().numpy(),
            "dtype": str(collectives.all_gather(x).dtype)}
    return out


def clip_case(inp):
    from team_tpu_torch.losses.clip_loss import clip_loss

    img, txt, vm, scale = (torch.from_numpy(inp[k]) for k in ("img", "txt", "vm", "scale"))
    rows = tmesh.make_mesh([world], device=["cpu"]).data_rows(len(img))
    out = {}
    for local in (False, True):
        for masked in (False, True):
            a, t = img[rows].clone().requires_grad_(True), txt[rows]
            loss = clip_loss(a, t, scale, axis_name="data", local_loss=local,
                             valid_mask=vm[rows] if masked else None)
            loss.backward()
            out[(local, masked)] = (float(loss), a.grad.numpy())
    return out


def shard_case(inp):
    ctx = tmesh.make_mesh([world], device=["cpu"])
    out = {"n_data": ctx.n_data, "data_rank": ctx.data_rank}
    for n in inp["batch_sizes"]:
        tree = {"x": np.arange(n * 3, dtype=np.float32).reshape(n, 3), "y": [np.arange(n)]}
        shard, valid = ctx.shard_batch(tree)
        out[n] = (shard["x"].numpy(), shard["y"][0].numpy(), valid)
    stacked = np.arange(3 * 4 * 2, dtype=np.float32).reshape(3, 4, 2)
    out["stacked"] = ctx.shard_stacked({"x": stacked})["x"].numpy()
    out["replicated"] = ctx.replicate({"x": np.full(3, rank, np.float32)})["x"].numpy()
    n = inp["n_rows"]
    out["indices"] = tmesh.host_shard_indices(n)
    local = inp["rows"][out["indices"]]
    out["gathered"] = tmesh.allgather_host_shards(local, n)
    return out


def tp_case(inp):
    from team_tpu_torch.backbone import clip as tclip
    from team_tpu_torch.bridge import params_from_numpy
    from team_tpu_torch.ops import mha_short

    cfg = tclip.CLIPConfig.tiny()
    ctx = tmesh.make_mesh([1, world], ("data", "model"), device=["cpu"])
    params = tmesh.shard_clip_params(params_from_numpy(inp["clip"]), ctx)
    mha_short.set_tp_mesh(ctx)
    try:
        with torch.no_grad():
            img = tclip.encode_image(params, torch.from_numpy(inp["images"]), cfg,
                                     attn_impl="mha_packed_tp")
            txt = tclip.encode_text(params, torch.from_numpy(inp["tokens"]), cfg,
                                    attn_impl="mha_packed_tp")
    finally:
        mha_short.set_tp_mesh(None)
    return {"image": img.numpy(), "text": txt.numpy(), "model_rank": ctx.model_rank,
            "qkv_w_cols": params["vision"]["blocks"][0]["attn"]["qkv_w"].shape[1]}


def int8_case(inp):
    """Each rank calibrates on its own batch; the ranks build one tower and
    take one gate decision. Then the committed tower under a [1, world]
    layout, its q3i attention head-split."""
    from team_tpu_torch.backbone import clip as tclip
    from team_tpu_torch.backbone import quant
    from team_tpu_torch.bridge import params_from_numpy
    from team_tpu_torch.config import Config
    from team_tpu_torch.learners.backbone_runtime import BackboneRuntime
    from team_tpu_torch.ops import mha_short

    cfg = Config(convnet_type="clip", device=["cpu"], encoder_quant="int8_static",
                 compute_dtype="bfloat16", extras={"tiny_backbone": True})
    rt = BackboneRuntime(cfg, params=params_from_numpy(inp["clip"]))
    calib_batch, gate_batch = (torch.from_numpy(b[rank]) for b in (inp["calib"], inp["gate"]))
    local_stats, _ = rt._calib_forward(calib_batch)
    rt.encode_image(calib_batch)
    pending = rt._qvision_pending
    rt.encode_image(gate_batch)
    out = {"local_stats": local_stats, "qvision": pending, "gate_cosine": rt.gate_cosine,
           "committed": rt.int8_committed}
    clip_cfg = tclip.CLIPConfig.tiny()
    if rt.int8_committed:
        images = torch.from_numpy(inp["images"])
        whole = quant.encode_image_int8(rt._qvision, images, clip_cfg)
        ctx = tmesh.make_mesh([1, world], ("data", "model"), device=["cpu"])
        calls = []
        tp = mha_short.fused_mha_packed_q3i_tp

        def counted(*a, **k):
            calls.append(1)
            return tp(*a, **k)

        quant.fused_mha_packed_q3i_tp = counted
        mha_short.set_tp_mesh(ctx)
        try:
            split = quant.encode_image_int8(rt._qvision, images, clip_cfg)
        finally:
            mha_short.set_tp_mesh(None)
            quant.fused_mha_packed_q3i_tp = tp
        out.update(whole=whole.numpy(), split=split.numpy(), tp_calls=len(calls))
    return out


def dp_proof_case(inp):
    from team_tpu_torch.bridge import params_from_numpy
    from team_tpu_torch.config import Config
    from team_tpu_torch.data import DataManager
    from team_tpu_torch.learners import proof
    from team_tpu_torch.learners.factory import get_model
    from team_tpu_torch.learners.proof_net import trainable_leaves

    # every step's gradients as the optimizer took them (summed over the ranks)
    grads, step = [], proof.train_step

    def recorded(tr, *a, **k):
        st = step(tr, *a, **k)
        grads.append([None if p.grad is None else p.grad.detach().clone().numpy()
                      for p in trainable_leaves(tr)])
        return st

    proof.train_step = recorded

    kw = dict(inp["cfg"])
    cfg = Config(**kw, log_dir=inp["log_dir"], device=["cpu"], mesh_shape=[world])
    dm = DataManager("synthetic_insects", shuffle=True, seed=kw["seed"][0],
                     init_cls=kw["init_cls"], increment=kw["increment"],
                     **kw["extras"]["dataset_kwargs"])
    model = get_model("proof", cfg, params_from_numpy(inp["clip"]), proof_state=inp["state"])
    keeps = inp["keeps"]
    seen = []

    def keep_fn(task, epoch, kb, n_batches):
        seen.append((task, epoch, kb, n_batches))
        return keeps[(task, epoch, kb)]

    model._keep_masks_override = keep_fn
    stats = []
    model._epoch_stats_hook = lambda t, e, d: stats.append((t, e, {k: float(v) for k, v in d.items()}))
    curves = []
    for _ in range(dm.nb_tasks):
        model.incremental_train(dm)
        cnn, *_ = model.eval_task()
        model.after_task()
        curves.append(float(cnn["top1"]))
    # the frozen features outside the cache: each rank encodes its share, gathered
    test_ds = dm.get_multimodal_dataset(np.arange(dm.get_total_classnum()), source="test",
                                        mode="test")
    cached = model._dataset_features(test_ds)
    model._cacheable = lambda ds: False
    sharded = model._dataset_features(test_ds)
    proof.train_step = step
    return {"curves": curves, "stats": stats, "keep_calls": seen, "grads": grads,
            "params": [t.detach().numpy() for t in trainable_leaves(model.trainable)],
            "cache_rows": len(model._feature_cache), "cached_feats": cached,
            "sharded_feats": sharded, "labels": test_ds.labels, "stages": test_ds.stages}


def checkpoint_case(inp):
    """PROOF on a data mesh over the ranks through the trainer with a shared
    checkpoint_dir: the whole run (rank 0 saves each task), then the last
    task's file deleted and the run resumed from the file before it."""
    from team_tpu_torch.config import Config
    from team_tpu_torch.trainer import train

    def cfg(resume):
        return Config(**inp["cfg"], log_dir=inp["log_dir"], device=["cpu"], mesh_shape=[world],
                      checkpoint_dir=inp["ckpt"], resume=resume)

    keys = ("cnn_top1", "cnn_top5", "nme_top1")
    whole = train(cfg(False))
    files = sorted(os.listdir(inp["ckpt"]))
    collectives.barrier()
    if rank == 0:
        os.remove(os.path.join(inp["ckpt"], files[-1]))
    collectives.barrier()
    resumed = train(cfg(True))
    return {"files": files, **{f"whole_{k}": [float(a) for a in whole[k]] for k in keys},
            **{f"resumed_{k}": [float(a) for a in resumed[k]] for k in keys}}


CASES = {"collectives": collectives_case, "clip": clip_case, "shard": shard_case, "tp": tp_case, "int8": int8_case,
         "dp_proof": dp_proof_case, "checkpoint": checkpoint_case}


def main():
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    tmesh.maybe_init_distributed(["cpu"], init_method=f"file://{init_file}", world_size=world,
                                 rank=rank)
    out = {"describe": collectives.describe()}
    for name, inp in inputs.items():
        out[name] = CASES[name](inp)
    collectives.barrier()
    out["modules"] = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "team_tpu"))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
