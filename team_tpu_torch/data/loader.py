"""Batched host-side loader: threaded decode + transform -> NHWC numpy batches.

Replaces the reference's torch ``DataLoader(num_workers=8)`` worker processes
(reference ``models/proof.py:19,300``) with a thread-pool decode pipeline (PIL
releases the GIL during file IO/decode) and optional double-buffered prefetch so
host decode overlaps device compute.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
from PIL import Image

from team_tpu_torch.data.manager import TeamDataset
from team_tpu_torch.data.transforms import clip_transform, flip_transform, vit_train_transform


def _load_image(item) -> Image.Image:
    if isinstance(item, (str, np.str_)):
        with open(item, "rb") as f:
            with Image.open(f) as img:
                return img.convert("RGB")
    return Image.fromarray(np.asarray(item))


def _np_patch_pixels(imgs_u8: np.ndarray, patch_size: int) -> np.ndarray:
    """``[B, H, W, 3] u8`` -> ``[B, g*g, 3*ps*ps] u8`` in the torch-conv
    element order — numpy mirror of :func:`team_tpu_torch.backbone.clip.patch_pixels`
    for the PIL fallback of patch-major loading."""
    b, h, w, _ = imgs_u8.shape
    g, ps = h // patch_size, patch_size
    x = imgs_u8.reshape(b, g, ps, g, ps, 3).transpose(0, 1, 3, 5, 2, 4)
    return np.ascontiguousarray(x.reshape(b, g * g, 3 * ps * ps))


class ArrayLoader:
    """Iterates a :class:`TeamDataset` in batches of numpy arrays.

    Yields dict batches: ``image [B,H,W,3] f32``, ``label [B] i32``,
    ``stage_id [B] i32``, ``index [B] i32`` (mirroring the reference multimodal
    dict batches, ``data_manager.py:521-567``).
    """

    def __init__(self, dataset: TeamDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_threads: int = 8, image_size: int = 224,
                 prefetch: int = 2, drop_last: bool = False, use_native: bool = False,
                 augment_ops=None, pad_last: bool = False,
                 indices: Optional[np.ndarray] = None,
                 device_normalize: bool = False,
                 patch_major: bool = False, patch_size: int = 16):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        # optional row restriction, served in its order (e.g. a rank's share of
        # the feature extraction, team_tpu_torch.parallel.mesh.host_shard_indices)
        self.indices = None if indices is None else np.asarray(indices)
        self.num_threads = num_threads
        self.image_size = image_size
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.augment_ops = augment_ops  # optional op names from team_tpu_torch.data.augment
        # pad_last repeats leading samples so every batch has a fixed shape (one
        # jit compile); batches then carry a "valid" count for the consumer.
        self.pad_last = pad_last
        self._epoch = 0
        # Native C++ decode+resize+normalize fast path (native/team_io.cc): only
        # valid for path-backed datasets on the deterministic CLIP pipeline.
        # Bicubic tap weights differ slightly from PIL's adaptive-support
        # downscale filter, so it is opt-in (parity runs keep PIL).
        self._native = False
        if use_native and dataset.use_path and dataset.mode in ("test", "train", "flip") \
                and (dataset.mode != "train" or dataset.deterministic_train):
            from team_tpu_torch.data import native_io

            self._native = native_io.available()
        # device_normalize: host stops at uint8 (decode+resize only); batches
        # carry uint8 images and the /255 + CLIP-normalize runs fused on device
        # (team_tpu_torch/ops/preprocess.py via BackboneRuntime) — 4x less
        # host->device transfer and zero per-pixel host float math. Only valid
        # on the deterministic CLIP pipeline (identical f32 math either side).
        self._device_normalize = bool(
            device_normalize and not augment_ops
            and (dataset.mode in ("test", "flip")
                 or (dataset.mode == "train" and dataset.deterministic_train))
        )
        # patch_major: uint8 batches ship in the ViT patch-pixel layout
        # [B, grid^2, 3*ps^2] so the device does ZERO spatial reorder — the
        # [H, W, 3] minor-dim-3 layout is lane-hostile on TPU (docs/BENCH.md
        # round-4 ingest audit). Only active when the NATIVE loader serves:
        # the C++ resampler writes every pixel anyway, so patch-major offsets
        # are free on the host, whereas the numpy reorder of the PIL/array
        # fallback costs ~97 ms/batch on this 1-core host (measured) — far
        # more than the ~0.35 ms/batch it saves on device. The numpy reorder
        # is kept ONLY for per-batch native decode failures, so one run keeps
        # one layout (one compiled encode graph).
        self._patch_major = bool(patch_major and self._device_normalize
                                 and self._native)
        self.patch_size = patch_size

    def __len__(self) -> int:
        n = len(self.dataset) if self.indices is None else len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _transform(self, img: Image.Image, rng: Optional[np.random.Generator]) -> np.ndarray:
        mode = self.dataset.mode
        if mode == "train" and self.augment_ops and rng is not None:
            from team_tpu_torch.data.augment import random_augment

            img = random_augment(img, rng, ops=self.augment_ops)
        if mode == "flip":
            return flip_transform(img, self.image_size)
        if mode == "train" and not self.dataset.deterministic_train:
            return vit_train_transform(img, self.image_size, rng=rng, normalize=True)
        return clip_transform(img, self.image_size)

    def _make_batch(self, idxs: np.ndarray, pool, rng) -> Dict[str, np.ndarray]:
        valid = len(idxs)
        if self.pad_last and valid < self.batch_size:
            reps = -(-self.batch_size // max(valid, 1))
            idxs = np.tile(idxs, reps)[: self.batch_size]
        items = [self.dataset.images[i] for i in idxs]

        def batch_dict(imgs):
            return {
                "image": imgs,
                "label": self.dataset.labels[idxs].astype(np.int32),
                "stage_id": self.dataset.stages[idxs].astype(np.int32),
                "index": idxs.astype(np.int32),
                "valid": np.int32(valid),
            }

        if self._native:
            from team_tpu_torch.data import native_io

            flips = (np.ones(len(idxs), np.uint8) if self.dataset.mode == "flip"
                     else np.zeros(len(idxs), np.uint8))
            if self._patch_major:
                imgs, ok = native_io.load_batch_u8_patches(
                    [str(p) for p in items], self.image_size, self.patch_size,
                    hflip=flips, n_threads=self.num_threads)
            else:
                loader_fn = native_io.load_batch_u8 if self._device_normalize else native_io.load_batch
                imgs, ok = loader_fn([str(p) for p in items], self.image_size,
                                     hflip=flips, n_threads=self.num_threads)
            if ok.all():
                return batch_dict(imgs)
            # fall through to the PIL path on any decode failure

        if self._device_normalize:
            def to_u8(item):
                if (isinstance(item, np.ndarray)
                        and item.shape[:2] == (self.image_size, self.image_size)
                        and self.dataset.mode != "flip"):
                    return item  # already uint8 at target size
                img = _load_image(item).resize((self.image_size, self.image_size),
                                               Image.BICUBIC)
                if self.dataset.mode == "flip":
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
                return np.asarray(img, dtype=np.uint8)

            imgs = np.stack(list(pool.map(to_u8, items)))
            if self._patch_major:
                imgs = _np_patch_pixels(imgs, self.patch_size)
            return batch_dict(imgs)
        rngs = [np.random.default_rng(rng.integers(0, 2 ** 31)) for _ in idxs] if rng else [None] * len(idxs)

        deterministic_clip = (
            self.dataset.mode == "test"
            or (self.dataset.mode == "train" and self.dataset.deterministic_train
                and not self.augment_ops)
        )

        def work(args):
            item, r = args
            if (deterministic_clip and isinstance(item, np.ndarray)
                    and item.shape[:2] == (self.image_size, self.image_size)):
                # array already at target size: the PIL same-size bicubic resize
                # is the identity, so normalize directly (single-core host win)
                from team_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD

                return (item.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
            return self._transform(_load_image(item), r)

        imgs = list(pool.map(work, zip(items, rngs)))
        return {
            "image": np.stack(imgs).astype(np.float32),
            "label": self.dataset.labels[idxs].astype(np.int32),
            "stage_id": self.dataset.stages[idxs].astype(np.int32),
            "index": idxs.astype(np.int32),
            "valid": np.int32(valid),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset)) if self.indices is None else self.indices
        rng = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            order = rng.permutation(order)
        elif self.augment_ops or (self.dataset.mode == "train"
                                  and not self.dataset.deterministic_train):
            # stochastic pipeline iterated unshuffled (e.g. per-epoch feature
            # re-encode): augmentation draws still vary per epoch, seeded
            rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        nb = len(self)

        with concurrent.futures.ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            if self.prefetch <= 0:
                for b in range(nb):
                    yield self._make_batch(order[b * self.batch_size:(b + 1) * self.batch_size], pool, rng)
                return
            q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
            stop = object()
            # set when the consumer abandons the generator (break / exception
            # in the consuming loop): the producer must stop queueing or it
            # blocks forever on a full queue and leaks the thread + prefetch
            # batches every abandoned epoch
            cancelled = threading.Event()

            def put(item) -> bool:
                while not cancelled.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def producer():
                # a raised exception must reach the CONSUMER: a bare
                # `finally: q.put(stop)` would turn a decode crash into a
                # clean early end-of-iteration and every downstream consumer
                # (feature cache, prototypes, eval) would silently run on a
                # truncated dataset
                try:
                    for b in range(nb):
                        if cancelled.is_set():
                            return
                        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                        if not put(self._make_batch(idxs, pool, rng)):
                            return
                    put(stop)
                except BaseException as e:  # pragma: no cover - rethrown below
                    put(e)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is stop:
                        break
                    if isinstance(item, BaseException):
                        t.join()
                        raise item
                    yield item
                t.join()
            finally:
                cancelled.set()
                t.join()
