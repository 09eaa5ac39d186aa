"""Host-side data source, fixed-shape batch loader and a device prefetcher:
the counterpart of ``fdtpu/data/pipeline.py``.

* the host does only **decode + resize + box scaling**; all other
  augmentation runs on the device (``fdtpu_torch/data/augment.py``), with
  rotation there too under ``TrainConfig.rotate_device``;
* variable-length box lists become fixed-capacity padded arrays with masks;
* a background thread pipelines host decode with device compute;
* data-level fault tolerance: degenerate all-zero-box targets fall back to
  the previous index and decode failures are appended to
  ``incorrect_indices.log`` with neighbor substitution, as in fdtpu.

:class:`WIDERFaceDataSource`, :class:`BatchLoader`,
:func:`rotate_image_and_boxes` and :func:`make_synthetic_widerface` are
fdtpu's numpy code, so the same seed gives the same bytes, and
``BatchLoader(process_shard=(rank, world))`` gives a data-parallel rank its
slice of every global batch, as fdtpu's multi-process feed does. The source
decodes a JPEG through the C++ libjpeg-turbo loader
(``fdtpu_torch/native/loader.py``: DCT-scaled decode and a fixed-point
bilinear resize) wherever the loader builds and loads, and with PIL
elsewhere and for other formats: ``use_native=None`` takes fdtpu's rule,
:func:`~fdtpu_torch.native.native_available`, so the same call gives the
same bytes as fdtpu's feed. :meth:`WIDERFaceDataSource.get_batch` decodes a
batch's misses in one threaded loader call, and :class:`BatchLoader` makes
its batches through it.
:class:`DevicePrefetcher` takes an explicit device (each rank its own): on a
CUDA device it stages each batch in pinned host memory and copies it on a
side stream one batch ahead.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from fdtpu_torch.core.boxes import pad_boxes


@dataclasses.dataclass
class Batch:
    """One fixed-shape batch. ``boxes`` rows are ``[1.0, x, y, w, h]`` pixels
    in the resized frame; ``box_mask`` marks real boxes; ``sample_mask``
    marks real samples (False rows are padding in the final partial batch).
    Numpy arrays from :class:`BatchLoader`, tensors from
    :class:`DevicePrefetcher`."""

    images: np.ndarray  # (B, H, W, 3) uint8
    boxes: np.ndarray  # (B, K, 5) float32
    box_mask: np.ndarray  # (B, K) bool
    sample_mask: np.ndarray  # (B,) bool


class WIDERFaceDataSource:
    """Decode + resize one sample at a time from parsed targets."""

    def __init__(
        self,
        targets: list[dict],
        input_shape: tuple[int, int],
        box_capacity: int = 8,
        error_log: str | None = "incorrect_indices.log",
        use_native: bool | None = None,
        rotate_prob: float = 0.0,
        rotate_limit: float = 20.0,
        seed: int = 0,
        cache_decoded: bool = True,
    ):
        self.targets = targets
        self.input_shape = input_shape  # (height, width)
        self.box_capacity = box_capacity
        # Decoded-frame RAM cache: decode+resize is deterministic (the random
        # ops all run after it), so epochs >= 2 read resized uint8 frames
        # from a preallocated array. ``cache_decoded=False`` re-decodes every
        # epoch.
        self.cache_decoded = cache_decoded
        self._cache_imgs: np.ndarray | None = None
        self._cache_meta: dict[int, tuple[int, int]] = {}
        self.error_log = error_log
        # Host-side Rotate(p=0.2, limit=20) of the reference train pipeline
        # (datamodule.py:115); TrainConfig.rotate_device rotates on the card
        self.rotate_prob = rotate_prob
        self.rotate_limit = rotate_limit
        self._rng = np.random.default_rng(seed)
        if use_native is None:
            from fdtpu_torch.native import native_available

            use_native = native_available()
        self.use_native = use_native

    def _decode(self, img_path):
        """-> (img uint8 (H, W, 3), (src_w, src_h)). A JPEG through the
        native loader where ``use_native``, else PIL's bilinear resize."""
        h, w = self.input_shape
        if self.use_native and str(img_path).lower().endswith((".jpg", ".jpeg")):
            from fdtpu_torch.native import decode_resize

            return decode_resize(Path(img_path).read_bytes(), h, w)
        from PIL import Image

        img = Image.open(img_path).convert("RGB")
        size = img.size
        return np.asarray(img.resize((w, h), Image.BILINEAR), np.uint8), size

    def __len__(self) -> int:
        return len(self.targets)

    def _resolve_target(self, index: int) -> dict:
        """Degenerate all-zero-box fallback (dataset.py:97-99)."""
        target = self.targets[index]
        bbx = target["bbx"]
        if bbx.shape[0] and (bbx[:, 1:] == 0).all(axis=1).any():
            target = self.targets[index - 1]
        return target

    def _finish_sample(self, arr: np.ndarray, bbx: np.ndarray, w0: int, h0: int):
        """Decoded frame + source-frame boxes -> (img, padded boxes, mask):
        box rescale + round (dataset.py:88), host rotation, pad."""
        h, w = self.input_shape
        boxes = bbx.copy()
        if boxes.shape[0]:
            boxes[:, [1, 3]] *= w / w0
            boxes[:, [2, 4]] *= h / h0
            boxes[:, 1:] = np.round(boxes[:, 1:])  # dataset.py:88
        if boxes.shape[0] > self.box_capacity and not getattr(self, "_warned_truncate", False):
            self._warned_truncate = True
            import warnings

            warnings.warn(
                f"image has {boxes.shape[0]} boxes but box_capacity="
                f"{self.box_capacity}; extra ground truth is dropped. "
                "Raise box_capacity.",
                stacklevel=2,
            )
        if self.rotate_prob and self._rng.random() < self.rotate_prob:
            angle = float(self._rng.uniform(-self.rotate_limit, self.rotate_limit))
            arr, boxes = rotate_image_and_boxes(arr, boxes, angle)
        padded, mask = pad_boxes(boxes, self.box_capacity)
        return arr, padded, mask

    def _log_failure(self, index: int) -> None:
        # dataset.py:148-150: append-only incorrect_indices.log
        if self.error_log:
            with open(self.error_log, "a") as f:
                f.write(f"{index}, {self.targets[index].get('img_path')}\n")

    def _cache_store(self, index: int, arr: np.ndarray, w0: int, h0: int):
        if not self.cache_decoded:
            return
        if self._cache_imgs is None:
            h, w = self.input_shape
            self._cache_imgs = np.zeros((len(self.targets), h, w, 3), np.uint8)
        self._cache_imgs[index] = arr
        self._cache_meta[index] = (w0, h0)

    def get(self, index: int, _depth: int = 0):
        """-> (image uint8 (H, W, 3), boxes (K, 5), mask (K,))."""
        if _depth > 3:
            # the reference's neighbor substitution recurses unboundedly when
            # sample 0 itself is bad (dataset.py:150); cap the retries
            raise RuntimeError(f"sample {index} and its neighbors failed to load")
        try:
            target = self._resolve_target(index)
            if self.cache_decoded and index in self._cache_meta:
                w0, h0 = self._cache_meta[index]
                return self._finish_sample(self._cache_imgs[index], target["bbx"], w0, h0)
            arr, (w0, h0) = self._decode(target["img_path"])
            self._cache_store(index, arr, w0, h0)
            return self._finish_sample(arr, target["bbx"], w0, h0)
        except Exception:
            # dataset.py:148-150: log and substitute the neighbor sample
            self._log_failure(index)
            return self.get(index - 1 if index != 0 else index + 1, _depth=_depth + 1)

    def get_batch(self, indices) -> list:
        """:meth:`get` of each of ``indices``, the misses of the RAM cache
        decoded in one threaded call of the native loader
        (``decode_resize_batch``). A slot whose decode (or box handling)
        fails is logged and takes :meth:`get`'s neighbour; a batch with a
        source that is not a JPEG, or a source without ``use_native``, takes
        the per-sample path wholesale."""
        indices = [int(i) for i in indices]
        if not self.use_native:
            return [self.get(i) for i in indices]
        out: list = [None] * len(indices)
        miss: list[int] = []
        for pos, i in enumerate(indices):
            if self.cache_decoded and i in self._cache_meta:
                try:
                    target = self._resolve_target(i)
                    w0, h0 = self._cache_meta[i]
                    out[pos] = self._finish_sample(self._cache_imgs[i], target["bbx"], w0, h0)
                    continue
                except Exception:
                    pass
            miss.append(pos)
        if not miss:
            return out

        blobs: list[bytes] = []
        metas: list[tuple[int, dict | None]] = []
        for pos in miss:
            i = indices[pos]
            try:
                target = self._resolve_target(i)
                path = str(target["img_path"])
                if not path.lower().endswith((".jpg", ".jpeg")):
                    for p in miss:
                        out[p] = self.get(indices[p])
                    return out
                blobs.append(Path(path).read_bytes())
                metas.append((i, target))
            except Exception:
                blobs.append(b"")
                metas.append((i, None))
        from fdtpu_torch.native import decode_resize_batch

        h, w = self.input_shape
        imgs, dims, _ = decode_resize_batch(blobs, h, w)
        for slot, pos in enumerate(miss):
            i, target = metas[slot]
            try:
                if target is None or dims[slot, 0] < 0:
                    raise ValueError("decode failed")
                w0, h0 = int(dims[slot, 0]), int(dims[slot, 1])
                self._cache_store(i, imgs[slot], w0, h0)
                out[pos] = self._finish_sample(imgs[slot], target["bbx"], w0, h0)
            except Exception:
                # get()'s tolerance a slot: log and substitute the neighbour
                # (a failure after the decode too, e.g. malformed boxes)
                self._log_failure(i)
                out[pos] = self.get(i - 1 if i != 0 else i + 1, _depth=1)
        return out


def rotate_image_and_boxes(arr: np.ndarray, boxes: np.ndarray, angle_deg: float):
    """Rotate an (H, W, 3) uint8 image by ``angle_deg`` (counterclockwise,
    Albumentations ``Rotate`` convention) about its center with reflect-101
    borders, and transform cxywh boxes via corner rotation -> AABB -> clip
    (Albumentations bbox rotate semantics).

    Uses PIL's C affine path; the reflect border is emulated by reflect-
    padding before rotation and cropping back.
    """
    from PIL import Image

    h, w = arr.shape[0], arr.shape[1]
    margin = int(0.25 * max(h, w)) + 2  # covers 20-degree corner excursions
    padded = np.pad(arr, ((margin, margin), (margin, margin), (0, 0)), mode="reflect")
    rot = Image.fromarray(padded).rotate(angle_deg, resample=Image.BILINEAR, expand=False)
    out = np.asarray(rot, dtype=np.uint8)[margin:-margin, margin:-margin]

    if boxes.shape[0]:
        # PIL rotates the image content counterclockwise; points transform by
        # out = R(-a) @ (p - c) + c in (x, y-down) coordinates.
        a = np.deg2rad(angle_deg)
        c, s = np.cos(a), np.sin(a)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        x, y = boxes[:, 1], boxes[:, 2]
        bw, bh = boxes[:, 3], boxes[:, 4]
        corners_x = np.stack([x, x + bw, x, x + bw], 1) - cx
        corners_y = np.stack([y, y, y + bh, y + bh], 1) - cy
        rx = c * corners_x + s * corners_y + cx
        ry = -s * corners_x + c * corners_y + cy
        x0 = np.clip(rx.min(1), 0, w)
        x1 = np.clip(rx.max(1), 0, w)
        y0 = np.clip(ry.min(1), 0, h)
        y1 = np.clip(ry.max(1), 0, h)
        boxes = np.stack([boxes[:, 0], x0, y0, x1 - x0, y1 - y0], axis=1).astype(np.float32)
        boxes = boxes[(boxes[:, 3] * boxes[:, 4]) >= 10.0]  # min_area
        boxes[:, 1:] = np.round(boxes[:, 1:])
    return out, boxes


class BatchLoader:
    """Iterates fixed-shape batches with a one-batch background prefetch.

    ``epoch_fraction=4`` reproduces the SSD dataset's quarter-epoch
    ``__len__`` (``dataset_ssd.py:32-34``).

    ``process_shard=(rank, world)`` is the data-parallel feed: every rank
    derives the **same** global index order (seeded by epoch), and each
    yields only its ``batch_size / world`` slice of every global batch
    (``batch_size`` is the global batch). Partial final batches are dropped
    in this mode (their split across ranks would be uneven).
    """

    def __init__(
        self,
        source: WIDERFaceDataSource,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        epoch_fraction: int = 1,
        prefetch: int = 2,
        process_shard: tuple[int, int] | None = None,
    ):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch_fraction = epoch_fraction
        self.prefetch = prefetch
        self.process_shard = process_shard
        if process_shard is not None:
            rank, world = process_shard
            if not 0 <= rank < world:
                raise ValueError(f"bad process_shard {process_shard}")
            if batch_size % world:
                raise ValueError(f"global batch_size {batch_size} not divisible by {world} ranks")
            self._local_batch = batch_size // world
        else:
            self._local_batch = batch_size
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.source) // self.epoch_fraction
        if self.drop_last or self.process_shard is not None:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.source) // self.epoch_fraction
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            idx = rng.permutation(len(self.source))[:n]
        return idx

    def _make_batch(self, idx_chunk: np.ndarray) -> Batch:
        imgs, boxes, masks = [], [], []
        if hasattr(self.source, "get_batch"):
            samples = self.source.get_batch(idx_chunk)
        else:
            samples = [self.source.get(int(i)) for i in idx_chunk]
        for im, bx, mk in samples:
            imgs.append(im)
            boxes.append(bx)
            masks.append(mk)
        sample_mask = np.ones((self._local_batch,), dtype=bool)
        pad = self._local_batch - len(imgs)
        if pad:
            sample_mask[len(imgs):] = False
            imgs += [imgs[-1]] * pad
            boxes += [boxes[-1]] * pad
            masks += [masks[-1]] * pad
        return Batch(
            images=np.stack(imgs),
            boxes=np.stack(boxes).astype(np.float32),
            box_mask=np.stack(masks),
            sample_mask=sample_mask,
        )

    def __iter__(self) -> Iterator[Batch]:
        idx = self._indices()
        self._epoch += 1
        nb = len(idx) // self.batch_size
        chunks = [idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)]
        if self.process_shard is not None:
            rank, lb = self.process_shard[0], self._local_batch
            chunks = [ch[rank * lb : (rank + 1) * lb] for ch in chunks]
        elif not self.drop_last and len(idx) % self.batch_size:
            chunks.append(idx[nb * self.batch_size :])

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list[BaseException] = []

        def producer():
            try:
                for ch in chunks:
                    q.put(self._make_batch(ch))
            except BaseException as e:  # noqa: BLE001 — re-raised on consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                break
            yield item


class DevicePrefetcher:
    """Host -> device feed of a ``Batch`` iterable onto ``device``, one batch
    ahead (fdtpu: ``jax.device_put`` issued a batch early).

    On a CUDA device each batch is staged in pinned host memory and copied
    on a side stream while the compute stream runs the previous step; the
    compute stream waits on the copy's event when the batch is handed out,
    and each tensor is registered with ``record_stream`` so the caching
    allocator keeps it until that stream is done with it. On
    ``torch.device("cpu")`` the batches become CPU tensors (no copy).

    A train step captured in a CUDA graph (``train/graphs.py``) reads its
    batch from static buffers: it copies each handed-out batch into them on
    the compute stream, after the wait on the copy's event, so the feed
    keeps its one-batch-ahead overlap and the buffers are written only
    between replays.
    """

    def __init__(self, loader, device: torch.device | str):
        self.loader = loader
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __len__(self):
        return len(self.loader)

    def _put(self, batch: Batch):
        host = [torch.from_numpy(np.asarray(a)) for a in
                (batch.images, batch.boxes, batch.box_mask, batch.sample_mask)]
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            staged = [t.pin_memory() for t in host]
            moved = [t.to(self.device, non_blocking=True) for t in staged]
            done = torch.cuda.Event()
            done.record(self._stream)
        return moved, done

    def _hand_out(self, item) -> Batch:
        tensors, done = item
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for t in tensors:
                t.record_stream(compute)
        return Batch(*tensors)

    def __iter__(self):
        pending: collections.deque = collections.deque()
        for batch in self.loader:
            pending.append(self._put(batch))
            if len(pending) > 1:
                yield self._hand_out(pending.popleft())
        while pending:
            yield self._hand_out(pending.popleft())


def make_synthetic_widerface(
    root,
    num_images: int = 24,
    split: str = "train",
    max_faces: int = 2,
    seed: int = 0,
):
    """Generate a tiny WIDERFace-format dataset (images + ``bbx_gt.txt``) for
    tests and benchmarks, the same bytes as fdtpu's for the same arguments.
    "Faces" are high-contrast ellipse blobs on textured noise, so a detector
    can actually fit them. Returns the data dir for
    :func:`fdtpu_torch.data.load_targets`.
    """
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(seed)
    root = Path(root)
    img_dir = root / f"WIDER_{split}" / "images" / "0--Synthetic"
    img_dir.mkdir(parents=True, exist_ok=True)
    split_dir = root / "wider_face_split"
    split_dir.mkdir(parents=True, exist_ok=True)

    lines = []
    for n in range(num_images):
        w0 = int(rng.integers(420, 680))
        h0 = int(rng.integers(340, 560))
        arr = rng.integers(0, 90, size=(h0, w0, 3), dtype=np.uint8)
        img = Image.fromarray(arr)
        draw = ImageDraw.Draw(img)
        num_faces = int(rng.integers(1, max_faces + 1))
        rows = []
        for _ in range(num_faces):
            fw = int(rng.integers(40, max(41, w0 // 3)))
            fh = int(rng.integers(40, max(41, h0 // 3)))
            x = int(rng.integers(0, max(1, w0 - fw)))
            y = int(rng.integers(0, max(1, h0 - fh)))
            skin = tuple(int(v) for v in rng.integers(170, 255, size=3))
            draw.ellipse([x, y, x + fw, y + fh], fill=skin, outline=(0, 0, 0))
            # eyes to give local structure
            draw.ellipse(
                [x + fw // 4, y + fh // 3, x + fw // 4 + max(2, fw // 10),
                 y + fh // 3 + max(2, fh // 10)], fill=(10, 10, 10)
            )
            draw.ellipse(
                [x + 3 * fw // 5, y + fh // 3, x + 3 * fw // 5 + max(2, fw // 10),
                 y + fh // 3 + max(2, fh // 10)], fill=(10, 10, 10)
            )
            rows.append(f"{x} {y} {fw} {fh} 0 0 0 0 0 0")
        name = f"0--Synthetic/synth_{n:04d}.jpg"
        img.save(img_dir / f"synth_{n:04d}.jpg", quality=90)
        lines.append(name)
        lines.append(str(num_faces))
        lines.extend(rows)
    (split_dir / f"wider_face_{split}_bbx_gt.txt").write_text("\n".join(lines) + "\n")
    return root
