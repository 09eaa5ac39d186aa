"""WIDERFace download + annotation parsing: a copy of
``fdtpu/data/widerface.py``, which is numpy-only.

Host-side re-design of the reference's ``WIDERFaceDataModule`` data
acquisition (``datasets/WIDERFace/datamodule.py:15-103``):

* the same download table (Google Drive + CUHK mirror URLs,
  ``datamodule.py:15-32``) — but this environment has no egress and no
  ``gdown``, so :func:`download_dataset_files` only checks/extracts local
  archives and raises a clear error otherwise;
* the same ``wider_face_<split>_bbx_gt.txt`` parser (``datamodule.py:69-99``):
  filename line -> face-count line -> per-face ``x y w h ...`` rows, keeping
  the first 4 numbers and prepending class confidence 1.0;
* the same crowding filters: YOLO keeps images with ``< 3`` faces
  (``datamodule.py:102``), SSD ``< 120`` (``datamodule_ssd.py:103``).
"""

from __future__ import annotations

import zipfile
from pathlib import Path

import numpy as np

DATASET_LINKS = {
    "train": {
        "url": "https://drive.google.com/u/0/uc?export=download&confirm=AB-4&id=0B6eKvaijfFUDQUUwd21EckhUbWs",
        "output": "WIDER_train.zip",
    },
    "val": {
        "url": "https://drive.google.com/u/0/uc?export=download&confirm=aVur&id=0B6eKvaijfFUDd3dIRmpvSk8tLUk",
        "output": "WIDER_val.zip",
    },
    "test": {
        "url": "https://drive.google.com/u/0/uc?export=download&confirm=7vAN&id=0B6eKvaijfFUDbW4tdGpaYjgzZkU",
        "output": "WIDER_test.zip",
    },
    "target": {
        "url": "http://mmlab.ie.cuhk.edu.hk/projects/WIDERFace/support/bbx_annotation/wider_face_split.zip",
        "output": "wider_face_split.zip",
    },
}


def download_dataset_files(
    data_dir: str | Path,
    required: tuple[str, ...] = ("train", "val", "target"),
) -> None:
    """Ensure the WIDERFace archives are present and extracted.

    The reference uses ``gdown.cached_download`` (``datamodule.py:60-67``);
    here non-Google-Drive URLs are fetched directly (urllib, streamed) when
    the host has egress, local zips are extracted, and anything still
    missing raises with the URLs so a user can fetch out of band (Drive
    links need cookie negotiation — the reference's gdown dependency — and
    this container has no egress anyway, so they are never auto-fetched).
    Only ``required`` splits are mandatory (training needs
    train/val/annotations; the unlabeled test split is optional).
    """
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    missing = []
    for split in required:
        link = DATASET_LINKS[split]
        folder = data_dir / Path(link["output"]).stem
        zip_path = data_dir / link["output"]
        if folder.exists():
            continue
        if not zip_path.exists() and "drive.google" not in link["url"]:
            _try_fetch(link["url"], zip_path)
        if zip_path.exists():
            try:
                with zipfile.ZipFile(zip_path) as zf:
                    zf.extractall(data_dir)
                continue
            except zipfile.BadZipFile:
                # e.g. an HTTP-200 HTML error page saved by _try_fetch;
                # delete it so the next run re-fetches instead of crashing
                # here forever, and fall through to the manual-URL error
                zip_path.unlink()
        missing.append(f"  {split}: {link['url']} -> {zip_path}")
    if missing:
        raise FileNotFoundError(
            "WIDERFace archives missing and not fetchable from here; "
            "download manually:\n" + "\n".join(missing)
        )


def _try_fetch(url: str, dest: Path, timeout: float = 30.0) -> bool:
    """Best-effort streamed download to ``dest`` (partial files cleaned up);
    False on any network failure — callers fall back to the manual-URL
    error."""
    import shutil
    import urllib.request

    tmp = dest.with_suffix(dest.suffix + ".part")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, open(
            tmp, "wb"
        ) as f:
            shutil.copyfileobj(r, f)
        tmp.rename(dest)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def parse_wider_annotations(
    data_dir: str | Path, split: str = "train"
) -> list[dict]:
    """Parse ``wider_face_<split>_bbx_gt.txt`` into target dicts.

    Returns ``[{"img_path": Path, "number_faces": int, "bbx": (n, 5) float32
    array of [1.0, x, y, w, h]}]`` — the reference's structure
    (``datamodule.py:69-99``) with numpy in place of torch tensors.
    """
    data_dir = Path(data_dir)
    ann = data_dir / "wider_face_split" / f"wider_face_{split}_bbx_gt.txt"
    lines = ann.read_text().split("\n")
    targets: list[dict] = []
    target: dict = {}
    for line_no, line in enumerate(lines):
        if len(line) == 0:
            continue
        if line[-3:] == "jpg":
            if line_no > 1:
                targets.append(target)
            img_path = data_dir / f"WIDER_{split}" / "images" / line
            assert img_path.exists(), (
                f"Image for this target does not exist: {img_path}"
            )
            target = {"img_path": img_path, "number_faces": 0, "bbx": []}
        else:
            parts = line.split()
            if len(parts) == 1:
                target["number_faces"] = int(line)
            else:
                target["bbx"].append([1.0] + [float(v) for v in parts[:4]])
    targets.append(target)
    for t in targets:
        t["bbx"] = np.asarray(t["bbx"], dtype=np.float32).reshape(-1, 5)
    return targets


def load_targets(
    data_dir: str | Path,
    split: str = "train",
    max_faces: int = 3,
) -> list[dict]:
    """Parse + crowding filter.

    ``max_faces=3`` reproduces the YOLO pipeline's ``< 3`` filter
    (``datamodule.py:102``); pass 120 for the SSD pipeline
    (``datamodule_ssd.py:103``).
    """
    targets = parse_wider_annotations(data_dir, split)
    return [t for t in targets if t["bbx"].shape[0] < max_faces]
