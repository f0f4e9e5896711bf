"""VOC2012 segmentation (paddle_tpu/vision/datasets/voc2012.py) from the
local VOCtrainval tar: (image, label) pairs from its ImageSets lists;
``download=True`` raises."""
from __future__ import annotations

import io
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["VOC2012"]

_LIST = {
    "train": "ImageSets/Segmentation/train.txt",
    "valid": "ImageSets/Segmentation/val.txt",
    "test": "ImageSets/Segmentation/trainval.txt",
}


class VOC2012(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if mode not in _LIST:
            raise ValueError(f"mode must be one of {list(_LIST)}")
        if download:
            raise RuntimeError(
                "paddle_tpu_torch reads local files only: fetch VOCtrainval "
                "yourself and pass data_file")
        if not data_file:
            raise ValueError("data_file is required (download=False)")
        self.transform = transform
        self._tar_path = data_file
        self._tar = None
        self._keys = None
        self._mode = mode

    def _ensure(self):
        if self._tar is not None:
            return
        self._tar = tarfile.open(self._tar_path)
        names = self._tar.getnames()
        # archives may or may not carry the VOCdevkit/VOC2012 prefix
        prefix = ""
        for n in names:
            if n.endswith(_LIST[self._mode]):
                prefix = n[: -len(_LIST[self._mode])]
                break
        listing = self._tar.extractfile(
            prefix + _LIST[self._mode]).read().decode()
        self._keys = [ln.strip() for ln in listing.splitlines()
                      if ln.strip()]
        self._prefix = prefix

    def _read_image(self, rel):
        data = self._tar.extractfile(self._prefix + rel).read()
        from PIL import Image
        return Image.open(io.BytesIO(data))

    def __getitem__(self, idx):
        self._ensure()
        key = self._keys[idx]
        img = np.asarray(self._read_image(
            f"JPEGImages/{key}.jpg").convert("RGB"))
        label = np.asarray(self._read_image(
            f"SegmentationClass/{key}.png"))
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        self._ensure()
        return len(self._keys)
