"""Oxford 102 Flowers (paddle_tpu/vision/datasets/flowers.py) from local
files: the image tgz, imagelabels.mat and setid.mat (scipy's loadmat);
``download=True`` raises."""
from __future__ import annotations

import io
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["Flowers"]

_SPLIT_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}


class Flowers(Dataset):
    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None):
        if mode not in _SPLIT_KEY:
            raise ValueError(f"mode must be one of {list(_SPLIT_KEY)}")
        if download:
            raise RuntimeError(
                "paddle_tpu_torch reads local files only: download the "
                "Flowers archives yourself and pass data_file/label_file/"
                "setid_file")
        if not (data_file and label_file and setid_file):
            raise ValueError("data_file, label_file and setid_file are "
                             "required (download=False)")
        import scipy.io
        self.transform = transform
        labels = scipy.io.loadmat(label_file)["labels"].ravel()
        ids = scipy.io.loadmat(setid_file)[_SPLIT_KEY[mode]].ravel()
        self.indexes = ids.astype(np.int64)          # 1-based image ids
        self.labels = labels
        self._tar_path = data_file
        self._tar = None
        self._names = None

    def _ensure_tar(self):
        if self._tar is None:
            self._tar = tarfile.open(self._tar_path)
            self._names = {n.rsplit("/", 1)[-1]: n
                           for n in self._tar.getnames()
                           if n.endswith(".jpg")}

    def __getitem__(self, idx):
        self._ensure_tar()
        img_id = int(self.indexes[idx])
        name = self._names[f"image_{img_id:05d}.jpg"]
        data = self._tar.extractfile(name).read()
        from PIL import Image
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        if self.transform is not None:
            img = self.transform(img)
        label = np.asarray([int(self.labels[img_id - 1])], np.int64)
        return img, label

    def __len__(self):
        return len(self.indexes)
