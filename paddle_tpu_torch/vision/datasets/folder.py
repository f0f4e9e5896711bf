"""DatasetFolder / ImageFolder (paddle_tpu/vision/datasets/folder.py):
``root/class_x/**/file`` samples with class indices, and a flat recursive
image listing; images through PIL, ``.npy`` through numpy."""
from __future__ import annotations

import os

import numpy as np

from ...io import Dataset

__all__ = ["DatasetFolder", "ImageFolder"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp", ".npy")


def default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def has_valid_extension(filename, extensions):
    return filename.lower().endswith(tuple(extensions))


class DatasetFolder(Dataset):
    """root/<class_name>/**/<image> -> (image, class_index) samples."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        if not classes:
            raise RuntimeError(f"no class folders under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        check = is_valid_file or (
            lambda p: has_valid_extension(p, extensions))
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fn in sorted(files):
                    p = os.path.join(dirpath, fn)
                    if check(p):
                        self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(
                f"no valid files under {root} (extensions {extensions})")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat recursive listing: every image under root is one sample
    (no labels) — the reference's inference-time loader."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        check = is_valid_file or (
            lambda p: has_valid_extension(p, extensions))
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                p = os.path.join(dirpath, fn)
                if check(p):
                    self.samples.append(p)
        if not self.samples:
            raise RuntimeError(f"no valid files under {root}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)
