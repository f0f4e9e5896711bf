"""paddle.utils.download (paddle_tpu/utils/download.py, copied as it
is): reference python/paddle/utils/download.py get_weights_path_from_url.
Nothing is fetched: weights resolve from the local cache directory
(``PADDLE_TPU_WEIGHTS_DIR``, else ``~/.cache/paddle_tpu/weights``), and a
missing file raises naming the path to put it at."""
from __future__ import annotations

import os

__all__ = ["get_weights_path_from_url", "weights_cache_dir"]


def weights_cache_dir():
    d = os.environ.get("PADDLE_TPU_WEIGHTS_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "paddle_tpu", "weights")
    os.makedirs(d, exist_ok=True)
    return d


def get_weights_path_from_url(url, md5sum=None):
    fname = url.rsplit("/", 1)[-1]
    path = os.path.join(weights_cache_dir(), fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained weights {fname!r} not found. paddle_tpu runs "
            f"zero-egress: fetch {url} yourself and place it at {path} "
            "(or set PADDLE_TPU_WEIGHTS_DIR)")
    if md5sum:
        import hashlib
        with open(path, "rb") as f:
            got = hashlib.md5(f.read()).hexdigest()  # noqa: S324
        if got != md5sum:
            raise ValueError(f"{path}: md5 mismatch ({got} != {md5sum})")
    return path
