"""Fleet utils (paddle_tpu/distributed/fleet/util.py; the reference's
fleet/utils/fs.py and base/util_factory.py): ``LocalFS``, ``UtilBase``
(host values reduced and gathered over the world's ranks through
torch.distributed; the identity in a world of one) and ``HDFSClient``,
which shells out to ``hadoop fs`` as the JAX package's does and errors at
call time where there is no hadoop binary."""
from __future__ import annotations

import os
import shutil

import numpy as np

__all__ = ["UtilBase", "LocalFS", "HDFSClient"]


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist
    return None


class LocalFS:
    """Local filesystem with the reference's FS interface
    (reference fleet/utils/fs.py LocalFS; HDFS shells out in the reference,
    framework/io/fs.cc — cloud FS backends plug in here)."""

    def ls_dir(self, path):
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
        return dirs, files

    def is_exist(self, path):
        return os.path.exists(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.unlink(path)

    def rename(self, src, dst):
        os.replace(src, dst)

    def upload(self, local, remote):
        shutil.copy(local, remote)

    def download(self, remote, local):
        shutil.copy(remote, local)

    def touch(self, path, exist_ok=True):
        open(path, "a").close()


class UtilBase:
    def __init__(self):
        self._fs = LocalFS()

    def get_file_system(self):
        return self._fs

    def all_reduce(self, input, mode="sum"):  # noqa: A002
        """``input`` (host values) reduced over the world: "sum", "max"
        or "min"."""
        arr = np.asarray(input)
        dist = _world()
        if dist is None:
            return arr
        import torch
        op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
              "min": dist.ReduceOp.MIN}[mode]
        t = torch.from_numpy(np.array(arr, dtype=np.float64, ndmin=1))
        dist.all_reduce(t, op=op)
        out = t.numpy().astype(arr.dtype if arr.dtype.kind == "f"
                               else np.float64)
        return out.reshape(arr.shape)

    def all_gather(self, input):  # noqa: A002
        """[``input`` of each rank] over the world, in rank order."""
        dist = _world()
        if dist is None:
            return [input]
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, input)
        return out

    def barrier(self):
        from ..collective import barrier
        barrier()

    def print_on_rank(self, message, rank_id=0):
        from ..env import get_rank
        if get_rank() == rank_id:
            print(message)


class HDFSClient:
    """HDFS filesystem client (reference fleet/utils/fs.py HDFSClient):
    shells out to `hadoop fs` exactly like the reference — pass
    hadoop_home and the fs.default.name/ugi configs. Zero-egress images
    without a hadoop binary get a clear error at call time, not import
    time."""

    def __init__(self, hadoop_home=None, configs=None, time_out=300):
        import os as _os
        self._hadoop = (_os.path.join(hadoop_home, "bin", "hadoop")
                        if hadoop_home else "hadoop")
        self._configs = dict(configs or {})
        self._timeout = time_out

    def _run(self, *args):
        import subprocess
        cmd = [self._hadoop, "fs"]
        for k, v in self._configs.items():
            cmd += ["-D", f"{k}={v}"]
        cmd += list(args)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=self._timeout)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"HDFSClient: hadoop binary {self._hadoop!r} not found — "
                "set hadoop_home (the reference shells out the same way)"
            ) from e
        return r.returncode, r.stdout, r.stderr

    def is_exist(self, path):
        rc, _, _ = self._run("-test", "-e", path)
        return rc == 0

    def is_dir(self, path):
        rc, _, _ = self._run("-test", "-d", path)
        return rc == 0

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    def ls_dir(self, path):
        rc, out, err = self._run("-ls", path)
        if rc != 0:
            raise RuntimeError(f"hdfs ls failed: {err.strip()}")
        dirs, files = [], []
        for ln in out.splitlines():
            parts = ln.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def upload(self, local_path, fs_path):
        rc, _, err = self._run("-put", "-f", local_path, fs_path)
        if rc != 0:
            raise RuntimeError(f"hdfs put failed: {err.strip()}")

    def download(self, fs_path, local_path):
        rc, _, err = self._run("-get", fs_path, local_path)
        if rc != 0:
            raise RuntimeError(f"hdfs get failed: {err.strip()}")

    def mkdirs(self, path):
        rc, _, err = self._run("-mkdir", "-p", path)
        if rc != 0:
            raise RuntimeError(f"hdfs mkdir failed: {err.strip()}")

    def delete(self, path):
        rc, _, err = self._run("-rm", "-r", "-f", path)
        if rc != 0:
            raise RuntimeError(f"hdfs rm failed: {err.strip()}")

    def mv(self, src, dst):
        rc, _, err = self._run("-mv", src, dst)
        if rc != 0:
            raise RuntimeError(f"hdfs mv failed: {err.strip()}")
