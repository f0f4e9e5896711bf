"""Preemption-safe training checkpoints with a verification tier
(paddle_tpu/incubate/checkpoint.py), saved with torch in place of orbax.

- ``TrainingCheckpoint``: step-atomic directory commits (the step is
  written into a temporary directory, then published with ``os.replace``
  as ``{directory}/{step}``), keep-latest-k, and an async save: ``save``
  copies every device tensor of the state to the host before it returns,
  and a writer thread hashes, writes and commits while training goes on
  (``wait()`` joins it; one save is in flight at a time).
- Integrity: every save writes a manifest, ``manifest_{step}.json``, with
  each leaf's shape, dtype and sha256 over its bytes (``_leaf_record``,
  ``build_manifest``, ``verify_manifest``), committed before the step
  directory. A bf16 leaf is hashed over its raw 2-byte form under dtype
  ``"bfloat16"``, as the JAX package hashes an ml_dtypes array, so equal
  states give equal manifests in both packages. A restore re-hashes what
  it read; a corrupt, torn or schema-mismatched step raises
  ``CheckpointCorruptError`` naming the first bad leaf, and the latest
  restore quarantines it (``.quarantine/``, the ``ckpt.corrupt_skipped``
  counter, a flight-recorder dump) and walks back to the newest step
  that verifies.
- ``capture`` / ``restore_into`` (``Model.fit(auto_checkpoint_dir=...)``):
  parameters and buffers, the optimizer's state (slots, step count, LR
  schedule), the GradScaler's state, the data-pipeline position and the
  (epoch, step, global_step) counters. Where the JAX package stores its
  PRNG key, the port stores its generators' states: torch's CPU and CUDA
  default generators (dropout draws from them) and the port's own
  (``core/rng``).
- ``PreemptionGuard`` (SIGTERM: one forced synchronous save, then the
  default disposition) and ``train_epoch_range``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["TrainingCheckpoint", "train_epoch_range", "PreemptionGuard",
           "CheckpointCorruptError", "build_manifest", "verify_manifest"]

MANIFEST_VERSION = 1
_STATE_FILE = "state.pt"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification. ``step`` is the checkpoint step,
    ``leaf`` the first offending tree path ("<unreadable>" when the store
    itself could not be read), ``reason`` what mismatched."""

    def __init__(self, step, leaf, reason):
        self.step = int(step)
        self.leaf = leaf
        self.reason = reason
        super().__init__(
            f"checkpoint step {step} is corrupt at leaf {leaf!r}: {reason}")


def _host_tree(obj):
    """Tensors to CPU tensors (their own copies, taken now), tuples to
    lists; numpy arrays and Python values as they are."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.to("cpu", copy=True) if t.is_cuda else t.clone()
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_host_tree(v) for v in obj]
    return obj


def _flat_leaves(tree, prefix=""):
    """Deterministic (path, leaf) walk: dicts by sorted key, lists by
    index — the manifest's leaf namespace."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], f"{prefix}/{k}" if prefix
                                    else str(k))
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_leaves(v, f"{prefix}/{i}" if prefix
                                    else str(i))
        return
    yield prefix, tree


def _leaf_bytes(leaf):
    """(shape, numpy dtype name, raw bytes) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            raw = t.numpy().tobytes()
        return list(t.shape), name, raw
    arr = np.asarray(leaf)
    return list(arr.shape), str(arr.dtype), \
        np.ascontiguousarray(arr).tobytes()


def _leaf_record(leaf):
    """(shape, dtype, sha256) of one leaf over its raw bytes — symmetric
    between save time and restore time, so a bit flip anywhere in the
    stored bytes surfaces as a hash mismatch."""
    shape, dtype, raw = _leaf_bytes(leaf)
    return {"shape": shape, "dtype": dtype,
            "sha256": hashlib.sha256(raw).hexdigest()}


def build_manifest(step, state):
    return {"manifest_version": MANIFEST_VERSION, "step": int(step),
            "time": time.time(),
            "leaves": {path: _leaf_record(leaf)
                       for path, leaf in _flat_leaves(state)}}


def verify_manifest(step, state, manifest):
    """Raise CheckpointCorruptError naming the first bad leaf if ``state``
    does not match ``manifest`` (missing or extra leaves, shape or dtype
    drift, a hash mismatch)."""
    want = manifest.get("leaves", {})
    got = {path: leaf for path, leaf in _flat_leaves(state)}
    for path in sorted(want):
        if path not in got:
            raise CheckpointCorruptError(step, path,
                                         "leaf missing from restored tree")
    for path in sorted(got):
        if path not in want:
            raise CheckpointCorruptError(step, path,
                                         "leaf absent from manifest")
        rec = _leaf_record(got[path])
        ref = want[path]
        for field in ("shape", "dtype"):
            if rec[field] != ref[field]:
                raise CheckpointCorruptError(
                    step, path, f"{field} mismatch: manifest "
                    f"{ref[field]!r}, restored {rec[field]!r}")
        if rec["sha256"] != ref["sha256"]:
            raise CheckpointCorruptError(step, path, "sha256 mismatch")


def _rng_state():
    from ..core import rng as _rng
    state = {"torch_cpu": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["torch_cuda"] = torch.cuda.get_rng_state_all()
    state["port"] = {str(dev): g.get_state()
                     for dev, g in _rng.default_generator()._gens.items()}
    return state


def _set_rng_state(state):
    from ..core import rng as _rng
    torch.set_rng_state(state["torch_cpu"])
    if "torch_cuda" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(state["torch_cuda"])
    for dev, s in state.get("port", {}).items():
        _rng.default_generator().get(dev).set_state(s)


class TrainingCheckpoint:
    """Step-atomic training checkpoints with keep-latest-k, an async
    writer and manifest verification."""

    def __init__(self, directory, keep=3, save_interval_steps=50,
                 async_save=True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, int(keep))
        self.save_interval_steps = int(save_interval_steps)
        self.async_save = bool(async_save)
        self._writer = None           # the in-flight async save's thread
        self._writer_error = None
        self._emergency_handle = None
        self._emergency_fired = False
        self._in_save = False   # re-entrancy guard for signal-time saves
        self.last_save_seconds = None  # host copy + (sync) write

    # -- manifest plumbing ---------------------------------------------------
    def _manifest_path(self, step):
        return os.path.join(self.directory, f"manifest_{int(step)}.json")

    def _step_dir(self, step):
        return os.path.join(self.directory, str(int(step)))

    def _write_manifest(self, step, state):
        path = self._manifest_path(step)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(build_manifest(step, state), f)
        os.replace(tmp, path)

    def _read_manifest(self, step):
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _gc(self):
        """Keep the newest ``keep`` committed steps; drop manifests whose
        step is gone. Best effort."""
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        live = set(steps[-self.keep:])
        try:
            for name in os.listdir(self.directory):
                if name.startswith("manifest_") and name.endswith(".json"):
                    try:
                        step = int(name[len("manifest_"):-len(".json")])
                    except ValueError:
                        continue
                    if step not in live:
                        os.unlink(os.path.join(self.directory, name))
        except OSError:
            pass

    def _quarantine(self, step, exc):
        """Move a corrupt step out of sight so the walk-back (and every
        later restart) lands on a verified step, keeping the evidence."""
        from ..core import flight_recorder as _fr
        from ..core import monitor as _monitor
        qdir = os.path.join(self.directory, ".quarantine")
        os.makedirs(qdir, exist_ok=True)
        src = self._step_dir(step)
        dst = os.path.join(qdir, f"{int(step)}_{int(time.time())}")
        try:
            if os.path.isdir(src):
                os.replace(src, dst)
            mpath = self._manifest_path(step)
            if os.path.exists(mpath):
                shutil.move(mpath, dst + ".manifest.json")
        except OSError:
            pass
        _monitor.stat_add("ckpt.corrupt_skipped")
        _fr.dump("ckpt_corrupt", exc,
                 extra={"step": int(step), "directory": self.directory,
                        "leaf": getattr(exc, "leaf", None),
                        "quarantined_to": dst})

    # -- low-level ----------------------------------------------------------
    def _write(self, step, state):
        """Manifest first, then the step directory's atomic commit: a kill
        between the two leaves a manifest without a step (collected),
        never a committed step whose manifest lies."""
        self._write_manifest(step, state)
        tmp = os.path.join(self.directory,
                           f".tmp_{int(step)}_{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE_FILE))
        final = self._step_dir(step)
        if os.path.isdir(final):       # a forced re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _writer_main(self, step, state):
        try:
            self._write(step, state)
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            self._writer_error = e

    def save(self, step: int, state: dict, force=False):
        """Copy ``state`` to the host now and write it as step ``step``:
        on a writer thread when async (the previous async save is joined
        first), else before returning. ``force`` always writes
        synchronously."""
        self._in_save = True
        try:
            self.wait()
            t0 = time.perf_counter()
            host = _host_tree(state)
            if self.async_save and not force:
                self._writer = threading.Thread(
                    target=self._writer_main, args=(int(step), host),
                    name="ckpt-writer", daemon=True)
                self._writer.start()
            else:
                self._write(int(step), host)
            self.last_save_seconds = time.perf_counter() - t0
        finally:
            self._in_save = False

    def emergency_save(self, step: int, state: dict):
        """Synchronous forced save for failure paths (SIGTERM grace,
        PipelineStepError): returns only once the step is durable."""
        self.save(int(step), state, force=True)
        self.wait()

    def install_emergency_save(self, capture_fn,
                               reasons=("pipeline_step_error",
                                        "signal_SIGTERM")):
        """Join the flight-recorder trigger points: when a dump fires for
        one of ``reasons``, run one synchronous emergency save of
        capture_fn() -> (step, state). Fires at most once per process."""
        from ..core import flight_recorder as _fr

        def hook(reason, exc):
            if self._emergency_fired or self._in_save:
                return
            self._emergency_fired = True
            step, state = capture_fn()
            self.emergency_save(step, state)

        self._emergency_handle = _fr.register_emergency_hook(hook, reasons)
        return self._emergency_handle

    def uninstall_emergency_save(self):
        if self._emergency_handle is not None:
            from ..core import flight_recorder as _fr
            _fr.unregister_emergency_hook(self._emergency_handle)
            self._emergency_handle = None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def _restore_verified(self, step):
        """Load one step and verify it against its manifest. Raises
        CheckpointCorruptError (corrupt or mismatched) and
        FileNotFoundError (no such step)."""
        from ..core import flags as _flags
        from ..core import monitor as _monitor
        path = os.path.join(self._step_dir(step), _STATE_FILE)
        if not os.path.isdir(self._step_dir(step)):
            raise FileNotFoundError(path)
        try:
            state = torch.load(path, map_location="cpu", weights_only=False)
        except Exception as e:
            # a torn or partial step: torch could not even read it
            raise CheckpointCorruptError(step, "<unreadable>",
                                         f"{type(e).__name__}: {e}")
        manifest = self._read_manifest(step)
        if manifest is None:
            # a checkpoint without a manifest: loadable, not provable
            _monitor.stat_add("ckpt.unverified_loads")
            return state
        if _flags.flag("PADDLE_CKPT_VERIFY"):
            verify_manifest(step, state, manifest)
            _monitor.stat_set("ckpt.last_verified_step", int(step))
        return state

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """Restore a verified checkpoint. With an explicit ``step``:
        None if the step is gone, CheckpointCorruptError if it exists but
        fails verification. With step=None: newest to oldest,
        quarantining every corrupt step, the newest state that verifies
        (None when nothing restorable exists)."""
        self.wait()
        if step is not None:
            try:
                return self._restore_verified(step)
            except FileNotFoundError:
                return None
        for s in sorted(self.all_steps(), reverse=True):
            try:
                return self._restore_verified(s)
            except CheckpointCorruptError as e:
                self._quarantine(s, e)
            except FileNotFoundError:
                continue
        return None

    def wait(self):
        """Join the in-flight async save; re-raise its failure."""
        th, self._writer = self._writer, None
        if th is not None:
            th.join()
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def close(self):
        self.uninstall_emergency_save()
        self.wait()

    # -- Model.fit integration ---------------------------------------------
    def capture(self, model, epoch, step, global_step,
                data_state=None, ps_state=None) -> dict:
        state = {
            "model": dict(model.network.state_dict()),
            "optimizer": model._optimizer.state_dict(),
            "rng": _rng_state(),
            "counters": {"epoch": int(epoch), "step": int(step),
                         "global_step": int(global_step)},
        }
        amp_cfg = getattr(model, "_amp_configs", None)
        scaler = amp_cfg.get("scaler") if amp_cfg else None
        if scaler is not None:
            state["scaler"] = scaler.scale_state()
        if data_state is not None:
            state["data"] = data_state
        if ps_state is not None:
            state["ps"] = ps_state
        return state

    def maybe_save(self, model, epoch, step, global_step, force=False,
                   data_state=None, ps_state=None):
        if force or (global_step % self.save_interval_steps == 0
                     and global_step > 0):
            self.save(global_step,
                      self.capture(model, epoch, step, global_step,
                                   data_state=data_state,
                                   ps_state=ps_state),
                      force=force)
            return True
        return False

    def restore_into(self, model, data_loader=None) -> Optional[dict]:
        """Restore the latest verified checkpoint into the model, its
        optimizer and the generators (and, when ``data_loader`` has
        ``load_state_dict`` and the checkpoint a ``data`` section, the
        data-pipeline position); returns the counters (None without a
        checkpoint). A parameter whose shape changed since the save
        raises a ValueError naming it."""
        state = self.restore()
        if state is None:
            return None
        from ..hapi.model import _set_state_dict
        live = dict(model.network.state_dict())
        for name, saved in state["model"].items():
            cur = live.get(name)
            if cur is None:
                continue
            if tuple(saved.shape) != tuple(cur.shape):
                raise ValueError(
                    f"checkpoint/model shape mismatch for parameter "
                    f"{name!r}: checkpoint has {list(saved.shape)}, model "
                    f"has {list(cur.shape)} — the model architecture "
                    "changed since this checkpoint was written; restore "
                    "it into the original architecture or start fresh")
        _set_state_dict(model.network, state["model"])
        load_opt = getattr(model, "_load_optimizer_state",
                           model._optimizer.set_state_dict)
        load_opt(state["optimizer"])
        if "scaler" in state:
            amp_cfg = getattr(model, "_amp_configs", None)
            scaler = amp_cfg.get("scaler") if amp_cfg else None
            if scaler is not None:
                scaler.load_scale_state(state["scaler"])
        _set_rng_state(state["rng"])
        counters = {k: int(v) for k, v in state["counters"].items()}
        if data_loader is not None and "data" in state \
                and hasattr(data_loader, "load_state_dict"):
            data_loader.load_state_dict(state["data"])
            counters["data_resumed"] = True
        if "ps" in state:
            counters["ps_state"] = state["ps"]
        return counters


class PreemptionGuard:
    """SIGTERM-grace checkpointing: while installed, SIGTERM triggers one
    forced synchronous checkpoint before the default disposition, so a
    preempted job resumes from its exact step instead of the last
    periodic save. With ``runner`` (a PipelineRunner) the capture is
    preceded by ``runner.sync()``: in-flight steps drain and the carry
    writes back, so the saved step count matches the applied optimizer
    state."""

    def __init__(self, ckpt: TrainingCheckpoint, capture_fn, runner=None):
        """capture_fn() -> (step, state_dict) captured at signal time."""
        self._ckpt = ckpt
        self._capture = capture_fn
        self._runner = runner
        self._prev = None
        self.fired = False

    def _grace_save(self):
        if getattr(self._ckpt, "_in_save", False):
            # SIGTERM landed inside a periodic save on this manager (the
            # handler runs on the interrupted main thread): recovery
            # falls back to the last committed step
            return
        if self._runner is not None:
            try:
                self._runner.sync()
            except Exception:
                pass  # a poisoned pipeline: save what the carry left
        step, state = self._capture()
        self._ckpt.save(step, state, force=True)
        self._ckpt.wait()

    def __enter__(self):
        import signal

        def handler(signum, frame):
            self.fired = True
            try:
                self._grace_save()
            finally:
                if callable(self._prev):
                    self._prev(signum, frame)
                elif self._prev != signal.SIG_IGN:
                    # grace save done: die by SIGTERM as the default
                    # disposition would have, so the launcher sees the
                    # true wait status
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def __exit__(self, *exc):
        import signal
        signal.signal(signal.SIGTERM, self._prev or signal.SIG_DFL)
        return False


def train_epoch_range(max_epoch_num, save_checkpoint_inter=None,
                      directory=None):
    """A resumable epoch iterator (reference auto_checkpoint.py
    ``train_epoch_range``): the epoch counter persists under
    ``directory`` (or $PADDLE_TPU_CHECKPOINT_DIR /
    ./paddle_tpu_auto_checkpoint); on restart iteration continues after
    the last completed epoch. An epoch commits only when the loop body
    finishes and the iterator is resumed: a trainer killed between the
    yield and the save redoes that epoch."""
    directory = directory or os.environ.get(
        "PADDLE_TPU_CHECKPOINT_DIR", "./paddle_tpu_auto_checkpoint")
    ckpt = TrainingCheckpoint(directory, keep=2, async_save=False)
    try:
        last = ckpt.restore()
        start = int(last["epoch"]) + 1 if last is not None else 0
        for epoch in range(start, max_epoch_num):
            yield epoch
            ckpt.save(epoch, {"epoch": epoch}, force=True)
            ckpt.wait()
    finally:
        ckpt.close()
