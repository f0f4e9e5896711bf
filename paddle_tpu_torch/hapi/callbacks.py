"""Training callbacks (paddle_tpu/hapi/callbacks.py): Callback,
CallbackList, History, ProgBarLogger, ModelCheckpoint, EarlyStopping,
LRSchedulerCallback, VisualDL (over ``utils/log_writer``) and
config_callbacks.

``ProfilerCallback`` (needs ``profiler/``) waits for ROADMAP Queue 1 item
9."""
from __future__ import annotations

import numbers
import os
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRSchedulerCallback", "History", "VisualDL",
           "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_begin")(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_end")(step, logs)


class History(Callback):
    def __init__(self):
        super().__init__()
        self.history = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_begin(self, mode, logs=None):
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._seen = 0
        self._epoch_t0 = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _format(self, logs):
        parts = []
        for k, v in logs.items():
            if k == "batch_size":
                continue
            # float-convertibles cover the async fit loop's _LazyLoss
            # (hapi/model.py), which materializes its exact loss on read
            if isinstance(v, numbers.Number) or hasattr(v, "__float__"):
                parts.append(f"{k}: {float(v):.4f}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        self._seen += 1
        if self.verbose == 2 and self._seen % self.log_freq == 0:
            total = f"/{self.steps}" if self.steps else ""
            dt = (time.time() - self._epoch_t0) / max(self._seen, 1)
            print(f"step {self._seen}{total} - {self._format(logs or {})}"
                  f" - {dt * 1000:.0f}ms/step")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._epoch_t0
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - "
                  f"{self._format(logs or {})}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_end(self, mode, logs=None):
        if mode == "train" and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0

    def _better(self, current):
        if self.best is None:
            return True
        if self.mode == "min":
            return current < self.best - self.min_delta
        return current > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor)
        if current is None:
            current = logs.get(f"eval_{self.monitor}")
        if current is None:
            return
        current = float(np.asarray(current).reshape(-1)[0])
        if self._better(current):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping at epoch {epoch + 1}: best "
                          f"{self.monitor}={self.best:.5f}")


class LRSchedulerCallback(Callback):
    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return opt._lr_scheduler if opt else None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch and self._sched() is not None:
            self._sched().step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step and self._sched() is not None:
            self._sched().step()


class VisualDL(Callback):
    """Stream per-step loss and per-epoch metrics to a LogWriter
    (reference hapi/callbacks.py VisualDL; zero-egress JSON-lines form,
    ``utils.LogWriter``).

    `sample_freq`: write buffered per-batch losses every N batches
    instead of per batch. Under the async fit loop the per-batch
    `logs["loss"]` is a lazy window entry (hapi/model.py _LazyLoss) and
    reading it every batch forces a device sync that defeats the
    pipeline; the default N=10 matches fit's log_freq window boundary,
    where the loop has ALREADY drained the window — so the buffered
    reads cost no extra sync and per-batch values stay exact.
    sample_freq=1 restores write-every-batch (per-batch sync under the
    async loop). Pass the same value as fit(log_freq=...) if you change
    either."""

    def __init__(self, log_dir, sample_freq=10):
        from ..utils.log_writer import LogWriter
        self.writer = LogWriter(log_dir)
        self.sample_freq = max(1, int(sample_freq))
        self._step = 0
        self._pending = []   # [(global_step, loss-ish)] awaiting a write

    def _flush_pending(self):
        pending, self._pending = self._pending, []
        for s, v in pending:
            try:
                val = float(v)
            except Exception:
                # a buffered loss of a crashed in-flight step can refuse
                # to materialize; the earlier (good) entries still land
                continue
            # writer (I/O) errors propagate, as they always did
            self.writer.add_scalar("train/loss", val, s)

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if logs and "loss" in logs:
            self._pending.append((self._step, logs["loss"]))
        # cadence keyed on fit's PER-EPOCH step (the `step` argument), so
        # it stays phase-aligned with the loop's own log_freq drain even
        # when an epoch's length isn't a multiple of sample_freq
        if (step + 1) % self.sample_freq == 0:
            self._flush_pending()

    def on_epoch_end(self, epoch, logs=None):
        self._flush_pending()
        for k, v in (logs or {}).items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(f"epoch/{k}", v, epoch)
        self.writer.flush()

    def on_end(self, mode, logs=None):
        self._flush_pending()
        self.writer.close()

    def __del__(self):
        # fit() skips on_end when training raises; don't lose the
        # buffered tail — those are the losses closest to the crash
        try:
            self._flush_pending()
            self.writer.flush()
        except Exception:
            pass


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=10, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, ModelCheckpoint) for c in cbks) and save_dir:
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": metrics or ["loss"]})
    return cl
