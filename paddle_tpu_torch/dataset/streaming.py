"""Streaming dataset over serve-traffic completion records
(paddle_tpu/dataset/streaming.py, copied: pure Python over the port's
flags, monitor and the rpc fault seam).

The input half of the online-learning loop:
`inference/serving.ServeLoop(on_complete=ds.offer)` pushes one
structured completion record per retired request; a continuous trainer
consumes them through `batches()` exactly like any other
`train_from_dataset` source.

Delivery semantics, in transport terms:

- **at-least-once in**: producers may re-offer a record any number of
  times (a completion log replayed after a crash, a duplicated queue
  message). A bounded window of accepted record ids
  (PADDLE_STREAM_DEDUPE_WINDOW) rejects re-offers, so duplicates cost
  one counter bump, never a training step.
- **exactly-once training batches out, relative to the checkpoint
  cut**: `state_dict()` captures the undelivered buffer, the dedupe
  window, and the delivered-batch cursor. A restarted trainer that
  restores the snapshot and resumes with `batches(start_batch=cursor)`
  re-trains nothing it committed and loses nothing that was accepted:
  records buffered at the cut are redelivered, records accepted after
  the cut are re-admitted when the transport re-offers them (their ids
  are not in the restored window). Batches delivered after the cut but
  before the crash redeliver — the restored trainer never saw them, so
  the cut stays consistent as long as trainer state and dataset state
  checkpoint together (incubate/checkpoint.py's `capture` takes a
  `data_state`).
- **bounded queue**: `offer()` blocks once PADDLE_STREAM_QUEUE_CAP
  records are undelivered — backpressure into the serving tier instead
  of unbounded growth.

The delivery boundary consults the process-global fault injector
(paddle_tpu_torch.testing.faults, through distributed/ps/rpc.py's seam) as ("stream", "deliver", <name>): a
scripted STALL there is a deterministic BACKLOG BURST (delivery pauses,
records pile up, nothing is dropped — `faults.backlog_burst(...)`), and
a seeded chaos RESET is absorbed as a transient delivery fault
(counted, retried; records are never dropped at this boundary).

Observability: `stream.{backlog,watermark,accepted,duplicates,
delivered_records,delivered_batches,delivery_faults,rejected_full}`
published as gauges on every offer/delivery.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

__all__ = ["StreamingDataset"]


class StreamingDataset:
    """Bounded, deduplicating record queue with checkpointable cursors.

    batch_size: records per training batch. collate: list-of-records ->
    feed dict (None yields the raw record list). capacity /
    dedupe_window: 0 = take the PADDLE_STREAM_* flag defaults. name:
    the fault-injection / gauge identity of this stream.
    """

    def __init__(self, batch_size, collate=None, capacity=0,
                 dedupe_window=0, name="serve", poll_s=0.02):
        from ..core import flags as _flags
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.collate = collate
        self.capacity = int(capacity
                            or _flags.flag("PADDLE_STREAM_QUEUE_CAP"))
        self.dedupe_window = int(
            dedupe_window or _flags.flag("PADDLE_STREAM_DEDUPE_WINDOW"))
        self.name = str(name)
        self.poll_s = float(poll_s)
        self._buf: deque = deque()          # accepted, undelivered
        self._seen: OrderedDict = OrderedDict()  # rid -> None, FIFO
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._watermark = -1                # highest accepted rid
        self._accepted = 0
        self._duplicates = 0
        self._rejected_full = 0
        self._delivered_batches = 0
        self._delivered_records = 0
        self._delivery_faults = 0

    # -- producer side -------------------------------------------------------
    def offer(self, record, timeout=None):
        """Offer one completion record (a dict with an int "rid").
        Returns True if accepted, False if deduped / closed / timed out
        waiting on a full queue. Blocks while the queue is at capacity
        (backpressure); `timeout` bounds that wait. Thread-safe —
        usable directly as a ServeLoop on_complete hook."""
        rid = int(record["rid"])
        deadline = None if timeout is None \
            else time.perf_counter() + float(timeout)
        with self._cond:
            if self._closed:
                return False
            if rid in self._seen:
                self._duplicates += 1
                self._publish_gauges_locked()
                return False
            while len(self._buf) >= self.capacity and not self._closed:
                wait = self.poll_s
                if deadline is not None:
                    wait = min(wait, deadline - time.perf_counter())
                    if wait <= 0:
                        self._rejected_full += 1
                        self._publish_gauges_locked()
                        return False
                self._cond.wait(wait)
            if self._closed:
                return False
            if rid in self._seen:       # raced with a duplicate offer
                self._duplicates += 1
                self._publish_gauges_locked()
                return False
            self._seen[rid] = None
            while len(self._seen) > self.dedupe_window:
                self._seen.popitem(last=False)
            self._buf.append(dict(record))
            self._accepted += 1
            self._watermark = max(self._watermark, rid)
            self._publish_gauges_locked()
            self._cond.notify_all()
            return True

    def close(self):
        """End of stream: blocked offers return False, `batches()`
        flushes a final partial batch and stops."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------------
    def batches(self, start_batch=0):
        """Yield collated training batches. `start_batch` must equal
        the delivered-batch cursor (0 fresh, or the cursor of the
        restored `state_dict()` after a trainer restart) — delivered
        records are deliberately not retained, so an out-of-sync resume
        is an error, not a silent skip or replay."""
        if int(start_batch) != self._delivered_batches:
            raise ValueError(
                f"start_batch {start_batch} != delivered cursor "
                f"{self._delivered_batches}; restore the matching "
                f"state_dict() before resuming")
        while True:
            self._deliver_gate()
            with self._cond:
                while len(self._buf) < self.batch_size \
                        and not self._closed:
                    self._cond.wait(self.poll_s)
                if not self._buf and self._closed:
                    self._publish_gauges_locked()
                    return
                take = min(self.batch_size, len(self._buf))
                recs = [self._buf.popleft() for _ in range(take)]
                self._delivered_batches += 1
                self._delivered_records += take
                self._publish_gauges_locked()
                self._cond.notify_all()
            yield self.collate(recs) if self.collate is not None \
                else recs

    def _deliver_gate(self):
        """The fault-injection boundary in front of every delivery:
        STALL = scripted backlog burst, RESET = transient delivery
        fault (absorbed + retried — records are never dropped here)."""
        from ..distributed.ps import rpc as _rpc
        while True:
            try:
                _rpc._fault("stream", "deliver", self.name)
                return
            except ConnectionResetError:
                with self._cond:
                    self._delivery_faults += 1
                    self._publish_gauges_locked()
                time.sleep(self.poll_s)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self):
        """Snapshot for the trainer checkpoint: undelivered buffer,
        dedupe window, and cursors. Restoring it on a fresh instance
        resumes delivery exactly at the cut."""
        with self._cond:
            return {
                "buffered": [dict(r) for r in self._buf],
                "seen": list(self._seen),
                "watermark": self._watermark,
                "accepted": self._accepted,
                "duplicates": self._duplicates,
                "delivered_batches": self._delivered_batches,
                "delivered_records": self._delivered_records,
            }

    def load_state_dict(self, state):
        with self._cond:
            self._buf = deque(dict(r) for r in state["buffered"])
            self._seen = OrderedDict((int(r), None)
                                     for r in state["seen"])
            self._watermark = int(state["watermark"])
            self._accepted = int(state["accepted"])
            self._duplicates = int(state["duplicates"])
            self._delivered_batches = int(state["delivered_batches"])
            self._delivered_records = int(state["delivered_records"])
            self._publish_gauges_locked()
            self._cond.notify_all()

    # -- observability -------------------------------------------------------
    def stats(self):
        with self._cond:
            return {
                "backlog": len(self._buf),
                "watermark": self._watermark,
                "accepted": self._accepted,
                "duplicates": self._duplicates,
                "rejected_full": self._rejected_full,
                "delivered_batches": self._delivered_batches,
                "delivered_records": self._delivered_records,
                "delivery_faults": self._delivery_faults,
            }

    def _publish_gauges_locked(self):
        from ..core import monitor as _monitor
        _monitor.stat_set_many({
            "stream.backlog": len(self._buf),
            "stream.watermark": self._watermark,
            "stream.accepted": self._accepted,
            "stream.duplicates": self._duplicates,
            "stream.rejected_full": self._rejected_full,
            "stream.delivered_batches": self._delivered_batches,
            "stream.delivered_records": self._delivered_records,
            "stream.delivery_faults": self._delivery_faults,
        })
