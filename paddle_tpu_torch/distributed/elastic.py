"""Failure detection and elastic restart (paddle_tpu/distributed/elastic.py).

What lives here is detection and supervision: a heartbeat file any
watcher can read (``Heartbeat``), a stall monitor that fires a callback
when training stops progressing (``StallMonitor``: a hung collective or
a dead input pipeline), the bounded reaper (``_reap``) and the
``Supervisor``, the launcher-side loop (``launch.py --elastic``) that
kills and restarts trainers on death, heartbeat loss or stalled
progress, with backoff and a ``PADDLE_ELASTIC_MAX_RESTARTS`` budget.
Restarted trainers resume exactly from the verified auto-checkpoint
(``incubate/checkpoint.py``).

What a restart restarts:

- **A process group restarts whole** (``Supervisor(group=True)``, which
  ``launch_elastic`` uses for a collective job of more than one rank).
  The port runs one process per rank; when one rank dies or stalls, the
  others sit in a collective with a dead peer, and a new process cannot
  join the old group. So every rank is reaped and the group starts again
  at a new rendezvous. In the JAX package one process is the whole
  single-host job, so its restart of "the trainer" is this same thing.
- **Independent trainers restart one at a time** (``group=False``, the
  default): parameter-server trainers do not depend on each other, and a
  dead one rejoins the servers on its own, as in the JAX package.

The training loops (``Model.fit``, ``Executor.train_from_dataset``, the
``PipelineRunner`` hot loop) call ``notify_step()`` once a completed
step; every started ``StallMonitor`` and ``Heartbeat`` registers itself
as a listener.
"""
from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from typing import Callable, Optional

__all__ = ["Heartbeat", "StallMonitor", "Supervisor", "notify_step"]

_listeners_lock = threading.Lock()
_listeners: set = set()


def notify_step(step=None):
    """One completed training step: refresh every active StallMonitor /
    Heartbeat."""
    if not _listeners:
        return
    with _listeners_lock:
        targets = list(_listeners)
    for t in targets:
        try:
            t.step_done(step)
        except Exception:
            pass


def _register(listener):
    with _listeners_lock:
        _listeners.add(listener)


def _unregister(listener):
    with _listeners_lock:
        _listeners.discard(listener)


class Heartbeat:
    """Periodic liveness file ``{dir}/heartbeat_{rank}.json`` holding
    rank, step and timestamp. The beat thread writes the live step:
    ``step_fn`` wins, else the counter that ``notify_step()`` /
    ``update(step=...)`` refresh."""

    def __init__(self, directory, rank=None, interval_s=10.0,
                 step_fn: Optional[Callable[[], int]] = None):
        from .env import get_rank
        os.makedirs(directory, exist_ok=True)
        self.rank = get_rank() if rank is None else rank
        self.path = os.path.join(directory, f"heartbeat_{self.rank}.json")
        self.interval_s = interval_s
        self._step = 0
        self._step_fn = step_fn
        self._stop = threading.Event()
        self._thread = None

    def step_done(self, step=None):
        if step is not None:
            self._step = int(step)
        else:
            self._step += 1

    def update(self, step=None):
        if step is not None:
            self._step = int(step)
        if self._step_fn is not None:
            try:
                self._step = int(self._step_fn())
            except Exception:
                pass
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "step": self._step,
                       "time": time.time()}, f)
        os.replace(tmp, self.path)

    def start(self):
        def beat():
            while not self._stop.wait(self.interval_s):
                self.update()
        self.update()
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()
        _register(self)
        return self

    def stop(self):
        self._stop.set()
        _unregister(self)

    @staticmethod
    def read(directory):
        """{rank: {"step", "time"}} for every readable beat file; an
        unreadable or corrupt file maps to None."""
        out = {}
        try:
            names = sorted(os.listdir(directory))
        except OSError:
            return out
        for name in names:
            if not (name.startswith("heartbeat_")
                    and name.endswith(".json")):
                continue
            try:
                rank = int(name[len("heartbeat_"):-len(".json")])
            except ValueError:
                continue
            try:
                with open(os.path.join(directory, name)) as f:
                    rec = json.load(f)
                out[int(rec.get("rank", rank))] = {
                    "step": int(rec.get("step", 0)),
                    "time": float(rec["time"])}
            except (OSError, ValueError, KeyError, TypeError):
                out[rank] = None
        return out

    @staticmethod
    def check(directory, timeout_s=60.0):
        """Ranks whose heartbeat is stale or unreadable. Never raises on
        a bad beat file; publishes the oldest readable beat's age as the
        ``elastic.heartbeat_age_s`` gauge."""
        from ..core import monitor as _monitor
        now = time.time()
        stale, ages = [], []
        for rank, rec in Heartbeat.read(directory).items():
            if rec is None:
                stale.append(rank)
                continue
            age = now - rec["time"]
            ages.append(age)
            if age > timeout_s:
                stale.append(rank)
        if ages:
            _monitor.stat_set("elastic.heartbeat_age_s", max(ages))
        return stale


def _default_on_stall(dt):
    """Count the stall, flight-record it and warn."""
    from ..core import flight_recorder as _fr
    from ..core import monitor as _monitor
    _monitor.stat_add("elastic.stalls")
    _fr.dump("stall", extra={"stalled_s": dt})
    print(f"[paddle_tpu_torch] WARNING: no training step for {dt:.0f}s — "
          "hung collective or starved input pipeline?", flush=True)


class StallMonitor:
    """Fires ``on_stall`` when no step completes for ``timeout_s``.
    Started monitors register as ``notify_step()`` listeners. The default
    ``on_stall`` bumps ``elastic.stalls`` and writes a flight-recorder
    dump (reason ``stall``)."""

    def __init__(self, timeout_s=300.0,
                 on_stall: Optional[Callable[[float], None]] = None):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or _default_on_stall
        self._last = time.time()
        self._stop = threading.Event()
        self._thread = None
        self.stalled = False

    def step_done(self, step=None):
        self._last = time.time()
        self.stalled = False

    def start(self):
        def watch():
            while not self._stop.wait(min(self.timeout_s / 4, 30.0)):
                dt = time.time() - self._last
                if dt > self.timeout_s and not self.stalled:
                    self.stalled = True
                    self.on_stall(dt)
        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        _register(self)
        return self

    def stop(self):
        self._stop.set()
        _unregister(self)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def _reap(procs, grace_s=5.0, term_first=True):
    """Terminate child processes without ever hanging: TERM, a bounded
    wait, then KILL, and keep going — one wedged child must not leak
    its siblings."""
    import signal as _signal
    procs = [p for p in procs if p is not None]
    if term_first:
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(_signal.SIGTERM)
                except OSError:
                    pass
    for p in procs:
        try:
            p.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            try:
                p.kill()
            except OSError:
                pass
            try:
                p.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                pass
        except OSError:
            pass


class Supervisor:
    """Kill-and-restart supervision. ``start_fn(rank) -> Popen`` starts
    one trainer; the supervisor watches for death (a non-zero exit),
    silence (a heartbeat older than ``heartbeat_timeout_s`` or
    unreadable) and stalls (beats whose step has not advanced for
    ``stall_timeout_s``).

    ``group=False``: the failed rank alone restarts (independent PS
    trainers). ``group=True``: every rank is reaped and the group starts
    again, rank 0 first (a process group's ranks cannot outlive a peer).
    Each restart backs off linearly (``backoff_s`` x restarts) and burns
    one unit of the budget (per rank, or of the group); an exhausted
    budget tears the job down and raises ``SystemExit`` with the child's
    status. Ranks that exit 0 are done."""

    def __init__(self, start_fn, nranks=1, heartbeat_dir=None,
                 max_restarts=None, backoff_s=None,
                 heartbeat_timeout_s=None, stall_timeout_s=None,
                 poll_s=0.2, group=False):
        from ..core.flags import flag as _flag
        self._start = start_fn
        self.nranks = int(nranks)
        self.heartbeat_dir = heartbeat_dir
        self.max_restarts = int(_flag("PADDLE_ELASTIC_MAX_RESTARTS")
                                if max_restarts is None else max_restarts)
        self.backoff_s = float(_flag("PADDLE_ELASTIC_RESTART_BACKOFF_S")
                               if backoff_s is None else backoff_s)
        self.heartbeat_timeout_s = float(
            _flag("PADDLE_ELASTIC_HEARTBEAT_TIMEOUT_S")
            if heartbeat_timeout_s is None else heartbeat_timeout_s)
        self.stall_timeout_s = float(
            _flag("PADDLE_ELASTIC_STALL_TIMEOUT_S")
            if stall_timeout_s is None else stall_timeout_s)
        self.poll_s = float(poll_s)
        self.group = bool(group)
        self.restarts = {r: 0 for r in range(self.nranks)}
        self.group_restarts = 0
        self.events: list = []   # (time, rank, reason) timeline

    def _note(self, rank, reason, count):
        from ..core import monitor as _monitor
        self.events.append((time.time(), rank, reason))
        _monitor.stat_add("elastic.restarts")
        what = "group restart" if self.group else "restart"
        print(f"[paddle_tpu_torch.elastic] rank {rank}: {reason}; {what} "
              f"{count}/{self.max_restarts}", flush=True)

    def _restart(self, procs, rank, reason, rc=None):
        from ..core import flight_recorder as _fr
        self.restarts[rank] += 1
        if self.group:
            self.group_restarts += 1
        count = self.group_restarts if self.group else self.restarts[rank]
        if count > self.max_restarts:
            _fr.dump("elastic_budget_exhausted",
                     extra={"rank": rank, "reason": reason,
                            "restarts": count - 1})
            _reap(list(procs.values()))
            raise SystemExit(rc if rc not in (None, 0) else 1)
        self._note(rank, reason, count)
        _fr.dump("elastic_restart", extra={"rank": rank, "reason": reason,
                                           "restart": count,
                                           "group": self.group})
        ranks = list(range(self.nranks)) if self.group else [rank]
        _reap([procs[r] for r in ranks])
        time.sleep(self.backoff_s * count)
        for r in ranks:
            procs[r] = self._start(r)
        return ranks

    def run(self):
        procs = {rank: self._start(rank) for rank in range(self.nranks)}
        done: set = set()
        # a beat file older than the current attempt's start belongs to
        # an earlier incarnation and proves neither liveness nor death
        last_step = {r: None for r in range(self.nranks)}
        step_time = {r: time.time() for r in range(self.nranks)}
        started = {r: time.time() for r in range(self.nranks)}

        def _reset(ranks):
            for r in ranks:
                started[r] = step_time[r] = time.time()
                last_step[r] = None
                done.discard(r)

        try:
            while len(done) < self.nranks:
                beats = (Heartbeat.read(self.heartbeat_dir)
                         if self.heartbeat_dir else {})
                now = time.time()
                for rank in range(self.nranks):
                    if rank in done:
                        continue
                    rc = procs[rank].poll()
                    if rc == 0:
                        done.add(rank)
                        continue
                    if rc is not None:
                        _reset(self._restart(procs, rank,
                                             f"exited rc={rc}", rc=rc))
                        break
                    if not self.heartbeat_dir:
                        continue
                    rec = beats.get(rank)
                    if rec is not None and rec["time"] < started[rank]:
                        rec = None
                    if rec is None:
                        if now - started[rank] > self.heartbeat_timeout_s:
                            _reset(self._restart(
                                procs, rank, "heartbeat missing/unreadable"))
                            break
                        continue
                    if now - rec["time"] > self.heartbeat_timeout_s:
                        _reset(self._restart(
                            procs, rank,
                            f"heartbeat stale ({now - rec['time']:.1f}s)"))
                        break
                    if rec["step"] != last_step[rank]:
                        last_step[rank] = rec["step"]
                        step_time[rank] = now
                    elif now - step_time[rank] > self.stall_timeout_s:
                        from ..core import monitor as _monitor
                        _monitor.stat_add("elastic.stalls")
                        _reset(self._restart(
                            procs, rank,
                            f"stalled at step {rec['step']} for "
                            f"{now - step_time[rank]:.1f}s"))
                        break
                time.sleep(self.poll_s)
        except KeyboardInterrupt:
            _reap(list(procs.values()))
            raise
        except SystemExit:
            raise
        except BaseException:
            _reap(list(procs.values()))
            raise
        return 0
