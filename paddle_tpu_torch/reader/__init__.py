"""paddle.reader, the fluid-era reader decorators
(paddle_tpu/reader/__init__.py, copied as it is: pure Python).

Reference python/paddle/reader/decorator.py: a *reader creator* is a
zero-argument callable returning a generator of samples; these
combinators wrap creators, and ``batch`` (``paddle.batch``) groups their
samples. The 2.x path is ``paddle.io.DataLoader``.
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import threading

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache", "multiprocess_reader",
           "ComposeNotAligned", "batch"]


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size (reference
    python/paddle/batch.py:18 — exposed at the paddle root as
    paddle.batch)."""
    batch_size = int(batch_size)
    if batch_size <= 0:
        raise ValueError(
            "batch_size should be a positive integer value, "
            f"but got batch_size={batch_size}")

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    """reader of func(*samples) over zipped readers (decorator.py
    map_readers)."""
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle (decorator.py shuffle)."""
    def new_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return new_reader


def chain(*readers):
    """Concatenate readers (decorator.py chain)."""
    def reader():
        return itertools.chain(*[r() for r in readers])
    return reader


def compose(*readers, **kwargs):
    """Zip readers into flat tuples (decorator.py compose).
    check_alignment=True raises ComposeNotAligned on length mismatch."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())
            return
        while True:
            outputs = []
            done = 0
            for r in rs:
                try:
                    outputs.append(next(r))
                except StopIteration:
                    done += 1
            if done == len(rs):
                return
            if done:
                raise ComposeNotAligned(
                    "readers have different lengths")
            yield sum((make_tuple(o) for o in outputs), ())
    return reader


def buffered(reader, size):
    """Prefetch into a bounded queue on a thread (decorator.py
    buffered)."""
    END = object()

    def new_reader():
        q = queue.Queue(maxsize=size)

        def fill():
            try:
                for e in reader():
                    q.put(e)
            finally:
                q.put(END)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is END:
                return
            yield e
    return new_reader


def firstn(reader, n):
    def new_reader():
        return itertools.islice(reader(), n)
    return new_reader


def cache(reader):
    """Materialize once, replay from memory (decorator.py cache)."""
    all_data = []
    filled = [False]

    def new_reader():
        if not filled[0]:
            all_data.extend(reader())
            filled[0] = True
        yield from all_data
    return new_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads (decorator.py
    xmap_readers). order=True preserves input order."""
    END = object()

    def new_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(END)

        def work():
            while True:
                item = in_q.get()
                if item is END:
                    out_q.put(END)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        finished = 0
        if not order:
            while finished < process_num:
                item = out_q.get()
                if item is END:
                    finished += 1
                    continue
                yield item[1]
            return
        pending = {}
        nxt = 0
        while finished < process_num or pending:
            if nxt in pending:
                yield pending.pop(nxt)
                nxt += 1
                continue
            item = out_q.get()
            if item is END:
                finished += 1
                continue
            pending[item[0]] = item[1]
        while nxt in pending:
            yield pending.pop(nxt)
            nxt += 1
    return new_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers concurrently (decorator.py
    multiprocess_reader; worker THREADS here — the samples come from
    in-process synthetic datasets, so process isolation buys nothing)."""
    END = object()

    def new_reader():
        q = queue.Queue(queue_size)

        def run(r):
            try:
                for e in r():
                    q.put(e)
            finally:
                q.put(END)

        for r in readers:
            threading.Thread(target=run, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            e = q.get()
            if e is END:
                finished += 1
                continue
            yield e
    return new_reader
