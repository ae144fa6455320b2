"""Host-side pub/sub event bus.

Counterpart of ``gslam_tpu/app/messenger.py``, the same behaviour in the
port's own copy (pure Python).  The reference's ``Messenger``
(``GSLAM/core/Messenger.h``) is a ROS-style in-process bus: typed
topics, ``shared_ptr`` zero-copy payloads, and a bounded per-subscriber
queue drained by worker threads.

Here device dataflow is PyTorch calls on the card, so the bus carries
host wiring only: dataset playback, current-frame and map-update
notifications to the eval / viz consumers, and end of stream.  Python
object references give the same zero-copy payload semantics.
Subscribers are synchronous (callback inline on publish: deterministic,
used in tests) or queued (a bounded queue drained by a worker thread,
the reference's model; when full, the oldest message is dropped).

A queued callback that raises stops its subscriber: the exception is
kept in ``Subscriber.error``, no later message is delivered to it, and
``flush`` raises it.  (The reference prints it and goes on with the
next message, so a failed step would pass unseen.)
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, List, Optional


class Subscriber:
    def __init__(self, bus: "Messenger", topic: str, queue_size: int,
                 callback: Callable[[Any], None]):
        self._bus = bus
        self.topic = topic
        self.queue_size = queue_size
        self.callback = callback
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        if queue_size > 0:
            self._queue = queue.Queue(maxsize=queue_size)
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        assert self._queue is not None
        while not self._stop.is_set():
            try:
                msg = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self.callback(msg)
            except BaseException as exc:
                # kept for flush() to raise; this subscriber stops here
                self.error = exc
                self._stop.set()
            finally:
                self._queue.task_done()

    def _deliver(self, msg: Any) -> None:
        if self.error is not None:
            return
        if self._queue is None:
            self.callback(msg)
        else:
            try:
                self._queue.put_nowait(msg)
            except queue.Full:
                # bounded queue: drop oldest (reference drops when full)
                try:
                    self._queue.get_nowait()
                    self._queue.task_done()
                except queue.Empty:
                    pass
                try:
                    self._queue.put_nowait(msg)
                except queue.Full:
                    pass

    def shutdown(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=1.0)
        self._bus._unsubscribe(self)

    def flush(self, timeout: float = 5.0) -> None:
        """Block until this subscriber's queue is drained and its last
        callback has returned, or ``timeout`` seconds have passed; raise
        the exception a callback raised.  (The reference returns once the
        queue is empty, while the callback of the last message may still
        run.)"""
        if self._queue is None:
            return
        import time

        deadline = time.monotonic() + timeout
        while (self._queue.unfinished_tasks and self.error is None
               and time.monotonic() < deadline):
            time.sleep(0.001)
        if self.error is not None:
            raise self.error


class Publisher:
    def __init__(self, bus: "Messenger", topic: str):
        self._bus = bus
        self.topic = topic

    def publish(self, msg: Any) -> int:
        return self._bus.publish(self.topic, msg)

    def get_num_subscribers(self) -> int:
        return len(self._bus._subs.get(self.topic, []))


class Messenger:
    """Topic bus: ``advertise`` / ``subscribe`` / ``publish``."""

    def __init__(self):
        self._lock = threading.RLock()
        self._subs: Dict[str, List[Subscriber]] = {}

    def advertise(self, topic: str, queue_size: int = 0) -> Publisher:
        # queue_size kept for API parity; queuing lives on the subscriber side.
        del queue_size
        return Publisher(self, topic)

    def subscribe(self, topic: str, queue_size: int,
                  callback: Callable[[Any], None]) -> Subscriber:
        sub = Subscriber(self, topic, queue_size, callback)
        with self._lock:
            self._subs.setdefault(topic, []).append(sub)
        return sub

    def _unsubscribe(self, sub: Subscriber) -> None:
        with self._lock:
            subs = self._subs.get(sub.topic, [])
            if sub in subs:
                subs.remove(sub)

    def publish(self, topic: str, msg: Any) -> int:
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for sub in subs:
            sub._deliver(msg)
        return len(subs)

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(t for t, s in self._subs.items() if s)

    def shutdown(self) -> None:
        with self._lock:
            subs = [s for lst in self._subs.values() for s in lst]
        for s in subs:
            s.shutdown()


#: process-global bus, like the reference's global ``messenger``.
messenger = Messenger()
