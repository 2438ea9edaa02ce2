"""Typed topic pub/sub messaging.

Counterpart of ``slamrs_tpu/graph/pubsub.py``:

* string-named topics, each of one value type: the first publisher or
  subscriber that names a type pins it, and a later mismatch raises
  :class:`TopicTypeError`;
* publishers enqueue, and :meth:`PubSub.tick` drains every topic's queue
  to all of its subscribers; values are shared by reference, so nodes
  treat what they receive as immutable;
* :class:`Ticker` ticks from a background thread and calls the waker.
  It only moves messages between queues: every torch operation stays on
  the thread that runs the nodes (``App.frame``).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class TopicTypeError(TypeError):
    """A topic was used with two different value types."""


class _Topic:
    def __init__(self, name: str):
        self.name = name
        self.value_type: Optional[type] = None
        self.incoming: deque = deque()
        self.subscribers: list[Subscription] = []

    def pin_type(self, value_type: Optional[type]):
        if value_type is None:
            return
        if self.value_type is None:
            self.value_type = value_type
        elif self.value_type is not value_type:
            raise TopicTypeError(
                f"topic {self.name!r} is pinned to {self.value_type.__name__}, "
                f"got {value_type.__name__}")


class Publisher(Generic[T]):
    """Enqueues values on one topic."""

    def __init__(self, pubsub: "PubSub", topic: _Topic):
        self._pubsub = pubsub
        self._topic = topic

    def publish(self, value: T) -> None:
        if self._topic.value_type is not None and not isinstance(
                value, self._topic.value_type):
            raise TopicTypeError(
                f"topic {self._topic.name!r} expects "
                f"{self._topic.value_type.__name__}, got {type(value).__name__}")
        with self._pubsub._lock:
            self._topic.incoming.append(value)
        self._pubsub._signal()


class Subscription(Generic[T]):
    """One subscriber's queue of a topic's values."""

    def __init__(self, topic: _Topic):
        self._topic = topic
        self._queue: deque = deque()

    def try_recv(self) -> Optional[T]:
        try:
            return self._queue.popleft()
        except IndexError:
            return None

    def drain(self) -> list:
        out = list(self._queue)
        self._queue.clear()
        return out

    def latest(self) -> Optional[T]:
        """Drop all but the newest pending value and return it."""
        out = None
        while self._queue:
            out = self._queue.popleft()
        return out

    def __len__(self) -> int:
        return len(self._queue)


class PubSub:
    """The topics of one node graph."""

    def __init__(self) -> None:
        self._topics: dict[str, _Topic] = {}
        self._lock = threading.Lock()
        self._waker: Optional[Callable[[], None]] = None

    def _topic(self, name: str, value_type: Optional[type]) -> _Topic:
        t = self._topics.get(name)
        if t is None:
            t = self._topics[name] = _Topic(name)
        t.pin_type(value_type)
        return t

    def publish(self, name: str, value_type: Optional[type] = None
                ) -> Publisher:
        return Publisher(self, self._topic(name, value_type))

    def subscribe(self, name: str, value_type: Optional[type] = None
                  ) -> Subscription:
        t = self._topic(name, value_type)
        sub = Subscription(t)
        t.subscribers.append(sub)
        return sub

    def tick(self) -> int:
        """Drain every topic's incoming queue to all subscribers.
        Returns the number of distributed values."""
        n = 0
        with self._lock:
            for t in self._topics.values():
                while t.incoming:
                    v = t.incoming.popleft()
                    for s in t.subscribers:
                        s._queue.append(v)
                    n += 1
        if n and self._waker is not None:
            self._waker()
        return n

    def set_waker(self, waker: Callable[[], None]) -> None:
        self._waker = waker

    def _signal(self) -> None:
        pass  # synchronous tick model; Ticker polls

    def topic_names(self) -> list[str]:
        return sorted(self._topics)


class Ticker:
    """Background tick thread with waker.

    Optional: interactive/host mode only.  ``stop()`` joins the thread.
    """

    def __init__(self, pubsub: PubSub, interval_s: float = 0.005):
        self._pubsub = pubsub
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._pubsub.tick()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()
        self._pubsub.tick()  # final drain
