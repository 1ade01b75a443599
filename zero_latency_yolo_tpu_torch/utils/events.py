"""Process-local pub/sub event bus keyed by string event type.

Equivalent of the reference's EventBus singleton (src/common/event_bus.h:111-177).
Handlers run synchronously on the publishing thread; exceptions are logged and
swallowed so one bad subscriber cannot break the hot path.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List

from .logging import get_logger

log = get_logger("events")

# Event names (reference src/common/event_bus.h:17-32).
CLIENT_CONNECTED = "client_connected"
CLIENT_DISCONNECTED = "client_disconnected"
CLIENT_TIMEOUT = "client_timeout"
PACKET_RECEIVED = "packet_received"
PACKET_SENT = "packet_sent"
INFERENCE_COMPLETED = "inference_completed"
MODEL_UPDATED = "model_updated"
SERVER_STARTED = "server_started"
SERVER_STOPPING = "server_stopping"


class EventBus:
    def __init__(self) -> None:
        self._subs: Dict[str, List[Callable[[str, Any], None]]] = defaultdict(list)
        self._lock = threading.Lock()

    def subscribe(self, event: str, handler: Callable[[str, Any], None]) -> None:
        with self._lock:
            self._subs[event].append(handler)

    def unsubscribe(self, event: str, handler: Callable[[str, Any], None]) -> None:
        with self._lock:
            if handler in self._subs.get(event, []):
                self._subs[event].remove(handler)

    def publish(self, event: str, payload: Any = None) -> None:
        with self._lock:
            handlers = list(self._subs.get(event, ()))
        for h in handlers:
            try:
                h(event, payload)
            except Exception:  # noqa: BLE001
                log.exception("event handler failed for %s", event)

    def clear(self) -> None:
        with self._lock:
            self._subs.clear()


EVENT_BUS = EventBus()
