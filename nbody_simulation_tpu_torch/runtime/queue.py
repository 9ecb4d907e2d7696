"""Bounded lossy snapshot queue: ctypes over the native C++ ring, with a
pure-Python fallback of identical semantics.

The reference's sim→render channel is ``flume::bounded(2)`` (reference
src/main.rs:101-146): the producer drops a snapshot when the queue is full
(``try_send``), the consumer blocks on pop. The native source is
``runtime/native/snapshot_queue.cpp`` (built by ``runtime/nativelib.py``).
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import deque

from nbody_simulation_tpu_torch.runtime.nativelib import load_native

_lock = threading.Lock()
_lib = None
_tried = False


def _queue_lib():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            lib = load_native("snapshot_queue")
            if lib is not None:
                lib.sq_create.restype = ctypes.c_void_p
                lib.sq_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
                lib.sq_try_push.restype = ctypes.c_int
                lib.sq_try_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_size_t]
                lib.sq_pop.restype = ctypes.c_long
                lib.sq_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_size_t, ctypes.c_long]
                for name in ("sq_pushed", "sq_dropped"):
                    getattr(lib, name).restype = ctypes.c_uint64
                    getattr(lib, name).argtypes = [ctypes.c_void_p]
                lib.sq_len.restype = ctypes.c_size_t
                lib.sq_len.argtypes = [ctypes.c_void_p]
                lib.sq_is_full.restype = ctypes.c_int
                lib.sq_is_full.argtypes = [ctypes.c_void_p]
                lib.sq_close.restype = None
                lib.sq_close.argtypes = [ctypes.c_void_p]
                lib.sq_destroy.restype = None
                lib.sq_destroy.argtypes = [ctypes.c_void_p]
                _lib = lib
    return _lib


class SnapshotQueue:
    """Bounded lossy byte-slot queue. capacity=2 matches the reference."""

    def __init__(self, capacity: int = 2, slot_bytes: int = 8 << 20,
                 force_python: bool = False):
        self.capacity = capacity
        self.slot_bytes = slot_bytes
        self._lib = None if force_python else _queue_lib()
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.sq_create(capacity, slot_bytes))
            # Per-thread receive buffer: the bytes are read after sq_pop
            # returns, so concurrent pops must not share one buffer.
            self._tls = threading.local()
        else:
            self._dq: deque[bytes] = deque()
            self._cv = threading.Condition()
            self._pushed = 0
            self._dropped = 0
            self._closed = False

    @property
    def native(self) -> bool:
        return self._lib is not None

    def try_push(self, data: bytes) -> bool:
        """Non-blocking; drops (returns False) when full — flume try_send."""
        if self._lib is not None:
            return bool(self._lib.sq_try_push(self._h, data, len(data)))
        with self._cv:
            if self._closed or len(self._dq) >= self.capacity or \
                    len(data) > self.slot_bytes:
                self._dropped += 1
                return False
            self._dq.append(bytes(data))
            self._pushed += 1
            self._cv.notify()
            return True

    def pop(self, timeout: float | None = None) -> bytes | None:
        """Blocking pop; None on timeout or when closed-and-drained."""
        if self._lib is not None:
            buf = getattr(self._tls, "buf", None)
            if buf is None:
                buf = self._tls.buf = ctypes.create_string_buffer(self.slot_bytes)
            t = -1 if timeout is None else int(timeout * 1000)
            r = self._lib.sq_pop(self._h, buf, self.slot_bytes, t)
            if r < 0:
                return None
            return buf.raw[:r]
        with self._cv:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._dq and not self._closed:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return None
                self._cv.wait(rem)
            if not self._dq:
                return None
            return self._dq.popleft()

    def is_full(self) -> bool:
        if self._lib is not None:
            return bool(self._lib.sq_is_full(self._h))
        with self._cv:
            return len(self._dq) >= self.capacity

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.sq_len(self._h))
        with self._cv:
            return len(self._dq)

    @property
    def pushed(self) -> int:
        if self._lib is not None:
            return int(self._lib.sq_pushed(self._h))
        return self._pushed

    @property
    def dropped(self) -> int:
        if self._lib is not None:
            return int(self._lib.sq_dropped(self._h))
        return self._dropped

    def close(self) -> None:
        if self._lib is not None:
            self._lib.sq_close(self._h)
        else:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.sq_destroy(self._h)
