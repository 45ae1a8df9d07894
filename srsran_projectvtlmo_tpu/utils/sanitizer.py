"""Host-side thread sanitizer: lockset race detection + lock-order checking.

The reference relies on compiler sanitizers for its lockfree/threaded host
code (reference: CMakeLists.txt:59-60 ENABLE_TSAN/ENABLE_ASAN, mutually
exclusive, run in CI).  The rebuild's host side is Python, where TSAN
does not apply, so this module provides the equivalent instrumentation for
the framework's own threaded components (phy/realtime.py, utils/log.py,
utils/tracing.py):

* ``TrackedLock`` — a ``threading.Lock`` wrapper that reports acquisitions to
  a global lock-order graph.  A cycle in that graph (lock A held while taking
  B in one thread, B held while taking A in another) is a potential deadlock,
  reported even if the interleaving never actually deadlocks in the run.
* ``Monitored`` — Eraser-style lockset checking [Savage et al., SOSP'97] for
  shared state: every monitored field keeps a candidate lockset, intersected
  with the locks held at each access.  A write reachable from two threads
  with an empty candidate lockset is a data race.  The classic
  virgin → exclusive → shared → shared-modified state machine avoids false
  positives on thread-local init and read-only publish patterns.

Zero overhead when disabled: ``enable()``/``disable()`` switch a module flag
checked before any bookkeeping; production code paths use plain locks unless
a stress test opts in.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

_enabled = False
_registry_lock = threading.RLock()  # re-entrant: _check_order reports under it
_lock_order: dict[str, set[str]] = {}
_reports: list[str] = []
_tls = threading.local()


def enable() -> None:
    global _enabled
    with _registry_lock:
        _lock_order.clear()
        _reports.clear()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reports() -> list[str]:
    with _registry_lock:
        return list(_reports)


def _held() -> list[str]:
    if not hasattr(_tls, "held"):
        _tls.held = []
    return _tls.held


def _report(msg: str) -> None:
    with _registry_lock:
        if msg not in _reports:
            _reports.append(msg)


def _check_order(new_lock: str) -> None:
    """Record held-locks -> new_lock edges; report cycles (deadlock risk)."""
    held = _held()
    with _registry_lock:
        for h in held:
            if h == new_lock:
                continue
            _lock_order.setdefault(h, set()).add(new_lock)
        # DFS from new_lock: a path back to any currently-held lock closes a
        # cycle in the acquisition graph.
        stack, seen = [new_lock], set()
        while stack:
            node = stack.pop()
            if node in seen:
                continue
            seen.add(node)
            for nxt in _lock_order.get(node, ()):
                if nxt in held:
                    _report(
                        f"lock-order inversion: taking '{new_lock}' while "
                        f"holding '{nxt}' reverses an existing "
                        f"'{new_lock}' -> ... -> '{nxt}' ordering")
                else:
                    stack.append(nxt)


class TrackedLock:
    """``threading.Lock`` with lock-order instrumentation (context manager).

    Distinct instances sharing a role name are disambiguated with the
    instance id so two pools' locks never alias in the order graph; the
    bookkeeping runs only while the sanitizer is enabled (true zero overhead
    when disabled), and a release from a thread that did not acquire is
    reported rather than silently corrupting that thread's held list.
    """

    def __init__(self, name: str):
        self.name = f"{name}@{id(self):#x}"
        self._lock = threading.Lock()
        self._owner: int | None = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _enabled:
            _check_order(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            if _enabled:
                _held().append(self.name)
        return got

    def release(self) -> None:
        if _enabled:
            if self._owner is not None and self._owner != threading.get_ident():
                _report(f"cross-thread release: '{self.name}' released by a "
                        f"thread that did not acquire it")
            held = _held()
            if self.name in held:
                held.remove(self.name)
        self._owner = None
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# Eraser lockset states.
_VIRGIN, _EXCLUSIVE, _SHARED, _SHARED_MOD = range(4)


@dataclass
class _FieldState:
    state: int = _VIRGIN
    owner: int | None = None
    lockset: set[str] | None = None  # None = "all locks" (top element)
    reported: bool = False


class Monitored:
    """Attribute-access monitor implementing the Eraser lockset algorithm.

    Wrap a plain object: ``mon = Monitored(obj, "slot_pipeline")``.  All
    attribute reads/writes through the wrapper are checked; pass the wrapper
    to the threads under test.  Fields starting with '_san_' are internal.
    """

    def __init__(self, target: object, name: str):
        object.__setattr__(self, "_san_target", target)
        object.__setattr__(self, "_san_name", name)
        object.__setattr__(self, "_san_fields", {})
        object.__setattr__(self, "_san_lock", threading.Lock())

    def _san_access(self, attr: str, is_write: bool) -> None:
        if not _enabled:
            return
        tid = threading.get_ident()
        cur = set(_held())
        with object.__getattribute__(self, "_san_lock"):
            fields: dict[str, _FieldState] = object.__getattribute__(
                self, "_san_fields")
            fs = fields.setdefault(attr, _FieldState())
            if fs.state == _VIRGIN:
                fs.state = _EXCLUSIVE
                fs.owner = tid
                return
            if fs.state == _EXCLUSIVE:
                if fs.owner == tid:
                    return
                fs.state = _SHARED_MOD if is_write else _SHARED
                fs.lockset = cur
            else:
                fs.lockset = cur if fs.lockset is None else (fs.lockset & cur)
                if is_write:
                    fs.state = _SHARED_MOD
            if fs.state == _SHARED_MOD and not fs.lockset and not fs.reported:
                fs.reported = True
                name = object.__getattribute__(self, "_san_name")
                _report(f"data race: '{name}.{attr}' written by multiple "
                        f"threads with no common lock")

    def __getattr__(self, attr: str):
        self._san_access(attr, is_write=False)
        return getattr(object.__getattribute__(self, "_san_target"), attr)

    def __setattr__(self, attr: str, value) -> None:
        self._san_access(attr, is_write=True)
        setattr(object.__getattribute__(self, "_san_target"), attr, value)
