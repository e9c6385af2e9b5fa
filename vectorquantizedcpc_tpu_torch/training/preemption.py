"""Preemption-signal checkpointing (a copy of the JAX package's ``training/preemption.py``).

A preemptible machine gets SIGTERM with a grace window. This module turns
that signal into a flag the train loop polls at epoch-group boundaries: it
saves a final checkpoint and returns, and the same command with
``resume=<checkpoint>`` picks up where the preemption hit.

Signal handlers are process-global and must be installed from the main
thread; installation is idempotent, a no-op elsewhere, and chains any
previously installed handler.
"""

import signal
import threading
from typing import Iterable

_FLAG = threading.Event()
_INSTALLED: set = set()


def install_preemption_handler(
    signals: Iterable[int] = (signal.SIGTERM,),
) -> bool:
    """Route ``signals`` to the preemption flag. Returns True if active."""
    if threading.current_thread() is not threading.main_thread():
        return False
    for signum in signals:
        if signum in _INSTALLED:
            continue
        prev = signal.getsignal(signum)

        def handler(s, frame, _prev=prev):
            _FLAG.set()
            print(
                "Preemption signal received: will checkpoint and exit at "
                "the next step boundary.",
                flush=True,
            )
            if callable(_prev) and _prev not in (
                signal.SIG_IGN,
                signal.SIG_DFL,
                signal.default_int_handler,
            ):
                _prev(s, frame)

        try:
            signal.signal(signum, handler)
        except (ValueError, OSError):
            return False
        _INSTALLED.add(signum)
    return True


def preemption_requested() -> bool:
    return _FLAG.is_set()


def request_preemption() -> None:
    """Set the flag programmatically (tests; external orchestrators)."""
    _FLAG.set()


def clear_preemption() -> None:
    """Reset the flag (tests; or after a handled save when continuing)."""
    _FLAG.clear()
