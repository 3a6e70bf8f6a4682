"""Signal plumbing shared by the graceful-shutdown paths.

The CLI maps SIGTERM onto KeyboardInterrupt so ^C and orchestrator stops
share one shutdown path (``cli._sigterm_as_interrupt``); the pieces here
protect the *cleanup* that path runs.  The reference has no analog — its
JVMs die where they stand (``README.md:12`` tells the operator to ctrl+c a
backend and watch the survivors cope).
"""

from __future__ import annotations

import contextlib
import signal
import threading


@contextlib.contextmanager
def flight_dump_on_signals(recorder, *, reason: str = "sigterm", signals=None):
    """Dump the flight recorder when SIGTERM lands, then run the previous
    handler.

    Installed around a role's serve loop (inside the CLI's
    SIGTERM→KeyboardInterrupt mapping), so an orchestrator stop leaves the
    same post-mortem artifact an injected crash does — the last N spans and
    events at the moment the stop arrived — before the graceful-shutdown
    path runs.  The dump itself is failure-contained (it never raises), so
    it cannot break the shutdown it decorates.

    Chains: our handler dumps, then delegates to whatever handler was
    installed before (the CLI's KeyboardInterrupt-raiser in practice); a
    SIG_DFL/SIG_IGN predecessor is restored and left to fire naturally.
    Main thread only; C-installed handlers (getsignal() → None) are left
    untouched, same policy as :func:`mask_interrupts`.
    """
    if signals is None:
        signals = (signal.SIGTERM,)
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    installed = []

    def _make(sig, prev):
        def handler(signum, frame):
            recorder.dump(reason)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                # Re-deliver with the default disposition (usually: die).
                signal.signal(signum, signal.SIG_DFL)
                import os

                os.kill(os.getpid(), signum)

        return handler

    try:
        for sig in signals:
            prev = signal.getsignal(sig)
            if prev is None:
                continue  # C-installed: unrestorable through this module
            installed.append((sig, signal.signal(sig, _make(sig, prev))))
    except BaseException as e:
        for sig, old in installed:
            signal.signal(sig, old)
        if isinstance(e, ValueError):  # no signal support in this context
            yield
            return
        raise
    try:
        yield
    finally:
        for sig, old in installed:
            signal.signal(sig, old)


@contextlib.contextmanager
def stop_after(timeout_s: float, stop_fn):
    """Bound a graceful wait: run ``stop_fn`` if the block outlives
    ``timeout_s``.

    Used by the backend's SIGTERM drain: the worker keeps serving the
    migration protocol until the frontend releases it, but an unreachable
    or wedged frontend must not turn an orchestrator stop into a hang —
    past the deadline the watchdog forces the worker's own stop() and the
    caller falls back to the abrupt-leave path.  The timer thread is a
    daemon and is cancelled on every exit path, so a prompt release costs
    nothing."""
    timer = threading.Timer(timeout_s, stop_fn)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


@contextlib.contextmanager
def mask_interrupts():
    """Ignore SIGINT/SIGTERM for the duration of a graceful drain.

    Once shutdown cleanup has started (SHUTDOWN fan-out, checkpoint-queue
    drain, store close), a second ^C/SIGTERM would abort it half-way while
    still exiting with the "clean" status code — worse than either outcome
    alone.  Cleanup is bounded work, so the signals are ignored rather than
    deferred; an operator who truly needs an immediate stop has SIGKILL.
    No-op off the main thread, and C-installed handlers (getsignal() →
    None — unrestorable through the signal module) are left untouched.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    masked = []
    try:
        for sig in (signal.SIGINT, signal.SIGTERM):
            if signal.getsignal(sig) is None:
                continue
            masked.append((sig, signal.signal(sig, signal.SIG_IGN)))
    except BaseException:
        for sig, old in masked:
            signal.signal(sig, old)
        raise
    try:
        yield
    finally:
        for sig, old in masked:
            signal.signal(sig, old)


@contextlib.contextmanager
def interrupts_as_messages(post):
    """Deliver ^C/SIGTERM through ``post()`` for the duration of the block.

    A handler that raises KeyboardInterrupt tears the main thread out of
    whatever it is running: after a queue's ``get()`` has returned a frame
    and before the frame is dispatched, or half-way through a dispatch.  A
    loop that must lose no frame installs this around itself: the previous
    handler still runs (the flight dump, the CLI's SIGTERM mapping), and the
    KeyboardInterrupt it raises becomes a call of ``post``, which queues a
    marker behind the frames already taken in; the loop raises the
    interrupt when it reaches the marker.  ``post`` runs inside a signal
    handler, so it must be reentrant (``queue.SimpleQueue.put`` is).
    No-op off the main thread; SIG_DFL, SIG_IGN and C-installed handlers
    are left as they are.
    """
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def _make(prev):
        def handler(signum, frame):
            try:
                prev(signum, frame)
            except KeyboardInterrupt:
                post()

        return handler

    installed = []
    try:
        for sig in (signal.SIGINT, signal.SIGTERM):
            prev = signal.getsignal(sig)
            if callable(prev):
                installed.append((sig, signal.signal(sig, _make(prev))))
    except BaseException:
        for sig, old in installed:
            signal.signal(sig, old)
        raise
    try:
        yield
    finally:
        for sig, old in installed:
            signal.signal(sig, old)
