"""Spans and counters inside the program, on the profiler's clock.

``span(name)`` (or the decorator ``spanned(name)``, or ``span_calls(module,
name)`` for a module the program did not write) marks a stage where its
work happens: it records the name, the span it runs in, the host's start
and end (``time.perf_counter_ns``) and, when CUDA is initialised, a pair of
timing events on the current stream. ``count(name, n)`` adds to a
host-side counter; the program names each place it makes the host wait on
the card ``host_wait.<site>``. ``count_tensor(name, t)`` keeps a 0-d or [B]
tensor the program already made (``raster.instances``: the instances
binning expanded) and reads it only in ``summary()``. None of them launches
a kernel, copies or waits.

Tracing is on inside ``recording()`` and while a ``torch.profiler`` session
is active; each span is then also a ``torch.profiler.record_function``
range, so a profile shows the stages beside the device's activity. Off, a
span costs a check of the profiler's state (one C call) and returns a shared
null context; it never enters a profiler range. A session starts at the
first span or counter that finds tracing on and ends at the first that finds
it off, or when ``recording()`` exits; ``last_session()`` returns it, and
its ``summary()`` synchronises once and reads every event pair and kept
tensor (the summary of an ended session is kept, and its events are recorded
again by later sessions).

Spans nest per thread. A span opened on a thread with no span open (the
autograd engine's device thread, which runs ``_Composite.backward`` and
``_Preprocess.backward``) takes
as its parent the innermost span open on the thread that started the
session (``train.backward`` around ``torch.autograd.grad``). A session
holds at most ``MAX_SPANS`` spans and ``MAX_KEPT`` kept tensors (a kept
view holds its base's storage) and counts those it drops.

    with tracing.recording() as session:
        trainer.step()
    session.summary()["spans"]["raster.binning"]["device_self_ms"]
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

MAX_SPANS = 100_000
MAX_KEPT = 256
MAX_POOL = 4096

_profiling = torch._C._autograd._profiler_enabled
_record_function = torch.autograd.profiler.record_function
_NULL = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()
_streams: dict = {}
_pool: list = []        # timing events a read session gave back
_recording = False
_current: "Session | None" = None
_last: "Session | None" = None


def _stack() -> list:
    """This thread's open span records, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event() -> torch.cuda.Event:
    """A timing event recorded now on the current CUDA stream. The stream
    objects are cached by id, and the events of sessions already read are
    recorded again: ``torch.cuda.current_stream()`` and a new event's first
    record each cost more than a record."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    try:
        event = _pool.pop()
    except IndexError:
        event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


class Session:
    """What one traced window recorded. Each span record is
    [name, parent record, host start ns, host end ns, start event, end
    event]."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.kept: list = []            # (name, tensor)
        self.dropped = {"spans": 0, "tensors": 0}
        self._home = _stack()
        self._ref = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._ref = _event()
        self._summary = None

    def summary(self) -> dict:
        """{"spans": {name: {"count", "host_ms", "host_self_ms",
        "device_ms", "device_self_ms"}}, "counters": {name: int},
        "dropped": {"spans", "tensors"}}, sums over the session. A span's
        self time is its window less the part its child spans cover;
        device times are None off the card. Kept tensors are summed into
        "counters". Synchronises the card once."""
        if self._summary is not None:
            return self._summary
        ended = self is not _current
        recs = [r for r in list(self.spans) if r[3]]
        device = None
        if self._ref is not None:
            torch.cuda.synchronize()
            device = {id(r): (self._ref.elapsed_time(r[4]),
                              self._ref.elapsed_time(r[5])) for r in recs}
        host = {id(r): (r[2] / 1e6, r[3] / 1e6) for r in recs}
        counters = dict(self.counters)
        kept = list(self.kept)
        if kept:
            ts = [t.detach().reshape(-1).long() for _, t in kept]
            values = torch.cat([t.to(ts[0].device) for t in ts]).tolist()
            at = 0
            for (name, _), t in zip(kept, ts):
                n = t.shape[0]
                counters[name] = counters.get(name, 0) + int(sum(
                    values[at:at + n]))
                at += n
        children: dict = {}
        for r in recs:
            children.setdefault(id(r[1]), []).append(r)
        out: dict = {}
        for r in recs:
            kids = children.get(id(r), [])
            s = out.setdefault(r[0], {"count": 0, "host_ms": 0.0,
                                      "host_self_ms": 0.0,
                                      "device_ms": None if device is None
                                      else 0.0,
                                      "device_self_ms": None if device is None
                                      else 0.0})
            s["count"] += 1
            for clock, ms, self_ms in ((host, "host_ms", "host_self_ms"),
                                       (device, "device_ms",
                                        "device_self_ms")):
                if clock is None:
                    continue
                window = clock[id(r)]
                s[ms] += window[1] - window[0]
                s[self_ms] += self_time(window,
                                        [clock[id(k)] for k in kids])
        result = {"spans": out, "counters": counters,
                  "dropped": dict(self.dropped)}
        if ended:
            self._summary = result
            if self._ref is not None:
                self._release()
        return result

    def _release(self) -> None:
        """Give the read events back for later sessions to record again."""
        events = [self._ref] + [e for r in self.spans for e in r[4:6]
                                if e is not None]
        _pool.extend(events[:max(MAX_POOL - len(_pool), 0)])
        self._ref = None
        for r in self.spans:
            r[4] = r[5] = None


def self_time(window: tuple, inner: list) -> float:
    """The length of ``window`` (start, end) less the part the union of the
    ``inner`` windows covers."""
    lo, hi = window
    covered, at = 0.0, lo
    for s, t in sorted(inner):
        s, t = max(s, at), min(t, hi)
        if t > s:
            covered += t - s
            at = t
    return (hi - lo) - covered


def _session() -> Session:
    global _current
    s = _current
    if s is None:
        with _lock:
            if _current is None:
                _current = Session()
            s = _current
    return s


def _end() -> None:
    global _current, _last
    with _lock:
        if _current is not None:
            _last, _current = _current, None


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rec = self.rf = None

    def __enter__(self):
        if _profiling():
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        s = _session()
        stack = _stack()
        if len(s.spans) >= MAX_SPANS:
            s.dropped["spans"] += 1
            return self
        parent = stack[-1] if stack else (s._home[-1] if s._home else None)
        rec = [self.name, parent, time.perf_counter_ns(), 0, None, None]
        if s._ref is not None:
            rec[4] = _event()
        s.spans.append(rec)
        stack.append(rec)
        self.rec = rec
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if rec[4] is not None:
                rec[5] = _event()
            rec[3] = time.perf_counter_ns()
            _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _on() -> bool:
    """Whether tracing is on; when it is not, the open session ends."""
    if _recording or _profiling():
        return True
    if _current is not None:
        _end()
    return False


def span(name: str):
    """A context manager that records the block as span ``name`` when
    tracing is on, and does nothing otherwise."""
    return _Span(name) if _on() else _NULL


def spanned(name: str):
    """Decorate a function so that each call runs in span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def span_calls(module: torch.nn.Module, name: str) -> tuple:
    """Run each call of ``module`` (one the program did not write, such as
    a ``transformers`` block) in span ``name`` when tracing is on, through
    a forward pre-hook and a forward hook that runs even when the call
    raises; returns the two hook handles. Off, a call costs the hooks'
    check of the profiler's state."""
    opened = []

    def enter(mod, args):
        s = span(name)
        s.__enter__()
        opened.append(s)

    def leave(mod, args, output):
        opened.pop().__exit__(None, None, None)

    return (module.register_forward_pre_hook(enter),
            module.register_forward_hook(leave, always_call=True))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` when tracing is on."""
    if not _on():
        return
    s = _session()
    with _lock:
        s.counters[name] = s.counters.get(name, 0) + n


def count_tensor(name: str, t: torch.Tensor) -> None:
    """Keep ``t`` (0-d or [B] integers) to be summed into counter ``name``
    by ``summary()``, when tracing is on; nothing is read now."""
    if not _on():
        return
    s = _session()
    with _lock:
        if len(s.kept) < MAX_KEPT:
            s.kept.append((name, t))
        else:
            s.dropped["tensors"] += 1


@contextlib.contextmanager
def recording():
    """Turn tracing on for the block and yield its new session."""
    global _recording
    _end()
    _recording = True
    try:
        yield _session()
    finally:
        _recording = False
        _end()


def last_session() -> Session | None:
    """The open session, else the last one that ended (None before any)."""
    return _current or _last
