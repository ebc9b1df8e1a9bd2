"""The port's tracer: spans and counters where the work happens, on the
clock of `torch.profiler`'s events, and the tags that keep the loop
closer's work apart from the main path's.

Tags. A launch, a span or a count belongs to the main path (`MAIN`) unless
it is made under `counting_as(tag, stream)`: on the card the launches on
`stream` count under `tag` (a backward runs on its forward's stream, in the
autograd engine's thread), and the calling thread's spans, counts and CPU
twin calls record under it. The loop closer's thread runs under "lc", so
its spans never cover the loop's. `LaunchCounts` holds the kernels'
launch counters (`ops/composite_sorted.py` `counts()`, ...), one set a tag.

Spans and counters. `span(name)` is a context manager; a recorded span
holds its name, its id, its parent (the innermost span open on the same
thread), the frame id (`frame(frame_id)`, the root span the SLAM loop
opens each frame), the thread's tag and native id, and `t0_ns` / `t1_ns`
from `time.time_ns()`, the clock the profiler's events carry.
`count(name, n)` adds to a counter of the current frame and tag. Both
record only while tracing is on: after `enable()`, or while a
`torch.profiler` profile records, as `record_function` does (the
benchmark's traced run relies on the profile; `enable()` is for a caller
that traces without one). That state is looked up where a timed stage or a
frame opens (`Stages.span`, `frame`), a few times a frame; in between a
`span` or a `count` costs one flag check, and off it returns a shared null
context and allocates nothing. Records stay in memory until `drain()`
hands them over; only the newest `MAX_SPANS` spans are kept, so that a
long profile nobody drains holds a bounded store.

`Stages` are the spans that are always timed: the SLAM loop's stages and
the VO's step, whose sums, counts and last durations feed the run's
report; they record as spans too while tracing is on.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque

import torch

MAIN = "main"
_count_lock = threading.Lock()
_stream_tags = {}            # CUDA stream handle -> tag
_local = threading.local()   # .tag: this thread's tag; .stack: open spans


def count_tag(device: torch.device) -> str:
    """The tag a launch on `device` counts under: the current CUDA stream's
    on the card, this thread's on the CPU, else MAIN."""
    if device.type == "cuda":
        tag = _stream_tags.get(torch.cuda.current_stream(device).cuda_stream)
    else:
        tag = getattr(_local, "tag", None)
    return MAIN if tag is None else tag


@contextlib.contextmanager
def counting_as(tag: str, stream=None):
    """Count the launches made on `stream`, and the spans, counts and twin
    calls of this thread, under `tag`, apart from the main path's."""
    prev = getattr(_local, "tag", None)
    _local.tag = tag
    if stream is not None:
        _stream_tags[stream.cuda_stream] = tag
    try:
        yield
    finally:
        _local.tag = prev
        if stream is not None:
            _stream_tags.pop(stream.cuda_stream, None)


class LaunchCounts:
    """Counters of `keys`, one set per tag."""

    def __init__(self, keys):
        self.keys = tuple(keys)
        self._by_tag = {}

    def reset(self) -> None:
        with _count_lock:
            self._by_tag = {}

    def bump(self, key: str, device: torch.device) -> None:
        tag = count_tag(device)
        with _count_lock:
            d = self._by_tag.setdefault(tag, dict.fromkeys(self.keys, 0))
            d[key] += 1

    def get(self, tag: str = MAIN) -> dict:
        with _count_lock:
            return dict(self._by_tag.get(tag)
                        or dict.fromkeys(self.keys, 0))


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

_enabled = False
_on = False                  # recording: looked up by `refresh`
_frame_id = -1
_ids = itertools.count()
MAX_SPANS = 1 << 16          # ~90 frames of ~700 spans
_spans = deque(maxlen=MAX_SPANS)
_counters = defaultdict(int)  # (frame, tag, name) -> n


def enable() -> None:
    """Record spans and counters until `disable()`."""
    global _enabled, _on
    _enabled = _on = True


def disable() -> None:
    """Stop recording (a profile that records turns it on again)."""
    global _enabled, _on
    _enabled = _on = False


def refresh() -> bool:
    """Look up whether to record, and return it."""
    global _on
    _on = _enabled or torch._C._autograd._profiler_enabled()
    return _on


def recording() -> bool:
    return _on


def drain() -> dict:
    """The records since the last drain, and forget them: {"spans": [...],
    "counters": [{"frame", "tag", "name", "n"}]}."""
    global _spans, _counters
    with _count_lock:
        spans, counters = _spans, _counters
        _spans, _counters = deque(maxlen=MAX_SPANS), defaultdict(int)
    return {"spans": list(spans),
            "counters": [{"frame": f, "tag": t, "name": k, "n": n}
                         for (f, t, k), n in counters.items()]}


def _tag() -> str:
    tag = getattr(_local, "tag", None)
    return MAIN if tag is None else tag


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A span being recorded."""

    __slots__ = ("rec",)

    def __init__(self, name: str):
        stack = _stack()
        self.rec = {"name": name, "id": next(_ids),
                    "parent": stack[-1] if stack else None,
                    "frame": _frame_id, "tag": _tag(),
                    "tid": threading.get_native_id(),
                    "t0_ns": time.time_ns(), "t1_ns": None}
        stack.append(self.rec["id"])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(time.time_ns())
        return False

    def close(self, t1_ns: int) -> None:
        self.rec["t1_ns"] = t1_ns
        _stack().pop()
        _spans.append(self.rec)


_NULL = contextlib.nullcontext()


def span(name: str):
    """A span of `name` while recording, else the shared null context."""
    return _Span(name) if _on else _NULL


def count(name: str, n: int = 1) -> None:
    """Add `n` to this frame's counter `name`, while recording."""
    if _on:
        key = (_frame_id, _tag(), name)
        with _count_lock:
            _counters[key] += int(n)


class frame:
    """The root span of frame `frame_id`: every span and count until the
    next frame opens carries its id."""

    __slots__ = ("_span",)

    def __init__(self, frame_id: int):
        global _frame_id
        _frame_id = int(frame_id)
        self._span = _Span("frame") if refresh() else None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.close(time.time_ns())
        return False


class Stages:
    """Spans of one owner that are always timed: seconds summed by name
    (`total_s`), spans closed (`count`), the last one's seconds by name
    (`last_s`) and of any name (`last`)."""

    def __init__(self):
        self.total_s = defaultdict(float)
        self.count = defaultdict(int)
        self.last_s = {}
        self.last = 0.0

    def span(self, name: str):
        return _Timed(self, name)

    def mean_ms(self, name: str) -> float:
        n = self.count.get(name, 0)
        return 1e3 * self.total_s[name] / n if n else 0.0


class _Timed:
    __slots__ = ("stages", "name", "span", "t0")

    def __init__(self, stages: Stages, name: str):
        self.stages, self.name = stages, name

    def __enter__(self):
        self.span = _Span(self.name) if refresh() else None
        self.t0 = (time.time_ns() if self.span is None
                   else self.span.rec["t0_ns"])
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.span is not None:
            self.span.close(t1)
        s = (t1 - self.t0) / 1e9
        st = self.stages
        st.total_s[self.name] += s
        st.count[self.name] += 1
        st.last_s[self.name] = st.last = s
        return False
