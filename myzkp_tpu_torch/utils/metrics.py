"""Stage spans: named ranges on the profiler's own clock.

``span(name)`` marks a stage of the port, as a context manager or as a
decorator (on functions and methods alike)::

    with span("bind"):
        tables = [fold_into_half(t, r) for t in tables]

    @span("ladder")
    def scalar_mul_bits(...): ...

While a ``torch.profiler`` profile records, each entry opens a range named
``myzkp:<name>`` in it; the ranges share the profiler's clock with the CUDA
runtime calls and kernels it traces, so every launch and every idle gap of
the card falls in the innermost span that holds it.  With no profile
recording, an entry reads one flag and does nothing more: no range, no
clock, no synchronize.  There is no switch of its own: any profile that
records turns the spans on.

The ranges are plain host ranges (the profiler's ``cpu_op`` kind, as
``torch._C._profiler._RecordFunctionFast`` opens them), not
``record_function``'s user annotations, which kineto would mirror as ranges
on the device's timeline: a reader of the device's events then sees the
card's work alone.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd import profiler as _profiler

PREFIX = "myzkp:"

_Range = torch._C._profiler._RecordFunctionFast


class _Off:
    """A span with no profiler recording: entering it does nothing.  One
    instance a name, so an entry allocates nothing."""

    __slots__ = ("label",)

    def __init__(self, label: str):
        self.label = label

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None

    def __call__(self, fn):
        label = self.label

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Range(label):
                return fn(*args, **kwargs)

        return spanned


class _On(_Off):
    """A span entered while a profiler records: a range of its own, so that
    spans of one name nest and threads do not share it."""

    __slots__ = ("_range",)

    def __enter__(self) -> None:
        self._range = _Range(self.label)
        self._range.__enter__()

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)


_off: dict = {}


def span(name: str) -> _Off:
    """The span ``myzkp:<name>``: ``with span(name):`` or ``@span(name)``."""
    if _profiler._is_profiler_enabled:
        return _On(PREFIX + name)
    s = _off.get(name)
    if s is None:
        s = _off[name] = _Off(PREFIX + name)
    return s
