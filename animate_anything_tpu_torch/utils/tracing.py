"""Spans of the port's layers, as ``torch.profiler`` ranges.

A span is a range named ``aat.<name>`` in the profiler's trace: on the same
clock as the device's kernels and the host's launch calls, so a stretch in
which the device sat idle can be put down to the span the host was in.
Spans nest by time; a span's parent is the innermost span open around it.
They record only while a ``torch.profiler`` profile records in the process
(``torch.autograd._profiler_enabled()``, one C call); otherwise ``span``
returns one shared no-op context and nothing is recorded. The profiler keeps
the ranges in memory with the rest of its trace and hands them out when it
stops: there is no switch, file or clock of the spans' own.

    with span("denoise"):                 # a range aat.denoise
        ...

    @traced("op.ln_geglu_ff")             # a range around every call
    def ln_geglu_ff(...): ...

    norm = sync(float, total)             # the host's wait, in a range aat.sync

The names, by layer: ``request`` ⊃ ``encode``, ``denoise`` ⊃ ``step`` ⊃
``unet`` ⊃ ``op.<wrapper>``, then ``decode``; ``train_step`` ⊃ ``inputs``,
``loss``, ``backward``, ``metrics``, ``optimizer`` ⊃ ``norm``, ``update``,
``masters``; ``sync`` wherever the host blocks on a value of the device.
A ``request`` range (``traced_request``) carries one integer argument, the
request's id (``request_id``), which the trace keeps where the profile
records shapes.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools

import torch

PREFIX = "aat."
OFF = contextlib.nullcontext()          # what ``span`` returns while nothing records
_job = contextvars.ContextVar("aat_job", default=None)
_count = itertools.count()


class _Range:
    """One profiler range with its arguments (integers, floats or tensors:
    the trace keeps them where the profile records shapes)."""

    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.args)
        return self

    def __exit__(self, *exc) -> bool:
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str):
    """A context that records the range ``aat.<name>`` while a profile
    records, else ``OFF``."""
    if not torch.autograd._profiler_enabled():
        return OFF
    return _Range(PREFIX + name, ())


def traced(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    full = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kw)
            with _Range(full, ()):
                return fn(*args, **kw)
        return call
    return wrap


def traced_request(fn):
    """Decorator: every call of the function is one request, inside a
    range ``aat.request`` whose argument is its ``request_id``."""
    @functools.wraps(fn)
    def call(*args, **kw):
        if not torch.autograd._profiler_enabled():
            return fn(*args, **kw)
        with _Range(PREFIX + "request", (request_id(),)):
            return fn(*args, **kw)
    return call


def sync(read, *args):
    """``read(*args)``, a read of a device value by the host (``float``,
    ``.tolist()``, ``bool``), inside an ``aat.sync`` range: its length is the
    host's wait for the device, and the ranges count the syncs."""
    if not torch.autograd._profiler_enabled():
        return read(*args)
    with _Range(PREFIX + "sync", ()):
        return read(*args)


@contextlib.contextmanager
def serving(job: int):
    """The requests that this thread runs inside the block are the server's
    job ``job``."""
    token = _job.set(job)
    try:
        yield
    finally:
        _job.reset(token)


def request_id() -> int:
    """The id of the request about to run: the server's job (``serving``),
    else the next number of the process's count of traced requests."""
    job = _job.get()
    return next(_count) if job is None else job
