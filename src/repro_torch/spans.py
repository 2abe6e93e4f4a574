"""Spans: named intervals of the port's own work, kept in memory.

    from repro_torch import spans
    spans.enable()
    out = generate(model, params, prompts, shd, steps=8)
    spans.disable()
    for s in spans.drain():
        print(s.name, s.ids, (s.end_ns - s.start_ns) / 1e6, "ms")

Recording is off by default.  Off, :func:`span` checks one module flag
and returns a shared no-op context: it allocates nothing and reads no
clock.  On, each span records its name, its thread, its start and end,
its parent and its identifiers.  A span never synchronises the device
and never reads a tensor, so its interval is the host's: the time the
program spent issuing the work, not the device's time doing it.

* **Clock**: ``time.time_ns()``, Unix nanoseconds: the clock of the
  timestamps ``torch.profiler`` (kineto) gives its host and device
  events, so a span can be laid over a device trace of the same process.
* **Thread**: ``tid`` is the native thread id; ``ident`` is Python's
  thread identifier (the ``pthread_t``), which kineto's CUDA runtime
  events carry, cut to 32 bits, as their resource id.
* **Parent**: the innermost span open on the same thread when the span
  opened.  A thread with none open takes the main thread's innermost open
  span: autograd runs a backward (and a recompute under remat) on a
  thread of its own while the main thread waits in ``backward()``.
* **Identifiers**: the span's keyword arguments over its parent's, so
  that the spans of one request share them (``call`` of a ``generate``,
  ``step`` of a decode or train step, ``microbatch``, ``layer``).

The spans the port records, each opened where its work is launched:

=====================  ==============================================
``serve.generate``     ``serve/serve.py:generate`` (``call``)
``serve.prefill``      the prefill and its first token's sampling
``serve.decode_step``  one decode step and its sampling (``step``)
``serve.sample``       ``sample``, once per token
``train.step``         ``train/train.py`` ``train_step`` (``step``)
``train.leaves``       per-layer leaves, their hooks, the buffers
``train.microbatch``   one microbatch (``microbatch``)
``train.forward``      ``model.loss_fn``
``train.backward``     ``loss.backward()``
``train.optimizer``    ``apply_updates``: global norm, clip, update
``layer``              one layer of ``models/transformer.py`` (``layer``)
``attention``          the attention core: ``flash_attention.ops.attend``
                       (forward and remat recompute), its backward,
                       ``flash_decode.ops.decode_attend*``
``moe``                ``models/moe.py:moe_block``
``moe.dispatch``       routing, the dispatch tensors and product
``moe.experts``        the experts' ``wi`` product; again for their
                       ``wo`` product and the combine
=====================  ==============================================
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Optional

_on = False
_done: list = []
_serial = itertools.count()
_local = threading.local()
_main_stack: list = []
_NOOP = contextlib.nullcontext()


class Span:
    """One recorded span; ``end_ns`` is 0 while it is open."""

    __slots__ = ("id", "name", "tid", "ident", "start_ns", "end_ns",
                 "parent", "ids")

    def __init__(self, name: str, parent: Optional["Span"], ids: dict):
        self.id = next(_serial)
        self.name = name
        self.tid = _local.tid
        self.ident = _local.ident
        self.parent = None if parent is None else parent.id
        self.ids = dict(parent.ids, **ids) if parent is not None else ids
        self.start_ns = self.end_ns = 0

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"tid={self.tid}, ids={self.ids}, "
                f"{self.start_ns}..{self.end_ns})")


class _Recording:
    """The context :func:`span` returns while recording is on."""

    __slots__ = ("name", "ids", "span", "stack")

    def __init__(self, name: str, ids: dict):
        self.name = name
        self.ids = ids

    def __enter__(self) -> Span:
        stack = _stack()
        # a slice: the main thread may pop its last span meanwhile
        top = stack[-1:] or _main_stack[-1:]
        parent = top[0] if top else None
        s = Span(self.name, parent, self.ids)
        stack.append(s)
        self.span, self.stack = s, stack
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc) -> None:
        s = self.span
        s.end_ns = time.time_ns()
        self.stack.pop()
        _done.append(s)


def _stack() -> list:
    """This thread's stack of open spans (made on the thread's first
    span; the main thread's is :data:`_main_stack`)."""
    try:
        return _local.stack
    except AttributeError:
        main = threading.current_thread() is threading.main_thread()
        _local.stack = _main_stack if main else []
        _local.tid = threading.get_native_id()
        _local.ident = threading.get_ident()
        return _local.stack


def span(name: str, **ids):
    """A context that records ``name`` while recording is on, else the
    shared no-op context."""
    if not _on:
        return _NOOP
    return _Recording(name, ids)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans still open are recorded when they close."""
    global _on
    _on = False


def drain() -> list:
    """The spans finished so far, in the order they closed, handed over
    and forgotten."""
    n = len(_done)
    out = _done[:n]
    del _done[:n]
    return out
