"""CUDA graphs of a decode, captured once per shape and replayed.

A beam decode with ``early_exit=False`` (`ops/generation.py:beam_search`)
never reads the device and never changes a shape, so every call of one
shape enqueues the same kernels in the same order. At CapFilt's shape
that is 49 pieces and about 12,450 launches, whose enqueue takes longer
than the card takes to run them. `DecodeGraphs` records such a decode
once as CUDA graphs and replays them.

The eager code marks its pieces with ``with piece(span):`` (span None: a
piece outside any span); eagerly, `eager_piece` enters the span alone.
A capture runs the same code once with `Tape.piece`, which captures each
piece's body into a graph of its own. All graphs of a tape share one
private memory pool, so each tensor that passes from one piece to the
next stays where the capture put it, and the graphs are replayed in the
order they were captured. A block of that pool serves only captures into
it, so an operand whose last reference goes after the capture (the cross
K/V) keeps its memory while the tape lives. Every tensor operation of a
decode must lie inside a piece: work between pieces would run once, at
the capture.

A replay (`Tape.replay`, inside the caller's graph span: ``decode.graph``
for the beam decode, ``lm.graph`` for the language model's) copies the
call's inputs into the capture's input buffers, replays each graph inside
the span of the piece it holds, and returns clones of the captured
outputs, so a later replay never overwrites what a caller holds.

Engagement (`DecodeGraphs.run`) follows what a call can observe: a key's
first call runs eager, its second captures (eager instead while a
profiler runs, which does not mix with a capture), later calls replay.
So a shape seen once (a dataset's last chunk) never pays for a capture.
At most `MAX_KEYS` keys are kept, the least recently used evicted first;
an evicted key's graphs and pool are released.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict

import torch
from torch.autograd import _profiler_enabled

from vidil_tpu_torch.utils.profiling import annotate

MAX_KEYS = 4
_NO_SPAN = contextlib.nullcontext()


def eager_piece(span: str | None):
    """A piece of an eager decode: the span `span` (None: no span)."""
    return annotate(span) if span else _NO_SPAN


def storage_key(tree) -> tuple:
    """The address, dtype, shape and strides of every tensor of a nested
    dict/list: a graph reads its operands at the addresses it was captured
    with, so a key that holds them replays only on the same storage."""
    if isinstance(tree, torch.Tensor):
        return ((tree.data_ptr(), tree.dtype, tuple(tree.shape), tree.stride()),)
    if isinstance(tree, dict):
        return tuple(x for k in sorted(tree) for x in storage_key(tree[k]))
    if isinstance(tree, (list, tuple)):
        return tuple(x for t in tree for x in storage_key(t))
    return ()


class Tape:
    """One captured decode: its input buffers, its graphs with their spans
    in capture order, and its outputs (tensors of the private pool)."""

    def __init__(self, inputs, pool=None, span: str = "decode.graph"):
        self.inputs = tuple(inputs)
        self.pool = pool
        self.span = span
        self.graphs: list = []  # [(span or None, CUDAGraph)]
        self.outputs: tuple = ()

    @contextlib.contextmanager
    def piece(self, span: str | None):
        """Capture the body into a graph of its own (on a side stream)."""
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()
        self.graphs.append((span, graph))

    def replay(self, inputs) -> tuple:
        """The decode of `inputs`: copied into the input buffers, every
        graph replayed in its span; clones of the outputs."""
        with annotate(self.span):
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
            for span, graph in self.graphs:
                with eager_piece(span):
                    graph.replay()
            return tuple(t.clone() for t in self.outputs)


class DecodeGraphs:
    """The graphs of one caller's decodes, by key (see the module's
    docstring). The key must cover everything that shapes the decode's
    launches and the storage of every operand it reads besides its
    inputs (`storage_key` of the weights)."""

    def __init__(self, span: str = "decode.graph"):
        self._tapes: OrderedDict = OrderedDict()  # key -> Tape, or None when seen once
        self._stream = None
        self.span = span  # the span of each replay

    def run(self, key, fn, *inputs) -> tuple:
        """``fn(*inputs, piece=...)``, a decode that returns a tuple of
        tensors: eager at the key's first call, captured at its second,
        replayed from then on. CPU tensors always run eager."""
        if not self._on_card(inputs[0]):
            return fn(*inputs)
        if key not in self._tapes:
            self._tapes[key] = None
            while len(self._tapes) > MAX_KEYS:
                self._tapes.popitem(last=False)
            return fn(*inputs)
        self._tapes.move_to_end(key)
        tape = self._tapes[key]
        if tape is None:
            if _profiler_enabled():
                return fn(*inputs)
            tape = self._tapes[key] = self._capture(fn, inputs)
        return tape.replay(inputs)

    @staticmethod
    def _on_card(x) -> bool:
        return x.is_cuda

    def _capture(self, fn, inputs) -> Tape:
        """Record ``fn`` on copies of `inputs`: once eager on the side
        stream (its per-stream library state made outside a capture), then
        captured piece by piece. Nothing runs until the first replay."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        main = torch.cuda.current_stream()
        tape = Tape([x.clone(memory_format=torch.contiguous_format) for x in inputs],
                    torch.cuda.graph_pool_handle(), self.span)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            fn(*tape.inputs)
            tape.outputs = tuple(fn(*tape.inputs, piece=tape.piece))
        main.wait_stream(self._stream)
        return tape
