"""CUDA graphs of the beam decode (`vidil_tpu_torch/ops/decode_graph.py`).

On the CPU: the decode stays eager and unchanged; every tensor operation
of a beam decode lies inside one of its pieces (what a capture records);
the engagement rule with the capture stubbed; a replay's spans; the
CapFilt engine's pinned readback buffers. Marked `cuda`: those buffers
behind pending work, and at CapFilt's shape (32 images x 577 tokens, beam 3, 20 tokens,
bf16, grouped cross K/V) an eager call, a capture and replays, each
bitwise the eager decode's tokens and scores, in every decode variant,
with the same kernels under the profiler. This file imports neither JAX
nor vidil_tpu, so the card runs it alone:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py
"""

import dataclasses
import json
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vidil_tpu_torch.config import MedConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.layers import cast_linears
from vidil_tpu_torch.ops import decode_attention as DA
from vidil_tpu_torch.ops import decode_graph as DG
from vidil_tpu_torch.ops.generation import GenerationConfig
from vidil_tpu_torch.pipeline.capfilt import PinnedArena
from vidil_tpu_torch.utils import profiling
from vidil_tpu_torch.utils.seeding import init_generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = MedConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                 max_position_embeddings=64, encoder_width=32)
GEN = GenerationConfig(max_length=12, min_length=3, num_beams=3, eos_token_id=5,
                       pad_token_id=0, early_exit=False)
VARIANTS = [{}, {"decode_layer_unroll": True}, {"decode_lazy_reorder": True}]


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


@pytest.fixture(scope="module")
def tiny():
    params = {"text_decoder": M.init_med(init_generator(0), TINY, with_lm_head=True)}
    g = torch.Generator().manual_seed(1)
    embeds = [torch.randn(2, 5, 32, generator=g) for _ in range(3)]
    prompt = torch.tensor([[1, 7, 8]], dtype=torch.int32).expand(2, -1)
    return params, embeds, prompt


class _Calls(DG.DecodeGraphs):
    """Graphs that record the calls to `run` and run them eager, each piece
    through `piece`."""

    def __init__(self, piece=DG.eager_piece):
        super().__init__()
        self.calls = []
        self.piece = piece

    def run(self, key, fn, *inputs):
        self.calls.append(key)
        return fn(*inputs, piece=self.piece)


def test_cpu_decode_stays_eager_and_unchanged(tiny):
    params, embeds, prompt = tiny
    graphs = DG.DecodeGraphs()
    for e in embeds + embeds:
        want = B.blip_beam_search(params, e, prompt, TINY, GEN, beam_group_kv=True)
        got = B.blip_beam_search(params, e, prompt, TINY, GEN, beam_group_kv=True, graphs=graphs)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ids = B.blip_generate_ids(params, e, prompt, TINY, GEN, beam_group_kv=True,
                                  graphs=graphs)
        assert torch.equal(ids, want[0])
    assert not graphs._tapes  # a CPU call never records a key


class _OutsidePieces(TorchDispatchMode):
    """The aten operations run while no piece is open."""

    def __init__(self):
        super().__init__()
        self.depth = 0
        self.outside = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0:
            self.outside.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kw", VARIANTS + [{"beam_group_kv": False},
                                           {"length_norm": "modern"},
                                           {"dtype": torch.bfloat16},
                                           {"dtype": torch.bfloat16,
                                            "cache_dtype": torch.float32}])
def test_every_tensor_operation_lies_inside_a_piece(tiny, kw):
    """A capture records only what runs inside its pieces: work between
    them would run once, at the capture, and never at a replay. The spans
    of the pieces are the eager decode's, in its counts."""
    params, embeds, prompt = tiny
    kw = dict(kw)
    gen = dataclasses.replace(GEN, length_norm=kw.pop("length_norm", "legacy"))
    mode = _OutsidePieces()
    spans = []

    class _Piece:
        def __init__(self, span):
            spans.append(span)

        def __enter__(self):
            mode.depth += 1

        def __exit__(self, *exc):
            mode.depth -= 1

    graphs = _Calls(_Piece)
    want = B.blip_beam_search(params, embeds[0], prompt, TINY, gen,
                              **{"beam_group_kv": True, **kw})
    with mode:
        got = B.blip_beam_search(params, embeds[0], prompt, TINY, gen, graphs=graphs,
                                 **{"beam_group_kv": True, **kw})
    assert mode.outside == []
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tokens = GEN.max_length - prompt.shape[1]
    assert spans == (["decode.prefill"] * 2 + ["decode.select", "decode.reorder", "decode.step"]
                     * (tokens - 1) + ["decode.select", None])


def test_only_the_beam_decode_without_early_exit_reaches_the_graphs(tiny):
    params, embeds, prompt = tiny
    graphs = _Calls()
    B.blip_generate_ids(params, embeds[0], prompt, TINY, GEN, beam_group_kv=True, graphs=graphs)
    assert len(graphs.calls) == 1
    early = dataclasses.replace(GEN, early_exit=True)
    B.blip_generate_ids(params, embeds[0], prompt, TINY, early, graphs=graphs)
    sample = dataclasses.replace(GEN, num_beams=1)
    B.blip_generate_ids(params, embeds[0], prompt, TINY, sample, sample=True,
                        generator=torch.Generator().manual_seed(0), graphs=graphs)
    assert len(graphs.calls) == 1


def test_the_key_follows_shapes_options_and_weights(tiny):
    params, embeds, prompt = tiny
    graphs = _Calls()

    def call(e=embeds[0], p=prompt, prm=params, **kw):
        B.blip_beam_search(prm, e, p, TINY, GEN, graphs=graphs, **kw)
        return graphs.calls[-1]

    key = call()
    assert call(e=embeds[1]) == key  # other values, one key
    others = [call(e=embeds[0][:1], p=prompt[:1]), call(p=prompt[:, :2]),
              call(beam_group_kv=True),
              call(decode_layer_unroll=True), call(decode_lazy_reorder=True),
              call(prm={"text_decoder": M.init_med(init_generator(0), TINY,
                                                   with_lm_head=True)})]
    assert len({key, *others}) == 1 + len(others)


class _Stubbed(DG.DecodeGraphs):
    """The engagement rule on the CPU: every tensor counts as on the card,
    and a capture is a tape whose replay runs the decode eager."""

    def __init__(self):
        super().__init__()
        self.captures = []
        self.replays = 0
        self.eager = 0

    @staticmethod
    def _on_card(x):
        return True

    def _capture(self, fn, inputs):
        self.captures.append(fn)
        outer = self

        class Tape:
            def replay(self, inputs):
                outer.replays += 1
                return fn(*inputs, replay=True)

        return Tape()


def _count_eager(graphs, fn):
    def counted(*inputs, replay=False):
        graphs.eager += not replay
        return fn(*inputs)
    return counted


def _captured(graphs, key):
    return graphs._tapes.get(key) is not None


def test_first_sighting_runs_eager_and_the_second_captures():
    graphs = _Stubbed()
    fn = _count_eager(graphs, lambda x: (x + 1,))
    x = torch.zeros(2)
    graphs.run("k", fn, x)
    assert (graphs.eager, len(graphs.captures), graphs.replays) == (1, 0, 0)
    assert not _captured(graphs, "k")
    graphs.run("k", fn, x)
    assert (len(graphs.captures), graphs.replays) == (1, 1) and _captured(graphs, "k")
    out = graphs.run("k", fn, x)
    assert (len(graphs.captures), graphs.replays) == (1, 2) and torch.equal(out[0], x + 1)


def test_no_capture_while_a_profiler_runs():
    graphs = _Stubbed()
    fn = _count_eager(graphs, lambda x: (x,))
    x = torch.zeros(2)
    graphs.run("k", fn, x)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        graphs.run("k", fn, x)
        graphs.run("k", fn, x)
    assert (graphs.eager, len(graphs.captures)) == (3, 0)
    graphs.run("k", fn, x)
    assert len(graphs.captures) == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        graphs.run("k", fn, x)  # a captured key replays under a profiler
    assert (graphs.eager, graphs.replays) == (3, 2)
    assert profiling.span_totals() == {}  # the stub's replay enters no span


def test_the_key_set_stays_bounded():
    graphs = _Stubbed()
    fn = _count_eager(graphs, lambda x: (x,))
    x = torch.zeros(2)
    assert DG.MAX_KEYS == 4
    for k in range(4):
        graphs.run(k, fn, x)
        graphs.run(k, fn, x)
    assert len(graphs._tapes) == 4 and len(graphs.captures) == 4
    graphs.run(0, fn, x)  # replayed: now the most recently used
    for k in (4, 5):
        graphs.run(k, fn, x)
    assert len(graphs._tapes) == 4
    assert not _captured(graphs, 1) and not _captured(graphs, 2)  # evicted, oldest first
    assert _captured(graphs, 0) and _captured(graphs, 3)
    eager = graphs.eager
    graphs.run(1, fn, x)  # evicted: a first sighting again
    assert graphs.eager == eager + 1 and len(graphs.captures) == 4


class _FakeGraph:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def replay(self):
        self.log.append(self.name)


def test_a_replay_counts_one_decode_graph_and_keeps_the_spans():
    log = []
    inputs = (torch.zeros(3), torch.zeros(2, dtype=torch.int32))
    tape = DG.Tape([x.clone() for x in inputs])
    tape.graphs = [("decode.prefill", _FakeGraph(log, 0)), ("decode.prefill", _FakeGraph(log, 1)),
                   ("decode.select", _FakeGraph(log, 2)), (None, _FakeGraph(log, 3))]
    tape.outputs = (torch.arange(4),)
    new = (torch.ones(3), torch.full((2,), 7, dtype=torch.int32))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = tape.replay(new)
        tape.replay(new)
    assert log == [0, 1, 2, 3] * 2
    assert all(torch.equal(b, x) for b, x in zip(tape.inputs, new))
    assert torch.equal(out[0], tape.outputs[0]) and out[0] is not tape.outputs[0]
    calls = {k: c for k, (c, _) in profiling.span_totals().items()}
    assert calls == {"decode.graph": 2, "decode.prefill": 4, "decode.select": 2}


def test_storage_key_follows_the_weights_storage():
    a = {"w": torch.zeros(2, 3), "l": [torch.ones(2)], "n": 1}
    assert DG.storage_key(a) == DG.storage_key(dict(a))
    assert DG.storage_key(a) != DG.storage_key({**a, "w": a["w"].clone()})
    assert DG.storage_key(a) != DG.storage_key({**a, "w": a["w"].t()})
    assert DG.storage_key(a) != DG.storage_key({**a, "w": a["w"].to(torch.float64)})


def test_pinned_arena_hands_out_fresh_copies(monkeypatch):
    """The early readback's buffers (`PinnedArena`, pinned on the card): each
    copy equal to its source in dtype, shape and values, aligned, and no
    byte handed out twice, across slabs too."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k: empty(*a, **k))
    monkeypatch.setattr(PinnedArena, "SLAB_BYTES", 1024)
    arena = PinnedArena()
    xs = [torch.arange(10, dtype=torch.int32), torch.rand(2, 3, 4).permute(0, 2, 1),
          torch.zeros(0), torch.rand(300, dtype=torch.float64), torch.ones(3, dtype=torch.int64)]
    outs = [arena.copy(x) for x in xs]
    spans = []
    for x, o in zip(xs, outs):
        assert o.dtype == x.dtype and o.shape == x.shape and torch.equal(o, x)
        assert o.data_ptr() % 64 == 0
        spans.append((o.data_ptr(), o.data_ptr() + o.numel() * o.element_size()))
    spans.sort()
    assert all(e <= s for (_, e), (s, _) in zip(spans, spans[1:]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_pinned_arena_copies_behind_pending_work():
    """Behind a long kernel, an arena copy is pinned, lands once the stream
    passes it, and stays put while later copies are made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned memory and async copies")
    x = torch.arange(640, dtype=torch.int32, device="cuda")
    arena = PinnedArena()
    torch.cuda._sleep(10 ** 7)
    first = arena.copy(x)
    later = [arena.copy(x + i) for i in range(1, 2000)]
    torch.cuda.synchronize()
    assert first.is_pinned() and torch.equal(first, x.cpu())
    assert all(torch.equal(o, (x + i + 1).cpu()) for i, o in enumerate(later))

@pytest.fixture(scope="module")
def card():
    """The CapFilt cell's decoder (BLIP's init from seed 0, linears in
    bf16 as the engine casts them), three draws of 32 images' embeddings
    and the prompt "a picture of " ([DEC] and three ids)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "portbench", "configs", "blip_capfilt_base384.json")) as f:
        cfg = json.load(f)
    med = MedConfig(**cfg["med"])
    g = cfg["generation"]
    gen = GenerationConfig(max_length=g["max_length"], min_length=g["min_length"],
                           num_beams=g["num_beams"], eos_token_id=102, pad_token_id=0,
                           length_norm=g["length_norm"], early_exit=False)
    params = cast_linears({"text_decoder": M.init_med(init_generator(0, dev), med,
                                                      with_lm_head=True, device=dev)},
                          torch.bfloat16)
    gen_e = torch.Generator(device=dev).manual_seed(5)
    embeds = [torch.randn(32, 577, 768, generator=gen_e, device=dev).to(torch.bfloat16)
              for _ in range(3)]
    prompt = torch.tensor([30522, 1037, 3861, 1997], dtype=torch.int32, device=dev)
    return params, med, gen, embeds, prompt[None].expand(32, -1)


def _decode(card, e, graphs=None, **kw):
    params, med, gen, _, prompt = card
    return B.blip_beam_search(params, e, prompt, med, gen, dtype=torch.bfloat16,
                              beam_group_kv=True, graphs=graphs, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", VARIANTS, ids=["plain", "unroll", "lazy"])
def test_replays_are_bitwise_the_eager_decode(card, kw):
    """Three calls with other embeddings (eager, capture, replay), then
    the first again: each the eager decode's tokens and scores, bit for
    bit; what a call returned stays as it was after later calls."""
    embeds = card[3]
    want = [_decode(card, e, **kw) for e in embeds]
    graphs = DG.DecodeGraphs()
    got = []
    for i, e in enumerate(embeds + embeds[:1]):
        got.append(_decode(card, e, graphs, **kw))
        tapes = list(graphs._tapes.values())
        assert len(tapes) == 1 and (tapes[0] is not None) == (i >= 1)
    torch.cuda.synchronize()
    kept = [(s.cpu(), c.cpu()) for s, c in got]
    _decode(card, embeds[2], graphs, **kw)
    for (s, c), (ws, wc), (ks, kc) in zip(got, want + want[:1], kept):
        assert s.dtype == torch.int32 and c.dtype == torch.float32
        assert torch.equal(s, ws) and torch.equal(c, wc)
        assert torch.equal(s.cpu(), ks) and torch.equal(c.cpu(), kc)
    # the draws give other captions, so the inputs did reach the replays
    assert not torch.equal(want[0][0], want[1][0])


@pytest.mark.cuda
def test_every_cross_attention_of_the_decode_runs_k6(card):
    """The decode's cross-attention is kernel K6 (`ops/decode_attention.py`)
    in every layer of the prefill and of each step: 12 x 16 launches an
    eager decode, twice that at its capture (an eager pass on the side
    stream, then the captured one), none at a replay (the graphs hold
    them)."""
    params, med, gen, embeds, prompt = card
    passes = gen.max_length - prompt.shape[1]
    graphs = DG.DecodeGraphs()
    counts = []
    for _ in range(3):  # eager, capture, replay
        DA.reset_launch_counts()
        _decode(card, embeds[0], graphs)
        counts.append(DA.launch_counts["decode_cross_attention"])
    per_decode = med.num_layers * passes
    assert counts == [per_decode, 2 * per_decode, 0] and per_decode == 192


GRAPH_NAMES = {"memset32": "Memset (Device)", "memcpy32_post": "Memcpy DtoD (Device -> Device)"}


def _profiled(fn, reps=3):
    """`reps` calls of fn under torch.profiler: device events (kernels,
    copies) a call by name, each name's count over the calls rounded up
    (the profiler can drop an event of a window, `device_profile`), and the
    program's spans by calls."""
    import math
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = {e.name for e in events if e.device_type != DeviceType.CUDA}
    names = Counter(e.name for e in events
                    if e.device_type == DeviceType.CUDA and e.name not in host)
    per_call = {k: math.ceil(n / reps) for k, n in names.items()}
    return per_call, {k: c for k, (c, _) in profiling.span_totals().items()}


@pytest.mark.cuda
def test_a_profiled_replay_shows_the_eager_kernels_and_spans(card):
    """The profiler sees a replay's kernels: none beyond the eager
    decode's, name by name, and the copies of the two inputs in and the
    two outputs out, and all but a few of them (the trace can lose records
    of a graph's nodes: 12,287 of 12,455 in one run on the card). Its spans
    are the eager decode's in their counts, plus one ``decode.graph`` a
    call. The prompt is contiguous here, as the capture's buffer is (an
    expanded prompt can take another variant of its first gather's
    kernel)."""
    from collections import Counter

    params, med, gen, embeds, prompt = card
    prompt = prompt.contiguous()

    def decode(graphs=None):
        return B.blip_beam_search(params, embeds[0], prompt, med, gen, dtype=torch.bfloat16,
                                  beam_group_kv=True, graphs=graphs)

    graphs = DG.DecodeGraphs()
    for _ in range(3):
        decode(graphs)
    decode()  # the profiler's first start outside the windows
    eager, eager_spans = _profiled(decode)
    replay, replay_spans = _profiled(lambda: decode(graphs))
    # the trace names the memsets and device-to-device copies that a graph
    # replays, and the copies made after one, as kernels
    replay = Counter({GRAPH_NAMES.get(k, k): n for k, n in replay.items()})
    extra, missing = replay - Counter(eager), Counter(eager) - replay
    print(f"device events a call: eager {sum(eager.values())}, replay {sum(replay.values())};"
          f" extra {dict(extra)}; missing {dict(missing)}")
    assert eager_spans == {"decode.prefill": 6, "decode.select": 48, "decode.reorder": 45,
                           "decode.step": 45}
    assert replay_spans == {**eager_spans, "decode.graph": 3}
    assert not extra - Counter({"Memcpy DtoD (Device -> Device)": 4})
    assert sum(missing.values()) <= 0.05 * sum(eager.values())
