"""The port's Nemotron-H language-model stage against the plain reference
(`tests/nemotron_h_reference.py`, float32) at a tiny size that keeps one
layer of each kind (``ME*EM``: hidden 64, 8 experts top-2 plus the shared
one, 2 key/value heads, a scan chunk shorter than the prompts): the packed
prefill, the greedy decode through the hybrid cache, the chunked scan, the
router, the experts' grouped GEMM (K7's plain version, and on a card the
kernel), the answer jsonl through `process_gpt3_response`, and the
reference's copy in `portbench/`.

The `cuda`-marked tests need a card (they skip here):
``python -m pytest --noconftest -m cuda tests/test_torch_nemotron_h.py``.
"""

from __future__ import annotations

import dataclasses
import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from vidil_tpu_torch.config import NemotronHConfig
from vidil_tpu_torch.models import nemotron_h as NH
from vidil_tpu_torch.ops import grouped_expert_gemm as k7
from vidil_tpu_torch.ops import moe, ssd
from vidil_tpu_torch.ops.generation import greedy_search
from vidil_tpu_torch.pipeline import gpt3, lm_answer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import nemotron_h_reference as R  # noqa: E402

torch.set_num_threads(2)
TINY = NemotronHConfig(vocab_size=512, hidden_size=64, hybrid_override_pattern="ME*EM",
                       mamba_num_heads=8, mamba_head_dim=16, ssm_state_size=16, n_groups=2,
                       chunk_size=8, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                       n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                       moe_shared_expert_intermediate_size=48)
RCFG = dataclasses.asdict(TINY)
LENGTHS = (13, 21, 5)  # not multiples of the chunk; one shorter than a chunk


@pytest.fixture(scope="module")
def model():
    params = NH.init_nemotron_h(TINY, torch.Generator().manual_seed(3), "cpu", torch.float32)
    rng = np.random.default_rng(4)
    prompts = [torch.from_numpy(rng.integers(5, TINY.vocab_size, n)) for n in LENGTHS]
    return params, prompts


def _prefill(params, prompts, capacity=40):
    cache = NH.init_cache(TINY, len(prompts), capacity, "cpu", torch.float32)
    first = NH.prefill(params, TINY, torch.cat(prompts),
                       ssd.pack(ssd.Packing(LENGTHS), TINY.chunk_size, "cpu"), cache)
    return first, cache


def test_packed_prefill_matches_the_reference(model):
    params, prompts = model
    first, cache = _prefill(params, prompts)
    for b, ids in enumerate(prompts):
        ref, _ = R.forward(params, RCFG, ids, logits_from=len(ids) - 1)
        torch.testing.assert_close(first[b], ref[0], atol=2e-5, rtol=0)
    assert cache["lengths"].tolist() == list(LENGTHS)


def test_greedy_decode_through_the_cache_matches_the_full_forward(model):
    """Prefill, then 6 greedy tokens through the hybrid cache: at every
    decoded position the logits are the reference's full forward over the
    prompt and the tokens before it."""
    params, prompts = model
    first, cache = _prefill(params, prompts)
    seen = [first]

    def step(tokens, c):
        logits = NH.step(params, TINY, tokens, c)
        seen.append(logits)
        return logits, c

    out = greedy_search(first, cache, step, 6, lm_answer.EOS, lm_answer.PAD)
    for b, ids in enumerate(prompts):
        full = torch.cat([ids, out[b, :-1].long()])
        ref, _ = R.forward(params, RCFG, full, logits_from=len(ids) - 1)
        got = torch.stack([s[b] for s in seen])
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)
        assert out[b].tolist() == ref.argmax(-1).tolist()


def test_reordered_cache_steps_as_its_rows_did(model):
    """`reorder_cache` (a beam search's reorder_fn) gathers every state of
    the hybrid cache by row: stepping the swapped cache gives the swapped
    rows' logits."""
    params, prompts = model
    _, cache = _prefill(params, prompts)
    tokens = torch.tensor([7, 11, 13])
    swapped = NH.reorder_cache(cache, torch.tensor([2, 0, 1]))
    want = NH.step(params, TINY, tokens, cache)
    got = NH.step(params, TINY, tokens[[2, 0, 1]], swapped)
    torch.testing.assert_close(got, want[[2, 0, 1]], atol=1e-6, rtol=0)


def test_chunked_scan_matches_the_sequential_recurrence():
    """ssd_chunked over packed prompts of unequal length (chunk 8) against
    the one-token recurrence run prompt by prompt from a zero state: every
    output and each prompt's final state."""
    H, P, G, N = 4, 8, 2, 6
    lengths = (19, 8, 3, 12)
    T = sum(lengths)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(T, H, P, generator=g)
    B, C = torch.randn(T, G, N, generator=g), torch.randn(T, G, N, generator=g)
    dt = torch.rand(T, H, generator=g) * 0.2
    A = -torch.rand(H, generator=g) * 4 - 0.5
    D = torch.randn(H, generator=g)
    packing = ssd.Packing(lengths)
    y, final = ssd.ssd_chunked(x, dt, A, B, C, D, ssd.pack(packing, 8, "cpu").layout,
                               len(lengths), 8)
    for p, (s, n) in enumerate(zip(packing.starts, lengths)):
        state = torch.zeros(1, H, P, N)
        for i in range(s, s + n):
            want = ssd.ssd_step(state, x[i:i + 1], dt[i:i + 1], A, B[i:i + 1], C[i:i + 1], D)
            torch.testing.assert_close(y[i:i + 1], want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(final[p:p + 1], state, atol=1e-5, rtol=1e-5)


def test_router_matches_the_reference(model):
    params, _ = model
    p = next(layer for layer in params["layers"] if layer["kind"] == "E")
    x = torch.randn(50, TINY.hidden_size, generator=torch.Generator().manual_seed(6))
    idx, w = moe.route(x, p["router"], p["router_bias"], TINY.num_experts_per_tok,
                       TINY.routed_scaling_factor, TINY.norm_topk_prob)
    ridx, rw = R.route(p, x, RCFG)
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(w, rw, atol=1e-6, rtol=0)
    assert torch.allclose(w.sum(-1), torch.full((50,), TINY.routed_scaling_factor))
    # the bias selects but does not gate: the weights are the unbiased scores'
    assert not torch.equal(idx, torch.topk(torch.sigmoid(x @ p["router"].t()), 2).indices)


def _grouped_case(E, N, K, counts, seed, device="cpu", dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    R_ = int(sum(counts))
    x = torch.randn(R_, K, generator=g).to(device, dtype)
    w = (torch.randn(E, N, K, generator=g) * 0.05).to(device, dtype)
    offsets = torch.zeros(E + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(torch.as_tensor(counts), 0)
    return x, w, offsets.to(device)


def _per_expert_loop(x, w, offsets, relu2):
    out = torch.zeros(x.shape[0], w.shape[1], dtype=x.dtype, device=x.device)
    o = offsets.tolist()
    for e in range(w.shape[0]):
        for r in range(o[e], o[e + 1]):
            acc = torch.mv(w[e].float(), x[r].float())
            out[r] = (torch.relu(acc) ** 2 if relu2 else acc).to(x.dtype)
    return out


@pytest.mark.parametrize("relu2", [False, True])
def test_grouped_gemm_twin_matches_a_per_expert_loop(relu2):
    """K7's plain version against a row-by-row loop, experts without rows
    included, at both epilogues."""
    x, w, offsets = _grouped_case(6, 24, 64, [5, 0, 9, 1, 0, 3], 7)
    got = k7.grouped_expert_gemm(x, w, offsets, relu2=relu2)
    want = _per_expert_loop(x, w, offsets, relu2)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


def test_routed_experts_match_the_reference_loop(model):
    """The sort, the grouped GEMM and the weighted sum of `routed_experts`
    plus the shared expert equal the reference's loop over experts."""
    params, _ = model
    p = next(layer for layer in params["layers"] if layer["kind"] == "E")
    x = torch.randn(30, TINY.hidden_size, generator=torch.Generator().manual_seed(8))
    got = moe.moe_layer(p, x, TINY)
    want = R.moe(p, x, RCFG, "fp32", [])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_answer_jsonl_round_trips_through_process_gpt3_response(model, tmp_path):
    """The stage's CLI shape: prompts jsonl in, one GPT-3 choice a line out,
    read unchanged by the pipeline's response processing."""
    params, _ = model
    vocab = lm_answer.SPECIALS + list(".,:") + [f"w{i}" for i in range(TINY.vocab_size - 8)]
    tok = lm_answer.WordTokenizer(vocab)
    prompts = ["w1 w2, w3.\n\nw4:", "w5 w6 w7 w8 w9 w10.\nw11:", "w12", "w13 w14."]
    src = tmp_path / "prompts.jsonl"
    with open(src, "w") as f:
        for p in prompts:
            f.write(json.dumps({"engine": "text-davinci-002", "prompt": p, "max_tokens": 8}) + "\n")
    with open(tmp_path / "prompts__idx_2_videoid.json", "w") as f:
        json.dump({str(i): f"video{i}" for i in range(len(prompts))}, f)
    engine = lm_answer.LMAnswerEngine(params, TINY, tok, max_prompt_tokens=32, max_new_tokens=5,
                                      device="cpu")
    with torch.no_grad():
        answers = lm_answer.answer_all(engine, lm_answer.read_prompts(str(src)), batch=3)
    out = tmp_path / "responses.jsonl"
    lm_answer.write_responses(str(out), answers)
    processed = gpt3.process_gpt3_response(str(tmp_path / "prompts__idx_2_videoid.json"),
                                           str(out), str(tmp_path / "processed.json"))
    got = json.load(open(processed))
    assert list(got) == [f"video{i}" for i in range(len(prompts))]
    for i, a in enumerate(answers):
        assert got[f"video{i}"] == [a.strip()] and len(a.split()) >= 1
    # the answers are the greedy tokens: one chunk of all four gives the same text
    with torch.no_grad():
        assert lm_answer.answer_all(engine, prompts, batch=4) == answers


def test_reference_copy_in_portbench_is_byte_equal():
    assert filecmp.cmp(os.path.join(HERE, "nemotron_h_reference.py"),
                       os.path.join(REPO, "portbench", "reference", "nemotron_h.py"),
                       shallow=False)


def test_the_reference_imports_nothing_of_either_package():
    src = open(os.path.join(HERE, "nemotron_h_reference.py")).read()
    assert "vidil_tpu" not in src and "jax" not in src


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 has no CPU mode (its plain version runs here)")
    return torch.device("cuda")


# prefill (~1.7k rows an expert at the cell's width, cut to 300 here),
# decode (0-3 rows an expert), and a single row
K7_CASES = [(128, 1856, 2688, "prefill"), (128, 1856, 2688, "decode"), (128, 2688, 1856, "decode"),
            (8, 64, 128, "one")]


def _counts(E, kind, rng):
    if kind == "prefill":
        return rng.integers(200, 400, E)
    if kind == "decode":
        return rng.integers(0, 4, E) * (rng.random(E) < 0.55)
    return np.eye(E, dtype=np.int64)[3]


@pytest.mark.cuda
@pytest.mark.parametrize("relu2", [False, True])
@pytest.mark.parametrize("E,N,K,kind", K7_CASES)
def test_k7_matches_its_twin(cuda_device, E, N, K, kind, relu2):
    counts = _counts(E, kind, np.random.default_rng(E + N + K))
    x, w, offsets = _grouped_case(E, N, K, counts, 9, cuda_device)
    got = k7.grouped_expert_gemm(x, w, offsets, relu2=relu2)
    torch.cuda.synchronize()
    want = k7.grouped_expert_gemm_ref(x, w, offsets, relu2=relu2)
    # bf16 outputs: one rounding apart at most (the sums' order differs)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=8e-3)


@pytest.mark.cuda
def test_k7_counts_launches_and_experts_read(cuda_device):
    counts = np.array([3, 0, 1, 0, 2, 0, 0, 5])
    x, w, offsets = _grouped_case(8, 64, 128, counts, 10, cuda_device)
    before = k7.launch_counts["grouped_expert_gemm"]
    read = k7.experts_read(cuda_device).clone()
    k7.grouped_expert_gemm(x, w, offsets, relu2=True)
    k7.grouped_expert_gemm(x, w, offsets)
    torch.cuda.synchronize()
    assert k7.launch_counts["grouped_expert_gemm"] == before + 2
    assert (k7.experts_read(cuda_device) - read).tolist() == [8]  # 4 experts with rows, twice


@pytest.mark.cuda
def test_k7_is_deterministic(cuda_device):
    x, w, offsets = _grouped_case(128, 1856, 2688, _counts(128, "prefill",
                                                           np.random.default_rng(1)), 11,
                                  cuda_device)
    a = k7.grouped_expert_gemm(x, w, offsets, relu2=True)
    b = k7.grouped_expert_gemm(x, w, offsets, relu2=True)
    assert torch.equal(a, b)
