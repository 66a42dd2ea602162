"""The port's Kimi Linear language model against the plain reference
(`tests/kimi_linear_reference.py`, float32) at a tiny size that keeps
every part (four layers: a dense SwiGLU layer, then experts; KDA and MLA
mixers; 8 experts top-2 plus the shared one; a KDA chunk shorter than the
prompts): the packed prefill and the greedy decode through the hybrid
cache, the chunked delta rule against its recurrence, the absorbed latent
attention against the expanded one, the held range of experts against the
uncut layer, K7's SwiGLU mode (its plain version here), the answer CLI
picking the model by its config's ``model_type``, and the reference's
copy in `portbench/`. K7's kernel test in SwiGLU mode sits beside its
others in `tests/test_torch_nemotron_h.py`.
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
import torch.nn.functional as F

from vidil_tpu_torch import answer_prompts
from vidil_tpu_torch.config import KimiLinearConfig, lm_config_from_dict
from vidil_tpu_torch.models import kimi_linear as KL
from vidil_tpu_torch.ops import grouped_expert_gemm as k7
from vidil_tpu_torch.ops import kda, moe, ssd
from vidil_tpu_torch.ops.generation import greedy_search
from vidil_tpu_torch.pipeline import lm_answer

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import kimi_linear_reference as R  # noqa: E402

torch.set_num_threads(2)
LA = {"full_attn_layers": [2, 4], "kda_layers": [1, 3], "head_dim": 16, "num_heads": 4,
      "short_conv_kernel_size": 4}
TINY = KimiLinearConfig(vocab_size=512, hidden_size=64, num_hidden_layers=4,
                        linear_attn_config=LA, num_attention_heads=4, kv_lora_rank=32,
                        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                        intermediate_size=96, moe_intermediate_size=32, num_experts=8,
                        num_experts_per_token=2, chunk_size=16)
RCFG = dataclasses.asdict(TINY)
# not multiples of the chunk; one shorter than the convolution, one than a chunk
LENGTHS = (37, 21, 3, 9)


@pytest.fixture(scope="module")
def model():
    params = KL.init_kimi_linear(TINY, torch.Generator().manual_seed(3), "cpu", torch.float32)
    rng = np.random.default_rng(4)
    prompts = [torch.from_numpy(rng.integers(5, TINY.vocab_size, n)) for n in LENGTHS]
    return params, prompts


def _prefill(params, prompts, cfg=TINY, capacity=48):
    cache = KL.init_cache(cfg, len(prompts), capacity, "cpu", torch.float32)
    lengths = tuple(len(p) for p in prompts)
    first = KL.prefill(params, cfg, torch.cat(prompts),
                       ssd.pack(ssd.Packing(lengths), cfg.chunk_size, "cpu"), cache)
    return first, cache


def test_config_defaults_are_the_published_model():
    c = KimiLinearConfig()
    kinds = c.layer_kinds
    assert len(kinds) == 27 and [i for i, k in enumerate(kinds) if k == "mla"] == [
        3, 7, 11, 15, 19, 23, 26]
    assert c.expert_range == (0, 256) and c.router_experts == 256
    held = KimiLinearConfig(num_experts=128, num_experts_published=256)
    assert held.expert_range == (0, 128) and held.router_experts == 256
    with pytest.raises(ValueError):
        KimiLinearConfig(num_experts=128, num_experts_published=256, expert_offset=200)


def test_packed_prefill_matches_the_reference(model):
    params, prompts = model
    first, cache = _prefill(params, prompts)
    refs = R.forward_batch(params, RCFG, prompts, logits_from=[len(p) - 1 for p in prompts])
    for b, (ref, _) in enumerate(refs):
        torch.testing.assert_close(first[b], ref[0], atol=2e-5, rtol=0)
    assert cache["lengths"].tolist() == list(LENGTHS)


def test_greedy_decode_through_the_cache_matches_the_full_forward(model):
    """Prefill, then 6 greedy tokens through the hybrid cache (the absorbed
    latent attention, the delta rule's one-token update): at every decoded
    position the logits are the reference's full forward over the prompt
    and the tokens before it."""
    params, prompts = model
    first, cache = _prefill(params, prompts)
    seen = [first]

    def step(tokens, c):
        logits = KL.step(params, TINY, tokens, c)
        seen.append(logits)
        return logits, c

    out = greedy_search(first, cache, step, 6, lm_answer.EOS, lm_answer.PAD)
    fulls = [torch.cat([ids, out[b, :-1].long()]) for b, ids in enumerate(prompts)]
    refs = R.forward_batch(params, RCFG, fulls, logits_from=[len(p) - 1 for p in prompts])
    for b, (ref, _) in enumerate(refs):
        got = torch.stack([s[b] for s in seen])
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)
        greedy = ref.argmax(-1).tolist()
        n = greedy.index(lm_answer.EOS) + 1 if lm_answer.EOS in greedy else len(greedy)
        assert out[b, :n].tolist() == greedy[:n]  # pads after </s>
        assert set(out[b, n:].tolist()) <= {lm_answer.PAD}


# float32 against float32: the chunked form sums in another order than the
# recurrence (the triangular solve, the products through the entering
# state); 1e-5 of outputs of order one
CHUNK_ATOL = 1e-5


@pytest.mark.parametrize("strongest", [-0.5, -30.0])
def test_chunked_rule_matches_the_recurrence(strongest):
    """kda_chunked over packed prompts of unequal length (chunk 16, so
    sub-chunk pairs, cross-sub-chunk pairs and the pass across chunks all
    run) against the one-token update run prompt by prompt from a zero
    state, with decays down to g = `strongest` a step: every output and
    each prompt's final state, all finite."""
    H, dk, dv = 3, 16, 12
    lengths = (37, 16, 3, 70, 17)
    T = sum(lengths)
    gen = torch.Generator().manual_seed(5)
    q, k = torch.randn(T, H, dk, generator=gen), torch.randn(T, H, dk, generator=gen)
    v = torch.randn(T, H, dv, generator=gen)
    g = torch.rand(T, H, dk, generator=gen) * strongest
    g[::5, :, ::3] = strongest          # the strongest decay on some channels
    beta = torch.rand(T, H, generator=gen)
    packing = ssd.Packing(lengths)
    o, final = kda.kda_chunked(q, k, v, g, beta, ssd.pack(packing, 16, "cpu").layout,
                               len(lengths), 16)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(final).all())
    for p, (s, n) in enumerate(zip(packing.starts, lengths)):
        state = torch.zeros(1, H, dk, dv)
        want = torch.cat([kda.kda_step(state, q[i:i + 1], k[i:i + 1], v[i:i + 1], g[i:i + 1],
                                       beta[i:i + 1]) for i in range(s, s + n)])
        torch.testing.assert_close(o[s:s + n], want, atol=CHUNK_ATOL, rtol=0)
        torch.testing.assert_close(final[p:p + 1], state, atol=CHUNK_ATOL, rtol=0)


def test_one_token_update_is_the_published_recurrence():
    """kda_step against S <- (I - beta k k^T) Diag(alpha) S + beta k v^T
    and o = S^T q / sqrt(dk) written out with explicit matrices."""
    H, dk, dv = 2, 8, 8
    gen = torch.Generator().manual_seed(6)
    S = torch.randn(1, H, dk, dv, generator=gen)
    q, k, v = (torch.randn(1, H, d, generator=gen) for d in (dk, dk, dv))
    g, beta = -torch.rand(1, H, dk, generator=gen), torch.rand(1, H, generator=gen)
    got = kda.kda_step(S.clone(), q, k, v, g, beta)
    for h in range(H):
        kn = F.normalize(k[0, h], dim=0, eps=0)
        qn = F.normalize(q[0, h], dim=0, eps=0)
        new = (torch.eye(dk) - beta[0, h] * torch.outer(kn, kn)) @ torch.diag(
            torch.exp(g[0, h])) @ S[0, h] + beta[0, h] * torch.outer(kn, v[0, h])
        torch.testing.assert_close(got[0, h], new.t() @ qn / dk ** 0.5, atol=1e-5, rtol=1e-5)


def test_absorbed_decode_matches_the_expanded_attention(model):
    """mla_step over a prefilled latent cache against mla_prefill over the
    prompts with the new token appended: the new token's output."""
    params, prompts = model
    p = next(layer for layer in params["layers"] if layer["kind"] == "mla")
    i = params["layers"].index(p)
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn(n + 1, TINY.hidden_size, generator=gen) for n in LENGTHS]
    cache = KL.init_cache(TINY, len(xs), 48, "cpu", torch.float32)
    packed = ssd.pack(ssd.Packing(LENGTHS), TINY.chunk_size, "cpu")
    KL.mla_prefill(p, torch.cat([x[:-1] for x in xs]), TINY, packed.packing, cache, i)
    cache["lengths"][:] = torch.tensor(LENGTHS)
    got = KL.mla_step(p, torch.stack([x[-1] for x in xs]), TINY, cache, i)
    full = ssd.Packing(tuple(n + 1 for n in LENGTHS))
    scratch = KL.init_cache(TINY, len(xs), 48, "cpu", torch.float32)
    want = KL.mla_prefill(p, torch.cat(xs), TINY, full, scratch, i)[full.ends - 1]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(cache[f"lat{i}"], scratch[f"lat{i}"], atol=0, rtol=0)


def test_held_shares_sum_to_the_uncut_layer(model):
    """The shares [0, E/2) and [E/2, E) of a MoE layer, the shared expert
    counted once, add up to the uncut reference layer; each share routes
    over all E experts and computes its own."""
    params, _ = model
    p = next(layer for layer in params["layers"] if layer["mlp"] == "moe")
    E = TINY.num_experts
    x = torch.randn(40, TINY.hidden_size, generator=torch.Generator().manual_seed(8))
    whole = R.moe(p, x, RCFG, "fp32", [])
    shared = moe.shared_expert(x, p["shared_gate_up"], p["shared_down"], "swiglu")
    parts = []
    for lo in (0, E // 2):
        half = KimiLinearConfig(**dict(RCFG, num_experts=E // 2, num_experts_published=E,
                                       expert_offset=lo))
        cut = dict(p, gate_up=p["gate_up"][lo:lo + E // 2], down=p["down"][lo:lo + E // 2])
        part = moe.moe_layer(cut, x, half, first=lo)
        ref = R.moe(cut, x, dict(RCFG, num_experts=E // 2, expert_offset=lo), "fp32", [])
        torch.testing.assert_close(part, ref, atol=1e-5, rtol=1e-5)
        parts.append(part - shared)
    torch.testing.assert_close(parts[0] + parts[1] + shared, whole, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(parts[0], parts[1])


def test_k7_swiglu_plain_version_matches_f_linear():
    """K7's plain version in SwiGLU mode against F.linear and SiLU(gate) *
    up on each expert's rows, the weight's blocks of 8 de-interleaved;
    experts without rows included, and rows past the last offset left
    zero (pairs routed to experts held elsewhere)."""
    E, I, K = 5, 24, 64
    counts = [4, 0, 7, 1, 3]
    gen = torch.Generator().manual_seed(9)
    R_ = sum(counts) + 5
    x = torch.randn(R_, K, generator=gen).bfloat16()
    w = (torch.randn(E, 2 * I, K, generator=gen) * 0.1).bfloat16()
    offsets = torch.zeros(E + 1, dtype=torch.int32)
    offsets[1:] = torch.cumsum(torch.tensor(counts), 0)
    got = k7.grouped_expert_gemm(x, w, offsets, "swiglu")
    assert got.shape == (R_, I)
    o = offsets.tolist()
    for e in range(E):
        blocks = w[e].float().view(I // 8, 2, 8, K)
        gate, up = blocks[:, 0].reshape(I, K), blocks[:, 1].reshape(I, K)
        xe = x[o[e]:o[e + 1]].float()
        want = F.silu(F.linear(xe, gate)) * F.linear(xe, up)
        torch.testing.assert_close(got[o[e]:o[e + 1]].float(), want, atol=2e-2, rtol=1e-2)
    assert not got[o[E]:].any()
    with pytest.raises(ValueError):
        k7.grouped_expert_gemm(x, w, offsets, "gelu")


def test_answer_cli_picks_the_model_by_model_type(model, tmp_path):
    """`answer_prompts --config` with a kimi_linear config.json runs Kimi
    Linear through LMAnswerEngine: the same answers as the engine driven
    here on the model drawn from the same seed."""
    cfg_file = tmp_path / "config.json"
    cfg_file.write_text(json.dumps(dict(RCFG, model_type="kimi_linear")))
    assert isinstance(lm_config_from_dict(json.loads(cfg_file.read_text())), KimiLinearConfig)
    with pytest.raises(ValueError):
        lm_config_from_dict({"model_type": "llama"})
    vocab = lm_answer.SPECIALS + list(".,:") + [f"w{i}" for i in range(TINY.vocab_size - 8)]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    prompts = ["w1 w2, w3.\n\nw4:", "w5 w6 w7 w8 w9 w10.\nw11:", "w12"]
    with open(tmp_path / "prompts.jsonl", "w") as f:
        for p in prompts:
            f.write(json.dumps({"prompt": p}) + "\n")
    rc = answer_prompts.main(["--prompts", str(tmp_path / "prompts.jsonl"), "--out",
                              str(tmp_path / "out.jsonl"), "--vocab", str(tmp_path / "vocab.txt"),
                              "--config", str(cfg_file), "--seed", "11", "--device", "cpu",
                              "--batch", "2", "--max_new_tokens", "4",
                              "--max_prompt_tokens", "40"])
    assert rc == 0
    got = [json.loads(line)["choices"][0]["text"] for line in open(tmp_path / "out.jsonl")]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(11)
    params = KL.init_kimi_linear(TINY, gen, "cpu")
    engine = lm_answer.LMAnswerEngine(params, TINY, lm_answer.WordTokenizer(vocab),
                                      max_prompt_tokens=40, max_new_tokens=4, device="cpu")
    assert engine.model is KL
    with torch.no_grad():
        assert lm_answer.answer_all(engine, prompts, 2) == got


def test_reference_copy_in_portbench_is_byte_equal():
    assert filecmp.cmp(os.path.join(HERE, "kimi_linear_reference.py"),
                       os.path.join(REPO, "portbench", "reference", "kimi_linear.py"),
                       shallow=False)


def test_the_reference_imports_nothing_of_either_package():
    src = open(os.path.join(HERE, "kimi_linear_reference.py")).read()
    assert "vidil_tpu" not in src and "jax" not in src
