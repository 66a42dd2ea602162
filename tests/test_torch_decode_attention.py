"""The decode's cross-attention (`vidil_tpu_torch/ops/decode_attention.py`,
kernel K6 on the card).

On the CPU: the plain version against `dot_product_attention` over the
memory repeated per query row, on the head-split views that
`precompute_cross_kv` returns; a tiny decode's tokens and scores through it
against the path it replaced; the bf16 limit of the card's comparison,
which must pass a change of summation order and fail planted faults; what
the kernel refuses; the launch count. Marked `cuda`: the kernel against the
plain version at CapFilt's step and prefill shapes, in bf16 and fp32,
bitwise run to run. This file imports
neither JAX nor vidil_tpu, so the card runs it alone:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_attention.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from vidil_tpu_torch.config import MedConfig
from vidil_tpu_torch.models import blip as B
from vidil_tpu_torch.models import med as M
from vidil_tpu_torch.models.layers import (dot_product_attention, grouped_softmax_attention,
                                           merge_heads, split_heads)
from vidil_tpu_torch.ops import decode_attention as DA
from vidil_tpu_torch.ops.generation import GenerationConfig
from vidil_tpu_torch.utils.seeding import init_generator

TINY = MedConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                 max_position_embeddings=64, encoder_width=32)
GEN = GenerationConfig(max_length=12, min_length=3, num_beams=3, eos_token_id=5,
                       pad_token_id=0, early_exit=False)


def _memory(cfg, B_, Lk, seed, device="cpu", dtype=None):
    """One layer's precomputed cross K/V (head-split views of (B, Lk, H*Dh)
    buffers, as the decode holds them) and the layer's parameters."""
    params = M.init_med(init_generator(seed, torch.device(device)), cfg, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    enc = torch.randn(B_, Lk, cfg.encoder_width, generator=g, device=device)
    k, v = M.precompute_cross_kv(params, enc, cfg, dtype=dtype)
    return params, k[0], v[0]


def _replicated(q, k, v, G):
    """`dot_product_attention` over the memory repeated G times along the
    batch (the reference's repeat_interleave of the beams)."""
    k, v = (t.repeat_interleave(G, 0) for t in (k, v))
    return merge_heads(dot_product_attention(split_heads(q, k.shape[1]), k, v))


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("L", [1, 4])
def test_plain_version_matches_the_plain_path(G, L):
    """(tolerance) fp32 on the CPU: the same sums over the same rows; only
    the batching of the products differs."""
    _, k, v = _memory(TINY, 3, 7, seed=G * 10 + L)
    assert k.stride()[-2] == TINY.hidden_size  # a head-split view, not a copy
    q = torch.randn(3 * G, L, TINY.hidden_size, generator=torch.Generator().manual_seed(L))
    got = DA.decode_cross_attention(q, k, v, G)
    assert got.shape == q.shape and got.dtype == v.dtype
    torch.testing.assert_close(got, _replicated(q, k, v, G), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    params = {"text_decoder": M.init_med(init_generator(0), TINY, with_lm_head=True)}
    embeds = torch.randn(2, 5, 32, generator=torch.Generator().manual_seed(1))
    prompt = torch.tensor([[1, 7, 8]], dtype=torch.int32).expand(2, -1)
    return params, embeds, prompt


def _old_path(monkeypatch):
    """Every cross-attention on the products it ran before K6."""
    def attention(q, k, v, G):
        qh = split_heads(q, k.shape[1])
        if G > 1:
            return merge_heads(grouped_softmax_attention(qh, k, v, None, G))
        return merge_heads(dot_product_attention(qh, k, v))

    monkeypatch.setattr(DA, "decode_cross_attention", attention)


@pytest.mark.parametrize("mode", ["beam_grouped", "beam", "sample"])
def test_tiny_decode_tokens_equal_the_old_paths(tiny, monkeypatch, mode):
    params, embeds, prompt = tiny

    def run():
        if mode == "sample":
            gen = dataclasses.replace(GEN, num_beams=1)
            return (B.blip_generate_ids(params, embeds, prompt, TINY, gen, sample=True,
                                        generator=torch.Generator().manual_seed(3)),)
        return B.blip_beam_search(params, embeds, prompt, TINY, GEN,
                                  beam_group_kv=mode == "beam_grouped")

    calls = []
    kernel = DA.decode_cross_attention
    monkeypatch.setattr(DA, "decode_cross_attention",
                        lambda *a: calls.append(a[3]) or kernel(*a))
    got = run()
    # prefill and steps, every layer, all through K6's entry
    assert len(calls) == TINY.num_layers * (GEN.max_length - prompt.shape[1])
    assert set(calls) == {3 if mode == "beam_grouped" else 1}
    _old_path(monkeypatch)
    want = run()
    assert len(calls) == TINY.num_layers * (GEN.max_length - prompt.shape[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


CAPFILT = MedConfig(vocab_size=30524, hidden_size=768, num_layers=1, num_heads=12,
                    intermediate_size=3072, encoder_width=768)


def k6_limit(want):
    """(tolerance) kernel vs plain version: the fp32 sums run in another
    order, which can flip a bf16 rounding of a probability or of the output
    by an ulp or two (2 at most on the card): 4 bf16 ulps of max|want|; a
    dropped key or a wrong memory row moves the output by 10 or more
    (`test_bf16_limit_passes_rounding_and_catches_planted_faults`). fp32
    only moves the last bits of each sum."""
    if want.dtype == torch.float32:
        return 2e-5
    m = max(want.float().abs().max().item(), torch.finfo(torch.bfloat16).tiny)
    return 4 * 2.0 ** (math.floor(math.log2(m)) - 7)


def k6_close(got, want):
    return (got.float() - want.float()).abs().max().item() <= k6_limit(want)


def _fp64_sums(q, k, v, G):
    """The plain version's rounding points with every sum in fp64: another
    summation order, as the kernel's."""
    B, H, Lk, Dh = k.shape
    L = q.shape[1]
    qf = q.double().reshape(B, G, L, H, Dh).permute(0, 3, 1, 2, 4).reshape(B, H, G * L, Dh)
    logits = (qf @ k.double().transpose(-1, -2)).float() * (1.0 / math.sqrt(Dh))
    probs = torch.softmax(logits.double(), dim=-1).to(v.dtype).double()
    ctx = (probs @ v.double()).to(v.dtype)
    return ctx.reshape(B, H, G, L, Dh).permute(0, 2, 3, 1, 4).reshape(B * G, L, H * Dh)


PLANTED = {
    "fp64_sums": (_fp64_sums, True),
    "last_key_dropped": (lambda q, k, v, G: DA.decode_cross_attention_ref(
        q, k[:, :, :-1], v[:, :, :-1], G), False),
    # 577 = 4 x 128 + 65: the ragged last block of keys
    "ragged_tail_dropped": (lambda q, k, v, G: DA.decode_cross_attention_ref(
        q, k[:, :, :512], v[:, :, :512], G), False),
    "memory_row_off_by_one": (lambda q, k, v, G: DA.decode_cross_attention_ref(
        q, k.roll(1, 0), v.roll(1, 0), G), False),
}


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("case", list(PLANTED))
def test_bf16_limit_passes_rounding_and_catches_planted_faults(case, L):
    """The card's bf16 comparison at CapFilt's widths (12 heads of 64, 577
    keys, 3 beams a memory row, K/V from the projections of `init_med`):
    the plain version with its sums in fp64 passes `k6_close`; a dropped
    key, the ragged tail of keys dropped, or the next memory row fails."""
    cfg = dataclasses.replace(CAPFILT, vocab_size=64)
    params, k, v = _memory(cfg, 4, 577, seed=7, dtype=torch.bfloat16)
    x = torch.randn(4 * 3, L, 768, generator=torch.Generator().manual_seed(L))
    q = M.linear(params["layers"][0]["cross_attn"]["query"], x, dtype=torch.bfloat16)
    want = DA.decode_cross_attention_ref(q, k, v, 3)
    fn, passes = PLANTED[case]
    assert k6_close(fn(q, k, v, 3), want) == passes


def _operands(dtype=torch.bfloat16, Dh=64, H=2, B_=2, G=3, L=1, Lk=9):
    kv = torch.zeros(B_, Lk, H * Dh, dtype=dtype)
    k = kv.reshape(B_, Lk, H, Dh).transpose(1, 2)
    return torch.zeros(B_ * G, L, H * Dh, dtype=dtype), k, k.clone(), G


@pytest.mark.parametrize("change,error", [
    ({"dtype": torch.float16}, TypeError),
    ({"Dh": 48}, ValueError),
    ({"Dh": 8}, ValueError),
    ({"Lk": 20000}, ValueError),
])
def test_kernel_refuses_what_it_does_not_take(change, error):
    """A CUDA call checks its operands first and raises on these (the
    check runs on any device, so the CPU shows it)."""
    assert DA.check_kernel_operands(*_operands()) == (2, 2, 9, 64)
    assert DA.check_kernel_operands(*_operands(torch.float32, Dh=128)) == (2, 2, 9, 128)
    with pytest.raises(error):
        DA.check_kernel_operands(*_operands(**change))


def test_kernel_refuses_mismatched_operands():
    q, k, v, G = _operands()
    for bad in ((q[:, :, :-8], k, v, G), (q, k, v.float(), G), (q, k, v, 2),
                (q.transpose(0, 1), k, v, G), (q, k[..., :32], v[..., :32], G)):
        with pytest.raises(ValueError):
            DA.check_kernel_operands(*bad)


def test_launch_count_starts_at_zero_and_resets(tiny):
    """The CPU's plain version is no launch; the count resets to 0."""
    DA.reset_launch_counts()
    assert DA.launch_counts == {"decode_cross_attention": 0}
    params, embeds, prompt = tiny
    B.blip_beam_search(params, embeds, prompt, TINY, GEN, beam_group_kv=True)
    assert DA.launch_counts["decode_cross_attention"] == 0
    DA.launch_counts["decode_cross_attention"] = 7
    DA.reset_launch_counts()
    assert DA.launch_counts["decode_cross_attention"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (chip_smoke.py runs it)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G,L", [(3, 1), (3, 4), (1, 1), (1, 4)])
def test_kernel_matches_plain_version_at_capfilt_shapes(cuda_device, dtype, G, L):
    """CapFilt's beam step (32 memory rows, 12 heads, 3 beams, 577 keys) and
    prefill (4 prompt tokens), and one row a memory row (sampling,
    non-grouped beams)."""
    _, k, v = _memory(CAPFILT, 32, 577, seed=7, device=cuda_device, dtype=dtype)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q = torch.randn(32 * G, L, 768, generator=g, device=cuda_device).to(dtype)
    before = DA.launch_counts["decode_cross_attention"]
    got = DA.decode_cross_attention(q, k, v, G)
    torch.cuda.synchronize()
    assert DA.launch_counts["decode_cross_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = DA.decode_cross_attention_ref(q, k, v, G)
    assert k6_close(got, want)
    if G == 1:
        assert k6_close(got, merge_heads(dot_product_attention(split_heads(q, 12), k, v)))
    assert torch.equal(DA.decode_cross_attention(q, k, v, G), got)  # no atomics
    # the kernel run on all but the last key fails the same comparison
    assert not k6_close(DA.decode_cross_attention(q, k[:, :, :-1], v[:, :, :-1], G), want)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,Lk,rows", [(32, 1, 1), (128, 200, 13), (64, 13000, 64)])
def test_kernel_edges(cuda_device, Dh, Lk, rows):
    """Other head widths, one key, a ragged last row block, and keys whose
    logits need more than 48 KB of shared memory."""
    H = 4
    rng = np.random.default_rng(Dh + Lk)
    kv = torch.from_numpy(rng.standard_normal((2, 2, Lk, H * Dh), dtype=np.float32))
    kv = kv.to(cuda_device, torch.bfloat16)
    k, v = (t.reshape(2, Lk, H, Dh).transpose(1, 2) for t in kv)
    q = torch.from_numpy(rng.standard_normal((2 * rows, 1, H * Dh), dtype=np.float32))
    q = q.to(cuda_device, torch.bfloat16)
    got = DA.decode_cross_attention(q, k, v, rows)
    assert k6_close(got, DA.decode_cross_attention_ref(q, k, v, rows))


@pytest.mark.cuda
def test_kernel_raises_on_cuda_operands_it_does_not_take(cuda_device):
    q, k, v, G = (t.to(cuda_device) if torch.is_tensor(t) else t
                  for t in _operands(torch.float16))
    with pytest.raises(TypeError):
        DA.decode_cross_attention(q, k, v, G)
