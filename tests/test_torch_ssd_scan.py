"""The LM prefill's chunked Mamba-2 scan: kernel K8 (`ops/ssd.py:
ssd_chunked` on CUDA tensors, `csrc/ssd_chunk_scan.cu`) against its plain
version `ssd_chunked_ref` and a float64 run of the one-token recurrence,
at the LM cell's widths (H 64, P 64, G 8, N 128, chunks of 128); on the
CPU, the wrapper's plain route, the layout's prompt table and the
kernel's operand checks.

The `cuda`-marked tests need a card (they skip here):
``python -m pytest --noconftest -m cuda tests/test_torch_ssd_scan.py``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vidil_tpu_torch.ops import ssd

H, P, G, N, L = 64, 64, 8, 128, 128


def _case(lengths, seed, device):
    """Packed prompts of `lengths` tokens at the cell's widths: x, B and C
    bf16 views of one (T, H P + 2 G N) convolution output, as the model
    splits it; dt the softplus of noise around the model's dt_bias; A =
    -U(1, 16); D near one."""
    g = torch.Generator().manual_seed(seed)
    T = sum(lengths)
    xbc = torch.randn(T, H * P + 2 * G * N, generator=g).to(torch.bfloat16).to(device)
    x = xbc[:, :H * P].reshape(T, H, P)
    B = xbc[:, H * P:H * P + G * N].reshape(T, G, N)
    C = xbc[:, H * P + G * N:].reshape(T, G, N)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt0 = torch.exp(torch.rand(H, generator=g) * (hi - lo) + lo)
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(torch.randn(T, H, generator=g) * 0.5 + bias).to(device)
    A = (-(1 + 15 * torch.rand(H, generator=g))).to(device)
    D = (1 + 0.1 * torch.randn(H, generator=g)).to(device)
    packed = ssd.pack(ssd.Packing(tuple(lengths)), L, device)
    return (x, dt, A, B, C, D, packed.layout, len(lengths), L), packed.packing


def _recurrence64(x, dt, A, B, C, D, packing):
    """The one-token recurrence h <- exp(dt A) h + dt x B^T, y = h C + D x
    in float64, all prompts in step: the scan's exact value to ~1e-16."""
    T = x.shape[0]
    hg = H // G
    starts = torch.tensor(packing.starts, device=x.device)
    lengths = torch.tensor(packing.lengths, device=x.device)
    y = torch.empty(T, H, P, dtype=torch.float64, device=x.device)
    h = torch.zeros(len(packing.lengths), H, P, N, dtype=torch.float64, device=x.device)
    A64, D64 = A.double(), D.double()
    for i in range(max(packing.lengths)):
        act = (lengths > i).nonzero().squeeze(1)
        rows = starts[act] + i
        xi, dti = x[rows].double(), dt[rows].double()
        Bi = B[rows].double().repeat_interleave(hg, 1)
        Ci = C[rows].double().repeat_interleave(hg, 1)
        hi = (h[act] * torch.exp(dti * A64)[..., None, None]
              + (dti[..., None] * xi)[..., None] * Bi[:, :, None, :])
        h[act] = hi
        y[rows] = (hi @ Ci[..., None]).squeeze(-1) + D64[:, None] * xi
    return y, h


def _fp32_limit(packing, want):
    """How far a float32 evaluation of the scan may lie from the exact
    value, whatever the order of its sums: gamma_n = n u / (1 - n u) (u =
    2^-24) times max|want|, n the longest chain of roundings behind one
    output: a chunk's own terms (C.B^T over N, its three weight roundings,
    the sum over the chunk's L slots, the read-out over N and its scale, D
    x) and the state carried through every chunk of the longest prompt (L
    + 4 each: its sum over the chunk, the decay, the weight, the add). A
    product rounded once to bf16 (2^-9 of a term) or to TF32 (2^-11) lies
    beyond it at these widths."""
    u = 2.0 ** -24
    n = 2 * N + L + 8 + math.ceil(max(packing.lengths) / L) * (L + 4)
    return n * u / (1 - n * u) * want.abs().max().item()


def test_ssd_chunked_takes_the_plain_version_on_cpu():
    """On CPU tensors the wrapper is today's plain scan, bit for bit, and
    launches nothing."""
    args, _ = _case([3, 130, 1], 21, "cpu")
    before = ssd.launch_counts["ssd_scan"]
    y, final = ssd.ssd_chunked(*args)
    want_y, want_final = ssd.ssd_chunked_ref(*args)
    assert torch.equal(y, want_y) and torch.equal(final, want_final)
    assert ssd.launch_counts["ssd_scan"] == before


def test_the_layout_lists_prompts_longest_first():
    packed = ssd.pack(ssd.Packing((5, 300, 129, 300)), L, "cpu")
    prompts = packed.layout.prompts
    assert prompts.dtype == torch.int32
    assert prompts.tolist() == [[1, 5, 300], [3, 434, 300], [2, 305, 129], [0, 0, 5]]
    assert prompts[:, 0].tolist() == packed.layout.order.tolist()


def _bad(args, **change):
    names = ("x", "dt", "A", "B", "C", "D", "layout", "n_prompts", "chunk")
    kw = dict(zip(names, args))
    kw.update(change)
    return kw


@pytest.mark.parametrize("what", ["x_dtype", "dt_dtype", "head_dim", "state_size", "chunk",
                                  "groups", "dt_shape", "prompt_table", "x_copy_strides"])
def test_check_kernel_operands_raises(what):
    """What K8 does not take raises before any launch (CPU tensors: the
    checks need no card)."""
    args, _ = _case([40, 9], 22, "cpu")
    x, dt, A, B, C, D, layout, n, chunk = args
    bad = {"x_dtype": dict(x=x.float()),
           "dt_dtype": dict(dt=dt.half()),
           "head_dim": dict(x=x[..., :32]),
           "state_size": dict(B=B[..., :64], C=C[..., :64]),
           "chunk": dict(chunk=64),
           "groups": dict(B=B[:, :6], C=C[:, :6]),
           "dt_shape": dict(dt=dt[:, :32]),
           "prompt_table": dict(n_prompts=3),
           "x_copy_strides": dict(x=x.transpose(1, 2).contiguous().transpose(1, 2))}[what]
    with pytest.raises((TypeError, ValueError)):
        ssd.check_kernel_operands(**_bad(args, **bad))
    assert ssd.check_kernel_operands(*args) == (49, H, G)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 has no CPU mode (its plain version runs here)")
    return torch.device("cuda")


PACKINGS = {"one_prompt": [2600],
            "cell_16": [int(n) for n in np.random.default_rng(25).integers(1500, 3001, 16)],
            "edges": [1, 127, 128, 129, 257]}


@pytest.mark.cuda
@pytest.mark.parametrize("packing", list(PACKINGS))
def test_k8_matches_the_plain_scan(cuda_device, packing):
    """K8 and the plain scan against the float64 recurrence, each within
    the float32 limit, and K8 within twice it of the plain scan: y in token
    order and each prompt's final state."""
    args, packing_ = _case(PACKINGS[packing], 23, cuda_device)
    y, final = ssd.ssd_chunked(*args)
    torch.cuda.synchronize()
    want_y, want_final = ssd.ssd_chunked_ref(*args)
    exact_y, exact_final = _recurrence64(*args[:6], packing_)
    for got, plain, exact in ((y, want_y, exact_y), (final, want_final, exact_final)):
        assert bool(torch.isfinite(got).all())
        limit = _fp32_limit(packing_, exact)
        assert (got.double() - exact).abs().max().item() <= limit
        assert (plain.double() - exact).abs().max().item() <= limit
        assert (got - plain).abs().max().item() <= 2 * limit


@pytest.mark.cuda
def test_k8_is_bitwise_equal_run_to_run(cuda_device):
    args, _ = _case(PACKINGS["cell_16"], 24, cuda_device)
    a = ssd.ssd_chunked(*args)
    b = ssd.ssd_chunked(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_k8_counts_one_launch_a_call(cuda_device):
    args, _ = _case([300, 7], 25, cuda_device)
    before = ssd.launch_counts["ssd_scan"]
    ssd.ssd_chunked(*args)
    ssd.ssd_chunked(*args)
    torch.cuda.synchronize()
    assert ssd.launch_counts["ssd_scan"] == before + 2


@pytest.mark.cuda
def test_k8_refuses_operands_on_another_device(cuda_device):
    args, _ = _case([300, 7], 26, cuda_device)
    x, dt, A, B, C, D, layout, n, chunk = args
    before = ssd.launch_counts["ssd_scan"]
    with pytest.raises(ValueError):
        ssd.ssd_chunked(x, dt.cpu(), A, B, C, D, layout, n, chunk)
    with pytest.raises(TypeError):
        ssd.ssd_chunked(x.float(), dt, A, B, C, D, layout, n, chunk)
    with pytest.raises(ValueError):
        ssd.ssd_chunked(x[..., :32], dt, A, B, C, D, layout, n, chunk)
    assert ssd.launch_counts["ssd_scan"] == before
