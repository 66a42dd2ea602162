"""A/B device times of K2 (flash-attention backward) and of the fused ViT
block (K4, its attention alone, K5 with its workspace bytes, at both block
shapes) between two trees of the port, on one card.

    python tools/ab_attention.py <tree root> <label>

Imports vidil_tpu_torch from <tree root> (this checkout, or e.g. a parent
commit unpacked by `git archive` into a git-ignored directory) and the
measurement functions of this checkout's chip_smoke.py (phases 7b and 8:
each kernel is held against its twin first), and prints one line "AB
{json}" of bf16 device ms. Run each tree in its own process, in turns
(base, change, change, base), in one call on one card."""
import importlib.util
import json
import os
import sys

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(root))
import torch  # noqa: E402
from vidil_tpu_torch.ops import flash_attention as fa  # noqa: E402
from vidil_tpu_torch.ops import fused_vit_block as fvb  # noqa: E402

assert fa.__file__.startswith(os.path.abspath(root)), fa.__file__
spec = importlib.util.spec_from_file_location(
    "cs", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
dev = torch.device("cuda")
out = {"label": label}
for r in cs.check_bwd(fa, dev):
    if r["dtype"] == "bfloat16":
        out[f"k2_{r['shape']}"] = {k: r[k] for k in ("ms", "device_ms", "library_device_ms",
                                                    "tflops_7_products", "max_abs_err")}
        out[f"k2_{r['shape']}"]["kernels"] = r["kernels"]
for r in cs.check_block_attention(fvb, dev):
    if r["dtype"] == "bfloat16":
        out[f"attn_{r['shape']}_{int(r['stats'])}"] = {k: r[k] for k in (
            "ms", "device_ms", "library_device_ms", "max_abs_err")}
gen = torch.Generator(device=dev).manual_seed(5)
for shape, (B, Lp, tl) in cs.BLOCK_SHAPES.items():
    args = cs.block_args(B, Lp, torch.bfloat16, gen, dev)
    d = cs.block_device_times(lambda: fvb._launch_fwd(args, tl, 12, 1e-6),
                              lambda: cs.library_block(args, tl), B, Lp, torch.bfloat16)
    out[f"k4_{shape}"] = {"device_ms": d["device_ms"], "attention_ms": d["parts"]["attention"]["ms"]}
    g = torch.randn((B, Lp, 768), generator=gen, device=dev).to(torch.bfloat16)
    g[:, tl:] = 0
    want = fvb.fused_block_bwd_ref(*args, g, true_len=tl, num_heads=12, eps=1e-6)
    err = max(cs._rel_err(a, b) for a, b in zip(fvb._launch_bwd(args, g, tl, 12, 1e-6), want))
    assert err <= cs.BLOCK_BWD_RTOL[torch.bfloat16], err
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    d = cs.block_device_times(lambda: fvb._launch_bwd(args, g, tl, 12, 1e-6),
                              lambda: torch.autograd.grad(cs.library_block(leaves, tl), leaves, g),
                              B, Lp, torch.bfloat16, backward=True)
    out[f"k5_{shape}"] = {"device_ms": d["device_ms"], "library_device_ms": d["library_device_ms"],
                          "rel_err": err,
                          "workspace_bytes": fvb._kernel_fns()["bwd_ws"](0, B, Lp, 768, 3072, 12),
                          "parts": {k: [round(v["ms"], 4), v["launches"]]
                                    for k, v in d["parts"].items()}}
print("AB", json.dumps(out), flush=True)
