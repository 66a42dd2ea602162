"""vidil_tpu_torch — the PyTorch/CUDA port of vidil_tpu for NVIDIA Hopper.

A package beside ``vidil_tpu`` (the JAX reference, which it never
imports): plain tensor code in PyTorch, and a hand-written CUDA kernel
(``csrc/``) for each Pallas kernel of the JAX package on the ported
paths. Entry points that run a model run on CUDA unless the caller
passes ``device="cpu"``; the prompt-side CLIs without a model (prompt
generators, GPT-3 processing, caption eval) are host code.

fp32 means fp32: TF32 and reduced-precision bf16 GEMM reductions are
turned off at import, so fp32 and bf16 products accumulate in full fp32
as in the JAX package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
