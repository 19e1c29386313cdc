"""pygim_tpu_torch — the PyTorch / CUDA port of ``pygim_tpu``.

Prepare-once / run-many sparse aggregation for GNNs on one NVIDIA Hopper
card. The module layout follows ``pygim_tpu`` so every counterpart is
found under the same path; the JAX package stays the numeric reference.

It carries prepare-once / run-many SpMM on the ``hybrid`` (a square or
staircase hub-core of int8, int4, bf16 or f32 cells, or none, a BCSR
tile tier beside a square core, and an ELL tail), ``ell``, ``blocked``,
``coo`` and ``oracle`` backends, with float32, bfloat16 and integer
payloads, the fused int8, int16 and int32 quantized aggregation, SDDMM
(``ops.sddmm``), and GCN, GIN and SAGE inference and training (the
aggregate's backward on a prepared transpose): host prepare (``core``,
``ops.spmm``, ``data``), the hand-written kernels K-core with its int8,
int4 and bf16 cell modes (``ops.core_dot``), K-int (``ops.core_int``),
K-f32 (``ops.core_f32``), K-tail with its payload modes
(``ops.ell_tail``) and K-bcsr (``ops.bcsr``), the autotuner with the
card's cost model and the BCSR tier's probe (``tune``), the
quantization (``quant``), the
models and their training (``nn``), the benchmark bodies and reports
and the experiment harness with the named configurations (``bench``),
the dataset names and real-format parsers (``data``) and the flagship
forward step (``entry``); the entry scripts ``bench_cuda.py``,
``spmm_test_cuda.py``, ``inference_cuda.py``, ``train_cuda.py`` and
``sweep_cuda.py`` sit at the repository root.

The package never imports ``jax`` or ``pygim_tpu``. Entry points take an
explicit ``device`` (default ``"cuda"``); only tests pass ``"cpu"``.

TF32 is switched off here, at import: the reference computes float32
matmuls in full float32, and so does the port.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from pygim_tpu_torch.core.graph import CooGraph, CsrGraph  # noqa: E402

__all__ = ["CooGraph", "CsrGraph"]
