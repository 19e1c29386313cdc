"""pygim_tpu_torch — the PyTorch / CUDA port of ``pygim_tpu``.

Prepare-once / run-many sparse aggregation for GNNs on one NVIDIA Hopper
card. The module layout follows ``pygim_tpu`` so every counterpart is
found under the same path; the JAX package stays the numeric reference.

It carries 2-layer GCN inference through the staircase-int8 hybrid
SpMM, with a float payload or with int8, int16 or int32 quantized
aggregation (int32 by default, as the reference): host prepare
(``core``, ``ops.spmm``), the hand-written kernels K-core
(``ops.core_dot``), K-int (``ops.core_int``) and K-tail with its
quantized payload modes (``ops.ell_tail``), the quantization (``quant``),
the model (``nn``), the benchmark bodies (``bench.runners``) and the
flagship forward step (``entry``).

The package never imports ``jax`` or ``pygim_tpu``. Entry points take an
explicit ``device`` (default ``"cuda"``); only tests pass ``"cpu"``.

TF32 is switched off here, at import: the reference computes float32
matmuls in full float32, and so does the port.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
