from pygim_tpu_torch.bench.runners import (
    run_inference_benchmark,
    run_spmm_benchmark,
)

__all__ = ["run_inference_benchmark", "run_spmm_benchmark"]
