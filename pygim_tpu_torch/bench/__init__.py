from pygim_tpu_torch.bench.experiment import Experiment, run_experiments
from pygim_tpu_torch.bench.parse_results import results_to_csv
from pygim_tpu_torch.bench.runners import (
    run_inference_benchmark,
    run_spmm_benchmark,
)

__all__ = ["Experiment", "results_to_csv", "run_experiments",
           "run_inference_benchmark", "run_spmm_benchmark"]
