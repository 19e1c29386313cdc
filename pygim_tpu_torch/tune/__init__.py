"""Autotuning: the search-space DSL (``tune/space.py``), the card's cost
model and the mesh's collective constants (``tune/cost_model.py``), the
per-graph autotuner over one card or a device budget
(``tune/autotuner.py``), its distribution plans and the halo cut
(``tune/dist.py``) and the BCSR tier's sampled probe
(``tune/bcsr_probe.py``)."""

from pygim_tpu_torch.tune.autotuner import (
    DEFAULT_SPACE,
    HYBRID_SPACE,
    TuneResult,
    autotune,
    plan_statistics,
    prepare_tuned,
)
from pygim_tpu_torch.tune.cost_model import (
    CardCostModel,
    calibrate_from_phases,
    measure_constants,
    measure_ici_constants,
    predict_spmm_time,
)
from pygim_tpu_torch.tune.dist import DistPlan, enumerate_dist, halo_statistics
from pygim_tpu_torch.tune.space import Concat, For, Product, Space, Table, Unit

__all__ = ["CardCostModel", "Concat", "DEFAULT_SPACE", "DistPlan", "For",
           "HYBRID_SPACE", "Product", "Space", "Table", "TuneResult", "Unit",
           "autotune", "calibrate_from_phases", "enumerate_dist",
           "halo_statistics", "measure_constants", "measure_ici_constants",
           "plan_statistics", "predict_spmm_time", "prepare_tuned"]
