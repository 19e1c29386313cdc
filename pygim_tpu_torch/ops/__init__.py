"""Sparse products: host prepare, the hand-written kernels, the oracle."""

from pygim_tpu_torch.ops import (
    bcsr,
    bn_train,
    core_dot,
    core_f32,
    core_int,
    ell_tail,
    epilogue,
    quant_prologue,
    seg_rows,
)
from pygim_tpu_torch.ops.reference import spmm_coo_oracle, spmm_csr_oracle
from pygim_tpu_torch.ops.spmm import (
    PreparedAggregate,
    PreparedSpmm,
    SpmmConfig,
    prepare_spmm,
)


def launch_counts() -> dict:
    """Each kernel's launches since :func:`reset_launch_counts` (each
    wrapper adds one where it launches its kernel, and nowhere else)."""
    return {"K-core": core_dot.launches, "K-int": core_int.launches,
            "K-core int4": core_dot.packed_launches,
            "K-int int4": core_int.packed_launches,
            "K-core bf16": core_dot.bf16_launches,
            "K-f32": core_f32.launches,
            "K-f32 limbs": core_f32.limb_launches,
            "K-tail": ell_tail.launches,
            "K-tail-quant": ell_tail.quant_launches,
            "K-tail bf16": ell_tail.bf16_launches,
            "K-bcsr": bcsr.launches,
            **{f"K-bcsr {k}": bcsr.route_launches.get(k, 0)
               for k in bcsr.route_keys()},
            "K-rows": seg_rows.launches,
            "K-rows coo": seg_rows.coo_launches,
            "K-epi": epilogue.launches,
            "K-quant": quant_prologue.launches,
            **{f"K-quant {k}": n
               for k, n in quant_prologue.entry_launches.items()},
            **{f"K-bn {k}": n for k, n in bn_train.launches.items()}}


def reset_launch_counts() -> None:
    core_dot.launches = core_int.launches = 0
    core_dot.packed_launches = core_int.packed_launches = 0
    core_dot.bf16_launches = core_f32.launches = 0
    core_f32.limb_launches = 0
    ell_tail.launches = ell_tail.quant_launches = ell_tail.bf16_launches = 0
    bcsr.launches = 0
    bcsr.route_launches.clear()
    seg_rows.launches = seg_rows.coo_launches = 0
    epilogue.launches = quant_prologue.launches = 0
    quant_prologue.entry_launches.update(
        dict.fromkeys(quant_prologue.entry_launches, 0))
    bn_train.launches.update(dict.fromkeys(bn_train.launches, 0))


__all__ = ["PreparedAggregate", "PreparedSpmm", "SpmmConfig", "prepare_spmm",
           "spmm_coo_oracle", "spmm_csr_oracle", "launch_counts",
           "reset_launch_counts"]
