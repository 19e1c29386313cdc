#!/usr/bin/env python3
"""Where K-bcsr's time goes, on the card: the kernel beside a copy of it
that adds nothing, and its work plan in two item orders.

    python3 tools/bcsr_diag.py

On each smoke tier of ``chip_smoke.py`` (``BCSR_CONFIGS``, H 256, an f32
x) and both layouts of its 1 GiB random tier (``scale_tiers``), it times:

* ``kernel``: ``bcsr_add`` on the plan ``bcsr_plan`` builds, after a
  check against ``bcsr_plain``;
* ``no adds``: the same launch of a library built from ``csrc/bcsr.cu``
  with every add returning at once (the products, tile loads, panel
  gathers and epilogue staging stay), so ``kernel - no adds`` is what the
  adds cost beyond what overlaps them;
* ``panel order``: the kernel on the same plan with its items in panel
  order instead of longest first.

Each line names the card and its power limit (``nvidia-smi``). The
edited copy is built with the package's own ``nvcc`` flags into a
temporary directory and removed with it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# the line of add4 that skips an all-zero piece: returning there instead
# skips every add
SKIP = "  if (v0 == 0.f && v1 == 0.f && v2 == 0.f && v3 == 0.f) return;\n"


def no_adds_library(tmp: str) -> ctypes.CDLL:
    """``csrc/bcsr.cu`` with every add removed, built and bound like the
    package's own library."""
    from pygim_tpu_torch.ops import _build

    src = (_build.CSRC / "bcsr.cu").read_text()
    if src.count(SKIP) != 1:
        raise RuntimeError("csrc/bcsr.cu: the zero-skip line of add4 moved")
    cu = Path(tmp) / "bcsr_no_adds.cu"
    cu.write_text(src.replace(SKIP, "  return;\n"))
    so = Path(tmp) / "libbcsr_no_adds.so"
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.bcsr_add.argtypes = _build.SIGNATURES["bcsr"]["bcsr_add"]
    lib.bcsr_add.restype = ctypes.c_int
    return lib


def readings(key, tables, nodes, x, libs) -> dict:
    import torch

    import chip_smoke as cs
    from pygim_tpu_torch.ops import bcsr as kbcsr

    kind, tiles, pidx, rb = tables[:4]
    plan = kbcsr.bcsr_plan(kind, pidx, rb, tiles.shape[2], x.shape[1],
                           tile_bytes=tiles.element_size())
    by_panel = dataclasses.replace(
        plan, items=plan.items[plan.items[:, 0].argsort()].contiguous())
    want = kbcsr.bcsr_plain(x, *tables, torch.zeros(nodes, x.shape[1],
                                                    device=x.device))
    out = torch.zeros_like(want)
    load = kbcsr._build.load
    res = {}
    try:
        for name, lib, p in (("kernel", None, plan),
                             ("no adds", libs["no adds"], plan),
                             ("panel order", None, by_panel)):
            p = p.to(x.device)
            if lib is not None:
                kbcsr._build.load = lambda n, lib=lib: lib
            if lib is None:
                cs.check_close(f"{key} {name}",
                               kbcsr.bcsr_add(x, *tables, out.zero_(), plan=p),
                               want, cs.bcsr_mag(x, tables, nodes), cs.REL_TOL)
            res[name] = cs.cuda_ms(
                lambda: kbcsr.bcsr_add(x, *tables, out.zero_(), plan=p),
                iters=10)
            kbcsr._build.load = load
    finally:
        kbcsr._build.load = load
    res.update(items=plan.stages, adds=plan.adds)
    return res


def main() -> int:
    sys.path.insert(0, str(HERE))
    os.environ.setdefault("PYGIM_TPU_TORCH_DATA",
                          tempfile.mkdtemp(prefix="bcsr_diag_"))
    import torch

    import chip_smoke as cs
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.utils.device import card_line

    if not torch.cuda.is_available():
        print("bcsr_diag: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"no adds": no_adds_library(tmp)}
        ds = load_dataset(cs.BCSR_GRAPH)
        n = ds.graph.nrows
        x = torch.randn(n, cs.HIDDEN,
                        generator=torch.Generator().manual_seed(1)).cuda()
        for key, kw in cs.BCSR_CONFIGS.items():
            prep = prepare_spmm(ds.graph, SpmmConfig(
                backend="hybrid", hybrid_shape="square",
                hybrid_core_bytes=cs.BCSR_CORE_BYTES,
                bcsr_bytes=cs.BCSR_BYTES, hidden_hint=cs.HIDDEN, **kw),
                device="cuda")
            res = readings(key, prep.bcsr_tables(prep.dev_arrays), n, x, libs)
            print(json.dumps({"tier": key, "ms": res, "card": card}),
                  flush=True)
            del prep
            torch.cuda.empty_cache()
        for tables, nodes, xs in cs.scale_tiers("cuda"):
            res = readings(f"scale {tables[0]}", tables, nodes, xs, libs)
            print(json.dumps({"tier": f"scale {tables[0]}", "ms": res,
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
