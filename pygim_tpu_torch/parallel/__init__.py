"""Multi-device layouts of the port: the 2D ``sp × ds`` mesh SpMM
(``spmm_2d.py``), its device grid (``mesh.py``) and its ``sp`` merge
(``collectives.py``). Counterpart of ``pygim_tpu/parallel/``; the halo
layout is not ported yet (ROADMAP.md, Queue 1 item 6b)."""

from pygim_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from pygim_tpu_torch.parallel.spmm_2d import (  # noqa: F401
    PreparedSpmm2D,
    prepare_spmm_2d,
)
