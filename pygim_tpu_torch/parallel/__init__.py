"""Multi-device layouts of the port, the counterpart of
``pygim_tpu/parallel/``: the 2D ``sp × ds`` mesh SpMM (``spmm_2d.py``),
the row-partitioned halo layout over a 1-D ``nodes`` mesh (``halo.py``),
their device grids (``mesh.py``) and their collectives
(``collectives.py``)."""

from pygim_tpu_torch.parallel.halo import (  # noqa: F401
    PreparedSpmmHalo,
    make_node_mesh,
    prepare_spmm_halo,
)
from pygim_tpu_torch.parallel.mesh import Mesh, NodeMesh, make_mesh  # noqa: F401
from pygim_tpu_torch.parallel.spmm_2d import (  # noqa: F401
    PreparedSpmm2D,
    prepare_spmm_2d,
)
