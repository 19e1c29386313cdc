"""Search spaces (``tune/space.py``) and the BCSR tier's sampled probe
(``tune/bcsr_probe.py``). The tuner itself is not ported yet
(ROADMAP.md, Queue 1 item 5)."""

from pygim_tpu_torch.tune.space import Concat, For, Product, Space, Table, Unit

__all__ = ["Concat", "For", "Product", "Space", "Table", "Unit"]
