"""Model checkpoint and resume: the counterpart of
``pygim_tpu/nn/checkpoint.py`` with ``torch.save`` / ``torch.load``.

Layout, as the reference's directory: ``<path>/params.pt`` (the model's
state dict, under ``"params"``, and each extra state dict, e.g. the
optimizer's under ``"opt_state"``) and ``<path>/meta.json`` (``step``,
the state-dict keys, ``format: "torch"`` and any caller metadata).
"""

from __future__ import annotations

import json
from pathlib import Path

import torch


def save_checkpoint(path, model: torch.nn.Module, step: int = 0,
                    meta: dict | None = None,
                    extra: dict | None = None) -> None:
    """Save ``model``'s state dict and ``extra`` objects with a
    ``state_dict()`` (``{"opt_state": optimizer}``) under ``path``; the
    file is written beside and renamed into place."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree = {"params": model.state_dict()}
    for name, obj in (extra or {}).items():
        tree[name] = obj.state_dict()
    tmp = path / "params.tmp.pt"
    torch.save(tree, tmp)
    tmp.replace(path / "params.pt")
    (path / "meta.json").write_text(json.dumps({
        "step": step,
        "keys": list(tree["params"]),
        "extra": sorted(extra or {}),
        "format": "torch",
        **(meta or {}),
    }))


def restore_checkpoint(path, model: torch.nn.Module,
                       extra: dict | None = None) -> int:
    """Load a checkpoint of :func:`save_checkpoint` into ``model`` (and
    into each object of ``extra``, by name) in place; returns the saved
    step. The state dict must match the model key for key and shape for
    shape (``load_state_dict(strict=True)`` raises otherwise), so a
    checkpoint never restores into the wrong layer."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    if meta.get("format") != "torch":
        raise ValueError(f"{path}: not a checkpoint of the port "
                         f"(format {meta.get('format')!r})")
    tree = torch.load(path / "params.pt", map_location="cpu",
                      weights_only=True)
    missing = sorted(set(extra or {}) - set(tree))
    if missing:
        raise ValueError(f"{path}: no saved state for {missing}")
    model.load_state_dict(tree["params"])
    for name, obj in (extra or {}).items():
        obj.load_state_dict(tree[name])
    return int(meta.get("step", 0))
