"""Training and evaluation steps: the counterpart of
``pygim_tpu/nn/train.py``.

Full-graph node classification: masked softmax cross-entropy, Adam
(``torch.optim.Adam(params, lr)``, the update of ``optax.adam(lr)``:
``mhat / (sqrt(vhat) + 1e-8)``), and the BatchNorm running statistics of
the training forward merged into the model after the optimizer's step.
Training aggregates the float payload (``agg_dtype=None``): ``round()``
has no gradient, and the reference quantizes for inference only. On the
``hybrid``, ``ell``, ``blocked`` and ``coo`` backends the aggregate's
backward runs the hand kernels on the prepared transpose
(:class:`~pygim_tpu_torch.ops.spmm.SpmmFunction`).

A step mutates the model and the optimizer in place and returns the loss,
where the reference's pure step returns new pytrees.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from pygim_tpu_torch.nn.models import GNN, gnn_apply, merge_bn_stats
from pygim_tpu_torch.ops import launch_counts
from pygim_tpu_torch.ops.spmm import PreparedAggregate


def softmax_cross_entropy(logits, labels, mask=None):
    """Mean negative log-likelihood of ``labels``; with a float ``mask``,
    ``Σ nll · mask / max(Σ mask, 1)``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def accuracy(logits, labels, mask=None):
    """Share of ``argmax(logits) == labels``, masked as the loss."""
    hit = (logits.argmax(-1) == labels).float()
    if mask is not None:
        return (hit * mask).sum() / torch.clamp(mask.sum(), min=1)
    return hit.mean()


class StepSplit:
    """Per-phase times and kernel launches of the steps of
    :func:`make_train_step`: ``forward`` (to the loss), ``backward`` and
    ``adam`` (the optimizer's step and the BatchNorm merge). On the card
    each phase lies between CUDA events, and a step synchronises at its
    end; on the CPU, between host clock reads. ``ms[phase]`` lists every
    step's time, ``launches[phase]`` the last step's launches by kernel
    name (differences of :func:`~pygim_tpu_torch.ops.launch_counts`, which
    it does not reset): a 2-layer step on the card launches ``K-bn stats``
    and ``K-bn fwd`` three times in its forward and ``K-bn bwd stats`` and
    ``K-bn bwd`` three times in its backward, one each a BatchNorm block."""

    PHASES = ("forward", "backward", "adam")

    def __init__(self):
        self.ms = {p: [] for p in self.PHASES}
        self.launches = {}
        self._marks = []

    def _mark(self, device):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev, launch_counts()
        return time.perf_counter(), launch_counts()

    def start(self, device) -> None:
        self._device = torch.device(device)
        self._marks = [self._mark(self._device)]

    def mark(self) -> None:
        """Ends the next phase; the last one ends the step."""
        self._marks.append(self._mark(self._device))
        if len(self._marks) <= len(self.PHASES):
            return
        cuda = self._device.type == "cuda"
        if cuda:
            self._marks[-1][0].synchronize()
        for phase, (t0, n0), (t1, n1) in zip(self.PHASES, self._marks,
                                             self._marks[1:]):
            self.ms[phase].append(t0.elapsed_time(t1) if cuda
                                  else (t1 - t0) * 1e3)
            self.launches[phase] = {k: n1[k] - n0[k] for k in n1}


def make_train_step(model: GNN, aggregate: Callable,
                    optimizer: torch.optim.Optimizer,
                    split: Optional[StepSplit] = None):
    """Returns ``step(x, labels, mask, generator) -> loss``: the training
    forward (batch statistics, dropout from ``generator``), the masked
    loss, its backward, ``optimizer.step()``, then the running statistics
    merged into ``model.bn0``/``bns``. The loss comes back detached. With
    ``split``, each step's phases are timed and their launches counted
    (:class:`StepSplit`)."""

    def train_step(x, labels, mask, generator=None):
        model.train()
        if split is not None:
            split.start(x.device)
        optimizer.zero_grad(set_to_none=True)
        logits, bn_stats = gnn_apply(model, x, aggregate, training=True,
                                     generator=generator,
                                     return_bn_stats=True)
        loss = softmax_cross_entropy(logits, labels, mask)
        if split is not None:
            split.mark()
        loss.backward()
        if split is not None:
            split.mark()
        optimizer.step()
        merge_bn_stats(model, bn_stats)
        if split is not None:
            split.mark()
        return loss.detach()

    return train_step


def make_train_step_threaded(model: GNN, prep,
                             optimizer: torch.optim.Optimizer):
    """The reference's threaded step, whose point is to pass the prepared
    tables through ``jax.jit`` as arguments. PyTorch runs eagerly, so this
    is :func:`make_train_step` over ``prep.raw_mul(v, dev)``
    (:class:`~pygim_tpu_torch.ops.spmm.PreparedAggregate`, rebound to each
    call's ``dev``). Returns ``(step, dev)``; call ``step(x, labels, mask,
    generator, dev)``."""
    aggregate = PreparedAggregate(prep)
    step = make_train_step(model, aggregate, optimizer)

    def train_step(x, labels, mask, generator, dev):
        aggregate.dev = dev
        return step(x, labels, mask, generator)

    return train_step, prep.dev_arrays


def make_eval_step(model: GNN, aggregate: Callable):
    """Returns ``step(x, labels, mask) -> (accuracy, logits)``: the
    evaluation forward (running statistics, no dropout, ``model``'s
    ``agg_dtype``) without autograd."""

    @torch.no_grad()
    def eval_step(x, labels, mask):
        logits = gnn_apply(model, x, aggregate, training=False)
        return accuracy(logits, labels, mask), logits

    return eval_step
