"""Trained-accuracy parity of the PyTorch port on the CPU, the twin of
``tests/test_training_parity.py``: the same initialisation trained twice
with the same dropout seeds, through a backend under test and through
the oracle, must learn the same function (``run_training_benchmark``,
the reference's assertions and tolerances). The hybrid cases here run on
the stair-int8 core with the reference's hybrid ``acc_tol`` of 0.03; the
twin of the reference's own hybrid case, on a bf16 core, is in
``tests/test_torch_float_train.py``. Also: a checkpoint round trip that
resumes training bit for bit, and ``train_cuda.py`` on the CPU."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pygim_tpu_torch.bench.runners import run_training_benchmark
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.nn.checkpoint import restore_checkpoint, save_checkpoint
from pygim_tpu_torch.nn.models import make_gnn
from pygim_tpu_torch.nn.train import make_train_step
from pygim_tpu_torch.ops.spmm import PreparedAggregate, SpmmConfig, prepare_spmm
from pygim_tpu_torch.utils.metrics import parse_data_lines

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import train  # noqa: E402
import train_cuda  # noqa: E402

STAIR = dict(backend="hybrid", hybrid_shape="stair", hybrid_dtype="int8",
             hybrid_core_bytes=1 << 16)


@pytest.fixture(scope="module")
def planted():
    return load_dataset("planted-2000-24000-4")


def test_planted_dataset_is_learnable_shape(planted):
    ds = planted
    assert ds.num_classes == 4 and ds.num_nodes == 2000
    same = (ds.y[ds.graph.rows] == ds.y[ds.graph.cols]).mean()
    assert same > 0.7


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
def test_training_parity_ell(planted, model):
    res = run_training_benchmark(
        planted, model=model, hidden=32, epochs=25,
        config=SpmmConfig(backend="ell"), device="cpu")
    assert res["test_acc"] > 0.55
    assert res["oracle_test_acc"] > 0.55
    assert res["acc_delta"] <= 0.01
    assert res["validate"] == "OK"
    assert res["transpose_bytes"] > 0
    assert min(res[f"{p}_ms"] for p in ("forward", "backward", "adam")) > 0
    assert set(res["step_launches"]) == {"forward", "backward", "adam"}


@pytest.mark.parametrize("model", ["gcn", "gin", "sage"])
def test_training_parity_hybrid(planted, model):
    prep = prepare_spmm(planted.graph, SpmmConfig(**STAIR), device="cpu")
    assert prep.stair, "the parity graph must fill stair bands"
    res = run_training_benchmark(
        planted, model=model, hidden=32, epochs=10,
        config=SpmmConfig(**STAIR), acc_tol=0.03, device="cpu")
    assert res["acc_delta"] <= 0.03
    assert res["validate"] == "OK"


def test_training_parity_divergence_detected(planted):
    """A deliberately broken aggregate must fail the parity assertion."""

    class Broken:
        def __init__(self, graph, config):
            self._p = prepare_spmm(graph, config or SpmmConfig(),
                                   device="cpu")
            self.dev_arrays = self._p.dev_arrays
            self.config = self._p.config

        def raw_mul(self, v, dev):  # wrong by 2x: trains another function
            return self._p.raw_mul(v, dev) * 2.0

        def mul(self, v):
            return self._p.mul(v) * 2.0

        def transpose(self, graph=None):
            # the default backend runs a kernel (K-rows): its backward is
            # the prepared Aᵀ's product
            return self._p.transpose(graph)

    with pytest.raises(AssertionError):
        run_training_benchmark(
            planted, hidden=32, epochs=10,
            prepare_fn=lambda g, c: Broken(g, c), acc_tol=0.0, device="cpu")


def test_training_parity_chunked_oracle(planted):
    res = run_training_benchmark(
        planted, hidden=32, epochs=10, config=SpmmConfig(backend="ell"),
        oracle_chunk=1024, device="cpu")
    assert res["acc_delta"] <= 0.01
    assert res["validate"] == "OK"


@pytest.mark.parametrize("backend", ["ell", "oracle"])
def test_checkpoint_round_trip_resumes_bit_equal(planted, tmp_path, backend):
    """2 steps, save, restore into a fresh model and optimizer, 1 more
    step: bit-equal to 3 straight steps (dropout 0.5, the same generator
    seeds)."""
    prep = prepare_spmm(planted.graph, SpmmConfig(backend=backend),
                        device="cpu")
    if backend == "ell":
        prep.transpose(planted.graph)  # the backward's operand
    agg = PreparedAggregate(prep)
    x = torch.as_tensor(planted.x)
    y = torch.as_tensor(planted.y.astype(np.int64))
    mask = torch.as_tensor(planted.train_mask.astype(np.float32))

    def fresh():
        m = make_gnn(0, "gin", 32, 16, planted.num_classes, device="cpu")
        return m, torch.optim.Adam(m.parameters(), lr=1e-2)

    def steps(m, opt, epochs):
        step = make_train_step(m, agg, opt)
        return [float(step(x, y, mask, torch.Generator().manual_seed(e)))
                for e in epochs]

    straight, opt = fresh()
    want = steps(straight, opt, range(3))
    first, opt = fresh()
    got = steps(first, opt, range(2))
    save_checkpoint(tmp_path / "ck", first, step=2, extra={"opt_state": opt})
    resumed, opt2 = fresh()
    assert restore_checkpoint(tmp_path / "ck", resumed,
                              extra={"opt_state": opt2}) == 2
    got += steps(resumed, opt2, [2])
    assert got == want
    for k, v in straight.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k


def test_checkpoint_refuses_other_layouts(tmp_path):
    m = make_gnn(0, "gcn", 8, 16, 3, device="cpu")
    save_checkpoint(tmp_path / "a", m, step=5, meta={"note": "x"})
    with pytest.raises(RuntimeError):
        restore_checkpoint(tmp_path / "a",
                           make_gnn(0, "sage", 8, 16, 3, device="cpu"))
    with pytest.raises(ValueError, match="opt_state"):
        restore_checkpoint(tmp_path / "a", m, extra={
            "opt_state": torch.optim.Adam(m.parameters())})
    assert restore_checkpoint(tmp_path / "a", m) == 5


def run_train(capsys, argv):
    capsys.readouterr()
    train_cuda.main(argv, device="cpu")
    out = capsys.readouterr().out
    return out, parse_data_lines(out.splitlines())


def test_train_cuda_on_the_cpu(capsys, tmp_path):
    """train_cuda.py's [DATA] lines, a falling loss, and its checkpoint."""
    out, got = run_train(capsys, [
        "--dataset", "planted-2000-24000-4", "--hidden_size", "32",
        "--epochs", "12", "--lr", "1e-2", "--checkpoint",
        str(tmp_path / "ck")])
    assert got["device"] == ["cpu"]
    assert got["epoch"] == [0.0, 10.0, 11.0]
    assert got["train_loss"][-1] < got["train_loss"][0]
    assert got["test_acc"][-1] > 0.55
    assert got["train_time(ms)"][0] > 0
    assert (tmp_path / "ck" / "params.pt").exists()
    m = make_gnn(0, "gcn", 32, 32, 4, device="cpu")
    assert restore_checkpoint(tmp_path / "ck", m) == 12


@pytest.mark.parametrize("argv,what", [
    (["--sp_parts", "2"], "mesh training"),
    (["--backend", "hybrid"], None),
], ids=["mesh", "hybrid-default-core"])
def test_train_cuda_unported_raise(capsys, argv, what):
    """Settings refused until their slice now train: train.py's --backend
    hybrid, on the port's default core (the graph's float dtype, f32
    cells), and a mesh (``what``, ROADMAP.md Queue 1 item 6c): --sp_parts
    2 trains over a (2, 1) mesh of CPU devices, with the single device's
    losses (the same parameters and dropout draws; f32 sums in another
    order)."""
    _out, got = run_train(capsys, ["--dataset", "tiny", "--epochs", "2",
                                   *argv])
    assert got["epoch"] == [0.0, 1.0]
    assert np.isfinite(got["train_loss"]).all()
    if what is not None:
        _out, one = run_train(capsys, ["--dataset", "tiny", "--epochs", "2"])
        np.testing.assert_allclose(got["train_loss"], one["train_loss"],
                                   rtol=1e-4)


def test_train_cuda_flags_match_train_py():
    assert vars(train_cuda.get_args([])) == vars(train.get_args([]))
    argv = ["--model", "sage", "--lr", "0.5", "--backend", "oracle",
            "--seed", "3"]
    assert vars(train_cuda.get_args(argv)) == vars(train.get_args(argv))
