"""K-bn (``ops/bn_train.py``): the training forward's BatchNorm → ReLU →
dropout block and its backward, on the CPU, where every wrapper runs its
plain version (the card holds the kernels to them:
``chip_smoke.py:bn_train_checks``).

What is held, and how closely:

* the plain Philox4x32-10 equals Random123's known answers, bit for bit,
  and the mask keeps 1 − rate of the elements within 4σ of a binomial;
* the plain statistics equal ``jnp.mean`` / ``jnp.var`` within 2e-5 of
  each column's value (the bar ``test_torch_train.py`` holds batch
  variances to; both are f32 results of a sum in another order);
* the port's training forward against the JAX package's at dropout 0.5,
  the same masks fed to both (``jax.random.bernoulli`` returns the port's
  masks in site order; nothing in the JAX package changes): logits within
  1e-5 of their largest magnitude, running means 1e-5 and variances 2e-5
  (``test_torch_train.py``'s bars), and every leaf's gradient within 1e-4
  of its largest |grad| (+1e-6 for the leaves that are rounding noise:
  a bias right before a BatchNorm), GIN's three cancelling leaves within
  1e-3 (``test_torch_train.py``'s module docstring gives the reason);
* :class:`BnReluDropout`'s dz, dγ and dβ against autograd through the
  unfused plain chain (``batchnorm_train_apply``, ``torch.relu``,
  ``dropout``): within 1e-5 of the sum of |terms| behind each value (the
  two compute the same formula in f32, in another order; the chain's
  statistics accumulate in another order too), and a backward with the
  ReLU's sign dropped must fail that bar;
* the refusals: a tensor off the CPU never reaches a plain version, the
  dtype and shape checks, and training without a generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn import models as jmodels
from pygim_tpu.nn import train as jtrain
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.bench.report import kernel_family
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.nn import layers as tlayers
from pygim_tpu_torch.nn.models import GNN, gnn_apply, params_from_jax
from pygim_tpu_torch.nn.train import softmax_cross_entropy
from pygim_tpu_torch.ops import bn_train as kb
from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
from pygim_tpu_torch.ops import spmm as tspmm

N, E, F, C = 301, 6000, 12, 5  # N odd: no row count divides evenly
WIDTHS = (32, 41)  # 41: the kernels' single-element path
RATE = 0.5
CONVS = ["gcn", "gin", "sage"]
LEAF_TOL = 1e-4
GIN_CANCELLING = ("convs.1.mlp.bn.scale", "convs.1.mlp.bn.var",
                  "convs.1.mlp.lin2.w")
GIN_CANCELLING_TOL = 1e-3
SUM_TOL = 1e-5

KNOWN_ANSWERS = [  # Random123's kat_vectors, philox4x32_10
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def key_from(seed):
    """A key of two 32-bit words from numpy's generator."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1 << 32, 2, dtype=np.int64))


def block_inputs(h, seed, n=N):
    """z (n, h) with per-column offsets and spreads, g, γ, β; numpy."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, h)) * rng.uniform(0.5, 3.0, h)
         + rng.standard_normal(h)).astype(np.float32)
    g = rng.standard_normal((n, h)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, h).astype(np.float32)
    beta = (0.3 * rng.standard_normal(h)).astype(np.float32)
    return [torch.from_numpy(a) for a in (z, g, gamma, beta)]


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = kb.philox4x32_10(torch.tensor([counter], dtype=torch.int64),
                           torch.tensor(key, dtype=torch.int64))
    assert got.tolist() == [list(want)]


def test_keep_mask_reads_word_e_mod_4_of_counter_e_div_4():
    """Element e's bit is word e % 4 of the counter (lo32(e / 4), hi32(e /
    4), 0, 0): the mask depends on the row-major index alone."""
    key = key_from(1)
    mask = kb.keep_mask(key, (N, 41), RATE)
    assert mask.dtype == torch.bool and mask.shape == (N, 41)
    assert torch.equal(mask.reshape(-1), kb.keep_mask(key, (N * 41,), RATE))
    e = torch.tensor([0, 1, 5, 4095, N * 41 - 1])
    q = e // 4
    ctr = torch.stack([q, torch.zeros_like(q), torch.zeros_like(q),
                       torch.zeros_like(q)], -1)
    words = kb.philox4x32_10(ctr, key).gather(1, (e % 4)[:, None])[:, 0]
    assert torch.equal(mask.reshape(-1)[e],
                       (words >> 8) < kb.keep_threshold(RATE))
    assert not torch.equal(mask, kb.keep_mask(key_from(2), (N, 41), RATE))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_keep_fraction(rate):
    """1 − rate of the elements are kept, within 4σ of a binomial."""
    n = 256 * 1024
    kept = float(kb.keep_mask(key_from(3), (n,), rate).double().mean())
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(kept - (1 - rate)) <= 4 * sigma, (kept, sigma)
    assert kb.keep_threshold(rate) == round((1 - rate) * 2 ** 24)


def test_keep_threshold_and_scale():
    assert kb.keep_threshold(0.0) == 1 << 24  # every word kept
    assert kb.keep_scale(0.5) == 2.0
    assert kb.keep_scale(0.3) == float(np.float32(1) / np.float32(0.7))
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="rate"):
            kb.keep_threshold(rate)


@pytest.mark.parametrize("h", WIDTHS)
def test_plain_stats_match_jnp(h):
    z = block_inputs(h, seed=h)[0]
    mean, var = kb.bn_stats(z)
    want_m = np.asarray(jnp.mean(jnp.asarray(z.numpy()), axis=0))
    want_v = np.asarray(jnp.var(jnp.asarray(z.numpy()), axis=0))
    assert mean.dtype == var.dtype == torch.float32
    scale = np.abs(z.numpy()).mean(0)
    assert np.all(np.abs(mean.numpy() - want_m) <= 2e-5 * scale)
    assert np.all(np.abs(var.numpy() - want_v) <= 2e-5 * want_v)


@pytest.mark.parametrize("n", [1, 255, 256, 257, N, 65535 * 256,
                               65535 * 256 + 1, 17_000_000, 2**31 - 1])
def test_chunks_leave_no_chunk_empty(n):
    """The reductions' chunk count: at most MAX_CHUNKS, and cut as the
    kernels cut it (ceil(n / chunks) rows a chunk) no chunk is empty, past
    65535 · 256 rows (where the cap binds) too."""
    chunks = kb._chunks(n)
    rows = -(-n // chunks)
    assert 1 <= chunks <= min(n, kb.MAX_CHUNKS)
    assert (chunks - 1) * rows < n
    assert rows == -(-n // min(-(-n // kb.CHUNK_ROWS), kb.MAX_CHUNKS))


def chunked_stats(z, chunks):
    """K-bn stats' reduction in float64 NumPy: chunks of ceil(n / chunks)
    rows, each chunk's (count, mean, M2), merged in chunk order with
    Chan's formula; a chunk past the last row counts no row (the merge
    kernel's ``rows > 0``)."""
    n = z.shape[0]
    step = -(-n // chunks)
    cnt, mean, m2 = 0.0, np.zeros(z.shape[1]), np.zeros(z.shape[1])
    for k in range(chunks):
        rows = min(step, n - k * step)
        if rows <= 0:
            continue
        part = z[k * step:k * step + rows]
        pm = part.mean(0)
        pm2 = ((part - pm) ** 2).sum(0)
        d = pm - mean
        tot = cnt + rows
        mean = mean + d * (rows / tot)
        m2 = m2 + pm2 + d * d * (cnt * rows / tot)
        cnt = tot
    return mean, m2 / n


@pytest.mark.parametrize("chunks", [1, 7, 151, 250, N])
def test_chunk_merge_skips_empty_chunks(chunks):
    """At 250 chunks of N = 301 rows (2 rows a chunk) the last 99 chunks
    are empty: the merge holds the statistics to NumPy's all the same."""
    z = block_inputs(41, seed=chunks)[0].double().numpy()
    mean, var = chunked_stats(z, chunks)
    np.testing.assert_allclose(mean, z.mean(0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(var, z.var(0), rtol=1e-12)


def chain(z, gamma, beta, rate, generator):
    """The unfused plain chain: ``batchnorm_train_apply``, ``torch.relu``,
    ``dropout``."""
    h = z.shape[1]
    y, _ = tlayers.batchnorm_train_apply(gamma, beta, torch.zeros(h),
                                         torch.ones(h), z)
    return tlayers.dropout(torch.relu(y), rate, generator, True)


def grads(fn, z, gamma, beta, g):
    leaves = [t.clone().requires_grad_() for t in (z, gamma, beta)]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad((out * g).sum(), leaves)


def sum_terms(z, g, gamma, beta, key, rate):
    """Per value, the sum of |terms| behind dz, dγ and dβ, float64."""
    zd, gd = z.double(), g.double()
    mean, var = zd.mean(0), zd.var(0, unbiased=False)
    inv = torch.rsqrt(var + 1e-5)
    xhat = (zd - mean) * inv
    gb = kb._grad_b(gd, xhat, gamma.double(), beta.double(), key, rate).abs()
    n = z.shape[0]
    sb, sx = gb.sum(0), (gb * xhat.abs()).sum(0)
    return ((gamma.double() * inv).abs() / n * (n * gb + sb + xhat.abs() * sx),
            sx, sb)


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("h", WIDTHS)
def test_function_gradients_match_the_plain_chain(h, rate):
    """BnReluDropout (its plain pieces) against autograd through the
    unfused chain, the same key drawn from the same generator state: out
    equal within 1e-5 of its scale, dz, dγ, dβ within SUM_TOL of the sum
    of |terms|; a backward with the ReLU's sign dropped fails that bar."""
    z, g, gamma, beta = block_inputs(h, seed=10 + h)

    def gen():
        return torch.Generator().manual_seed(7)

    def fused(z_, gamma_, beta_):
        key = kb.draw_key(gen(), "cpu") if rate else None
        return kb.BnReluDropout.apply(z_, gamma_, beta_, key, rate, 1e-5)[0]

    got_out, got = grads(fused, z, gamma, beta, g)
    want_out, want = grads(lambda *a: chain(*a, rate, gen()), z, gamma, beta,
                           g)
    assert float((got_out - want_out).abs().max()) <= \
        1e-5 * float(want_out.abs().max())
    key = kb.draw_key(gen(), "cpu") if rate else None
    mags = sum_terms(z, g, gamma, beta, key, rate)
    for what, a, b, mag in zip(("dz", "dgamma", "dbeta"), got, want, mags):
        assert a.shape == b.shape, what
        assert bool(((a - b).abs() <= SUM_TOL * mag + 1e-7).all()), what

    # the negative control: the ReLU's sign dropped from the backward
    real = kb._grad_b
    try:
        kb._grad_b = lambda g_, xh, gm, bt, k, r: real(
            g_, xh, gm, torch.full_like(bt, 1e9), k, r)
        _, bad = grads(fused, z, gamma, beta, g)
    finally:
        kb._grad_b = real
    assert not all(bool(((a - b).abs() <= SUM_TOL * mag + 1e-7).all())
                   for a, b, mag in zip(bad, want, mags))


def test_wrappers_match_their_plain_versions_on_the_cpu():
    """On the CPU each wrapper is its plain version, and the Function's
    pieces are the wrappers."""
    z, g, gamma, beta = block_inputs(41, seed=4)
    key = key_from(5)
    mean, var = kb.bn_stats(z)
    inv = torch.rsqrt(var + 1e-5)
    assert torch.equal(kb.bn_apply(z, mean, inv, gamma, beta, key, RATE),
                       kb.bn_apply_plain(z, mean, inv, gamma, beta, key,
                                         RATE))
    sb, sx = kb.bn_bwd_stats(g, z, mean, inv, gamma, beta, key, RATE)
    want = kb.bn_bwd_stats_plain(g, z, mean, inv, gamma, beta, key, RATE)
    assert torch.equal(sb, want[0]) and torch.equal(sx, want[1])
    assert torch.equal(
        kb.bn_bwd(g, z, mean, inv, gamma, beta, key, RATE, sb, sx),
        kb.bn_bwd_plain(g, z, mean, inv, gamma, beta, key, RATE, sb, sx))
    reset_launch_counts()
    kb.BnReluDropout.apply(z.requires_grad_(), gamma, beta, key, RATE,
                           1e-5)[0].sum().backward()
    n = launch_counts()
    assert {k: n[k] for k in n if k.startswith("K-bn")} == {
        "K-bn stats": 0, "K-bn fwd": 0, "K-bn bwd stats": 0, "K-bn bwd": 0}


def test_dropout_and_the_block_draw_the_same_mask():
    """``dropout`` and ``bn_relu_dropout_train`` draw one key a site from
    the generator: the same generator state gives the same mask, and the
    block's value and running statistics are the unfused chain's."""
    z = block_inputs(32, seed=6)[0]
    layer = tlayers.BatchNorm(32)
    with torch.no_grad():
        out, stats = tlayers.bn_relu_dropout_train(
            layer, z, RATE, torch.Generator().manual_seed(9))
        y, want_stats = tlayers.batchnorm_train_apply(
            layer.scale, layer.bias, layer.mean, layer.var, z)
        want = tlayers.dropout(torch.relu(y), RATE,
                               torch.Generator().manual_seed(9), True)
    assert torch.equal(out == 0, want == 0)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for k in ("mean", "var"):
        assert float((stats[k] - want_stats[k]).abs().max()) <= \
            1e-5 * float(want_stats[k].abs().max()), k
    frac = float((out != 0).float().mean())
    assert 0.15 < frac < 0.35  # half dropped, about half the rest above 0


def test_refusals():
    """A tensor off the CPU never reaches a plain version (the meta device
    stands for the card here: no kernel runs it, and nothing falls back),
    and the dtype and shape checks raise on every device."""
    z, g, gamma, beta = block_inputs(32, seed=8)
    mean, var = kb.bn_stats(z)
    inv = torch.rsqrt(var + 1e-5)
    key = key_from(1)
    meta = [t.to("meta") for t in (z, g, gamma, beta, mean, inv, key)]
    zm, gm, gam, bem, mm, im, km = meta
    plains = ("bn_stats_plain", "bn_apply_plain", "bn_bwd_stats_plain",
              "bn_bwd_plain")
    saved = {p: getattr(kb, p) for p in plains}

    def refuse(*a, **k):
        raise AssertionError("a plain version ran for a meta tensor")

    try:
        for p in plains:
            setattr(kb, p, refuse)
        for call in (
                lambda: kb.bn_stats(zm),
                lambda: kb.bn_apply(zm, mm, im, gam, bem, km, RATE),
                lambda: kb.bn_bwd_stats(gm, zm, mm, im, gam, bem, km, RATE),
                lambda: kb.bn_bwd(gm, zm, mm, im, gam, bem, km, RATE, mm,
                                  mm)):
            with pytest.raises(ValueError, match="no K-bn"):
                call()
    finally:
        for p, f in saved.items():
            setattr(kb, p, f)
    bad = [
        (lambda: kb.bn_stats(z.double()), "float32 \\(N, H\\)"),
        (lambda: kb.bn_stats(z[0]), "float32 \\(N, H\\)"),
        (lambda: kb.bn_stats(z[:0]), "N >= 1"),
        (lambda: kb.bn_apply(z, mean[:5], inv, gamma, beta, key, RATE),
         "per-column"),
        (lambda: kb.bn_apply(z, mean, inv.double(), gamma, beta, key, RATE),
         "per-column"),
        (lambda: kb.bn_apply(z, mean, inv, gamma, beta, key.int(), RATE),
         "key"),
        (lambda: kb.bn_apply(z, mean, inv, gamma, beta, key[:1], RATE),
         "key"),
        (lambda: kb.bn_apply(z, mean, inv, gamma, beta, key, 1.0), "rate"),
        (lambda: kb.bn_bwd_stats(g[1:], z, mean, inv, gamma, beta, key,
                                 RATE), "gradient"),
        (lambda: kb.bn_bwd(g.double(), z, mean, inv, gamma, beta, key, RATE,
                           mean, mean), "gradient"),
    ]
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(RuntimeError, match="requires grad"):
        kb.bn_stats(z.clone().requires_grad_())


def test_training_needs_a_generator():
    layer = tlayers.BatchNorm(32)
    z = block_inputs(32, seed=2)[0]
    with pytest.raises(ValueError, match="Generator"):
        tlayers.bn_relu_dropout_train(layer, z, RATE, None)
    out, _ = tlayers.bn_relu_dropout_train(layer, z, 0.0, None)
    assert out.shape == z.shape and bool((out >= 0).all())


def test_profile_names_the_k_bn_family():
    for name in ("void bn_train::fwd_kernel<true, true>(float const*)",
                 "void bn_train::partial_kernel<false, 1, true>(...)",
                 "void bn_train::merge_kernel<0>(double2 const*)"):
        assert kernel_family(name) == "K-bn"
    assert kernel_family("void at::native::vectorized_elementwise_kernel"
                         "<4, at::native::CUDAFunctor_add<float>>") == "torch"
    assert kernel_family("void epilogue_kernel<true, true, true>()") == \
        "hand"


# ---------------------------------------------------- against the JAX package

def graph():
    rng = np.random.default_rng(11)
    rows = rng.integers(0, N, E)
    cols = rng.integers(0, N, E)
    vals = rng.standard_normal(E).astype(np.float32)
    return rows, cols, vals


def both(conv, h):
    rows, cols, vals = graph()
    jp = jspmm.prepare_spmm(jgraph.CooGraph.from_edges(
        rows, cols, vals, nrows=N, ncols=N), jspmm.SpmmConfig(
            backend="oracle"))
    tp = tspmm.prepare_spmm(tgraph.CooGraph.from_edges(
        rows, cols, vals, nrows=N, ncols=N), tspmm.SpmmConfig(
            backend="oracle"), device="cpu")
    jgnn = jmodels.make_gnn(jax.random.key(3), conv, F, h, C, num_layers=2,
                            dropout=RATE)
    model = GNN(conv, F, h, C, num_layers=2, dropout=RATE)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgnn.params)))
    return jspmm.PreparedAggregate(jp), tspmm.PreparedAggregate(tp), jgnn, \
        model.train()


def data(seed=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    mask = (rng.random(N) < 0.4).astype(np.float32)
    return x, y, mask


def port_masks(seed, h):
    """The port's masks of a 2-layer model's three dropout sites, in site
    order, for ``torch.Generator().manual_seed(seed)``."""
    g = torch.Generator().manual_seed(seed)
    return [kb.keep_mask(kb.draw_key(g, "cpu"), (N, h), RATE).numpy()
            for _ in range(3)]


@pytest.fixture
def fed_masks(monkeypatch):
    """``feed(masks)`` makes ``jax.random.bernoulli`` return ``masks`` in
    call order (the JAX dropout sites' order), and checks the call's
    probability and shape."""
    queue = []

    def bernoulli(key, p, shape):
        mask = queue.pop(0)
        assert p == 1.0 - RATE and tuple(shape) == mask.shape
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def feed(masks):
        queue[:] = list(masks)
        return queue

    return feed


def jax_loss(jgnn, agg, x, y, mask):
    def loss_fn(params):
        logits, stats = jmodels.gnn_apply(
            params, jnp.asarray(x), agg, conv=jgnn.conv, num_layers=2,
            dropout_rate=RATE, agg_dtype=None, training=True,
            rng=jax.random.key(0), return_bn_stats=True)
        return jtrain.softmax_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(mask)), (logits, stats)
    return loss_fn


def close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and np.isfinite(got).all(), what
    assert err <= rel * mag, f"{what}: {err} > {rel} × {mag}"


@pytest.mark.parametrize("conv", CONVS)
def test_training_forward_and_stats_match_jax(conv, fed_masks):
    """Dropout 0.5, the port's masks on both sides: the logits and every
    block's running statistics."""
    h = 41 if conv == "sage" else 32
    jagg, tagg, jgnn, model = both(conv, h)
    x, y, mask = data()
    queue = fed_masks(port_masks(5, h))
    _, (want, jstats) = jax_loss(jgnn, jagg, x, y, mask)(jgnn.params)
    assert not queue
    with torch.no_grad():
        got, stats = gnn_apply(model, torch.from_numpy(x), tagg,
                               training=True, return_bn_stats=True,
                               generator=torch.Generator().manual_seed(5))
    close(got.numpy(), want, 1e-5, "logits")
    for name, s, js in [("bn0", stats["bn0"], jstats["bn0"])] + [
            (f"bns.{i}", s, js) for i, (s, js) in
            enumerate(zip(stats["bns"], jstats["bns"]))]:
        close(s["mean"].numpy(), js["mean"], 1e-5, f"{name}.mean")
        close(s["var"].numpy(), js["var"], 2e-5, f"{name}.var")


@pytest.mark.parametrize("conv", CONVS)
def test_gradients_match_jax(conv, fed_masks):
    """Dropout 0.5, the port's masks on both sides: the loss within 1e-5
    and every leaf's gradient within its bar (module docstring); the
    running statistics of bn0/bns get none in the port and zeros in JAX."""
    h = 41 if conv == "sage" else 32
    jagg, tagg, jgnn, model = both(conv, h)
    x, y, mask = data(13)
    fed_masks(port_masks(6, h))
    (jl, _), jg = jax.value_and_grad(jax_loss(jgnn, jagg, x, y, mask),
                                     has_aux=True)(jgnn.params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    logits = gnn_apply(model, torch.from_numpy(x), tagg, training=True,
                       generator=torch.Generator().manual_seed(6))
    loss = softmax_cross_entropy(logits, torch.from_numpy(y.astype(np.int64)),
                                 torch.from_numpy(mask))
    loss.backward()
    close(float(loss.detach()), float(jl), 1e-5, "loss")
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert set(named) | set(buffers) == set(want)
    for k, w in want.items():
        w = w.numpy()
        if k in buffers:
            assert not w.any(), k
            continue
        tol = GIN_CANCELLING_TOL if conv == "gin" and k in GIN_CANCELLING \
            else LEAF_TOL
        scale = float(np.abs(w).max())
        err = float(np.abs(named[k].grad.numpy() - w).max())
        assert err <= tol * scale + 1e-6, (k, err, scale)
