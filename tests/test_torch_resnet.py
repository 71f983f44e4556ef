"""Port parity for the ResNet family (ray_tpu_torch/models/resnet.py against
ray_tpu/models/resnet.py, on the CPU), on the reference's init converted by
models/convert.py with its BatchNorm scales, shifts and running statistics
perturbed from a seed (so eval mode is not the identity).

flax's traps, each held here at resolutions where they show: SAME pads
split low ``total // 2`` (the stem's 7x7/2 on 32 and 16 pads (2, 3), the
3x3/2 convs and the max pool (0, 1)); the max pool pads with -inf;
BatchNorm updates ``var`` with the biased batch variance at momentum 0.99.

Tolerances (ROADMAP rule 4): f32 logits 1e-4, batch-stat updates 1e-5,
gradients 5e-4; after 6 SGD steps of the PBT trainable
(tests/test_resnet_pbt.py:53-74) losses 1e-5 relative and weights 1e-4;
bf16 logits 2e-2 relative (Frobenius), as both round activations to bf16
at different places."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models.resnet import ResNet as JResNet
from ray_tpu_torch.models import resnet as tres
from ray_tpu_torch.models.convert import (
    convert_resnet_variables,
    unconvert_resnet_variables,
)
from ray_tpu_torch.utils.flax_rules import same_pads

LOGIT_TOL = 1e-4
STAT_TOL = 1e-5
GRAD_TOL = 5e-4
WEIGHT_TOL = 1e-4
BF16_RTOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _variables(jmodel, x, seed=1):
    """Variables of the reference's shapes for inputs shaped as x, drawn
    with numpy from ``seed`` (no init to compile): kernels normal over
    sqrt(fan-in), biases and running means near 0, BN scales and running
    variances near 1 (so eval mode is not the identity)."""
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                                  train=True),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        noise = rng.normal(size=s.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name in ("scale", "var"):
            return np.float32(0.9) + np.float32(0.3) * np.abs(noise)
        return np.float32(0.2) * noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(jmodel, tmodel, x, seed=1):
    """(reference variables, the port model loaded with them)."""
    v = _variables(jmodel, x, seed)
    sd = convert_resnet_variables(v["params"], v["batch_stats"])
    tmodel.load_state_dict({k: torch.from_numpy(a.copy())
                            for k, a in sd.items()})
    return v, tmodel


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64)
                                - np.asarray(want, np.float64))
                 / np.linalg.norm(np.asarray(want, np.float64)))


def test_same_pads_and_pool_follow_flax():
    """SAME pads at every shape resnet50ish meets at 224 and the tiny one
    at 32 and 16 (lax.padtype_to_pads), and the -inf max pool against
    flax's on signed inputs of even and odd size."""
    for size, k, s, want in ((224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)),
                             (56, 3, 2, (0, 1)), (28, 3, 2, (0, 1)),
                             (14, 3, 2, (0, 1)), (56, 1, 2, (0, 0)),
                             (32, 7, 2, (2, 3)), (16, 3, 2, (0, 1)),
                             (8, 3, 2, (0, 1)), (16, 7, 2, (2, 3)),
                             (4, 3, 2, (0, 1)), (7, 3, 1, (1, 1))):
        ref = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
        assert same_pads(size, k, s) == tuple(ref) == want, (size, k, s)
    rng = np.random.default_rng(0)
    for h, w in ((8, 8), (7, 9), (112, 112)):
        x = rng.normal(size=(2, h, w, 3)).astype(np.float32) - 2.0
        ref = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                           padding="SAME")
        got = tres.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_batchnorm_biased_variance_and_momentum():
    """A [4, 3, 3, 2] batch: flax's running update is 0.99 old + 0.01 of
    the batch mean and ddof-0 variance; ddof 1 would miss by far more than
    the tolerance. Output f32 whatever the input dtype."""
    rng = np.random.default_rng(3)
    x = (3.0 + 2.0 * rng.normal(size=(4, 3, 3, 2))).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = tres.BatchNorm(2, "cpu")
    updates = {}
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2), True, updates)
    mean, var = updates[port]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), ref,
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(mean.numpy(), upd["batch_stats"]["mean"],
                               atol=STAT_TOL, rtol=0)
    np.testing.assert_allclose(var.numpy(), upd["batch_stats"]["var"],
                               atol=STAT_TOL, rtol=0)
    unbiased = 0.99 + 0.01 * x.reshape(-1, 2).var(axis=0, ddof=1)
    assert np.abs(unbiased - upd["batch_stats"]["var"]).min() > 10 * STAT_TOL
    half = port(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(), False,
                {})
    assert half.dtype == torch.float32


@pytest.mark.parametrize("res", [32, 16])
def test_tiny_f32_matches(res):
    """tiny() in f32: training logits, the batch-stat updates and the
    gradients of softmax cross-entropy; eval logits with the updated
    statistics written back."""
    rng = np.random.default_rng(res)
    x = rng.normal(size=(4, res, res, 3)).astype(np.float32)
    y = np.array([0, 3, 7, 9])
    jm = JResNet.tiny(10)
    v, tm = _pair(jm, tres.ResNet.tiny(10, device="cpu"), x)

    @jax.jit
    def ref(v, x):
        def loss_fn(params):
            logits, upd = jm.apply({"params": params,
                                    "batch_stats": v["batch_stats"]}, x,
                                   train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy(
                logits, jax.nn.one_hot(y, 10)).mean()
            return loss, (logits, upd["batch_stats"])

        (_, (logits, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(v["params"])
        eval_logits = jm.apply({"params": v["params"], "batch_stats": stats},
                               x, train=False)
        return logits, stats, grads, eval_logits

    jl, jstats, jg, je = ref(v, jnp.asarray(x))
    tl, tstats = tm(torch.from_numpy(x), train=True)
    F.cross_entropy(tl, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(tl.detach().numpy(), jl, atol=LOGIT_TOL,
                               rtol=0)
    ref_stats = convert_resnet_variables({}, _np(jstats))
    assert ref_stats.keys() == tstats.keys()
    for k, want in ref_stats.items():
        np.testing.assert_allclose(tstats[k].numpy(), want, atol=STAT_TOL,
                                   rtol=0, err_msg=k)
    ref_grads = convert_resnet_variables(_np(jg), {})
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert ref_grads.keys() == got.keys()
    for k, want in ref_grads.items():
        np.testing.assert_allclose(got[k], want, atol=GRAD_TOL, rtol=0,
                                   err_msg=k)

    tm.update_batch_stats(tstats)
    with torch.no_grad():
        te = tm(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(te.numpy(), je, atol=LOGIT_TOL, rtol=0)
    with pytest.raises(KeyError):
        tm.update_batch_stats({"stem_bn.mean": tstats["stem_bn.mean"]})


def test_pbt_trainable_steps_match():
    """The PBT trainable's loop (tests/test_resnet_pbt.py:53-74): tiny(4)
    on 8 seeded 16x16 images, optax.sgd at lr 0.1, softmax cross-entropy,
    6 steps with the batch statistics carried; the port with torch's plain
    SGD, from the same seeded weights. Losses, weights and statistics."""
    jm = JResNet.tiny(num_classes=4)
    x = np.random.default_rng(0).standard_normal((8, 16, 16, 3)).astype(
        np.float32)
    y = np.array([0, 1, 2, 3] * 2)
    v = _variables(jm, x, seed=0)
    params, bstats = v["params"], v["batch_stats"]
    opt = optax.sgd(0.1)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, bstats, opt_state):
        def loss_fn(p):
            logits, updates = jm.apply(
                {"params": p, "batch_stats": bstats}, jnp.asarray(x),
                train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy(
                logits, jax.nn.one_hot(y, 4)).mean(), updates

        (loss, updates), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        upd, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(params, upd), updates["batch_stats"],
                opt_state, loss)

    tm = tres.ResNet.tiny(4, device="cpu")
    tm.load_state_dict({k: torch.from_numpy(a.copy()) for k, a in
                        convert_resnet_variables(params, bstats).items()})
    topt = torch.optim.SGD(tm.parameters(), lr=0.1)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ref_losses, losses = [], []
    for _ in range(6):
        params, bstats, opt_state, loss = step(params, bstats, opt_state)
        ref_losses.append(float(loss))
        logits, stats = tm(xt, train=True)
        tloss = F.cross_entropy(logits, yt)
        topt.zero_grad()
        tloss.backward()
        topt.step()
        tm.update_batch_stats(stats)
        losses.append(tloss.item())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert ref_losses[-1] < ref_losses[0]
    want = convert_resnet_variables(_np(params), _np(bstats))
    got = tm.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, atol=WEIGHT_TOL,
                                   rtol=0, err_msg=k)


def test_bf16_tiny_matches():
    """The tiny topology at the default dtype (bf16 convs, residuals and
    ReLUs; f32 BatchNorm and classifier): eval and training logits within
    2e-2 relative of the reference's."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = JResNet(num_classes=10, stage_sizes=(1, 1), width=8)
    v, tm = _pair(jm, tres.ResNet(10, (1, 1), 8, device="cpu"), x, seed=2)
    assert tm.dtype == torch.bfloat16
    with torch.no_grad():
        te = tm(torch.from_numpy(x), train=False)
        tl, _ = tm(torch.from_numpy(x), train=True)
    assert te.dtype == tl.dtype == torch.float32
    je, (jl, _) = jax.jit(lambda v, x: (
        jm.apply(v, x, train=False),
        jm.apply(v, x, train=True, mutable=["batch_stats"])))(
            v, jnp.asarray(x))
    assert _rel(te.numpy(), je) < BF16_RTOL
    assert _rel(tl.numpy(), jl) < BF16_RTOL


def test_converter_round_trip_and_init():
    """convert/unconvert round trip bit for bit; resnet50ish's names and
    shapes (the reference's by eval_shape, the port's on the meta device)
    agree, with a projection only in each later stage's first block; the
    port's init draws lecun_normal kernels from its generator (a seed
    repeats them), BN scales 1 and variances 1; no device needs the card."""
    v = _variables(JResNet.tiny(4), np.zeros((1, 16, 16, 3), np.float32))
    sd = convert_resnet_variables(v["params"], v["batch_stats"])
    params, stats = unconvert_resnet_variables(sd)
    assert jax.tree.structure(params) == jax.tree.structure(v["params"])
    assert jax.tree.structure(stats) == jax.tree.structure(v["batch_stats"])
    jax.tree.map(np.testing.assert_array_equal, params, v["params"])
    jax.tree.map(np.testing.assert_array_equal, stats, v["batch_stats"])
    np.testing.assert_array_equal(
        sd["stem.weight"], v["params"]["stem"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["classifier.weight"],
                                  v["params"]["classifier"]["kernel"].T)

    shapes = jax.eval_shape(lambda: JResNet.resnet50ish().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))
    ref = convert_resnet_variables(
        *(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes[k])
          for k in ("params", "batch_stats")))
    meta = tres.ResNet.resnet50ish(device="meta")
    assert {k: tuple(v.shape) for k, v in meta.state_dict().items()} == \
        {k: v.shape for k, v in ref.items()}
    assert [n for n in ref if n.endswith("proj.weight")] == [
        f"stage{i}_block0.proj.weight" for i in (1, 2, 3)]
    n_params = sum(p.numel() for p in meta.parameters())
    assert 21.7e6 < n_params < 21.9e6, n_params

    a = tres.ResNet.tiny(4, device="cpu")
    b = tres.ResNet.tiny(4, device="cpu")
    a.init_params(torch.Generator().manual_seed(0))
    b.init_params(torch.Generator().manual_seed(0))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    w = a.stage1_block0.conv1.weight.detach()
    assert abs(float(w.std()) * np.sqrt(9 * 8) - 1) < 0.15
    assert float(w.abs().max()) <= 2 / np.sqrt(9 * 8) / 0.8796 + 1e-6
    assert torch.equal(a.stem_bn.scale, torch.ones(8))
    assert torch.equal(a.stem_bn.var, torch.ones(8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tres.ResNet.tiny()
