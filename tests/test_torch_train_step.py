"""Port parity: ray_tpu_torch.train.step against ray_tpu.train.step.

The tiny f32 Llama starts from the same weights (a flax init converted by
models/convert.py) and takes the same batch of 2 × 32 token ids on both
sides. Tolerances: the loss within 1e-5 relative; step-1 gradients 5e-4
(the JAX tests' gradient tolerance, tests/test_attention.py:78);
parameters within 1e-4 absolute, a tenth of the learning rate: Adam's first
steps move each weight by about ±lr, so a wrong update shows as an error of
order lr."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.train import step as jstep
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import convert_params
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.train import step as tstep


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after:
    the suite runs several pytest workers at once, and torch's default of
    one thread per core in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LR = 1e-3
STEPS = 3


def _ids(vocab=512, b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _state_dict(params):
    return convert_params(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module", params=["reference", "flash"])
def jax_run(request):
    """Three optax.adamw steps of ray_tpu.train.step on the tiny config:
    the initial weights, step-1 gradients, and loss and weights after each
    step."""
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(),
                              attention_impl=request.param)
    model = jllama.LlamaModel(cfg)
    opt = optax.adamw(LR)
    ids = jnp.asarray(_ids())
    state = jstep.init_train_state(model, opt, ids)
    init = _state_dict(state.params)

    def loss_fn(params):
        logits = model.apply({"params": params}, ids)
        return jstep.cross_entropy_loss(logits[:, :-1], ids[:, 1:])

    grads = _state_dict(jax.jit(jax.grad(loss_fn))(state.params))
    step = jstep.make_train_step(model, opt, donate=False)
    losses, params = [], []
    for _ in range(STEPS):
        state, loss = step(state, ids, ids)
        losses.append(float(loss))
        params.append(_state_dict(state.params))
    return request.param, init, grads, losses, params


def _torch_model(impl, init, **cfg_kw):
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), attention_impl=impl,
                              **cfg_kw)
    model = tllama.LlamaModel(cfg, device="cpu", param_dtype=torch.float32)
    tllama.load_params(model, init)
    return model


def test_train_step_matches_jax(jax_run):
    impl, init, jgrads, jlosses, jparams = jax_run
    model = _torch_model(impl, init)
    opt = tstep.adamw(model.parameters(), LR)
    ids = torch.from_numpy(_ids()).long()
    state = tstep.init_train_state(model, opt, ids, device="cpu")
    step = tstep.make_train_step(model, opt)
    for i in range(STEPS):
        state, loss = step(state, ids, ids)
        if i == 0:
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), jgrads[name],
                                           atol=5e-4, rtol=5e-4,
                                           err_msg=name)
        if i in (0, STEPS - 1):
            np.testing.assert_allclose(loss.item(), jlosses[i], rtol=1e-5)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           jparams[i][name], atol=LR / 10,
                                           rtol=0, err_msg=name)
    assert state.step == STEPS


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.int32) if masked else None
    ref = jstep.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = tstep.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_cross_entropy_loss_takes_bf16_logits_in_f32():
    logits = torch.randn(1, 5, 40, generator=torch.Generator().manual_seed(2))
    labels = torch.arange(5)[None]
    got = tstep.cross_entropy_loss(logits.bfloat16(), labels)
    want = tstep.cross_entropy_loss(logits.bfloat16().float(), labels)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_adamw_matches_optax():
    """Three steps on a few arrays with the same gradients: torch's AdamW
    built by ``adamw`` against optax.adamw(1e-3) (weight decay 1e-4 on
    every array)."""
    rng = np.random.default_rng(3)
    shapes = [(4, 5), (7,), (2, 3, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    opt = optax.adamw(LR)
    jparams = [jnp.asarray(a) for a in init]
    jstate = opt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    topt = tstep.adamw(tparams, LR)
    for g in grads:
        upd, jstate = opt.update([jnp.asarray(x) for x in g], jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x)
        topt.step()
        for p, j in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       atol=1e-7, rtol=1e-6)


def test_remat_on_and_off_agree(monkeypatch):
    """cfg.remat wraps each layer in torch.utils.checkpoint: the flash
    forward runs twice per layer (forward and recompute), and loss and
    gradients are the same as without it."""
    calls = []
    plain = tattn.flash_attention_fwd_plain

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_fwd_plain", counted)
    init = _random_init()
    ids = torch.from_numpy(_ids(seed=4)).long()
    results = []
    for remat in (False, True):
        model = _torch_model("flash", init, remat=remat)
        calls.clear()
        loss = tstep.cross_entropy_loss(model(ids)[:, :-1], ids[:, 1:])
        loss.backward()
        n_layers = model.cfg.num_layers
        assert len(calls) == (2 if remat else 1) * n_layers
        results.append((loss.detach(), {n: p.grad.clone()
                                        for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def _random_init():
    model = tllama.LlamaModel(tllama.LlamaConfig.tiny(), device="cpu")
    tllama.init_params(model, torch.Generator().manual_seed(5))
    return {k: v.detach() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_f32_params_with_bf16_compute_equal_bf16_weights(impl):
    """A model that keeps f32 parameters and computes in bf16 gives logits
    equal to the bf16-weight serving model on the same weights: the cast
    at use rounds each weight as storing it in bf16 does."""
    init = _random_init()
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.bfloat16,
                              attention_impl=impl)
    serving = tllama.LlamaModel(cfg, device="cpu")
    training = tllama.LlamaModel(cfg, device="cpu",
                                 param_dtype=torch.float32)
    tllama.load_params(serving, init)
    tllama.load_params(training, init)
    assert serving.lm_head.weight.dtype == torch.bfloat16
    assert training.lm_head.weight.dtype == torch.float32
    assert training.layers[0].self_attn.q_proj.weight.dtype == torch.float32
    ids = torch.from_numpy(_ids(seed=6)).long()
    with torch.no_grad():
        a, b = serving(ids), training(ids)
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a, b)


def test_train_step_decreases_loss():
    model = _torch_model("reference", _random_init())
    opt = tstep.adamw(model.parameters(), LR)
    ids = torch.from_numpy(_ids(b=8, s=8, seed=7)).long()
    state = tstep.init_train_state(model, opt, ids, device="cpu")
    step = tstep.make_train_step(model, opt)
    losses = []
    for _ in range(5):
        state, loss = step(state, ids, ids)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    assert state.step == 5


def test_init_train_state_draws_seeded_weights():
    ids = torch.zeros((1, 4), dtype=torch.long)
    states = []
    for _ in range(2):
        model = _torch_model("reference", _random_init())
        opt = tstep.adamw(model.parameters(), LR)
        states.append(tstep.init_train_state(
            model, opt, ids, generator=torch.Generator().manual_seed(8),
            device="cpu"))
    for p, q in zip(states[0].model.parameters(),
                    states[1].model.parameters()):
        assert torch.equal(p, q)
    assert states[0].step == 0


def test_mesh_and_mismatches_raise():
    """As the reference: a mesh is accepted (one of a single device runs
    the single-device step), and param_rules without a mesh are ignored.
    A mesh the model was not built over, a foreign optimizer or state, and
    a sample that is not token ids raise ValueError. (The sharded step
    itself: tests/test_torch_train_sharded.py.)"""
    model = _torch_model("reference", _random_init())
    opt = tstep.adamw(model.parameters(), LR)
    ids = torch.zeros((1, 4), dtype=torch.long)
    one = create_mesh({}, devices=[torch.device("cpu")])
    state = tstep.init_train_state(model, opt, ids, device="cpu",
                                   param_rules=tllama.LLAMA_SHARDING)
    step = tstep.make_train_step(model, opt, mesh=one,
                                 param_rules=tllama.LLAMA_SHARDING)
    state, loss = step(state, ids, ids)
    assert state.step == 1 and torch.isfinite(loss)
    two = create_mesh({"data": 2}, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="LlamaModel"):
        tstep.make_train_step(model, opt, mesh=two)
    with pytest.raises(ValueError, match="LlamaModel"):
        tstep.init_train_state(model, opt, ids, device="cpu", mesh=two)
    opt = tstep.adamw(model.parameters(), LR)
    with pytest.raises(ValueError):
        tstep.init_train_state(model, tstep.adamw(
            [torch.nn.Parameter(torch.zeros(2))], LR), ids, device="cpu")
    with pytest.raises(ValueError):
        tstep.init_train_state(model, opt, ids.float(), device="cpu")
    other = tstep.adamw(_torch_model("reference",
                                     _random_init()).parameters(), LR)
    step = tstep.make_train_step(model, opt)
    with pytest.raises(ValueError):
        step(tstep.TrainState(0, model, other), ids, ids)
