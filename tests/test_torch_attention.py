"""Port parity: ray_tpu_torch.ops.attention against ray_tpu.ops.attention.

The same numpy inputs go through the JAX functions (the Pallas flash
kernels, forward and backward, in interpret mode on the CPU, as tests/test_attention.py runs it) and the
port's plain PyTorch versions. Tolerance: f32 atol=rtol=2e-5, the JAX
tests' own (tests/test_attention.py:28); gradients 5e-4 (:78)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads for this module's torch work, restored after:
    the suite runs several pytest workers at once, and torch's default of
    one thread per core in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(b=2, sq=128, h=4, hkv=2, d=32, skv=None, seed=0):
    rng = np.random.default_rng(seed)
    skv = skv or sq
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, skv, hkv, d), dtype=np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("hkv", [4, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_out_and_lse_match_pallas_kernel(causal, hkv):
    """flash_attention_fwd_plain vs the Pallas forward core (_flash_kernel
    in interpret mode): output and row logsumexp, over GQA groupings."""
    q, k, v = _qkv(hkv=hkv)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jk, jv = jattn._gqa_expand(jk, jv, q.shape[2])
    tr = lambda x: x.transpose(0, 2, 1, 3)
    scale = 1.0 / math.sqrt(q.shape[-1])
    out_j, lse_j = jattn._flash_fwd_core(tr(jq), tr(jk), tr(jv),
                                         (causal, scale, 64, 64, True))
    out_t, lse_t = tattn.flash_attention_fwd_plain(*_t(q, k, v), causal)
    np.testing.assert_allclose(out_t.numpy(),
                               np.asarray(out_j).transpose(0, 2, 1, 3), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               **TOL)


@pytest.mark.parametrize("sq,skv,blocks,causal", [
    (96, 96, (32, 32), True),      # ragged against the 64-row CUDA tiles
    (100, 100, (128, 128), True),  # blocks shrink to the sequence
    (100, 100, (128, 128), False),
    (64, 128, (32, 64), False),    # Sq != Skv
])
def test_flash_attention_matches_jax_flash(sq, skv, blocks, causal):
    q, k, v = _qkv(sq=sq, skv=skv, hkv=2, seed=1)
    ref = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                block_q=blocks[0], block_k=blocks[1])
    out = tattn.flash_attention(*_t(q, k, v), causal=causal,
                                block_q=blocks[0], block_k=blocks[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal,sq,q_offset", [
    (True, 64, 0), (False, 64, 0), (True, 32, 32)])
def test_attention_reference_matches_jax(causal, sq, q_offset):
    q, k, v = _qkv(sq=sq, skv=64, hkv=2, seed=2)
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, q_offset=q_offset)
    out = tattn.attention_reference(*_t(q, k, v), causal=causal,
                                    q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hkv", [4, 1])
def test_plain_flash_matches_attention_reference(hkv):
    q, k, v = _qkv(hkv=hkv, seed=3)
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    out = tattn.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_mask", [False, True])
def test_block_attn_helpers_match_jax(use_mask):
    """Two kv blocks through block_attn_init/update/finish: running stats
    and the finished output agree with the JAX helpers."""
    q, k, v = _qkv(b=1, sq=32, h=2, hkv=2, skv=64, seed=4)
    scale = 1.0 / math.sqrt(q.shape[-1])
    mask = None
    if use_mask:
        mask = np.where(np.arange(32)[None, :] <= np.arange(32)[:, None],
                        0.0, jattn.NEG_INF).astype(np.float32)
    jstate = jattn.block_attn_init(jnp.asarray(q))
    tstate = tattn.block_attn_init(torch.from_numpy(q))
    for blk in (slice(0, 32), slice(32, 64)):
        jstate = jattn.block_attn_update(
            jnp.asarray(q), jnp.asarray(k[:, blk]), jnp.asarray(v[:, blk]),
            *jstate, scale=scale,
            mask=None if mask is None else jnp.asarray(mask))
        tstate = tattn.block_attn_update(
            *_t(q, k[:, blk], v[:, blk]), *tstate, scale=scale,
            mask=None if mask is None else torch.from_numpy(mask))
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    out_j = jattn.block_attn_finish(jstate[1], jstate[2], jnp.float32)
    out_t = tattn.block_attn_finish(tstate[1], tstate[2], torch.float32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("sq,blocks,hkv,causal", [
    *[(256, 64, hkv, causal) for hkv in (4, 2, 1) for causal in (True, False)],
    (200, 64, 2, True),   # ragged: the Pallas blocks shrink to divide 200
    (200, 64, 2, False),
])
def test_flash_gradients_match_pallas_backward(sq, blocks, hkv, causal):
    """Gradients of the port's flash_attention (FlashAttention with
    flash_attention_bwd_plain on the CPU) against jax.grad through JAX's
    flash_attention, whose custom_vjp runs the Pallas K2 (_flash_dq_kernel)
    and K3 (_flash_dkv_kernel) in interpret mode, as
    tests/test_attention.py:59-79 runs them."""
    q, k, v = _qkv(b=1, sq=sq, h=4, hkv=hkv, d=32, seed=6)
    w = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)

    def loss_j(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal, block_q=blocks,
                                    block_k=blocks, interpret=True)
        return (out * w).sum()

    gj = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [t.requires_grad_() for t in _t(q, k, v)]
    (tattn.flash_attention(tq, tk, tv, causal=causal)
     * torch.from_numpy(w)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4)


@pytest.mark.parametrize("hkv,causal,skv", [(4, True, 96), (2, False, 80),
                                            (1, True, 96)])
def test_plain_flash_backward_matches_autograd_of_reference(hkv, causal,
                                                            skv):
    """flash_attention_bwd_plain against autograd through the port's
    attention_reference, with the forward's own out and lse."""
    q, k, v = _qkv(b=2, sq=96, h=4, hkv=hkv, d=32, skv=skv, seed=8)
    dout = np.random.default_rng(9).standard_normal(q.shape).astype(
        np.float32)
    tq, tk, tv = [t.requires_grad_() for t in _t(q, k, v)]
    ref = torch.autograd.grad(
        tattn.attention_reference(tq, tk, tv, causal=causal), (tq, tk, tv),
        torch.from_numpy(dout))
    q_, k_, v_ = _t(q, k, v)
    out, lse = tattn.flash_attention_fwd_plain(q_, k_, v_, causal)
    got = tattn.flash_attention_bwd_plain(q_, k_, v_, out, lse,
                                          torch.from_numpy(dout), causal)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_gradients_match_jax(causal):
    """On the CPU the flash path's backward (flash_attention_bwd_plain)
    matches JAX's gradients through the reference."""
    q, k, v = _qkv(b=1, sq=64, h=4, hkv=2, d=32, seed=5)

    def loss_ref(q, k, v):
        return jattn.attention_reference(q, k, v, causal=causal).sum()

    gj = jax.grad(loss_ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [t.requires_grad_() for t in _t(q, k, v)]
    tattn.flash_attention(tq, tk, tv, causal=causal).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4)


def test_flash_attention_rejects_bad_blocks():
    q, k, v = _t(*_qkv(sq=16))
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, v, block_q=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 2e-5)])
def test_flash_kernel_matches_plain_on_cuda(cuda, dtype, atol):
    """K1 on the card against its plain version on the same inputs (bf16:
    one bf16 ulp at |x| < 4, and P is rounded to bf16 before P·V)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = [t.to(cuda, dtype) for t in _t(*_qkv(sq=200, hkv=2, d=64))]
    before = tattn.flash_fwd_kernel.launches
    out, lse = tattn.flash_fwd_kernel(q, k, v, causal=True)
    ref, ref_lse = tattn.flash_attention_fwd_plain(q, k, v, True)
    assert tattn.flash_fwd_kernel.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


def _bwd_inputs(cuda, dtype, d, causal):
    """Ragged S=200 with GQA 2:1 on the card: q, k, v, dout, K1's out and
    lse, and Delta."""
    q, k, v = [t.to(cuda, dtype) for t in _t(*_qkv(sq=200, hkv=2, d=d))]
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                       ).to(cuda, dtype)
    out, lse = tattn.flash_fwd_kernel(q, k, v, causal=causal)
    return q, k, v, dout, out, lse, tattn.flash_bwd_delta(out, dout)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 5e-2),
                                        (torch.float32, 5e-4)])
def test_flash_backward_kernels_match_plain_on_cuda(cuda, dtype, atol, d,
                                                    causal):
    """K2 and K3 on the card against flash_attention_bwd_plain on the same
    inputs, ragged S=200 with GQA 2:1, every head dim the bf16 path is
    built for (bf16: P and dS are rounded to bf16 before their products,
    as in the Pallas kernels)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, dout, out, lse, delta = _bwd_inputs(cuda, dtype, d, causal)
    before = (tattn.flash_bwd_dq_kernel.launches,
              tattn.flash_bwd_dkv_kernel.launches)
    dq = tattn.flash_bwd_dq_kernel(q, k, v, dout, lse, delta, causal=causal)
    dk, dv = tattn.flash_bwd_dkv_kernel(q, k, v, dout, lse, delta,
                                        causal=causal)
    assert (tattn.flash_bwd_dq_kernel.launches,
            tattn.flash_bwd_dkv_kernel.launches) == (before[0] + 1,
                                                     before[1] + 1)
    refs = tattn.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    for got, ref in zip((dq, dk, dv), refs):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 128])
def test_flash_backward_kernels_are_deterministic_on_cuda(cuda, d):
    """Two launches of K2 and of K3 on the same inputs give the same bits:
    the GQA sum runs inside K3's block in a fixed order, with no
    atomics."""
    q, k, v, dout, _, lse, delta = _bwd_inputs(cuda, torch.bfloat16, d, True)
    runs = [(tattn.flash_bwd_dq_kernel(q, k, v, dout, lse, delta),
             *tattn.flash_bwd_dkv_kernel(q, k, v, dout, lse, delta))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
