"""Port parity: ray_tpu_torch.llm._internal.paged against
ray_tpu.llm._internal.paged on the same numpy inputs. The JAX decode kernel
runs in interpret mode on the CPU, as tests/test_llm_engine.py:112 runs it;
f32 tolerance 2e-5 as there."""

import inspect
import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm._internal import paged as jpaged
from ray_tpu_torch.llm._internal import paged as tpaged


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


def _decode_inputs(seq_lens, seed=0, H=8, HK=2, D=64, PS=8, MP=4, P=16):
    """The shapes of tests/test_llm_engine.py:124-131 unless given, page
    table permuted."""
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    q = rng.standard_normal((B, 1, H, D), dtype=np.float32)
    k_pages = rng.standard_normal((HK, P, PS, D), dtype=np.float32)
    v_pages = rng.standard_normal((HK, P, PS, D), dtype=np.float32)
    page_table = (rng.permutation(P - 1)[:B * MP].reshape(B, MP)
                  % (P - 1)).astype(np.int32)
    return q, k_pages, v_pages, page_table, np.asarray(seq_lens, np.int32)


def _write_inputs(S, seed):
    """Pages, new KV and a page table with masked lanes; masked lanes of the
    prefill case carry positions past the page-table row (padding)."""
    rng = np.random.default_rng(seed)
    HK, P, PS, D, B, MP = 2, 12, 4, 8, 3, 3
    pages = rng.standard_normal((HK, P, PS, D), dtype=np.float32)
    new_kv = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    page_table = rng.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
    starts = np.array([0, 2, 5])
    positions = (starts[:, None] + np.arange(S)[None, :]).astype(np.int32)
    true_lens = np.array([S, max(1, S - 3), 0]) if S > 1 else np.array(
        [1, 0, 1])
    mask = np.arange(S)[None, :] < true_lens[:, None]
    positions = np.where(mask, positions, 10 * PS * MP).astype(np.int32)
    return pages, new_kv, page_table, positions, mask


@pytest.mark.parametrize("S", [1, 7])
def test_paged_write_matches_jax(S):
    pages, new_kv, page_table, positions, mask = _write_inputs(S, seed=S)
    ref = jpaged.paged_write(*map(jnp.asarray, (pages, new_kv, page_table,
                                                positions, mask)))
    got = tpaged.paged_write(*map(torch.from_numpy, (pages.copy(), new_kv,
                                                     page_table, positions,
                                                     mask)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_paged_write_updates_in_place():
    pages, new_kv, page_table, positions, mask = _write_inputs(7, seed=3)
    t = torch.from_numpy(pages.copy())
    out = tpaged.paged_write(t, *map(torch.from_numpy, (
        new_kv, page_table, positions, mask)))
    assert out.data_ptr() == t.data_ptr()
    assert not np.array_equal(t.numpy(), pages)


def test_paged_gather_matches_jax():
    _, k_pages, _, page_table, _ = _decode_inputs([5, 17, 31])
    ref = jpaged.paged_gather(jnp.asarray(k_pages), jnp.asarray(page_table))
    got = tpaged.paged_gather(torch.from_numpy(k_pages),
                              torch.from_numpy(page_table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("S", [1, 5])
def test_paged_attention_gather_path_matches_jax(S):
    rng = np.random.default_rng(S)
    _, k_pages, v_pages, page_table, _ = _decode_inputs([0, 0, 0], seed=S)
    q = rng.standard_normal((3, S, 8, 64), dtype=np.float32)
    seq_lens = np.array([S + 3, S + 10, S + 20], np.int32)
    q_positions = (seq_lens[:, None] - S
                   + np.arange(S)[None, :]).astype(np.int32)
    args = (q, k_pages, v_pages, page_table, q_positions, seq_lens)
    ref = jpaged.paged_attention(*map(jnp.asarray, args), use_kernel=False)
    got = tpaged.paged_attention(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("seq_lens", [
    [5, 17, 31],
    [0, 9, 40],   # empty sequence, and a length past the row's 32 slots
])
def test_paged_decode_plain_matches_pallas_kernel(seq_lens):
    args = _decode_inputs(seq_lens, seed=7)
    ref = jpaged.paged_attention_decode_kernel(*map(jnp.asarray, args),
                                               interpret=True)
    got = tpaged.paged_decode_plain(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("seq_lens", [
    [5, 17, 31],
    [0, 9, 40],
])
def test_paged_decode_plain_matches_pallas_kernel_bf16(seq_lens):
    """bf16: the plain version rounds P to bf16 before P·V and sums the
    denominator from the unrounded P, as the Pallas kernel does, so where
    that kernel takes one chunk (MP 4 here) the two agree bit for bit."""
    args = _decode_inputs(seq_lens, seed=7)
    ref = jpaged.paged_attention_decode_kernel(
        *(jnp.asarray(a).astype(jnp.bfloat16) if a.dtype == np.float32
          else jnp.asarray(a) for a in args), interpret=True)
    got = tpaged.paged_decode_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) if a.dtype == np.float32
          else torch.from_numpy(a) for a in args))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_decode_split_is_a_function_of_shapes():
    """K4's split of a page-table row is picked on the host from the shapes
    and the SM count alone: it takes no seq_lens, so choosing it never
    waits on the card (nor breaks the capture of a decode step)."""
    assert list(inspect.signature(tpaged.decode_split).parameters) == [
        "b", "hk", "hg", "mp", "ps", "num_sms"]
    # The 8B serving shape: a 512-key row in 2 splits, so its 176 live
    # keys take one split and no merge.
    assert tpaged.decode_split(8, 8, 4, 8, 64, 132) == (4, 2)
    # B=1 x 32768 keys: 32 splits of 1,024 keys, 256 blocks on 132 SMs.
    assert tpaged.decode_split(1, 8, 4, 512, 64, 132) == (16, 32)
    for b, hk, hg, mp, ps in itertools.product(
            [1, 3, 8], [1, 2, 8], [1, 4, 16, 32], [1, 7, 64, 512],
            [1, 4, 16, 64]):
        pps, splits = tpaged.decode_split(b, hk, hg, mp, ps, 132)
        assert 1 <= pps <= mp and splits == -(-mp // pps)
        # At least 256 keys a split, unless the whole row is shorter.
        assert pps * ps >= min(256, mp * ps)
        # No more blocks than 2 an SM, unless a row is already one split.
        assert splits == 1 or b * hk * -(-hg // 16) * splits <= 2 * 132 \
            or pps * ps < 256 + ps


def test_decode_on_cpu_takes_the_plain_path():
    """S == 1 on CPU tensors: no kernel launch, and the gather path agrees
    with the decode kernel's plain version."""
    q, k_pages, v_pages, page_table, seq_lens = map(
        torch.from_numpy, _decode_inputs([5, 17, 31], seed=8))
    before = tpaged.paged_attention_decode_kernel.launches
    gather = tpaged.paged_attention(q, k_pages, v_pages, page_table,
                                    (seq_lens - 1)[:, None], seq_lens)
    wrapped = tpaged.paged_attention_decode_kernel(q, k_pages, v_pages,
                                                   page_table, seq_lens)
    assert tpaged.paged_attention_decode_kernel.launches == before
    np.testing.assert_allclose(wrapped.numpy(), gather.numpy(), **TOL)


def _allocator_state(alloc, cache):
    return (sorted(alloc.free), [list(p) for p in alloc.slot_pages],
            dict(alloc.ref), list(cache._entries.items()), cache.lookups,
            cache.hit_pages)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_prefix_cache_copies_match_originals(seed):
    """One random op sequence drives the copied PageAllocator/PrefixCache
    and the originals side by side; their state stays equal."""
    rng = random.Random(seed)
    pairs = []
    for mod in (jpaged, tpaged):
        cfg = mod.PagedCacheConfig(num_pages=24, page_size=4, max_seqs=4,
                                   max_pages_per_seq=8)
        alloc = mod.PageAllocator(cfg)
        pairs.append((mod, alloc, mod.PrefixCache(alloc)))
    prompts = [[rng.randrange(50) for _ in range(rng.randrange(1, 20))]
               for _ in range(6)]
    for _ in range(200):
        op = rng.choice(["ensure", "release", "index", "match", "evict"])
        slot = rng.randrange(4)
        n = rng.randrange(1, 30)
        n_evict = rng.randrange(1, 4)
        prompt = rng.choice(prompts)
        results = []
        for mod, alloc, cache in pairs:
            try:
                if op == "ensure":
                    r = list(alloc.ensure(slot, n))
                elif op == "release":
                    r = alloc.release(slot)
                elif op == "index":
                    digests = cache.page_digests(prompt, 4)
                    r = cache.insert(digests, alloc.slot_pages[slot])
                elif op == "match":
                    r = cache.match(cache.page_digests(prompt, 4))
                else:
                    r = cache.evict(n_evict)
            except MemoryError:
                r = "oom"
            results.append(r)
        assert results[0] == results[1], op
        assert _allocator_state(*pairs[0][1:]) == _allocator_state(
            *pairs[1][1:])


def test_refcounted_release_returns_pages_once():
    cfg = tpaged.PagedCacheConfig(num_pages=8, page_size=4, max_seqs=2,
                                  max_pages_per_seq=4)
    alloc = tpaged.PageAllocator(cfg)
    pages = alloc.ensure(0, 8)  # 2 pages, ref 1 each
    alloc.share(1, pages)       # now ref 2
    free0 = alloc.num_free
    alloc.release(0)
    assert alloc.num_free == free0  # still held by slot 1
    alloc.release(1)
    assert alloc.num_free == free0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 2e-5)])
def test_paged_decode_kernel_matches_plain_on_cuda(cuda, dtype, atol):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k_pages, v_pages, page_table, seq_lens = [
        torch.from_numpy(a).to(cuda) for a in _decode_inputs([1, 17, 40])]
    q, k_pages, v_pages = (t.to(dtype) for t in (q, k_pages, v_pages))
    before = tpaged.paged_attention_decode_kernel.launches
    got = tpaged.paged_attention_decode_kernel(q, k_pages, v_pages,
                                               page_table, seq_lens)
    ref = tpaged.paged_decode_plain(q, k_pages, v_pages, page_table,
                                    seq_lens)
    assert tpaged.paged_attention_decode_kernel.launches == before + 1
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("H,HK,D", [(32, 2, 128), (16, 8, 256), (8, 2, 72),
                                    (40, 2, 64)])
def test_paged_decode_kernel_shapes_on_cuda(cuda, dtype, atol, H, HK, D):
    """K4 at a GQA group of 16 and 20 (two 16-head tiles), head dims 256 and
    72, with an empty sequence and rows that span 1 and 2 splits (MP 32 ×
    ps 16, 256-key splits): against its plain version at the tolerances
    above, and two launches give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k_pages, v_pages, page_table, seq_lens = [
        torch.from_numpy(a).to(cuda) for a in _decode_inputs(
            [0, 37, 256, 400, 512], seed=11, H=H, HK=HK, D=D, PS=16, MP=32,
            P=5 * 32 + 1)]
    q, k_pages, v_pages = (t.to(dtype) for t in (q, k_pages, v_pages))
    runs = [tpaged.paged_attention_decode_kernel(q, k_pages, v_pages,
                                                 page_table, seq_lens)
            for _ in range(2)]
    ref = tpaged.paged_decode_plain(q, k_pages, v_pages, page_table,
                                    seq_lens)
    assert torch.equal(runs[0], runs[1])
    assert not runs[0][0].any()  # seq_len 0 gives zeros
    torch.testing.assert_close(runs[0].float(), ref.float(), atol=atol,
                               rtol=atol)
