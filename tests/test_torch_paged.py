"""Port parity: ray_tpu_torch.llm._internal.paged against
ray_tpu.llm._internal.paged on the same numpy inputs. The JAX decode kernel
runs in interpret mode on the CPU, as tests/test_llm_engine.py:112 runs it;
f32 tolerance 2e-5 as there."""

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


def _decode_inputs(seq_lens, seed=0):
    """The shapes of tests/test_llm_engine.py:124-131, page table permuted."""
    rng = np.random.default_rng(seed)
    B, H, HK, D, PS, MP, P = 3, 8, 2, 64, 8, 4, 16
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
