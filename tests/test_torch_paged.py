"""K4 (paged decode attention) and its surroundings in the port against the JAX
package on the CPU.

The plain version of K4 is held against the Pallas kernel run in interpret mode on
the cases of tests/test_paged_attention.py (shuffled disjoint page ids; partial,
tiny and full lengths), plus a row with no live slot (both give 0) and block tables
whose entries past each row's pages are garbage ids outside [0, P) (neither reads
them). The gather oracle is held against the JAX oracle and against the contiguous
plain decode attention; `append_to_pages` must equal the JAX scatter exactly,
including the dropped write at capacity. fp32 to atol 5e-5 (the repo's parity bar).

The kernel's two passes in plain torch (the split pass K4 shares with K3, with K4's
rule for a row with no live slot, then the split merge) are held against the plain
version and the Pallas kernel to 1e-5 at the lengths where they could part: 0, 1,
either side of a split and of a page boundary, capacity and past it, with pages that
a 32-slot tile crosses (16) and pages that hold whole tiles (64). The address policy's
plain mirror must index exactly as the gather oracle does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoomearth_tpu.ops.attention import decode_attention as jax_decode_attention
from zoomearth_tpu.ops.paged_attention import append_to_pages as jax_append
from zoomearth_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from zoomearth_tpu.ops.paged_attention import paged_decode_attention_reference as jax_oracle
from zoomearth_tpu_torch.ops import flash_decode as K3
from zoomearth_tpu_torch.ops import paged_attention as K4
from zoomearth_tpu_torch.ops.attention import decode_attention
from zoomearth_tpu_torch.scripts import paged_256_test

torch.set_num_threads(1)
ATOL = 5e-5
PAGE = 16


@pytest.fixture(autouse=True)
def _highest_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(B=3, H=4, Hkv=2, D=32, max_pages=5, seed=0, lengths=(PAGE * 2 + 3, 1, PAGE * 5)):
    """The JAX package's kernel-test layout: P = B * max_pages + 2 pages, disjoint
    shuffled ids per row."""
    rng = np.random.default_rng(seed)
    P = B * max_pages + 2
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kpool = rng.standard_normal((P, Hkv, PAGE, D)).astype(np.float32)
    vpool = rng.standard_normal((P, Hkv, PAGE, D)).astype(np.float32)
    ids = rng.permutation(P)[: B * max_pages].reshape(B, max_pages).astype(np.int32)
    return q, kpool, vpool, ids, np.asarray(lengths, np.int32)


def _pallas(q, kpool, vpool, bt, lengths):
    return np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(bt),
                                jnp.asarray(lengths), page_size=PAGE, interpret=True))


@pytest.mark.parametrize("case", ["partial_tiny_full", "3b_heads", "zero_length_row", "garbage_table_tail"])
def test_k4_plain_matches_pallas_kernel(case):
    if case == "3b_heads":
        q, kpool, vpool, bt, lengths = _setup(B=2, H=16, Hkv=2, D=128, max_pages=3, seed=4, lengths=(40, 48))
    elif case == "zero_length_row":
        q, kpool, vpool, bt, lengths = _setup(seed=1, lengths=(0, PAGE + 1, PAGE * 4))
    else:
        q, kpool, vpool, bt, lengths = _setup(seed=2)
    if case == "garbage_table_tail":
        n = -(-lengths // PAGE)
        for b in range(bt.shape[0]):  # entries at or past a row's page count are never read
            bt[b, n[b]:] = [10**6, -7, 2**30, -(2**31), 99][: bt.shape[1] - n[b]]
        assert (bt[1, 1:] >= kpool.shape[0]).any() or (bt[1, 1:] < 0).any()
    ref = _pallas(q, kpool, vpool, bt, lengths)
    out = K4.paged_decode_attention(_t(q), _t(kpool), _t(vpool), _t(bt), _t(lengths), page_size=PAGE).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)
    if case == "zero_length_row":
        np.testing.assert_array_equal(ref[0], 0.0)  # the Pallas kernel's value: acc / max(l, 1e-30) = 0
        np.testing.assert_array_equal(out[0], 0.0)


def test_k4_oracle_matches_jax_oracle_and_keeps_its_zero_length_value():
    q, kpool, vpool, bt, lengths = _setup(seed=3, lengths=(0, 7, PAGE * 5))
    ref = np.asarray(jax_oracle(jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(bt),
                                jnp.asarray(lengths), page_size=PAGE))
    out = K4.paged_decode_attention_reference(_t(q), _t(kpool), _t(vpool), _t(bt), _t(lengths),
                                              page_size=PAGE).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)
    # a row with no live slot: every logit is masked, so the oracle gives the mean of v
    # over the row's gathered slots; the kernel and the port's plain version give 0
    v0 = vpool[bt[0]].transpose(1, 0, 2, 3).reshape(2, -1, 32).mean(1)  # (Hkv, D)
    np.testing.assert_allclose(out[0], np.repeat(v0, 2, axis=0), atol=1e-5)
    plain = K4.paged_decode_attention_plain(_t(q), _t(kpool), _t(vpool), _t(bt), _t(lengths), page_size=PAGE)
    np.testing.assert_array_equal(plain[0].numpy(), 0.0)
    np.testing.assert_allclose(plain[1:].numpy(), ref[1:], atol=ATOL, rtol=1e-4)


def test_k4_oracle_and_plain_match_contiguous_decode_attention():
    """Pages laid out from a contiguous cache at shuffled ids == slot-contiguous
    decode attention (port and JAX alike)."""
    B, H, Hkv, D, max_pages = 2, 4, 2, 32, 4
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    T = max_pages * PAGE
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    lengths = np.array([T - 5, 7], np.int32)
    kpool, vpool, bt = paged_256_test.to_pages(_t(k), _t(v), PAGE, np.random.default_rng(2))
    want = np.asarray(jax_decode_attention(jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
                                           kv_len=jnp.asarray(lengths)))[:, 0]
    port = decode_attention(_t(q[:, None]), _t(k), _t(v), kv_len=_t(lengths))[:, 0].numpy()
    np.testing.assert_allclose(port, want, atol=ATOL, rtol=1e-4)
    for fn in (K4.paged_decode_attention_reference, K4.paged_decode_attention_plain):
        got = fn(_t(q), kpool, vpool, bt, _t(lengths), page_size=PAGE).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("lengths", [(PAGE * 2 + 3, 1, PAGE * 4), (PAGE * 5, 3, PAGE), (0, PAGE * 5 - 1, PAGE * 9)])
def test_append_to_pages_equals_jax_exactly(lengths):
    """Rows at or past capacity (max_pages * page) drop their write; the others write
    slot lengths % page of page block_table[b, lengths // page]. The port updates the
    pools in place and returns them."""
    q, kpool, vpool, bt, lengths = _setup(seed=5, lengths=lengths)
    rng = np.random.default_rng(6)
    k_new = rng.standard_normal((3, 2, 32)).astype(np.float32)
    v_new = rng.standard_normal((3, 2, 32)).astype(np.float32)
    want_k, want_v = jax_append(jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(bt), jnp.asarray(lengths), page_size=PAGE)
    kp, vp = _t(kpool), _t(vpool)
    got_k, got_v = K4.append_to_pages(kp, vp, _t(k_new), _t(v_new), _t(bt), _t(lengths), page_size=PAGE)
    assert got_k is kp and got_v is vp
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    full = lengths >= bt.shape[1] * PAGE
    for b in np.flatnonzero(full):  # a full row's pages are untouched
        np.testing.assert_array_equal(got_k.numpy()[bt[b]], kpool[bt[b]])


def test_page_counts_match_jax_formula():
    lengths = np.array([0, 1, 15, 16, 17, 255, 256, 257, 4096], np.int32)
    for page in (16, 64, 256):
        want = np.asarray((jnp.asarray(lengths) + page - 1) // page)  # paged_attention.py:110
        got = K4.page_counts(_t(lengths), page)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    bt = torch.zeros((2, 4), dtype=torch.int32)
    assert K4.read_bytes(torch.tensor([5, 100]), bt, 16, 2, 128, 2) == (5 + 64) * 2 * 128 * 2 * 2


def test_k4_cpu_dispatch_launches_nothing_and_plain_follows_dtype():
    q, kpool, vpool, bt, lengths = _setup(seed=7)
    n0 = K4.paged_decode_cuda.launches
    out = K4.paged_decode_attention(_t(q).bfloat16(), _t(kpool).bfloat16(), _t(vpool).bfloat16(), _t(bt),
                                    _t(lengths), page_size=PAGE)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert K4.paged_decode_cuda.launches == n0


def test_paged_decode_loop_on_cpu():
    """The entry point's decode loop (append, then paged attention, against the
    contiguous cache) on the CPU plain versions: the full row's pages stay as they
    were, and the pools hold exactly the contiguous cache's live slots."""
    err, unchanged, same = paged_256_test.decode_loop(torch.device("cpu"), B=3, steps=5, page=16, max_pages=3)
    assert unchanged and same
    assert err <= 1e-6  # the same fp32 algorithm over the same values, gathered or not


def _edge_setup(page, max_pages, seed):
    """B = 8 rows of H = 4, Hkv = 2, D = 32 whose lengths sit on every edge of the split
    pass: 0, 1, either side of a split boundary and of a page boundary, capacity and
    past capacity. Disjoint shuffled page ids; table entries past a row's pages are
    ids far outside the pool."""
    B, H, Hkv, D = 8, 4, 2, 32
    cap = page * max_pages
    split, nsplit = K3.split_plan(B, Hkv, cap)
    assert nsplit >= 2 and split + 1 < cap and page + 1 < cap
    rng = np.random.default_rng(seed)
    P = B * max_pages + 3
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kpool = rng.standard_normal((P, Hkv, page, D)).astype(np.float32)
    vpool = rng.standard_normal((P, Hkv, page, D)).astype(np.float32)
    bt = rng.permutation(P)[: B * max_pages].reshape(B, max_pages).astype(np.int32)
    lengths = np.array([0, 1, split - 1, split + 1, page - 1, page + 1, cap, cap + 7], np.int32)
    n = -(-np.minimum(lengths, cap) // page)
    for b in range(B):
        bt[b, n[b]:] = 10**6 + b
    return q, kpool, vpool, bt, lengths, split


@pytest.mark.parametrize("page,max_pages", [(16, 5), (64, 3)])
def test_k4_two_passes_match_plain_and_pallas_kernel(page, max_pages):
    q, kpool, vpool, bt, lengths, split = _edge_setup(page, max_pages, seed=8)
    B, H, D = q.shape
    m, l, acc, walked = K4.paged_partials_plain(_t(q), _t(kpool), _t(vpool), _t(bt), _t(lengths), split,
                                                page_size=page)
    Hkv = kpool.shape[1]
    cap = page * max_pages
    assert walked.tolist() == [w for n in np.minimum(lengths, cap) for w in [-(-int(n) // split)] * Hkv]
    two = K3.merge_splits_plain(m, l, acc, walked).reshape(B, H, D).numpy()
    plain = K4.paged_decode_attention_plain(_t(q), _t(kpool), _t(vpool), _t(bt), _t(lengths), page_size=page).numpy()
    np.testing.assert_allclose(two, plain, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(two[0], 0.0)  # no live slot: no split walked, the merge gives 0
    safe = np.where(np.arange(max_pages)[None] < -(-np.minimum(lengths, cap)[:, None] // page), bt, 0)
    ref = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(safe),
                               jnp.asarray(np.minimum(lengths, cap)), page_size=page, interpret=True))
    np.testing.assert_allclose(two, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("page,max_pages", [(16, 5), (64, 3), (7, 9)])
def test_k4_address_policy_indexes_as_the_gather_oracle(page, max_pages):
    """slot_address(t) = (block_table[b, t // page], t % page) reaches exactly the
    element the oracle's gathered cache holds at slot t, for every slot of every row."""
    B, Hkv, D = 3, 2, 8
    rng = np.random.default_rng(9)
    P = B * max_pages
    pool = _t(rng.standard_normal((P, Hkv, page, D)).astype(np.float32))
    bt = _t(rng.permutation(P).reshape(B, max_pages).astype(np.int32))
    t = torch.arange(page * max_pages)[None].expand(B, -1)
    ids, slots = K4.slot_address(bt, t, page)
    assert ids.shape == slots.shape == t.shape
    got = pool[ids, :, slots]  # (B, T, Hkv, D)
    assert torch.equal(got.transpose(1, 2), K4._gather(pool, bt))


@pytest.mark.parametrize("B,Hkv,page,max_pages", [(32, 2, 64, 64), (64, 2, 256, 16), (8, 2, 16, 5), (3, 1, 7, 9),
                                                  (1, 8, 256, 1)])
def test_split_plan_covers_the_paged_capacity(B, Hkv, page, max_pages):
    cap = page * max_pages
    split, nsplit = K3.split_plan(B, Hkv, cap)
    assert split > 0 and split % K3.TILE == 0
    assert (nsplit - 1) * split < cap <= nsplit * split  # the splits cover [0, capacity), none is empty
