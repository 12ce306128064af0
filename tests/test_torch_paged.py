"""K4 (paged decode attention) and its surroundings in the port against the JAX
package on the CPU.

The plain version of K4 is held against the Pallas kernel run in interpret mode on
the cases of tests/test_paged_attention.py (shuffled disjoint page ids; partial,
tiny and full lengths), plus a row with no live slot (both give 0) and block tables
whose entries past each row's pages are garbage ids outside [0, P) (neither reads
them). The gather oracle is held against the JAX oracle and against the contiguous
plain decode attention; `append_to_pages` must equal the JAX scatter exactly,
including the dropped write at capacity. fp32 to atol 5e-5 (the repo's parity bar).
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
