"""The decode-attention probes P1 (stream_only) and P2 (bigmm_decode_attention) and
the in-turns timing helper, in the port against the JAX reference on the CPU.

The reference probes live in scripts/probe_attn.py (no package): the module is
loaded from its file. P1 runs under force_tpu_interpret_mode() (it takes no
interpret argument), P2 with interpret=True. fp32 to atol 5e-5 (the repo's parity
bar); P1's element sum against a float64 sum to 1e-6 of the summed magnitudes.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zoomearth_tpu_torch.ops import _cuda
from zoomearth_tpu_torch.ops.flash_decode import merge_splits_plain
from zoomearth_tpu_torch.scripts import probe_attn as P
from zoomearth_tpu_torch.scripts.timing import PLAIN, in_turns, medians_in_turns

torch.set_num_threads(1)
ATOL = 5e-5
_REF_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "probe_attn.py")


def _load_reference():
    spec = importlib.util.spec_from_file_location("reference_probe_attn", _REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


@pytest.fixture(autouse=True)
def _highest_precision():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(B, H, Hkv, D, T, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    return q, k, v


# ---------------------------------------------------------------------------
# P1: stream_only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,D,T,chunk,rb", [
    (8, 16, 2, 32, 64, 32, 4),  # 3B heads; 64 summed rows = row 0's two kv heads
    (4, 8, 2, 32, 96, 16, 2),  # the 64 rows span both rows of the row block
    (4, 4, 1, 16, 256, 128, 4),  # the 64 rows are the first slots of one (row, head)
    (3, 16, 2, 32, 128, 64, 1),  # row blocks of one row
    (6, 16, 2, 16, 64, 16, 2),  # chunks under 64: the 32 output rows span both kv heads of row 0
])
def test_p1_plain_matches_pallas_probe(B, H, Hkv, D, T, chunk, rb):
    q, k, v = _inputs(B, H, Hkv, D, T, seed=B + T)
    lens = np.full((B,), T, np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(REF.stream_only(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                                         chunk=chunk, rb=rb))
    out, sums = P.stream_only(_t(q), _t(k), _t(v), _t(lens), chunk=chunk, rb=rb)
    assert out.shape == ref.shape == (B, 1, H, D)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=1e-5)
    want = (k.astype(np.float64) + v).reshape(B // rb, -1).sum(1)
    mass = (np.abs(k.astype(np.float64)) + np.abs(v)).reshape(B // rb, -1).sum(1)
    assert sums.dtype == torch.float32 and sums.shape == (B // rb,)
    assert np.all(np.abs(sums.numpy() - want) <= 1e-6 * mass)


@pytest.mark.parametrize("B,H,Hkv,D,T,chunk,rb", [(8, 16, 2, 16, 128, 64, 4), (4, 8, 2, 8, 96, 16, 2),
                                                  (5, 16, 2, 8, 96, 8, 1), (4, 4, 1, 8, 200, 40, 4)])
def test_p1_kernel_row_ownership_reproduces_the_plain_output(B, H, Hkv, D, T, chunk, rb):
    """The kernel sums out's rows straight from the cache: row f of a row block is one
    (row, kv head, slot) in every chunk (stream_out_rows). Gathering those and summing
    over the chunks gives the plain version's out."""
    q, k, v = _inputs(B, H, Hkv, D, T, seed=B * T)
    want, _ = P.stream_only_plain(_t(q), _t(k), _t(v), chunk=chunk, rb=rb)
    r, h, s = P.stream_out_rows(H, Hkv, chunk, rb)
    assert int(r.max()) < rb
    kv = (_t(k) + _t(v)).reshape(B // rb, rb, Hkv, T // chunk, chunk, D).permute(0, 3, 1, 2, 4, 5)
    got = kv[:, :, r, h, s].sum(1)  # (B / rb, chunks, rb * H, D) summed over the chunks
    np.testing.assert_allclose(got.reshape(B, 1, H, D).numpy(), want.numpy(), atol=1e-5, rtol=1e-6)


def test_p1_refuses_what_the_probe_cannot_tile():
    q, k, v = _inputs(6, 8, 2, 16, 64, seed=1)
    with pytest.raises(ValueError, match="multiple of rb"):
        P.stream_only(_t(q), _t(k), _t(v), chunk=32, rb=4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        P.stream_only(_t(q), _t(k), _t(v), chunk=24, rb=2)
    q, k, v = _inputs(4, 32, 2, 16, 64, seed=2)
    with pytest.raises(ValueError, match="exceed"):
        P.stream_only(_t(q), _t(k), _t(v), chunk=32, rb=4)


# ---------------------------------------------------------------------------
# P2: bigmm_decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,lens,q_rank", [
    (4, (3, 20, 5, 40), 4),  # RB = 4; chunks past ncb = 3 skipped
    (4, (3, 20, 5, 40), 3),
    (6, (1, 17, 64, 2, 9, 33), 4),  # RB = 2; row blocks walk 2, 4 and 3 chunks
    (5, (16, 1, 48, 30, 7), 3),  # RB = 1
])
def test_p2_plain_matches_pallas_kernel(B, lens, q_rank):
    H, Hkv, D, T, chunk = 8, 2, 32, 64, 16
    q, k, v = _inputs(B, H, Hkv, D, T, seed=B)
    qq = q if q_rank == 4 else q[:, 0]
    lens = np.asarray(lens, np.int32)
    ref = np.asarray(REF.bigmm_decode_attention(jnp.asarray(qq), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                                                chunk=chunk, interpret=True))
    out = P.bigmm_decode_attention(_t(qq), _t(k), _t(v), _t(lens), chunk=chunk).numpy()
    assert out.shape == ref.shape == qq.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)


def test_p2_zero_length_row_follows_the_pallas_kernel():
    """kv_len = 0: n_chunks is floored at 1 (probe_attn.py:136) and every logit is
    masked, so the row gets the mean of v over the ncb * chunk slots its row block
    walks: here row 1 walks 3 chunks of 16 because row 2 needs them."""
    B, H, Hkv, D, T, chunk = 4, 16, 2, 128, 64, 16
    q, k, v = _inputs(B, H, Hkv, D, T, seed=9)
    lens = np.array([5, 0, 40, 16], np.int32)
    ref = np.asarray(REF.bigmm_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
                                                chunk=chunk, interpret=True))
    out = P.bigmm_decode_attention(_t(q), _t(k), _t(v), _t(lens), chunk=chunk).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)
    mean = v[1, :, :48].mean(1)  # (Hkv, D)
    np.testing.assert_allclose(out[1, 0], np.repeat(mean, H // Hkv, axis=0), atol=1e-5)


@pytest.mark.parametrize("B,lens,chunk,split", [
    (4, (5, 0, 40, 16), 16, 16),  # RB = 4, a dead row; the block walks 3 chunks
    (6, (0, 17, 64, 2, 0, 0), 16, 32),  # RB = 2; the last block holds only dead rows
    (5, (0, 1, 48, 30, 7), 32, 16),  # RB = 1: a dead row walks one chunk alone
])
def test_p2_split_pass_and_merge_match_the_plain_version(B, lens, chunk, split):
    """P2's kernel in two plain passes (its per-split softmax states with every logit
    past kv_len at -1e30, then K3's split merge over the splits the row block walks)
    gives its plain version, a zero-length row's mean of v over the walked slots
    included."""
    H, Hkv, D, T = 8, 2, 32, 64
    q, k, v = _inputs(B, H, Hkv, D, T, seed=B + split)
    lens = _t(np.asarray(lens, np.int32))
    m, l, acc, walked = P.bigmm_partials_plain(_t(q), _t(k), _t(v), lens, chunk=chunk, split=split)
    out = merge_splits_plain(m, l, acc, walked).reshape(B, 1, H, D)
    ref = P.bigmm_decode_attention_plain(_t(q), _t(k), _t(v), lens, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    spans = P.block_chunks(lens, T, chunk, P.row_block(B)).repeat_interleave(P.row_block(B)) * chunk
    np.testing.assert_array_equal(walked.numpy(), (-(-spans // split)).repeat_interleave(Hkv).numpy())


def test_p2_block_chunks_match_jax_formula_and_t_tail_is_refused():
    T, chunk = 2048, 512
    kv_len = np.array([-3, 0, 1, 512, 513, 1024, 2048, 5000], np.int32)
    for RB in (4, 2, 1):
        lens = jnp.clip(jnp.asarray(kv_len), 0, T)  # probe_attn.py:135-137
        want = jnp.max(jnp.maximum((lens + chunk - 1) // chunk, 1).reshape(-1, RB), axis=1)
        np.testing.assert_array_equal(P.block_chunks(_t(kv_len), T, chunk, RB).numpy(), np.asarray(want))
    assert [P.row_block(B) for B in (32, 6, 5, 4, 2)] == [4, 2, 1, 4, 2]
    q, k, v = _inputs(2, 8, 2, 16, 40, seed=3)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        P.bigmm_decode_attention(_t(q), _t(k), _t(v), torch.tensor([40, 7]), chunk=16)


def test_probe_cpu_dispatch_launches_nothing():
    q, k, v = _inputs(4, 8, 2, 16, 32, seed=4)
    n = (P.stream_only_cuda.launches, P.bigmm_decode_cuda.launches)
    P.stream_only(_t(q), _t(k), _t(v), chunk=16, rb=4)
    P.bigmm_decode_attention(_t(q), _t(k), _t(v), torch.tensor([1, 2, 3, 4]), chunk=16)
    assert (P.stream_only_cuda.launches, P.bigmm_decode_cuda.launches) == n


# ---------------------------------------------------------------------------
# Timing in turns
# ---------------------------------------------------------------------------

def test_in_turns_alternates_with_equal_warmup_and_runs():
    calls, clock = [], iter(range(1, 1000))

    def fake_timer(fn):
        fn()
        return float(next(clock))

    plain = lambda: calls.append("plain")  # noqa: E731
    kernel = lambda: calls.append("kernel")  # noqa: E731
    times = in_turns([plain, kernel], fake_timer, runs=10, warmup=2)
    assert calls[:8] == ["plain", "kernel", "kernel", "plain"] * 2
    assert calls.count("plain") == calls.count("kernel") == 12
    assert [len(t) for t in times] == [10, 10]
    # the fake clock ticks once per timed call: warm-ups are not timed, and each
    # function gets its own calls' readings in the order they ran
    assert times[0] == [1.0, 4.0, 5.0, 8.0, 9.0, 12.0, 13.0, 16.0, 17.0, 20.0]
    assert times[1] == [2.0, 3.0, 6.0, 7.0, 10.0, 11.0, 14.0, 15.0, 18.0, 19.0]


def test_in_turns_reverses_every_other_round_for_more_functions():
    calls = []
    fns = [lambda i=i: calls.append(i) for i in range(4)]
    in_turns(fns, lambda fn: (fn(), 0.0)[1], runs=2, warmup=1)
    assert calls == [0, 1, 2, 3, 3, 2, 1, 0, 0, 1, 2, 3]
    ticks = iter([5.0, 1.0, 6.0, 2.0, 7.0, 3.0])
    assert medians_in_turns([lambda: None, lambda: None], lambda fn: next(ticks), runs=3, warmup=0) == [5.0, 3.0]


def test_count_launch_skips_calls_captured_into_a_cuda_graph(monkeypatch):
    """A wrapper called during CUDA graph capture launches nothing: its count stays."""
    def wrapper():
        pass

    wrapper.launches = 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    _cuda.count_launch(wrapper)
    assert wrapper.launches == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    _cuda.count_launch(wrapper)
    assert wrapper.launches == 1


def test_probe_measure_times_each_probe_beside_its_plain_version(monkeypatch):
    """measure() names a kernel's plain version by the kernel's case + PLAIN, as the
    chip smoke pairs them; P1's rate follows from its bytes and device time."""
    monkeypatch.setattr(P, "time_in_turns", lambda fns: ([1.0] * len(fns), [0.5] * len(fns)))
    q, k, v = _inputs(4, 8, 2, 16, 32, seed=5)
    times = P.measure(_t(q), _t(k), _t(v), torch.tensor([3, 32, 17, 9]))
    for case in ("P2 bigmm512 len600-1200", "P2 bigmm512 len=T", "P1 stream_only (copy floor) len=T"):
        assert case in times and case + PLAIN in times
    assert times["P1 stream_only (copy floor) len=T"][2] == P.stream_bytes(_t(k)) / 0.5 / 1e6
    assert times["K3 flash_decode len600-1200"][2] is None
