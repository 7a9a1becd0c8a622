"""The port's ring attention, Ulysses and K5 / K12 ``kv_offset`` against
the JAX package, on the CPU.

Covered: ``ops.flash_prefill`` (output and base-2 LSE) and
``ops.flash_bwd.flash_prefill_bwd`` with ``kv_offset`` (sinks across a
chunk edge, a chunk in the rows' future through a negative ``q_offsets``,
a sequence of length 0) against JAX's kernels in interpret mode; then
``parallel.ring`` (contiguous forward causal and not, with the window and
with the window plus sinks across a chunk edge; the zigzag forward; the
ring backward's gradients; the permutation; the refusals) and
``parallel.ulysses`` (forward, window plus sinks, gradients, the refusal),
each the twin of a test of ``tests/test_ring.py`` or
``tests/test_ulysses.py``. JAX runs its ring and Ulysses on 4 of
conftest's 8 virtual CPU devices; the port runs on a world of 4 gloo
processes with ``device="cpu"`` (``tests/torch_parallel_worker.py``),
spawned once for the file by a module fixture that runs every case and
returns each rank's arrays. Rank i's output rows are compared with the
rows of JAX's global output that rank i holds. The gradients are held to
JAX's single-device ``flash_attention`` gradients, the oracle JAX's own
ring and Ulysses gradient tests use (running JAX's ring backward costs
several times as long on the CPU).

Tolerances: fp32 on both sides, sums in another order: outputs, LSEs and
gradients within 2e-5 of each peak (on the valid rows for outputs);
permutations and errors exact, and the empty rows' zeros and LSE of 3e38
exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.ops.flash_bwd import flash_attention as j_flash_attention
from starflashattention_tpu.ops.flash_bwd import flash_prefill_bwd as j_flash_prefill_bwd
from starflashattention_tpu.ops.flash_prefill import flash_prefill as j_flash_prefill
from starflashattention_tpu.parallel import make_mesh as j_make_mesh
from starflashattention_tpu.parallel.ring import make_ring_prefill as j_make_ring_prefill
from starflashattention_tpu.parallel.ring import ring_attention as j_ring_attention
from starflashattention_tpu.parallel.ring import zigzag_permutation as j_zigzag_permutation
from starflashattention_tpu.parallel.ulysses import make_ulysses_prefill as j_make_ulysses_prefill
from starflashattention_tpu_torch.ops import flash_bwd as t_fb
from starflashattention_tpu_torch.ops import flash_prefill as t_fp
from starflashattention_tpu_torch.parallel import ring as t_ring
from starflashattention_tpu_torch.parallel import ulysses as t_ulysses

import torch_parallel_worker as worker

torch.set_num_threads(1)

RTOL = 2e-5
N = worker.WORLD


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, mask=None):
    """|got - want| within RTOL of want's peak (over ``mask`` where given)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    if mask is not None:
        err = np.where(mask, err, 0.0)
    peak = np.abs(want if mask is None else np.where(mask, want, 0.0)).max()
    assert err.max() <= RTOL * peak, (err.max(), peak)


# ---------------------------------------------------------------- K5 / K12 with kv_offset

# one q chunk of 16 rows over one KV chunk of 16: sequence 0 one chunk past
# the KV chunk, sequence 1 a chunk BEFORE it (every position in its rows'
# future: a negative q_offsets), sequence 2 of length 0
KV_Q_OFFSETS = np.array([16, -16, 16], np.int32)
KV_LENGTHS = np.array([16, 16, 0], np.int32)
KV_OFFSET_CASES = {
    "sinks_across_edge": dict(window=24, sinks=20, kv_offset=16),  # cols 0-3 of the chunk are sinks
    "sinks_first_chunk": dict(window=24, sinks=20, kv_offset=0),
    "sinks_below_chunk": dict(window=24, sinks=4, kv_offset=32),  # no sink in this chunk
    "causal_only": dict(kv_offset=16),
}


def _kv_inputs(rng, b=3, hq=4, hkv=2, c=16, d=16):
    q, do = (rng.standard_normal((b, hq, c, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, c, d), dtype=np.float32) for _ in range(2))
    return q, k, v, do


def _j_prefill(q, k, v, **kw):
    return j_flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(KV_LENGTHS),
                           q_offsets=jnp.asarray(KV_Q_OFFSETS), block_q=16, block_k=16, return_lse=True,
                           **kw)


@pytest.mark.parametrize("case", list(KV_OFFSET_CASES))
def test_prefill_kv_offset_matches_jax(rng, case):
    kw = KV_OFFSET_CASES[case]
    q, k, v, _ = _kv_inputs(rng)
    jo, jlse = _j_prefill(q, k, v, **kw)
    o, lse = t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(KV_LENGTHS), q_offsets=_t(KV_Q_OFFSETS),
                                return_lse=True, **kw)
    # sequences 1 and 2 see nothing: 0 and the LSE 3e38, on both sides
    for side_o, side_lse in ((o.numpy(), lse.numpy()), (np.asarray(jo), np.asarray(jlse))):
        assert (side_o[1:] == 0).all() and (side_lse[1:] == np.float32(3e38)).all()
    _assert_close(lse.numpy()[0], np.asarray(jlse)[0])
    _assert_close(o.numpy(), np.asarray(jo))


@pytest.mark.parametrize("case", list(KV_OFFSET_CASES))
def test_bwd_kv_offset_matches_jax(rng, case):
    """K12's plain twin fed JAX's own ``o`` and ``lse``: the same gradients,
    and exact zeros (no NaN from 2^(s - 3e38)) for the empty sequences."""
    kw = KV_OFFSET_CASES[case]
    q, k, v, do = _kv_inputs(rng)
    jo, jlse = _j_prefill(q, k, v, **kw)
    want = j_flash_prefill_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jlse, jnp.asarray(do),
                               jnp.asarray(KV_LENGTHS), jnp.asarray(KV_Q_OFFSETS), block_q=16, block_k=16,
                               **kw)
    got = t_fb.flash_prefill_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), _t(KV_LENGTHS),
                                 _t(KV_Q_OFFSETS), **kw)
    for g, w in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all() and (g[1:] == 0).all()
        _assert_close(g, np.asarray(w))


def test_kv_offset_moves_only_the_sinks():
    """The sink bound a chunk's kernel gets: ``max(sinks - kv_offset, 0)``;
    a negative offset is refused."""
    opts = t_fp.prefill_options(24, 20, None, 16, True)
    assert (opts["window"], opts["sinks"]) == (24, 4)
    assert t_fp.prefill_options(24, 20, None, 32, True)["sinks"] == 0
    with pytest.raises(ValueError, match="kv_offset"):
        t_fp.prefill_options(None, 0, None, -1, True)


# ---------------------------------------------------------------- the world


def _attn_inputs():
    rng = np.random.default_rng(7)
    a = worker.ATTN
    q, w = (rng.standard_normal((a["b"], a["hq"], a["s"], a["d"]), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((a["b"], a["hkv"], a["s"], a["d"]), dtype=np.float32) for _ in range(2))
    lengths = np.array([a["s"], a["s"] // 2 + 11], np.int32)
    return dict(q=q, k=k, v=v, w=w, lengths=lengths)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on the port's 4 ranks, once: (inputs, [each rank's arrays])."""
    inputs = _attn_inputs()
    return inputs, worker.run_world("ring", inputs, tmp_path_factory.mktemp("ring_world"))


@pytest.fixture(scope="module")
def mesh4():
    return j_make_mesh({"seq": N}, devices=jax.devices()[:N])


def _jax_args(inputs):
    return [jnp.asarray(inputs[n]) for n in ("q", "k", "v", "lengths")]


def _valid_rows(lengths, s):
    return (np.arange(s)[None, :] < lengths[:, None])[:, None, :, None]


def _check_ranks(results, key, want, lengths, rows_of=None):
    """Rank i's ``key`` against rows ``rows_of(i)`` (default its contiguous
    chunk) of JAX's global ``want``, on the valid rows."""
    s = want.shape[2]
    valid = _valid_rows(lengths, s)
    for i, res in enumerate(results):
        rows = np.arange(i * s // N, (i + 1) * s // N) if rows_of is None else rows_of(i)
        _assert_close(res[key], want[:, :, rows], np.broadcast_to(valid[:, :, rows], res[key].shape))


@pytest.mark.parametrize("case", list(worker.RING_CASES))
def test_ring_matches_jax(world, mesh4, case):
    """Twins of ``test_ring_matches_flash_causal_ragged``,
    ``test_ring_noncausal`` and ``test_ring_sliding_window``, and the
    window with sinks across the first chunk's edge (each chunk's sinks
    moved by ``kv_offset``)."""
    inputs, results = world
    want = np.asarray(j_make_ring_prefill(mesh4, seq_axis="seq", **worker.RING_CASES[case])(
        *_jax_args(inputs)))
    _check_ranks(results, f"ring_{case}/o", want, inputs["lengths"])


def test_ring_zigzag_balanced_matches_jax(world, mesh4):
    inputs, results = world
    want = np.asarray(j_make_ring_prefill(mesh4, seq_axis="seq", balanced=True)(*_jax_args(inputs)))
    perm = j_zigzag_permutation(inputs["q"].shape[2], N)
    c = perm.size // N
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res["zigzag/rows"], perm[i * c:(i + 1) * c])
    _check_ranks(results, "zigzag/o", want, inputs["lengths"], rows_of=lambda i: perm[i * c:(i + 1) * c])


def test_zigzag_permutation_matches_jax():
    for s, n in ((256, 4), (64, 4), (48, 2)):
        np.testing.assert_array_equal(t_ring.zigzag_permutation(s, n), j_zigzag_permutation(s, n))
    perm = t_ring.zigzag_permutation(256, 4)
    np.testing.assert_array_equal(perm[np.argsort(perm)], np.arange(256))
    with pytest.raises(ValueError) as got:
        t_ring.zigzag_permutation(100, 4)  # not divisible by 2n
    with pytest.raises(ValueError) as want:
        j_zigzag_permutation(100, 4)
    assert str(got.value) == str(want.value)


def _jax_grads(inputs, **kw):
    """JAX's single-device ``flash_attention`` gradients of sum(o * w)."""
    q, k, v, lengths = _jax_args(inputs)
    w = jnp.asarray(inputs["w"])

    def loss(q, k, v):
        return jnp.sum(j_flash_attention(q, k, v, lengths, causal=True, **kw) * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _check_grads(results, kind, case, want):
    for name, w in zip(("dq", "dk", "dv"), want):
        got = np.concatenate([res[f"{kind}_grads_{case}/{name}"] for res in results], axis=2)
        _assert_close(got, w)


@pytest.mark.parametrize("case", list(worker.GRAD_CASES))
def test_ring_grads_match_jax(world, case):
    """Twin of ``test_ring_grad_matches_single_device``: the ring backward's
    dq, dk and dv on every rank, gathered, against JAX's; with the window
    and sinks across the first chunk's edge, the backward's ``kv_offset``."""
    inputs, results = world
    _check_grads(results, "ring", case, _jax_grads(inputs, **worker.GRAD_CASES[case]))


def test_ring_rejects_unequal_chunks():
    # q chunk 32 vs kv chunk 64 breaks the aligned-chunk skip contract
    q = torch.zeros((1, 2, 32, 16))
    k = torch.zeros((1, 2, 64, 16))
    with pytest.raises(ValueError) as got:
        t_ring.ring_attention(q, k, k, axis_name=None)
    with pytest.raises(ValueError) as want:
        j_ring_attention(jnp.zeros((1, 2, 32, 16)), jnp.zeros((1, 2, 64, 16)), jnp.zeros((1, 2, 64, 16)),
                         axis_name="seq")
    assert str(got.value) == str(want.value)


def test_ring_balanced_differentiable_unsupported(mesh4):
    with pytest.raises(NotImplementedError) as got:
        t_ring.make_ring_prefill(None, seq_axis="seq", balanced=True, differentiable=True)
    with pytest.raises(NotImplementedError) as want:
        j_make_ring_prefill(mesh4, seq_axis="seq", balanced=True, differentiable=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", list(worker.ULYSSES_CASES))
def test_ulysses_matches_jax(world, mesh4, case):
    """Twins of ``test_ulysses_matches_flash`` and
    ``test_ulysses_window_sinks``."""
    inputs, results = world
    want = np.asarray(j_make_ulysses_prefill(mesh4, seq_axis="seq", **worker.ULYSSES_CASES[case])(
        *_jax_args(inputs)))
    _check_ranks(results, f"ulysses_{case}/o", want, inputs["lengths"])


def test_ulysses_agrees_with_ring(world):
    inputs, results = world
    s = inputs["q"].shape[2]
    valid = _valid_rows(inputs["lengths"], s)
    for i, res in enumerate(results):
        rows = slice(i * s // N, (i + 1) * s // N)
        _assert_close(res["ulysses_plain/o"], res["ring_causal/o"],
                      np.broadcast_to(valid[:, :, rows], res["ring_causal/o"].shape))


def test_ulysses_grads_match_jax(world):
    """Twin of ``test_ulysses_grads_match_single_device``: the all-to-alls
    carry the gradients back through ``flash_attention``."""
    inputs, results = world
    _check_grads(results, "ulysses", "causal", _jax_grads(inputs))


def test_ulysses_rejects_too_many_shards():
    """An axis of 8 cannot split 4 KV heads: the same error as JAX's, which
    points at the ring."""
    from jax.sharding import Mesh

    q = torch.zeros((1, 8, 64, 16))
    k = torch.zeros((1, 4, 64, 16))
    with pytest.raises(ValueError, match="ring attention") as got:
        t_ulysses.ulysses_attention(q, k, k, axis_name=types.SimpleNamespace(size=8))
    mesh8 = Mesh(np.array(jax.devices()[:8]), axis_names=("seq",))
    fn = j_make_ulysses_prefill(mesh8, seq_axis="seq")
    with pytest.raises(ValueError) as want:
        fn(jnp.zeros((1, 8, 64, 16)), jnp.zeros((1, 4, 64, 16)), jnp.zeros((1, 4, 64, 16)),
           jnp.full((1,), 512, jnp.int32))
    assert str(got.value) == str(want.value)
