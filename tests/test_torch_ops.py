"""The PyTorch port's ops against the JAX package's, on the CPU.

The same numpy inputs go through the JAX op (its Pallas kernel in interpret
mode) and the port's op (its plain PyTorch twin, which is what a CPU tensor
takes). ``test_torch_kernels.py`` holds the CUDA kernels themselves to the
same plain twins on the card.

Tolerances: both sides compute in fp32 over the same inputs and differ only
in the order of their sums, so op outputs agree to 1e-5 (absolute, at
magnitudes of a few units); byte-level results (cache appends) are equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu_torch.core import quant as t_quant
from starflashattention_tpu_torch.ops import cache_append as t_append
from starflashattention_tpu_torch.ops import flash_decode as t_fd
from starflashattention_tpu_torch.ops import flash_prefill as t_fp
from starflashattention_tpu_torch.ops import quant_matmul as t_qmm
from starflashattention_tpu_torch.utils.bridge import tensor_from_numpy, tensor_to_numpy

# the JAX package's ops/__init__ re-exports functions under the module names
j_append, j_fd, j_fp, j_qmm = (
    importlib.import_module(f"starflashattention_tpu.ops.{name}")
    for name in ("cache_append", "flash_decode", "flash_prefill", "quant_matmul"))

torch.set_num_threads(1)

ATOL = 1e-5  # fp32 on both sides; only the summation order differs


def _t(a):
    return torch.from_numpy(np.array(a))


def _decode_inputs(rng, b=4, hq=4, hkv=2, s=128, d=16, n_layers=2):
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    k = rng.standard_normal((n_layers, b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((n_layers, b, hkv, s, d), dtype=np.float32)
    # ragged, at least 1 (a row of length 0 is a JAX quirk, not a contract)
    lengths = np.array([1, s, 37, 100][:b], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("num_splits", [1, 4])
def test_flash_decode_matches_jax(rng, num_splits):
    q, k, v, lengths = _decode_inputs(rng)
    kw = dict(layer=1, num_splits=num_splits, block_k=32)
    assert t_fd._split_geometry(128, num_splits, 32)[0] == num_splits
    ref = j_fd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), **kw)
    out = t_fd.flash_decode(_t(q), _t(k), _t(v), _t(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_decode_with_stats_matches_jax(rng):
    """Partials compare one to one: the split geometry is the JAX one. JAX
    runs one sequence per grid cell so that a split past a sequence's
    length stays empty (m = NEG_INF, l = 0, o = 0) on both sides."""
    q, k, v, lengths = _decode_inputs(rng)
    kw = dict(layer=0, num_splits=4, block_k=32)
    jo, jm, jl = j_fd.flash_decode_with_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), batch_block=1, **kw)
    to, tm, tl = t_fd.flash_decode_with_stats(_t(q), _t(k), _t(v), _t(lengths), **kw)
    assert to.shape == (4, 4, 4, 16) and tm.shape == tl.shape == (4, 4, 4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=1e-6)
    merged = t_fd.lse_combine_splits(to, tm, tl)
    ref = j_fd.lse_combine_splits(jo, jm, jl)
    np.testing.assert_allclose(merged.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,ns,bk", [(128, 4, 32), (128, 4, 256), (1024, 4, 256), (384, 4, 256),
                                     (96, 3, 64), (4096, 8, 512)])
def test_split_geometry_matches_jax(s, ns, bk):
    assert t_fd._split_geometry(s, ns, bk) == j_fd._split_geometry(s, ns, bk)


def test_split_geometry_rejects_untileable_cache():
    with pytest.raises(ValueError):
        t_fd._split_geometry(521, 4, 256)


def test_length_zero_row_gives_zero(rng):
    """The port's contract for an empty row (the JAX kernel returns a mean
    of V there instead); not compared with JAX."""
    q, k, v, lengths = _decode_inputs(rng)
    lengths[2] = 0
    for splits in (1, 4):
        out = t_fd.flash_decode(_t(q), _t(k), _t(v), _t(lengths), layer=1,
                                num_splits=splits, block_k=32)
        assert torch.all(out[2] == 0)
        assert torch.all(torch.isfinite(out))


@pytest.mark.parametrize("kwargs", [dict(window=8), dict(softcap=30.0),
                                    dict(k_scales=torch.ones(2), v_scales=torch.ones(2))])
def test_flash_decode_unported_options_raise(rng, kwargs):
    q, k, v, lengths = _decode_inputs(rng)
    with pytest.raises(NotImplementedError):
        t_fd.flash_decode(_t(q), _t(k), _t(v), _t(lengths), layer=0, num_splits=1, **kwargs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_rows_kv_matches_jax(rng, dtype):
    n_layers, b, hkv, s, d = 3, 4, 2, 32, 16
    k = rng.standard_normal((n_layers, b, hkv, s, d), dtype=np.float32).astype(jnp.dtype(dtype))
    v = rng.standard_normal((n_layers, b, hkv, s, d), dtype=np.float32).astype(jnp.dtype(dtype))
    kn = rng.standard_normal((b, hkv, d), dtype=np.float32).astype(jnp.dtype(dtype))
    vn = rng.standard_normal((b, hkv, d), dtype=np.float32).astype(jnp.dtype(dtype))
    pos = np.array([0, 5, 31, 17], np.int32)  # includes the last slot
    jk, jv = j_append.append_rows_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kn),
                                     jnp.asarray(vn), 2, jnp.asarray(pos))
    tk, tv = tensor_from_numpy(k), tensor_from_numpy(v)
    out_k, out_v = t_append.append_rows_kv(tk, tv, tensor_from_numpy(kn), tensor_from_numpy(vn),
                                           2, _t(pos))
    assert out_k is tk and out_v is tv  # in place
    np.testing.assert_array_equal(tensor_to_numpy(tk), np.asarray(jk).astype(np.float32))
    np.testing.assert_array_equal(tensor_to_numpy(tv), np.asarray(jv).astype(np.float32))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_quant_matmul_matches_jax(rng, mode, stacked, out_dtype):
    m, h, o = 6, 64, 96
    w = rng.standard_normal((3, h, o) if stacked else (h, o), dtype=np.float32)
    x = rng.standard_normal((m, h), dtype=np.float32)
    jw = j_quant.quantize_weight(jnp.asarray(w), mode)
    layer = 2 if stacked else None
    ref = j_qmm.quant_matmul(jnp.asarray(x), jw["w"], jw["scale"], layer=layer,
                             out_dtype=jnp.dtype(out_dtype))
    tw = t_quant.quantize_weight(_t(w), mode)
    out = t_qmm.quant_matmul(_t(x), tw["w"], tw["scale"], layer=layer,
                             out_dtype=getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype)
    ref = np.asarray(ref).astype(np.float32)
    # bf16 outputs: each side rounds its fp32 sum once, so they may differ by
    # one bf16 ulp (2^-8 relative) where the sums straddle a rounding point
    tol = ATOL * np.abs(ref).max() if out_dtype == "float32" else 2.0**-8 * np.abs(ref).max()
    np.testing.assert_allclose(tensor_to_numpy(out), ref, atol=tol, rtol=0)


def test_quant_matmul_rejects_dense_weights():
    with pytest.raises(ValueError):
        t_qmm.quant_matmul(torch.zeros(2, 8), torch.zeros(8, 8), torch.ones(8))


def _prefill_inputs(rng, b=2, hq=4, hkv=2, sq=24, skv=64, d=16):
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    q_off = np.array([0, 17], np.int32)
    lengths = np.array([20, 17 + sq], np.int32)  # row 0 has 4 padded queries
    return q, k, v, q_off, lengths


def test_flash_prefill_matches_jax(rng):
    q, k, v, q_off, lengths = _prefill_inputs(rng)
    ref = j_fp.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
                             causal=True, q_offsets=jnp.asarray(q_off), block_q=8, block_k=128)
    out = t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths), q_offsets=_t(q_off))
    assert out.shape == q.shape
    ref = np.asarray(ref)
    # compare valid query rows only: padded rows (past the sequence's
    # length) are discarded by every caller
    for bi in range(q.shape[0]):
        valid = lengths[bi] - q_off[bi]
        np.testing.assert_allclose(out.numpy()[bi, :, :valid], ref[bi, :, :valid], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kwargs", [dict(window=8), dict(sinks=2, window=8), dict(softcap=30.0),
                                    dict(return_lse=True), dict(kv_offset=4), dict(causal=False)])
def test_flash_prefill_unported_options_raise(rng, kwargs):
    q, k, v, q_off, lengths = _prefill_inputs(rng)
    with pytest.raises(NotImplementedError):
        t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths), q_offsets=_t(q_off), **kwargs)
