"""The attention variants of the port's ops (sliding window, sinks, softcap,
head_dim 256) against the JAX package's, on the CPU.

The same numpy inputs go through the JAX op (its Pallas kernel in interpret
mode) and the port's op (its plain PyTorch twin, which a CPU tensor takes):
K1 decode and verify, K2 at head_dim 256, K5 prefill and K7 paged decode.
``test_torch_kernels.py`` holds the CUDA kernels to the same twins on the
card.

Tolerances: fp32 on both sides, differing only in the order of the sums,
so outputs agree to 1e-5 (absolute, at magnitudes of a few units). The
verify mode equals the decode at ``lengths + j`` exactly, with every
option on.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu.core import reference as j_ref
from starflashattention_tpu_torch.core import reference as t_ref
from starflashattention_tpu_torch.ops import flash_decode as t_fd
from starflashattention_tpu_torch.ops import flash_prefill as t_fp
from starflashattention_tpu_torch.ops import paged_decode as t_pdec

# the JAX package's ops/__init__ re-exports functions under the module names
j_fd, j_fp, j_pdec = (importlib.import_module(f"starflashattention_tpu.ops.{name}")
                      for name in ("flash_decode", "flash_prefill", "paged_decode"))

torch.set_num_threads(1)

ATOL = 1e-5  # fp32 on both sides; only the summation order differs

# (window, sinks, softcap): Mistral's band, StreamingLLM sinks (one inside
# a band tile, one spanning past a tile), Gemma-2's softcap, all together
VARIANTS = {
    "window": (48, 0, None),
    "window+sinks": (48, 4, None),
    "window+wide-sinks": (40, 70, None),
    "softcap": (None, 0, 30.0),
    "all": (48, 4, 50.0),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


def _opts(name):
    w, sk, cap = VARIANTS[name]
    return dict(window=w, sinks=sk, softcap=cap)


def _decode_inputs(rng, b=4, hq=4, hkv=2, s=256, d=16, n_layers=2, t=None):
    qshape = (b, hq, d) if t is None else (b, hq, t, d)
    q = rng.standard_normal(qshape, dtype=np.float32)
    k = rng.standard_normal((n_layers, b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((n_layers, b, hkv, s, d), dtype=np.float32)
    # ragged: inside the first band, past it, across a 64-row block, the end
    lengths = np.array([3, 150, 129, s - (t or 1) + 1][:b], np.int32)
    return q, k, v, lengths


# ----------------------------------------------------------------- K1 decode


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flash_decode_variants_match_jax(rng, variant):
    q, k, v, lengths = _decode_inputs(rng)
    kw = dict(layer=1, num_splits=1, block_k=64, **_opts(variant))
    ref = j_fd.flash_decode(_j(q), _j(k), _j(v), _j(lengths), **kw)
    out = t_fd.flash_decode(_t(q), _t(k), _t(v), _t(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    w, sk, cap = VARIANTS[variant]
    oracle = t_ref.decode_reference(_t(q), _t(k[1]), _t(v[1]), _t(lengths), sliding_window=w,
                                    attention_sinks=sk, softcap=cap)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=ATOL, rtol=0)


def test_decode_reference_matches_jax(rng):
    q, k, v, lengths = _decode_inputs(rng)
    kw = dict(sliding_window=48, attention_sinks=4, softcap=30.0)
    ref = j_ref.decode_reference(_j(q), _j(k[0]), _j(v[0]), _j(lengths), **kw)
    out = t_ref.decode_reference(_t(q), _t(k[0]), _t(v[0]), _t(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_flash_decode_variants_on_a_quantized_cache_match_jax(rng, mode):
    """sm_scale * k_scale folded into q, then the softcap on those scaled
    scores (JAX flash_decode.py:94-98)."""
    q, k, v, lengths = _decode_inputs(rng)
    hkv = k.shape[2]
    qmax = 127.0 if mode == "int8" else 448.0
    ks = (5.0 / qmax * (1.0 + 0.1 * np.arange(hkv))).astype(np.float32)
    vs = (5.0 / qmax * (1.0 - 0.05 * np.arange(hkv))).astype(np.float32)
    kq = np.asarray(j_quant.quantize_value(_j(k), _j(ks), mode, head_axis=2))
    vq = np.asarray(j_quant.quantize_value(_j(v), _j(vs), mode, head_axis=2))
    kw = dict(layer=0, num_splits=1, block_k=64, **_opts("all"))
    ref = j_fd.flash_decode(_j(q), _j(kq), _j(vq), _j(lengths), k_scales=_j(ks), v_scales=_j(vs),
                            **kw)
    tk, tv = (torch.from_numpy(x.view(np.int8).copy()).view(
        torch.int8 if mode == "int8" else torch.float8_e4m3fn) for x in (kq, vq))
    out = t_fd.flash_decode(_t(q), tk, tv, _t(lengths), k_scales=_t(ks), v_scales=_t(vs), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_flash_decode_head_dim_256_with_softcap_matches_jax(rng):
    """Gemma-2's head_dim with its softcap and a band, Hq = 2 Hkv."""
    q, k, v, lengths = _decode_inputs(rng, b=2, hq=4, hkv=2, s=128, d=256, n_layers=1)
    lengths = np.array([100, 128], np.int32)
    kw = dict(layer=0, num_splits=1, block_k=64, window=48, softcap=50.0, sm_scale=256**-0.5)
    ref = j_fd.flash_decode(_j(q), _j(k), _j(v), _j(lengths), **kw)
    out = t_fd.flash_decode(_t(q), _t(k), _t(v), _t(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kwargs", [dict(window=8), dict(softcap=30.0), dict(window=8, sinks=2)])
def test_split_decode_refuses_window_and_softcap_like_jax(rng, kwargs):
    """K2 keeps JAX's ValueError for a window or softcap over several splits."""
    q, k, v, lengths = _decode_inputs(rng)
    with pytest.raises(ValueError):
        j_fd.flash_decode(_j(q), _j(k), _j(v), _j(lengths), layer=0, num_splits=4, block_k=32,
                          **kwargs)
    with pytest.raises(ValueError):
        t_fd.flash_decode(_t(q), _t(k), _t(v), _t(lengths), layer=0, num_splits=4, block_k=32,
                          **kwargs)


def test_sinks_without_a_window_raise_like_jax(rng):
    q, k, v, lengths = _decode_inputs(rng)
    for fn, a in ((j_fd.flash_decode, _j), (t_fd.flash_decode, _t)):
        with pytest.raises(ValueError, match="sinks require a sliding window"):
            fn(a(q), a(k), a(v), a(lengths), layer=0, num_splits=1, sinks=4)


# ----------------------------------------------------------------- K2 at head_dim 256


@pytest.mark.parametrize("num_splits", [1, 4])
def test_split_decode_head_dim_256_matches_jax(rng, num_splits):
    """Gemma-7B's geometry in small: Hq = Hkv, head_dim 256, 4 splits. JAX
    runs one sequence per grid cell, so that a split past a sequence's
    length stays empty (m = NEG_INF, l = 0, o = 0) on both sides."""
    q, k, v, lengths = _decode_inputs(rng, b=2, hq=2, hkv=2, s=128, d=256, n_layers=1)
    lengths = np.array([37, 128], np.int32)
    kw = dict(layer=0, num_splits=num_splits, block_k=32)
    ref = j_fd.flash_decode_with_stats(_j(q), _j(k), _j(v), _j(lengths), batch_block=1, **kw)
    out = t_fd.flash_decode_with_stats(_t(q), _t(k), _t(v), _t(lengths), **kw)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    ref = j_fd.flash_decode(_j(q), _j(k), _j(v), _j(lengths), **kw)
    out = t_fd.flash_decode(_t(q), _t(k), _t(v), _t(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


# ----------------------------------------------------------------- K1 verify


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flash_verify_variants_match_jax(rng, variant):
    q, k, v, lengths = _decode_inputs(rng, t=4)
    kw = dict(layer=1, block_k=256, **_opts(variant))  # one JAX block: its walk covers every row
    ref = j_fd.flash_verify(_j(q), _j(k), _j(v), _j(lengths), **kw)
    out = t_fd.flash_verify(_t(q), _t(k), _t(v), _t(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_verify_token_j_is_decode_at_lengths_plus_j_with_variants(rng, variant):
    q, k, v, lengths = _decode_inputs(rng, t=5)
    kw = dict(layer=0, **_opts(variant))
    out = t_fd.flash_verify(_t(q), _t(k), _t(v), _t(lengths), **kw)
    for j in range(5):
        dec = t_fd.flash_decode(_t(q[:, :, j]), _t(k), _t(v), _t(lengths + j), num_splits=1, **kw)
        assert torch.equal(out[:, :, j], dec)


def test_verify_band_across_a_block_boundary_matches_jax_decode(rng):
    """Token 0's band starts at row 255 and the last token's at 259, across
    JAX's 256-row block boundary. The JAX verify starts every token's walk
    at the last token's block and so drops row 255 for token 0; the port's
    token j equals JAX's own decode at ``lengths + j``."""
    t, w = 5, 100
    q, k, v, _ = _decode_inputs(rng, b=2, s=512, t=t, n_layers=1)
    lengths = np.array([355, 300], np.int32)
    out = t_fd.flash_verify(_t(q), _t(k), _t(v), _t(lengths), layer=0, window=w)
    for j in range(t):
        ref = j_fd.flash_decode(_j(q[:, :, j]), _j(k), _j(v), _j(lengths + j), layer=0,
                                num_splits=1, block_k=256, window=w)
        np.testing.assert_allclose(out[:, :, j].numpy(), np.asarray(ref), atol=ATOL, rtol=0)


# ----------------------------------------------------------------- K5 prefill


def _prefill_inputs(rng, b=2, hq=4, hkv=2, sq=96, skv=192, d=16):
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    q_off = np.array([96, 30], np.int32)  # chunked-prefill offsets
    lengths = np.array([192, 110], np.int32)
    return q, k, v, q_off, lengths


def _assert_valid_rows_close(out, ref, lengths, q_off):
    for bi in range(out.shape[0]):
        valid = lengths[bi] - q_off[bi]  # padded rows are discarded by every caller
        np.testing.assert_allclose(out[bi, :, :valid], ref[bi, :, :valid], atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flash_prefill_variants_match_jax(rng, variant):
    q, k, v, q_off, lengths = _prefill_inputs(rng)
    kw = dict(q_offsets=q_off, **_opts(variant))
    ref = j_fp.flash_prefill(_j(q), _j(k), _j(v), _j(lengths), block_q=32, block_k=64,
                             **{n: _j(x) if n == "q_offsets" else x for n, x in kw.items()})
    out = t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths),
                             **{n: _t(x) if n == "q_offsets" else x for n, x in kw.items()})
    _assert_valid_rows_close(out.numpy(), np.asarray(ref), lengths, q_off)


def test_flash_prefill_head_dim_256_matches_jax(rng):
    q, k, v, q_off, lengths = _prefill_inputs(rng, hq=4, hkv=2, sq=40, skv=80, d=256)
    q_off, lengths = np.array([40, 0], np.int32), np.array([80, 33], np.int32)
    kw = dict(window=24, softcap=50.0, sm_scale=256**-0.5)
    ref = j_fp.flash_prefill(_j(q), _j(k), _j(v), _j(lengths), q_offsets=_j(q_off), block_q=32,
                             block_k=64, **kw)
    out = t_fp.flash_prefill(_t(q), _t(k), _t(v), _t(lengths), q_offsets=_t(q_off), **kw)
    _assert_valid_rows_close(out.numpy(), np.asarray(ref), lengths, q_off)


# ----------------------------------------------------------------- K7 paged


def _paged_inputs(rng, b=3, hq=4, hkv=2, ps=16, pages_per_seq=12, d=16, n_layers=2):
    num_pages = b * pages_per_seq + 1
    shape = (n_layers, hkv, num_pages, ps, d)
    k = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    table = (rng.permutation(num_pages - 1)[: b * pages_per_seq] + 1).reshape(
        b, pages_per_seq).astype(np.int32)
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    lengths = np.array([5, 150, 192][:b], np.int32)
    return q, k, v, table, lengths


def _reclaim(k, v, table, lengths, window, sinks, ps, block_pages):
    """The engine's rolling buffer in small: table entries wholly below each
    row's walk block (and past its sink pages) become the null page 0, which
    is filled with large finite junk that a read would show."""
    table = table.copy()
    bk = block_pages * ps
    sink_pages = -(-sinks // bk) * block_pages if sinks else 0
    for bi, n in enumerate(lengths):
        table[bi, sink_pages: max(n - window, 0) // bk * block_pages] = 0
    k, v = k.copy(), v.copy()
    k[:, :, 0] = 1e4
    v[:, :, 0] = -1e4
    return k, v, table


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_decode_variants_match_jax(rng, variant):
    q, k, v, table, lengths = _paged_inputs(rng)
    w, sk, cap = VARIANTS[variant]
    if w is not None:  # reclaimed pages are nulled as the engine does it
        k, v, table = _reclaim(k, v, table, lengths, w, sk, 16, 2)
    kw = dict(layer=1, pages_per_compute_block=2, **_opts(variant))
    ref = j_pdec.paged_flash_decode(_j(q), _j(k), _j(v), _j(table), _j(lengths), **kw)
    out = t_pdec.paged_flash_decode(_t(q), _t(k), _t(v), _t(table), _t(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_paged_decode_head_dim_256_with_softcap_matches_jax(rng):
    q, k, v, table, lengths = _paged_inputs(rng, b=2, d=256, pages_per_seq=8, n_layers=1)
    lengths = np.array([77, 128], np.int32)
    kw = dict(layer=0, pages_per_compute_block=2, window=48, softcap=50.0, sm_scale=256**-0.5)
    k, v, table = _reclaim(k, v, table, lengths, 48, 0, 16, 2)
    ref = j_pdec.paged_flash_decode(_j(q), _j(k), _j(v), _j(table), _j(lengths), **kw)
    out = t_pdec.paged_flash_decode(_t(q), _t(k), _t(v), _t(table), _t(lengths), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_paged_decode_equals_contiguous_decode_with_variants(rng):
    """The same rows read through a shuffled page table or from a dense
    table give the same numbers (both fold sm_scale into q first)."""
    q, k, v, table, lengths = _paged_inputs(rng)
    kw = dict(layer=0, sm_scale=1.0, **_opts("all"))
    dense_k = np.transpose(k[:, :, table], (0, 2, 1, 3, 4, 5)).reshape(2, 3, 2, -1, 16)
    dense_v = np.transpose(v[:, :, table], (0, 2, 1, 3, 4, 5)).reshape(2, 3, 2, -1, 16)
    out = t_pdec.paged_flash_decode(_t(q), _t(k), _t(v), _t(table), _t(lengths), **kw)
    dec = t_fd.flash_decode(_t(q), _t(dense_k), _t(dense_v), _t(lengths), num_splits=1, **kw)
    np.testing.assert_allclose(out.numpy(), dec.numpy(), atol=ATOL, rtol=0)
