"""The port's quantized slice against the JAX package's, on the CPU: int4
weights (kernel K6), W8A8 / W4A8 prefill (K10, K11) and int8 / fp8 KV
caches, at tiny sizes.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode) and the port's (the plain twins a CPU tensor takes).

Tolerances:
- quantized bytes and scales (``quantize_weight_int4``, ``quantize_rows``
  against eager JAX, KV appends): identical;
- the matmul entries in fp32: both sides sum the same exact products (int4
  nibbles times fp32 activations; int8 x int8 in exact integer sums) and
  differ only in the order of the fp32 group sums, so 1e-5 of the output's
  peak; bf16 outputs add one bf16 rounding on each side (2^-8 of the peak);
- model logits in fp32: 1e-4, as tests/test_torch_llama.py holds them. Under
  ``w8a8_prefill`` JAX's jitted model quantizes the rows with XLA, which may
  turn ``absmax / 127`` into a multiply by 1/127 (one fp32 ulp of a row
  scale, and so one int8 step of an activation that sits on a rounding
  boundary); the streams are still required to be equal.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.cache import contiguous as j_cache
from starflashattention_tpu.cache import paged as j_paged
from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu.models import llama as j_llama
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.cache import paged as t_paged
from starflashattention_tpu_torch.core import quant as t_quant
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.ops import quant_matmul as t_qmm
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.utils import bridge

j_qmm = importlib.import_module("starflashattention_tpu.ops.quant_matmul")

torch.set_num_threads(1)

REL_F32 = 1e-5
REL_BF16 = 2.0**-8
LOGIT_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ quantization bytes


@pytest.mark.parametrize("shape,group", [((2, 256, 48), None),  # g128, 2 groups a layer
                                         ((384, 40), None),  # 3 groups: an odd count
                                         ((96, 24), 32),  # an explicit cap
                                         ((2, 192, 16), None)])  # 192: largest even divisor 96
def test_quantize_weight_int4_bytes_identical(rng, shape, group):
    w = rng.standard_normal(shape, dtype=np.float32)
    w[..., 0] = 0.0  # an all-zero column takes scale 1
    ref = j_quant.quantize_weight_int4(jnp.asarray(w), group)
    out = t_quant.quantize_weight_int4(_t(w), group)
    assert out["w"].dtype == torch.int8 and out["scale"].dtype == torch.float32
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(ref["w"]))
    np.testing.assert_array_equal(out["scale"].numpy(), np.asarray(ref["scale"]))
    assert t_quant.is_int4_weight(out) and j_quant.is_int4_weight(ref)
    np.testing.assert_array_equal(t_quant.dequantize_weight(out).numpy(),
                                  np.asarray(j_quant.dequantize_weight(ref)))


def test_default_int4_group_and_unpack_match_jax(rng):
    for h in (64, 128, 192, 384, 11008, 4096, 22):
        assert t_quant.default_int4_group(h) == j_quant.default_int4_group(h)
    packed = rng.integers(-128, 128, (8, 5)).astype(np.int8)
    for got, want in zip(t_quant.unpack_int4(_t(packed)), j_quant.unpack_int4(jnp.asarray(packed))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _nib2_bf16(a, b, i, high):
    """csrc/quant_matmul.cu's nib2_bf16<I, HIGH> in torch integer ops on
    32-bit words a, b (int64 tensors): prmt puts byte i of a in bytes 0 and
    1 and byte i of b in bytes 2 and 3; lop3 computes (x & 0x000f000f) ^
    magic; the bf16x2 FMA adds -136 to each half. Returns the (low, high)
    halves as bf16."""
    byte_a, byte_b = (a >> (8 * i)) & 0xFF, (b >> (8 * i)) & 0xFF
    x = byte_a | (byte_a << 8) | (byte_b << 16) | (byte_b << 24)
    y = (x & 0x000F000F) ^ (0x43084308 if high else 0x43004300)

    def bf16(bits):  # 16-bit patterns as bf16
        return torch.as_tensor(bits).to(torch.int32).to(torch.int16).view(torch.bfloat16)

    def half(bits):  # plus bf16(-136) (0xc308), rounded to bf16
        return (bf16(bits).float() + bf16([0xC308]).float()).to(torch.bfloat16)

    return half(y & 0xFFFF), half(y >> 16)


@pytest.mark.parametrize("i", range(4))
def test_int4_magic_unpack_equals_unpack_int4(rng, i):
    """The tiled K6 kernel's register unpack, at byte i of its 32-bit words,
    gives both nibbles of all 256 byte values bit for bit as
    ``core/quant.unpack_int4`` (the other bytes random; the high nibbles
    come from the words shifted right by 4, as the kernel shifts them)."""
    vals = torch.arange(256, dtype=torch.int64)
    words = torch.from_numpy(rng.integers(0, 2**32, (2, 256), dtype=np.int64))
    a = (words[0] & ~(0xFF << (8 * i))) | (vals << (8 * i))
    b = (words[1] & ~(0xFF << (8 * i))) | (vals.flip(0) << (8 * i))
    lo, hi = t_quant.unpack_int4(torch.stack([vals, vals.flip(0)]).to(torch.uint8).view(torch.int8))
    for high, want in ((False, lo), (True, hi)):
        wa, wb = (a >> 4, b >> 4) if high else (a, b)
        got_a, got_b = _nib2_bf16(wa, wb, i, high)
        for got, ref in ((got_a, want[0]), (got_b, want[1])):
            assert torch.equal(got.view(torch.int16), ref.to(torch.bfloat16).view(torch.int16))


def _prmt(a, b, sel):
    """PTX ``prmt.b32`` (default mode) on 32-bit words a, b (int64 tensors):
    result byte n is byte ``s & 7`` of the pool (a's bytes 0-3, b's 4-7) for
    selector nibble s, or that byte's sign replicated when ``s & 8``."""
    pool = [(a >> (8 * k)) & 0xFF for k in range(4)] + [(b >> (8 * k)) & 0xFF for k in range(4)]
    out = torch.zeros_like(a)
    for n in range(4):
        s = (sel >> (4 * n)) & 0xF
        byte = pool[s & 7]
        if s & 8:
            byte = torch.where(byte >= 0x80, 0xFF, 0)
        out |= byte << (8 * n)
    return out


def _bf16_halves(word):
    """The (low, high) 16-bit halves of 32-bit words as bf16."""
    def bf16(bits):
        return bits.to(torch.int32).to(torch.int16).view(torch.bfloat16)

    return bf16(word & 0xFFFF), bf16((word >> 16) & 0xFFFF)


def _s8x2_bf16(a, b, i):
    """csrc/quant_matmul.cu's s8x2_bf16<I> on words a, b: prmt byte i of
    each into its 16-bit half, lop3 into L = 0x4300 | (byte & 0x7F) and C =
    0x4300 | (byte & 0x80), then the bf16x2 FMA C * -1 + L (exact, so
    torch's bf16 arithmetic rounds as ``fma.rn.bf16x2``). Returns the
    (low, high) halves as bf16."""
    x = _prmt(a, b, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12))
    l_half = _bf16_halves((x & 0x007F007F) | 0x43004300)
    c_half = _bf16_halves((x & 0x00800080) | 0x43004300)
    return tuple((lv.float() - cv.float()).to(torch.bfloat16) for lv, cv in zip(l_half, c_half))


def _e4m3x2_bf16(a, b, i):
    """csrc/quant_matmul.cu's e4m3x2_bf16<I>: prmt byte i of a and of b into
    the two halves with their signs replicated above, shift left 4, mask
    0x87F087F0, multiply each bf16 half by 2^120 (exact, so torch's bf16
    product rounds as ``mul.rn.bf16x2``)."""
    sel = i | ((i | 8) << 4) | ((4 + i) << 8) | ((12 + i) << 12)
    y = (_prmt(a, b, sel) << 4) & 0x87F087F0
    two120 = torch.tensor(2.0**120, dtype=torch.bfloat16)
    return tuple(h * two120 for h in _bf16_halves(y))


def _transpose4(r):
    """csrc/quant_matmul_a8.cu's transpose4 on words r[0..3]."""
    t0, t1 = _prmt(r[0], r[1], 0x5140), _prmt(r[2], r[3], 0x5140)
    t2, t3 = _prmt(r[0], r[1], 0x7362), _prmt(r[2], r[3], 0x7362)
    return [_prmt(t0, t1, 0x5410), _prmt(t0, t1, 0x7632), _prmt(t2, t3, 0x5410), _prmt(t2, t3, 0x7632)]


def _nib16(word):
    """csrc/quant_matmul_a8.cu's (nib_lo16, nib_hi16) on words."""
    return ((word << 4) & 0xF0F0F0F0) ^ 0x80808080, word & 0xF0F0F0F0


def _word_with_byte(rng, vals, i):
    """Random 32-bit words (int64) with byte i replaced by ``vals``."""
    words = torch.from_numpy(rng.integers(0, 2**32, vals.shape[0], dtype=np.int64))
    return (words & ~(0xFF << (8 * i))) | (vals << (8 * i))


@pytest.mark.parametrize("i", range(4))
def test_int8_magic_convert_equals_cast(rng, i):
    """K4's tiled int8 conversion at byte i of its words gives all 256 byte
    values, in both halves, bit for bit as ``w.to(torch.bfloat16)``."""
    vals = torch.arange(256, dtype=torch.int64)
    a, b = _word_with_byte(rng, vals, i), _word_with_byte(rng, vals.flip(0), i)
    got_a, got_b = _s8x2_bf16(a, b, i)
    for got, byte in ((got_a, vals), (got_b, vals.flip(0))):
        want = byte.to(torch.uint8).view(torch.int8).to(torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("i", range(4))
def test_e4m3_convert_equals_cast(rng, i):
    """K4's tiled e4m3 conversion at byte i gives every finite e4m3 code
    (the subnormals and both zeros too), in both halves, bit for bit as
    ``w.view(torch.float8_e4m3fn).to(torch.bfloat16)``."""
    vals = torch.tensor([v for v in range(256) if v & 0x7F != 0x7F], dtype=torch.int64)  # 0x7F / 0xFF: NaN
    a, b = _word_with_byte(rng, vals, i), _word_with_byte(rng, vals.flip(0), i)
    got_a, got_b = _e4m3x2_bf16(a, b, i)
    for got, byte in ((got_a, vals), (got_b, vals.flip(0))):
        want = byte.to(torch.uint8).view(torch.float8_e4m3fn).to(torch.bfloat16)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("i", range(4))
def test_w4a8_transpose_and_widen_equal_unpack_int4(rng, i):
    """K11's B registers: four words (packed rows q = 0..3, columns 0..3)
    transposed and widened. Every byte value reaches byte i of each row
    word; byte q of register column c must be 16 times ``unpack_int4``'s
    low / high nibble of row q, column c (exact in int8)."""
    vals = torch.arange(256, dtype=torch.int64)
    rows = [_word_with_byte(rng, (vals + 67 * q) % 256, i) for q in range(4)]
    packed = torch.stack([torch.stack([(w >> (8 * c)) & 0xFF for c in range(4)], -1) for w in rows], -2)
    lo, hi = t_quant.unpack_int4(packed.to(torch.uint8).view(torch.int8))  # (256, row q, column c)
    for c, word in enumerate(_transpose4(rows)):
        for got, want in zip(_nib16(word), (lo, hi)):
            got8 = torch.stack([(got >> (8 * q)) & 0xFF for q in range(4)], -1).to(torch.uint8).view(torch.int8)
            assert torch.equal(got8.to(torch.int32), 16 * want[:, :, c])


# ------------------------------------------------------------------ tiled kernels' fragment maps


def test_fragment_maps_cover_each_element_once():
    """Over the 32 lanes, K4's B registers hold each (k, column) of a k16 x
    32 band once, K10's each (k, column) of a k32 x 32 band once, K11's each
    (packed row, column) of a 32 x 32 chunk once, and the stores write each
    (row, column) of a 16 x 32 tile once, with every lane storing 8
    consecutive columns."""
    for fragment, k_rows in ((t_qmm.k4_b_fragment, 16), (t_qmm.k10_b_fragment, 32),
                             (t_qmm.k11_b_fragment, 32)):
        b = [v for lane in range(32) for v in fragment(lane)["b"].values()]
        assert sorted(b) == [(k, c) for k in range(k_rows) for c in range(32)]
        stores = [fragment(lane)["store"] for lane in range(32)]
        assert sorted(v for s in stores for v in s.values()) == [(r, c) for r in range(16) for c in range(32)]
        for lane, s in enumerate(stores):
            for row in (lane >> 2, (lane >> 2) + 8):
                cols = sorted(c for r, c in s.values() if r == row)
                assert cols == list(range(8 * (lane & 3), 8 * (lane & 3) + 8))


def _store_band(out, acc, c0, extra=None):
    """Each lane's accumulators of one 32-column band (acc: (M, tile i, 16
    rows of the m16 tile's row offsets folded in M, 8)) to the output
    columns its store map names: accumulator j of tile i is the mma's row g
    + 8 (j // 2), column 2t + j % 2."""
    m16 = out.shape[0] // 16
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for (i, j), (row, col) in t_qmm.k4_b_fragment(lane)["store"].items():
            vals = acc[:, i, g + 8 * (j // 2), 2 * t + j % 2]
            out[row::16][:m16, c0 + col] = vals if extra is None else vals * extra[c0 + col]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_k4_fragment_mma_matches_plain_and_jax(rng, mode):
    """K4's tiled kernel emulated in numpy through ``k4_b_fragment``: each
    k16 step's B registers filled by the map, the m16n8k16 product on the
    mma's own layout, the accumulators stored by the map, times the column
    scale. Within 1e-5 of the peak (fp32 sums in another order) of the
    plain twin and of JAX's ``quant_matmul`` in interpret mode."""
    m, k, n = 80, 256, 96
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(torch.bfloat16).float()
    w = rng.standard_normal((k, n), dtype=np.float32)
    wq = t_quant.quantize_weight(_t(w), mode)
    wf, scale = wq["w"].float().numpy(), wq["scale"].numpy()
    xt = x.numpy().reshape(m // 16, 16, k)
    out = np.zeros((m, n), np.float32)
    for c0 in range(0, n, 32):
        acc = np.zeros((m // 16, 4, 16, 8), np.float32)
        for k0 in range(0, k, 16):
            bv = np.zeros((4, 16, 8), np.float32)  # the mma's B of each n8 tile: (k, n)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for (i, r, e), (kk, col) in t_qmm.k4_b_fragment(lane)["b"].items():
                    bv[i, 2 * t + 8 * r + e, g] = wf[k0 + kk, c0 + col]
            acc += np.einsum("mrk,ikn->mirn", xt[:, :, k0:k0 + 16], bv)
        _store_band(out, acc, c0, scale)
    plain = t_qmm.quant_matmul_plain(x, wq["w"], wq["scale"]).numpy()
    jw = j_quant.quantize_weight(jnp.asarray(w), mode)
    ref = np.asarray(j_qmm.quant_matmul(jnp.asarray(x.numpy()), jw["w"], jw["scale"]))
    for want in (plain, ref):
        np.testing.assert_allclose(out, want, atol=REL_F32 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("group", [64, 128])
def test_k11_fragment_mma_matches_plain_and_jax(rng, group):
    """K11's W4A8 kernel emulated in numpy through ``k11_b_fragment``: each
    chunk's B registers filled by the map with the widened nibbles (16 n),
    the m16n8k32 products on the mma's layout in exact integers, each
    group's sums flushed times its scale in fp32, stored by the map, times
    rs / 16. The group sums must equal 16 times the exact integer products,
    and the output the plain twin's and JAX's ``quant_matmul_w4a8`` (in
    interpret mode) within 1e-5 of the peak."""
    m, k, n = 80, 256, 96
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32)
    wq = t_quant.quantize_weight_int4(_t(w), group)
    half = group // 2
    x8, rs = (v.numpy() for v in t_qmm.quantize_rows(_t(x)))
    lo, hi = (16 * v.numpy().astype(np.int64) for v in t_quant.unpack_int4(wq["w"]))
    scale = wq["scale"].numpy()
    xt = x8.astype(np.int64).reshape(m // 16, 16, k)
    facc = np.zeros((m, n), np.float32)
    for c0 in range(0, n, 32):
        fband = np.zeros((m // 16, 4, 16, 8), np.float32)
        for grp in range(k // group):
            gacc = np.zeros((m // 16, 4, 16, 8), np.int64)
            for off in range(0, half, 32):  # the group's chunks
                p0, x_lo = grp * half + off, grp * group + off
                b_lo, b_hi = np.zeros((4, 32, 8), np.int64), np.zeros((4, 32, 8), np.int64)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for (i, r, q), (prow, col) in t_qmm.k11_b_fragment(lane)["b"].items():
                        b_lo[i, 16 * r + 4 * t + q, g] = lo[p0 + prow, c0 + col]
                        b_hi[i, 16 * r + 4 * t + q, g] = hi[p0 + prow, c0 + col]
                gacc += np.einsum("mrk,ikn->mirn", xt[:, :, x_lo:x_lo + 32], b_lo)
                gacc += np.einsum("mrk,ikn->mirn", xt[:, :, x_lo + half:x_lo + half + 32], b_hi)
            sums = np.zeros((m, n), np.int64)
            _store_band(sums, gacc, c0)
            exact = (x8[:, grp * group:grp * group + half].astype(np.int64) @ lo[grp * half:(grp + 1) * half]
                     + x8[:, grp * group + half:(grp + 1) * group].astype(np.int64)
                     @ hi[grp * half:(grp + 1) * half])
            np.testing.assert_array_equal(sums[:, c0:c0 + 32], exact[:, c0:c0 + 32])
            sc = np.zeros((4, 8), np.float32)  # the group's scale at the mma's columns
            for lane in range(32):
                for (i, j), (_, col) in t_qmm.k4_b_fragment(lane)["store"].items():
                    sc[i, 2 * (lane & 3) + j % 2] = scale[grp, c0 + col]
            fband += gacc.astype(np.float32) * sc[None, :, None, :]
        _store_band(facc, fband, c0)
    out = facc * (rs * np.float32(0.0625))
    plain = t_qmm.quant_matmul_w4a8_plain(_t(x), wq["w"], wq["scale"]).numpy()
    jw = j_quant.quantize_weight_int4(jnp.asarray(w), group)
    ref = np.asarray(j_qmm.quant_matmul_w4a8(jnp.asarray(x), jw["w"], jw["scale"]))
    for want in (plain, ref):
        np.testing.assert_allclose(out, want, atol=REL_F32 * np.abs(want).max(), rtol=0)


def _emulate_w8a8(x8, rs, w8, scale):
    """K10's kernel (``qmm_w8a8_tiled``) in numpy, in fp32 out: each 128 x
    256 tile's ring stages of 128 K columns filled as its copies fill them
    (zeros past M, N and K), each k32 step's B registers through
    ``k10_b_fragment`` (the m16n8k32 product on the mma's layout, exact in
    int64), the steps past K skipped, the accumulators stored through the
    store map, then ``f32(acc) * rs[row] * s[col]`` in that order."""
    m, k = x8.shape
    n = w8.shape[1]
    bm, bn, sk = t_qmm.W8A8_TILE
    tiles_m, tiles_n, stages = t_qmm.w8a8_grid(m, k, n)
    # the mma's B (n8 tile i, k, column g) <- (row, column) of the step's band
    src_k, src_c = np.zeros((4, 32, 8), np.int64), np.zeros((4, 32, 8), np.int64)
    dst_r, dst_c = np.zeros((4, 16, 8), np.int64), np.zeros((4, 16, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        frag = t_qmm.k10_b_fragment(lane)
        for (i, r, q), (kk, col) in frag["b"].items():
            src_k[i, 16 * r + 4 * t + q, g], src_c[i, 16 * r + 4 * t + q, g] = kk, col
        for (i, j), (row, col) in frag["store"].items():  # accumulator j: the mma's row g + 8 (j // 2), column 2t + j % 2
            dst_r[i, g + 8 * (j // 2), 2 * t + j % 2], dst_c[i, g + 8 * (j // 2), 2 * t + j % 2] = row, col
    out = np.zeros((m, n), np.float32)
    for tm in range(tiles_m):
        for tn in range(tiles_n):
            m0, n0 = tm * bm, tn * bn
            acc = np.zeros((bm // 16, bn // 32, 4, 16, 8), np.int64)  # (m16 tile, band, n8 tile, row, column)
            for s in range(stages):
                a, b = np.zeros((bm, sk), np.int64), np.zeros((sk, bn), np.int64)
                rows, ks, cols = min(bm, m - m0), min(sk, k - s * sk), min(bn, n - n0)
                a[:rows, :ks] = x8[m0:m0 + rows, s * sk:s * sk + ks]
                b[:ks, :cols] = w8[s * sk:s * sk + ks, n0:n0 + cols]
                for j in range(sk // 32):
                    if s * sk + 32 * j >= k:
                        break
                    at = a[:, 32 * j:32 * j + 32].reshape(bm // 16, 16, 32)
                    for band in range(bn // 32):
                        bv = b[32 * j:32 * j + 32, 32 * band:32 * band + 32][src_k, src_c]
                        acc[:, band] += np.einsum("mrk,ikn->mirn", at, bv)
            tile = np.zeros((bm, bn), np.int64)
            for mt in range(bm // 16):
                for band in range(bn // 32):
                    tile[16 * mt + dst_r, 32 * band + dst_c] = acc[mt, band]
            rows, cols = min(bm, m - m0), min(bn, n - n0)
            out[m0:m0 + rows, n0:n0 + cols] = (tile[:rows, :cols].astype(np.float32) * rs[m0:m0 + rows]
                                               * scale[n0:n0 + cols])
    return out


@pytest.mark.parametrize("shape", [(200, 192, 384),  # a ragged row tile, half a column tile, K % 128 == 64
                                   (72, 256, 160)])  # one partial row tile, 5 of 8 column bands
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_k10_fragment_mma_matches_plain_and_jax(rng, shape, out_dtype):
    """K10 emulated in numpy (``_emulate_w8a8``) on the rows JAX's
    ``quantize_rows`` gives: byte for byte JAX's ``quant_matmul_w8a8`` (in
    interpret mode) and the plain twin, in fp32 and in bf16 out."""
    m, k, n = shape
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32)
    wq = t_quant.quantize_weight(_t(w), "int8")
    x8, rs = (v.numpy() for v in t_qmm.quantize_rows(_t(x)))
    out = torch.from_numpy(_emulate_w8a8(x8.astype(np.int64), rs, wq["w"].numpy().astype(np.int64),
                                         wq["scale"].numpy())).to(getattr(torch, out_dtype))
    jw = j_quant.quantize_weight(jnp.asarray(w), "int8")
    ref = j_qmm.quant_matmul_w8a8(jnp.asarray(x), jw["w"], jw["scale"], out_dtype=jnp.dtype(out_dtype))
    plain = t_qmm.quant_matmul_w8a8_plain(_t(x), wq["w"], wq["scale"], out_dtype=getattr(torch, out_dtype))
    bits = torch.int32 if out_dtype == "float32" else torch.int16
    assert torch.equal(out.view(bits), plain.view(bits))
    assert torch.equal(out.view(bits), bridge.tensor_from_numpy(np.asarray(ref)).view(bits))


# (K, N) of the W8A8 projections: 7B-GQA's four layer shapes and a TP-4
# rank's shards of them (phase 14: column shards N 1536 and 5504, row shards
# K 1024 and 2752)
W8A8_SHAPES = [(4096, 6144), (4096, 4096), (4096, 22016), (11008, 4096),
               (4096, 1536), (1024, 4096), (4096, 5504), (2752, 4096)]


@pytest.mark.parametrize("k,n", W8A8_SHAPES)
def test_w8a8_grid_takes_the_main_path_shapes(k, n):
    """The wrapper's geometry takes every main-path and phase-14 shape at
    2048 and 300 rows: the tiles cover the output with at most one partial
    row and column tile, and the stages cover K (half the last one when K %
    128 == 64, as N 5504's last column tile is half)."""
    bm, bn, sk = t_qmm.W8A8_TILE
    for m in (2048, 300):
        tiles_m, tiles_n, stages = t_qmm.w8a8_grid(m, k, n)
        assert (tiles_m - 1) * bm < m <= tiles_m * bm and (tiles_n - 1) * bn < n <= tiles_n * bn
        assert (stages - 1) * sk < k <= stages * sk
    for bad in ((96, 64), (128, 48)):
        with pytest.raises(ValueError, match="multiple"):
            t_qmm.w8a8_grid(16, *bad)


# ------------------------------------------------------------------ the split-K form (M <= 64)

# (m, k, n, group) at the main path's decode rows: 7B's five shapes (int8 and
# int4 g128), their TP-4 shards (int4 at g64), DeepSeek-V2-Lite's int4 experts
# and wo, Mixtral's int8 experts, ModelConfig.tiny's projections
SMALL_M_SHAPES = {
    **{f"7b_{name}{'_int4' if g else ''}": (16, k, n, g) for name, k, n in (
        ("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gate_up", 4096, 22016), ("w_down", 11008, 4096),
        ("lm_head", 4096, 32000)) for g in (None, 128)},
    **{f"tp4_{name}{'_int4' if g else ''}": (16, k, n, g) for name, k, n in (
        ("wqkv", 4096, 1536), ("wo", 1024, 4096), ("w_gate_up", 4096, 5504), ("w_down", 2752, 4096))
       for g in (None, 64)},
    "tp4_lm_head": (16, 4096, 8000, None),
    "dsv2_gate_up": (4, 2048, 2816, 128), "dsv2_down": (4, 1408, 2048, 128), "dsv2_wo": (4, 2048, 2048, 128),
    "mixtral_gate_up": (4, 4096, 28672, None), "mixtral_down": (4, 14336, 4096, None),
    **{f"tiny_{name}{'_int4' if g else ''}": (16, k, n, g and t_quant.default_int4_group(k))
       for name, k, n in (("wqkv", 64, 128), ("wo", 64, 64), ("w_gate_up", 64, 256), ("w_down", 128, 64),
                          ("lm_head", 64, 256)) for g in (None, 1)},
}


@pytest.mark.parametrize("name", sorted(SMALL_M_SHAPES))
def test_small_m_grid_covers_k_and_reaches_its_target(name):
    """At every main-path shape, with 132 SMs: the bands cover the columns;
    every k16 step (int4: every whole group) falls in exactly one split; the
    blocks fit one wave of three an SM (one split where the bands alone fill
    it), and no more splits would, unless each split is already one unit or
    the shortest a split may be (4 weight rows a staged x row); the splits
    are as even as whole units allow."""
    m, k, n, group = SMALL_M_SHAPES[name]
    bands, splits, split = t_qmm.small_m_grid(m, k, n, group, sms=132)
    unit = group or 16
    assert (bands - 1) * t_qmm.SMALL_M_BAND < n <= bands * t_qmm.SMALL_M_BAND
    assert split % unit == 0 and k % unit == 0
    owner = np.full(k // unit, -1)
    for sp in range(splits):
        units = range(sp * split // unit, min((sp + 1) * split, k) // unit)
        assert len(units) > 0 and (owner[units.start:units.stop] == -1).all()
        owner[units.start:units.stop] = sp
    assert (owner >= 0).all()
    per, steps, target = split // unit, k // unit, 3 * 132
    shortest = min(steps, -(-4 * t_qmm.small_m_rows(m) // (unit // 2 if group else unit)))
    assert per >= shortest
    assert bands * splits <= max(target, bands)
    if per > shortest:
        assert bands * -(-steps // (per - 1)) > target
    assert per == -(-steps // splits)  # the splits as even as whole units allow


def _split_k_tables():
    """The split-K form's fragment maps as the mma's own tables: a[row, k] =
    (k, column) of the weights, b[k, n] = (k, x row), c[row, n] = (x row,
    column), each cell filled by exactly one (lane, register, half)."""
    a, b, c = np.full((16, 16, 2), -1), np.full((16, 8, 2), -1), np.full((16, 8, 2), -1)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        frag = t_qmm.small_m_fragment(lane)
        cells = ([(a, g + 8 * (r & 1), 2 * t + 8 * (r >> 1) + h, v) for (r, h), v in frag["a"].items()]
                 + [(b, 2 * t + 8 * r + h, g, v) for (r, h), v in frag["b"].items()]
                 + [(c, g + 8 * (i >> 1), 2 * t + (i & 1), v) for i, v in frag["acc"].items()])
        for table, i, j, v in cells:
            assert (table[i, j] == -1).all()
            table[i, j] = v
    return a, b, c


def test_small_m_fragment_map_covers_each_element_once():
    """Over the 32 lanes the split-K form's A registers hold each (k, column)
    of a k16 x 16 weight tile once, its B registers each (k, x row) of a k16
    x 8 tile once, and its accumulators each (x row, column) once. Each A
    row is one column at every k, and C's row is that column: the kernel's
    column permutation is one permutation throughout."""
    a, b, c = _split_k_tables()
    assert sorted(map(tuple, a.reshape(-1, 2))) == [(k, col) for k in range(16) for col in range(16)]
    assert sorted(map(tuple, b.reshape(-1, 2))) == [(k, r) for k in range(16) for r in range(8)]
    assert sorted(map(tuple, c.reshape(-1, 2))) == [(r, col) for r in range(8) for col in range(16)]
    assert (a[:, :, 0] == np.arange(16)).all() and (b[:, :, 0] == np.arange(16)[:, None]).all()
    perm = a[:, 0, 1]
    assert (a[:, :, 1] == perm[:, None]).all() and (c[:, :, 1] == perm[:, None]).all()
    assert (b[:, :, 1] == np.arange(8)).all() and (c[:, :, 0] == np.arange(8)).all()


def _emulate_split_k(x, w, scale, group, splits):
    """The split-K kernel in numpy through ``small_m_fragment``: for each
    band, split and warp (16 columns), each k16 step's (int4: each
    chunk's low and high) m16n8k16 products on the mma's tables in fp32;
    int4 flushes each group's partial times its scale at the group's end.
    Each band sums its splits' fp32 partials in split order; int8 / fp8 then
    multiply by the column scale. ``w``: the weight values (K, N), or for
    int4 the (lo, hi) nibble matrices (K/2, N)."""
    a, b, c = _split_k_tables()
    m, k = x.shape
    n = scale.shape[-1]
    rows = t_qmm.small_m_rows(m)
    xp = np.zeros((rows, k), np.float32)
    xp[:m] = x
    band_n = t_qmm.SMALL_M_BAND
    bands, n_splits, split = t_qmm.small_m_grid(m, k, n, group, splits=splits)
    out = np.zeros((m, bands * band_n), np.float32)

    def b_tile(col0):  # B of every n8 tile at x columns col0 .. + 15: (16, rows)
        return np.concatenate([xp[8 * jn + b[:, :, 1], col0 + b[:, :, 0]] for jn in range(rows // 8)], axis=1)

    for band in range(bands):
        parts = []
        for sp in range(n_splits):
            acc = np.zeros((rows, band_n), np.float32)
            for w0 in range(0, band_n, 16):
                c0 = band * band_n + w0
                if c0 >= n:
                    continue
                wacc = np.zeros((16, rows), np.float32)  # C: (the A row's column, x row)
                if group is None:
                    for k0 in range(sp * split, min((sp + 1) * split, k), 16):
                        wacc += w[k0 + a[:, :, 0], c0 + a[:, :, 1]] @ b_tile(k0)
                else:
                    lo, hi = w
                    half = group // 2
                    gacc = np.zeros((16, rows), np.float32)
                    for p0 in range(sp * split // 2, min((sp + 1) * split, k) // 2, 16):
                        grp = p0 // half
                        xlo = grp * group + p0 - grp * half
                        gacc += lo[p0 + a[:, :, 0], c0 + a[:, :, 1]] @ b_tile(xlo)
                        gacc += hi[p0 + a[:, :, 0], c0 + a[:, :, 1]] @ b_tile(xlo + half)
                        if (p0 + 16) % half == 0:
                            wacc += gacc * scale[grp, c0 + a[:, 0, 1]][:, None]
                            gacc[:] = 0
                for jn in range(rows // 8):
                    acc[8 * jn + c[:, :, 0], w0 + c[:, :, 1]] = wacc[:, 8 * jn:8 * jn + 8]
            parts.append(acc)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        cols = slice(band * band_n, (band + 1) * band_n)
        out[:, cols] = total[:m]
        if group is None:
            out[:, cols] *= np.pad(scale, (0, bands * band_n - n))[cols]
    return out[:, :n]


@pytest.mark.parametrize("m", [1, 4, 16, 40, 64])
@pytest.mark.parametrize("mode,group,k", [("int8", None, 352), ("fp8", None, 352), ("int4", 32, 352),
                                          ("int4", 128, 1408)])
def test_split_k_emulation_matches_plain_and_jax(rng, m, mode, group, k):
    """The split-K form's order, emulated in numpy (``_emulate_split_k``) at
    3 splits with a ragged last one (K 352: 22 k16 steps as 8 + 8 + 6, or
    11 g32 groups as 4 + 4 + 3; K 1408: 11 g128 groups) over a full and a
    partial band (N 160): within 1e-5 of the peak (fp32 sums of the same
    exact products in another order) of the plain twin and of JAX's
    ``quant_matmul`` / ``quant_matmul_int4`` in interpret mode."""
    n = 160
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(torch.bfloat16).float()
    w = rng.standard_normal((k, n), dtype=np.float32)
    if mode == "int4":
        wq = t_quant.quantize_weight_int4(_t(w), group)
        vals = tuple(v.float().numpy() for v in t_quant.unpack_int4(wq["w"]))
        plain = t_qmm.quant_matmul_int4_plain(x, wq["w"], wq["scale"]).numpy()
        jw = j_quant.quantize_weight_int4(jnp.asarray(w), group)
        ref = np.asarray(j_qmm.quant_matmul_int4(jnp.asarray(x.numpy()), jw["w"], jw["scale"]))
    else:
        wq = t_quant.quantize_weight(_t(w), mode)
        vals = wq["w"].float().numpy()
        plain = t_qmm.quant_matmul_plain(x, wq["w"], wq["scale"]).numpy()
        jw = j_quant.quantize_weight(jnp.asarray(w), mode)
        ref = np.asarray(j_qmm.quant_matmul(jnp.asarray(x.numpy()), jw["w"], jw["scale"]))
    assert t_qmm.small_m_grid(m, k, n, group, splits=3)[1:] == (3, (k // (group or 16) + 2) // 3 * (group or 16))
    out = _emulate_split_k(x.numpy(), vals, wq["scale"].numpy(), group, 3)
    for want in (plain, ref):
        np.testing.assert_allclose(out, want, atol=REL_F32 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bytes_identical(rng, dtype):
    x = (rng.standard_normal((7, 96), dtype=np.float32) * np.array([[1e-3], [1], [30], [0], [1],
                                                                    [5], [1e-8]], np.float32))
    x = x.astype(jnp.dtype(dtype))
    x8_ref, rs_ref = j_qmm.quantize_rows(jnp.asarray(x))
    x8, rs = t_qmm.quantize_rows(bridge.tensor_from_numpy(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(x8_ref))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_ref))


# ------------------------------------------------------------------ matmul entries


def _compare(out, ref, out_dtype):
    ref = np.asarray(ref).astype(np.float32)
    rel = REL_F32 if out_dtype == "float32" else REL_BF16
    assert out.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(bridge.tensor_to_numpy(out), ref, atol=rel * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("entry", ["int4", "w4a8"])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int4_matmuls_match_jax(rng, entry, stacked, out_dtype):
    """Weight-only int4 (K6) and W4A8 (K11), three groups of 128."""
    m, h, o = 6, 384, 40
    w = rng.standard_normal((2, h, o) if stacked else (h, o), dtype=np.float32)
    x = rng.standard_normal((m, h), dtype=np.float32)
    jw = j_quant.quantize_weight_int4(jnp.asarray(w))
    tw = t_quant.quantize_weight_int4(_t(w))
    layer = 1 if stacked else None
    name = "quant_matmul_" + entry
    ref = getattr(j_qmm, name)(jnp.asarray(x), jw["w"], jw["scale"], layer=layer,
                               out_dtype=jnp.dtype(out_dtype))
    out = getattr(t_qmm, name)(_t(x), tw["w"], tw["scale"], layer=layer,
                               out_dtype=getattr(torch, out_dtype))
    _compare(out, ref, out_dtype)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_matches_jax(rng, stacked, out_dtype):
    """K10: exact integer sums on both sides, then the same two fp32 multiplies."""
    m, h, o = 9, 128, 48
    w = rng.standard_normal((3, h, o) if stacked else (h, o), dtype=np.float32)
    x = rng.standard_normal((m, h), dtype=np.float32)
    jw = j_quant.quantize_weight(jnp.asarray(w), "int8")
    tw = t_quant.quantize_weight(_t(w), "int8")
    layer = 2 if stacked else None
    ref = j_qmm.quant_matmul_w8a8(jnp.asarray(x), jw["w"], jw["scale"], layer=layer,
                                  out_dtype=jnp.dtype(out_dtype))
    out = t_qmm.quant_matmul_w8a8(_t(x), tw["w"], tw["scale"], layer=layer,
                                  out_dtype=getattr(torch, out_dtype))
    _compare(out, ref, out_dtype)


def test_w8a8_refuses_fp8_weights(rng):
    tw = t_quant.quantize_weight(_t(rng.standard_normal((64, 32), dtype=np.float32)), "fp8")
    with pytest.raises(ValueError, match="int8"):
        t_qmm.quant_matmul_w8a8(torch.zeros(2, 64), tw["w"], tw["scale"])


@pytest.mark.parametrize("group,multiple,ok", [(128, 16, True), (64, 32, True), (32, 32, False),
                                               (48, 16, False)])
def test_int4_kernel_geometry_checks(group, multiple, ok):
    """The CUDA wrappers' geometry rule (checked before any launch): group/2
    a multiple of 16 (K6) or 32 (K11), O a multiple of 32."""
    w = t_quant.quantize_weight_int4(torch.randn(2, 384, 64), group)
    x = torch.zeros(4, 384)
    if ok:
        assert t_qmm._int4_geometry("k", x, w["w"], w["scale"], multiple) == (4, 384, 64, group // 2)
    else:
        with pytest.raises(ValueError, match="group/2"):
            t_qmm._int4_geometry("k", x, w["w"], w["scale"], multiple)


# ------------------------------------------------------------------ model: int4, W8A8 / W4A8 prefill


def _cfgs(**kw):
    return j_params.ModelConfig.tiny(dtype="float32", **kw), t_params.ModelConfig.tiny(dtype="float32", **kw)


def _quantized_models(mode):
    jc, _ = _cfgs()
    params = j_llama.quantize_model_weights(j_llama.init_params(jc, jax.random.PRNGKey(0)), mode,
                                            lm_head=True)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params))


def test_quantize_model_weights_int4_matches_jax():
    """Bytes identical; scales within one fp32 ulp (JAX jit-compiles this
    step, see tests/test_torch_llama.py)."""
    jc, _ = _cfgs()
    dense = j_llama.init_params(jc, jax.random.PRNGKey(0))
    ref = j_llama.quantize_model_weights(dense, "int4", lm_head=True, int4_group=32)
    out = t_llama.quantize_model_weights(bridge.params_from_numpy(jax.tree.map(np.asarray, dense)),
                                         "int4", lm_head=True, int4_group=32)
    pairs = [(out["layers"][n], ref["layers"][n]) for n in ("wqkv", "wo", "w_gate_up", "w_down")]
    for got, want in pairs + [(out["lm_head"], ref["lm_head"])]:
        assert got["scale"].shape == tuple(want["scale"].shape)
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        np.testing.assert_array_max_ulp(got["scale"].numpy(), np.asarray(want["scale"]), maxulp=1)


def test_init_params_int4_layout_matches_jax():
    jc, tc = _cfgs()
    jp = j_llama.init_params(jc, jax.random.PRNGKey(0), quantize="int4", int4_group=64)
    tp = t_llama.init_params(tc, torch.Generator().manual_seed(0), quantize="int4", int4_group=64,
                             device="cpu")
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp) == shapes


def _prefill_logits(mode, w8a8):
    """Prefill logits of a 4 x 64-row prompt batch (256 rows: W8A8 routes)."""
    jc, tc = _cfgs(w8a8_prefill=w8a8)
    jp, tp = _quantized_models(mode)
    prompts = np.random.default_rng(3).integers(0, 256, (4, 64)).astype(np.int32)
    lengths = np.array([64, 50, 9, 33], np.int32)
    jcache = j_cache.init_cache(2, 4, 2, 128, 16, dtype=jnp.float32)
    ref, _ = j_llama.prefill(jp, jcache, jnp.asarray(prompts), jnp.asarray(lengths),
                             *j_llama.rope_tables(jc), jc)
    tcache = t_cache.init_cache(2, 4, 2, 128, 16, dtype=torch.float32, device="cpu")
    out, _ = t_llama.prefill(tp, tcache, _t(prompts), _t(lengths), *t_llama.rope_tables(tc, "cpu"), tc)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_w8a8_prefill_logits_match_jax(mode):
    """W8A8 (int8 weights) and W4A8 (int4) prefill logits, and that the
    option really changes them (the rows took the int8-activation path)."""
    out, ref = _prefill_logits(mode, True)
    np.testing.assert_allclose(out, ref, atol=LOGIT_ATOL, rtol=0)
    weight_only, _ = _prefill_logits(mode, False)
    assert np.abs(out - weight_only).max() > 10 * LOGIT_ATOL


def test_w8a8_routing_counts_launch_sites():
    """Which entry each projection takes: >= 256 rows and int8-dtype weights
    go to W8A8 / W4A8 under the option; decode rows, the lm_head and fp8
    weights stay weight-only."""
    calls = []
    names = ("quant_matmul", "quant_matmul_int4", "quant_matmul_w8a8", "quant_matmul_w4a8")
    saved = {n: getattr(t_llama, n) for n in names}

    def spy(name):
        def fn(x, *a, **k):
            calls.append((name, x.shape[0]))
            return saved[name](x, *a, **k)
        return fn

    for n in names:
        setattr(t_llama, n, spy(n))
    try:
        for mode, want in (("int8", "quant_matmul_w8a8"), ("int4", "quant_matmul_w4a8"),
                           ("fp8", "quant_matmul")):
            _, tc = _cfgs(w8a8_prefill=True)
            tp = t_llama.init_params(tc, torch.Generator().manual_seed(0), quantize=mode,
                                     device="cpu")
            tp = t_llama.quantize_model_weights(tp, mode, lm_head=True)
            calls.clear()
            t_llama.generate(tp, tc, np.zeros((4, 64), np.int32), np.full((4,), 64), 2, device="cpu")
            prefill_layers = [c for c in calls if c[1] == 256]
            assert {c[0] for c in prefill_layers} == {want} and len(prefill_layers) == 4 * tc.num_layers
            weight_only = "quant_matmul_int4" if mode == "int4" else "quant_matmul"
            assert {c[0] for c in calls if c[1] == 4} == {weight_only}  # lm_head and decode rows
    finally:
        for n, fn in saved.items():
            setattr(t_llama, n, fn)


# ------------------------------------------------------------------ quantized KV caches


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_appends_match_jax(rng, mode):
    """Decode and prefill appends quantize against the fixed scales: the
    same bytes as the JAX cache."""
    jc = j_cache.init_cache(2, 3, 2, 32, 16, quant_mode=mode, calibration_scale=5.0)
    tc = t_cache.init_cache(2, 3, 2, 32, 16, quant_mode=mode, calibration_scale=5.0, device="cpu")
    np.testing.assert_array_equal(tc.k_scales.numpy(), np.asarray(jc.k_scales))
    chunk = rng.standard_normal((3, 2, 8, 16), dtype=np.float32) * 3.0  # some values clip
    jc = j_cache.append_prefill(jc, 1, jnp.asarray(chunk), jnp.asarray(chunk[::-1].copy()))
    t_cache.append_prefill(tc, 1, _t(chunk), _t(chunk[::-1].copy()))
    jc = j_cache.advance(jc, 8)
    t_cache.advance(tc, 8)
    row = rng.standard_normal((3, 2, 16), dtype=np.float32) * 3.0
    jc = j_cache.append_decode(jc, 0, jnp.asarray(row), jnp.asarray(-row))
    t_cache.append_decode(tc, 0, _t(row), _t(-row))
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        assert got.dtype == (torch.int8 if mode == "int8" else torch.float8_e4m3fn)
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_page_pools_match_jax(rng, mode):
    jc = j_paged.init_paged_cache(2, 2, 2, 16, num_pages=9, page_size=8, pages_per_seq=4,
                                  quant_mode=mode, calibration_scale=5.0)
    tc = t_paged.init_paged_cache(2, 2, 2, 16, num_pages=9, page_size=8, pages_per_seq=4,
                                  quant_mode=mode, calibration_scale=5.0, device="cpu")
    assert tc.quant_mode == mode and tc.k_pages.dtype == bridge.tensor_from_numpy(
        np.asarray(jc.k_pages)).dtype
    np.testing.assert_array_equal(tc.v_scales.numpy(), np.asarray(jc.v_scales))
    table = np.array([[3, 1, 0, 0], [5, 2, 7, 0]], np.int32)
    lengths = np.array([9, 17], np.int32)
    jc = dataclasses.replace(jc, page_table=jnp.asarray(table), lengths=jnp.asarray(lengths))
    tc.page_table.copy_(_t(table))
    tc.lengths.copy_(_t(lengths))
    row = rng.standard_normal((2, 2, 16), dtype=np.float32) * 3.0
    jc = j_paged.append_decode_paged(jc, 1, jnp.asarray(row), jnp.asarray(row * 0.5))
    t_paged.append_decode_paged(tc, 1, _t(row), _t(row * 0.5))
    for got, want in ((tc.k_pages, jc.k_pages), (tc.v_pages, jc.v_pages)):
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), np.asarray(want).view(np.uint8))


def test_unknown_kv_quant_mode_raises():
    with pytest.raises(ValueError, match="quant mode"):
        t_paged.init_paged_cache(1, 1, 1, 16, num_pages=3, page_size=8, pages_per_seq=2,
                                 quant_mode="int4", device="cpu")


# ------------------------------------------------------------------ bridge


def test_bridge_round_trips_int4_params():
    jp, tp = _quantized_models("int4")
    back = bridge.params_to_numpy(tp)
    for name in ("wqkv", "w_down"):
        np.testing.assert_array_equal(back["layers"][name]["w"], np.asarray(jp["layers"][name]["w"]))
        np.testing.assert_array_equal(back["layers"][name]["scale"], np.asarray(jp["layers"][name]["scale"]))
    assert t_quant.is_int4_weight(tp["lm_head"]) and tp["lm_head"]["w"].dtype == torch.int8
    again = bridge.params_from_numpy(back)
    assert torch.equal(again["lm_head"]["w"], tp["lm_head"]["w"])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_bridge_round_trips_quantized_caches(rng, mode):
    jc = j_cache.init_cache(2, 3, 2, 16, 8, quant_mode=mode, calibration_scale=5.0)
    jc = j_cache.append_prefill(jc, 0, jnp.asarray(rng.standard_normal((3, 2, 4, 8), dtype=np.float32)),
                                jnp.asarray(rng.standard_normal((3, 2, 4, 8), dtype=np.float32)))
    tc = bridge.cache_from_numpy(np.asarray(jc.k), np.asarray(jc.v), np.asarray(jc.lengths),
                                 np.asarray(jc.k_scales), np.asarray(jc.v_scales))
    assert tc.quant_mode == mode
    back = bridge.cache_to_numpy(tc)
    for name in ("k", "v", "lengths", "k_scales", "v_scales"):
        np.testing.assert_array_equal(back[name], np.asarray(getattr(jc, name)))
    again = bridge.cache_from_numpy(**back)
    assert torch.equal(again.k.view(torch.uint8), tc.k.view(torch.uint8))

    jp = j_paged.init_paged_cache(2, 3, 2, 8, num_pages=5, page_size=4, pages_per_seq=2,
                                  quant_mode=mode, calibration_scale=5.0)
    tp = bridge.paged_cache_from_numpy(**{n: np.asarray(getattr(jp, n)) for n in bridge.PAGED_FIELDS})
    assert tp.quant_mode == mode and tp.k_scales is not None
    back = bridge.paged_cache_to_numpy(tp)
    for name in bridge.PAGED_FIELDS:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(jp, name)))
