"""The port's fused quantized MLP (kernel K13's plain twin, which CPU
tensors take) against the JAX package's ``ops.fused_mlp.fused_mlp`` (its
Pallas kernel in interpret mode), on the CPU.

Twins of the three tests of ``tests/test_fused_mlp.py`` (the geometries,
stacked layers, the TPU block sizes, which change nothing in the port),
plus fp8 weights, bf16 activations and the refusals. The inputs are seeded
numpy arrays quantized by the JAX package; the same bytes go to both.

The CUDA kernel's bf16-x form runs each phase on K4's split-K plan; its
Python twins (``split_plan``, ``band_columns``, with
``quant_matmul.small_m_fragment``'s register map) are held here too: the
plans at the main path's shapes, the pairing of each gate column with its
up column in one band, and a numpy emulation of the kernel's sums (each
split's fp32 partial, the splits added in split order, the scales, silu *
up rounded to bf16, then the down phase the same way) against JAX.

Tolerances: fp32 activations, JAX's own: rtol 2e-5 and atol 2e-5 times
max(peak, 1) (the fp32 sums of the same exact products run in another
order). bf16 activations: ``act`` is rounded to bf16 between the two
matmuls, and an fp32 sum in another order may round it to the other side
of a tie, which moves the output by one bf16 ulp of that activation times
its weight row; 4e-3 of the output's peak bounds that.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu.ops.fused_mlp import fused_mlp as j_fused_mlp
from starflashattention_tpu_torch.ops import quant_matmul as qmm
from starflashattention_tpu_torch.ops.fused_mlp import band_columns, fused_mlp, fused_mlp_plain, split_plan

torch.set_num_threads(1)

BF16_REL = 4e-3


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":  # numpy has no fp8 that torch reads: cross as bytes
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int32)).to(torch.int16).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assert_close(got, want, x_dtype=jnp.float32):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if x_dtype == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * max(scale, 1.0))
    else:
        assert np.abs(got - want).max() <= BF16_REL * scale, np.abs(got - want).max() / scale


def _weights(rng, h, inter, mode="int8"):
    q1 = j_quant.quantize_weight(jnp.asarray(rng.standard_normal((h, 2 * inter)), jnp.float32), mode)
    q2 = j_quant.quantize_weight(jnp.asarray(rng.standard_normal((inter, h)), jnp.float32), mode)
    return q1["w"], q1["scale"], q2["w"], q2["scale"]


def _both(x, w1, s1, w2, s2, **kw):
    """(JAX's result, the port's) on the same bytes."""
    want = j_fused_mlp(x, w1, s1, w2, s2, **kw)
    tkw = {k: (int(v) if k == "layer" else v) for k, v in kw.items()}
    got = fused_mlp(*(_t(a) for a in (x, w1, s1, w2, s2)), **tkw)
    assert got.dtype == torch.float32
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("h,inter,b", [(64, 128, 4), (256, 384, 8), (128, 128, 2)])
def test_fused_mlp_matches_jax(rng, h, inter, b):
    """Twin of ``test_fused_mlp_matches_reference``."""
    x = jnp.asarray(rng.standard_normal((b, h)), jnp.float32)
    want, got = _both(x, *_weights(rng, h, inter))
    _assert_close(got, want)


def test_fused_mlp_stacked_layers(rng):
    """Twin of ``test_fused_mlp_stacked_layers``: (L, ...) stacks and a layer
    index."""
    h, inter, b, n_layers = 64, 128, 4, 3
    x = jnp.asarray(rng.standard_normal((b, h)), jnp.float32)
    layers = [_weights(rng, h, inter) for _ in range(n_layers)]
    w1, s1, w2, s2 = (jnp.stack([lw[i] for lw in layers]) for i in range(4))
    for layer in range(n_layers):
        want, got = _both(x, w1, s1, w2, s2, layer=jnp.asarray(layer))
        _assert_close(got, want)


def test_fused_mlp_block_geometry(rng):
    """Twin of ``test_fused_mlp_block_geometry``: the TPU tilings are
    accepted and change nothing in the port."""
    h, inter, b = 256, 256, 4
    x = jnp.asarray(rng.standard_normal((b, h)), jnp.float32)
    w = _weights(rng, h, inter)
    base = fused_mlp(*(_t(a) for a in (x, *w))).numpy()
    for bh, bo in [(128, 128), (256, 256), (128, 256)]:
        want, got = _both(x, *w, block_h=bh, block_o=bo)
        _assert_close(got, want)
        np.testing.assert_array_equal(got, base)


@pytest.mark.parametrize("mode,x_dtype", [("fp8", jnp.float32), ("int8", jnp.bfloat16),
                                          ("fp8", jnp.bfloat16)])
def test_fused_mlp_fp8_and_bf16(rng, mode, x_dtype):
    """fp8 e4m3 weights, and bf16 activations (``act`` rounded to bf16
    between the matmuls, as the TPU kernel's scratch holds it)."""
    h, inter, b = 128, 256, 6
    x = jnp.asarray(rng.standard_normal((b, h)), x_dtype)
    w = _weights(rng, h, inter, mode)
    assert w[0].dtype == (jnp.int8 if mode == "int8" else jnp.float8_e4m3fn)
    want, got = _both(x, *w)
    _assert_close(got, want, x_dtype)


def test_fused_mlp_plain_is_the_cpu_route(rng):
    """A CPU tensor takes the plain twin and counts no launch."""
    h, inter = 64, 64
    w = [_t(a) for a in _weights(rng, h, inter)]
    x = torch.from_numpy(rng.standard_normal((3, h)).astype(np.float32))
    before = fused_mlp.launches
    assert torch.equal(fused_mlp(x, *w), fused_mlp_plain(x, *w))
    assert fused_mlp.launches == before


def test_fused_mlp_refusals(rng):
    """Stacked weights without a layer, weights that are not 8-bit, and
    weights of two dtypes are refused on every device."""
    h, inter = 64, 64
    w1, s1, w2, s2 = (_t(a) for a in _weights(rng, h, inter))
    x = torch.zeros((2, h))
    with pytest.raises(ValueError, match="layer index required"):
        fused_mlp(x, w1[None], s1[None], w2[None], s2[None])
    with pytest.raises(ValueError, match="int8 / fp8 weights"):
        fused_mlp(x, w1.float(), s1, w2.float(), s2)
    with pytest.raises(ValueError, match="int8 / fp8 weights"):
        fused_mlp(x, w1, s1, w2.view(torch.float8_e4m3fn), s2)


# ----------------------------------------------------------------- the bf16-x kernel's plan


@pytest.mark.parametrize("b", [1, 16, 64, 100])
@pytest.mark.parametrize("inter", [11008, 2752])
def test_split_plan_takes_the_main_path_shapes(b, inter):
    """7B-GQA's MLP and a TP-4 shard's: row tiles of up to 64 rows; phase 1
    in bands of 64 gate and 64 up columns over splits of H, phase 2 in bands
    of 128 columns over splits of I; splits of whole k16 steps that cover K
    once; at most one wave of three blocks an SM a phase and row tile."""
    h = 4096
    plan = split_plan(b, h, inter)
    rows, tiles = plan["rows"], plan["row_tiles"]
    assert rows == qmm.small_m_rows(min(b, 64)) and (tiles - 1) * rows < b <= tiles * rows
    for (bands, splits, split), k, n in ((plan["gate_up"], h, 2 * inter), (plan["down"], inter, h)):
        assert bands == -(-n // qmm.SMALL_M_BAND) and split % 16 == 0
        assert (splits - 1) * split < k <= splits * split
        assert bands * splits <= qmm.SMALL_M_BLOCKS_PER_SM * 132
    assert plan["gate_up"][0] == inter // 64  # a band a 64-column pair


@pytest.mark.parametrize("inter", [64, 384, 2752, 11008])
def test_band_columns_pair_gate_and_up(inter):
    """The bands cover w1's 2 I columns once; position c of a band is a
    gate column and position 64 + c its up column."""
    cols = [c for band in range(inter // 64) for c in band_columns(band, inter)]
    assert sorted(cols) == list(range(2 * inter))
    for band in range(inter // 64):
        bc = band_columns(band, inter)
        assert bc[:64] == list(range(64 * band, 64 * band + 64))
        assert [c + inter for c in bc[:64]] == bc[64:]


def test_fragment_map_holds_a_band_whole():
    """Through small_m_fragment, the 8 warps' accumulators hold each x row
    of an n8 tile at each of the band's 128 positions once: warps 0-3 the
    gate half, 4-7 the up half, so the band's last block has both halves of
    every activation it writes."""
    held = collections.Counter()
    for warp in range(8):
        for lane in range(32):
            for _, (row, col) in small_m_fragment_acc(lane):
                pos = 16 * warp + col
                assert (pos < 64) == (warp < 4)
                held[(row, pos)] += 1
    assert set(held) == {(r, p) for r in range(8) for p in range(128)} and set(held.values()) == {1}


def small_m_fragment_acc(lane):
    return qmm.small_m_fragment(lane)["acc"].items()


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _emulate(x, w1, s1, w2, s2, plan):
    """The bf16-x kernel's sums in numpy: a row tile, band and split at a
    time, each split's partial in fp32, the splits added in split order, the
    column scales on the sum; phase 1's band pairs gate and up, whose silu *
    up is rounded to bf16 into act; phase 2 the same over act."""
    b, h = x.shape
    inter = w2.shape[0]
    rows = plan["rows"]
    act = np.zeros((b, inter), np.float32)
    out = np.zeros((b, h), np.float32)

    def band_sum(a, w, cols, splits, split):
        acc = None
        for sp in range(splits):
            k = slice(sp * split, (sp + 1) * split)
            part = a[:, k] @ w[k][:, cols]
            acc = part if acc is None else (acc + part).astype(np.float32)
        return acc

    for rt in range(plan["row_tiles"]):
        r = slice(rt * rows, (rt + 1) * rows)
        bands, splits, split = plan["gate_up"]
        for band in range(bands):
            cols = band_columns(band, inter)
            gu = band_sum(x[r], w1, cols, splits, split) * s1[cols]
            gate, up = gu[:, :64], gu[:, 64:]
            with np.errstate(over="ignore"):  # exp(-gate) past fp32: silu 0, as expf gives it
                act[r, 64 * band:64 * band + 64] = _bf16(gate / (1 + np.exp(-gate)) * up)
        bands, splits, split = plan["down"]
        for band in range(bands):
            cols = list(range(128 * band, min(128 * band + 128, h)))
            out[r, cols] = band_sum(act[r], w2, cols, splits, split) * s2[cols]
    return out


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("b,h,inter,sms", [(6, 256, 384, 132), (16, 192, 320, 4), (64, 512, 256, 132),
                                           (100, 1024, 128, 8)])
def test_split_k_sum_order_matches_jax(rng, mode, b, h, inter, sms):
    """The emulation of the kernel's plan (several splits a band; two row
    tiles at 100 rows; a partial last band at H 192) against JAX's
    fused_mlp in interpret mode, within the bf16 tolerance above, and the
    port's CPU entry on the same bytes."""
    plan = split_plan(b, h, inter, sms=sms)
    assert plan["gate_up"][1] > 1 or plan["down"][1] > 1
    x = jnp.asarray(rng.standard_normal((b, h)), jnp.bfloat16)
    w1, s1, w2, s2 = _weights(rng, h, inter, mode)
    want = np.asarray(j_fused_mlp(x, w1, s1, w2, s2))
    got = _emulate(*(np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in (x, w1, s1, w2, s2)), plan)
    _assert_close(got, want, jnp.bfloat16)
    _assert_close(fused_mlp(*(_t(a) for a in (x, w1, s1, w2, s2))).numpy(), want, jnp.bfloat16)
