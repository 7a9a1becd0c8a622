"""The port's fused quantized MLP (kernel K13's plain twin, which CPU
tensors take) against the JAX package's ``ops.fused_mlp.fused_mlp`` (its
Pallas kernel in interpret mode), on the CPU.

Twins of the three tests of ``tests/test_fused_mlp.py`` (the geometries,
stacked layers, the TPU block sizes, which change nothing in the port),
plus fp8 weights, bf16 activations and the refusals. The inputs are seeded
numpy arrays quantized by the JAX package; the same bytes go to both.

Tolerances: fp32 activations, JAX's own: rtol 2e-5 and atol 2e-5 times
max(peak, 1) (the fp32 sums of the same exact products run in another
order). bf16 activations: ``act`` is rounded to bf16 between the two
matmuls, and an fp32 sum in another order may round it to the other side
of a tie, which moves the output by one bf16 ulp of that activation times
its weight row; 4e-3 of the output's peak bounds that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu.ops.fused_mlp import fused_mlp as j_fused_mlp
from starflashattention_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain

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
