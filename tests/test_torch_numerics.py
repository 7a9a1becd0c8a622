"""The PyTorch port's numeric spec, configuration, bridge and package rules,
against the JAX package, on the CPU.

Tolerances: RoPE tables and rotations are fp32 transcendental evaluations
of the same fp32 angles in two libraries, so they agree to a few ulp of the
angle (1e-5 absolute at positions below 4096); the reference attentions are
fp32 on both sides and differ only in summation order (1e-5); quantized
weight bytes and scales are identical.
"""

import ast
import dataclasses
import inspect
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starflashattention_tpu.core import quant as j_quant
from starflashattention_tpu.core import reference as j_ref
from starflashattention_tpu.core import rope as j_rope
from starflashattention_tpu.runtime import params as j_params
from starflashattention_tpu_torch.cache import contiguous as t_cache
from starflashattention_tpu_torch.core import quant as t_quant
from starflashattention_tpu_torch.core import reference as t_ref
from starflashattention_tpu_torch.core import rope as t_rope
from starflashattention_tpu_torch.models import llama as t_llama
from starflashattention_tpu_torch.runtime import params as t_params
from starflashattention_tpu_torch.utils import bridge

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ RoPE

_LONGROPE = tuple(float(f) for f in np.linspace(1.0, 3.0, 8))
ROPE_SCALINGS = {
    "none": None,
    "linear": ("linear", 4.0),
    "llama3": ("llama3", 8.0, 1.0, 4.0, 64),
    "longrope_short": ("longrope", 4096, 4096, _LONGROPE, tuple(2 * f for f in _LONGROPE)),
    "longrope_long": ("longrope", 4096, 131072, _LONGROPE, tuple(2 * f for f in _LONGROPE)),
}


@pytest.mark.parametrize("kind", sorted(ROPE_SCALINGS))
def test_rope_table_matches_jax(kind):
    scaling = ROPE_SCALINGS[kind]
    jc, js = j_rope.rope_table(1024, 16, base=500000.0, scaling=scaling)
    tc, ts = t_rope.rope_table(1024, 16, base=500000.0, scaling=scaling)
    assert tc.shape == (1024, 8) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)


def test_rope_table_rejects_unknown_scaling():
    with pytest.raises(ValueError):
        t_rope.rope_table(16, 8, scaling=("yarn", 2.0))


@pytest.mark.parametrize("style", ["half", "interleaved"])
@pytest.mark.parametrize("rot", [16, 8])  # full and partial rotary dim
def test_apply_rope_matches_jax(rng, style, rot):
    x = rng.standard_normal((3, 4, 5, 16), dtype=np.float32)  # (B, H, S, D)
    pos = rng.integers(0, 128, (3, 1, 5)).astype(np.int32)
    jc, js = j_rope.rope_table(128, rot)
    tc, ts = t_rope.rope_table(128, rot)
    ref = j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc, js, style=style)
    out = t_rope.apply_rope(_t(x), _t(pos), tc, ts, style=style)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_apply_rope_decode_positions_broadcast(rng):
    """(B,) positions against (B, H, D), as the decode step passes them."""
    x = rng.standard_normal((3, 4, 16), dtype=np.float32)
    pos = np.array([0, 7, 100], np.int32)
    jc, js = j_rope.rope_table(128, 16)
    tc, ts = t_rope.rope_table(128, 16)
    ref = j_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc, js)
    out = t_rope.apply_rope(_t(x), _t(pos), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


# ------------------------------------------------------------------ quantization


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 96)])
def test_quantize_weight_bytes_identical(rng, mode, shape):
    w = rng.standard_normal(shape, dtype=np.float32) * 3.0
    w[..., 5] = 0.0  # an all-zero column takes the scale-1 branch
    jq = j_quant.quantize_weight(jnp.asarray(w), mode)
    tq = t_quant.quantize_weight(_t(w), mode)
    j_bytes = np.asarray(jq["w"]).view(np.uint8)
    t_bytes = tq["w"].view(torch.uint8).numpy()
    np.testing.assert_array_equal(t_bytes, j_bytes)
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    np.testing.assert_array_equal(t_quant.dequantize_weight(tq).numpy(),
                                  np.asarray(j_quant.dequantize_weight(jq)))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_value_bytes_identical(rng, mode):
    x = rng.standard_normal((2, 4, 8, 16), dtype=np.float32) * 4.0
    scales = np.array([0.01, 0.02, 0.05, 0.03], np.float32)  # saturates some values
    ref = j_quant.quantize_value(jnp.asarray(x), jnp.asarray(scales), mode, head_axis=1)
    out = t_quant.quantize_value(_t(x), _t(scales), mode, head_axis=1)
    np.testing.assert_array_equal(out.view(torch.uint8).numpy(), np.asarray(ref).view(np.uint8))


def test_quantize_weight_int4_not_ported():
    with pytest.raises(NotImplementedError):
        t_quant.quantize_weight(torch.zeros(8, 8), "int4")


# ------------------------------------------------------------------ reference attention


def test_mha_reference_matches_jax(rng):
    q = rng.standard_normal((2, 4, 6, 16), dtype=np.float32)
    k = rng.standard_normal((2, 2, 20, 16), dtype=np.float32)
    v = rng.standard_normal((2, 2, 20, 16), dtype=np.float32)
    lengths = np.array([9, 20], np.int32)
    q_off = np.array([3, 14], np.int32)
    ref = j_ref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              lengths=jnp.asarray(lengths), causal=True, q_offset=jnp.asarray(q_off))
    out = t_ref.mha_reference(_t(q), _t(k), _t(v), lengths=_t(lengths), causal=True, q_offset=_t(q_off))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    ref = j_ref.prefill_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  lengths=jnp.asarray(lengths))
    out = t_ref.prefill_reference(_t(q), _t(k), _t(v), lengths=_t(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_decode_reference_and_stats_match_jax(rng):
    q = rng.standard_normal((3, 4, 16), dtype=np.float32)
    k = rng.standard_normal((3, 2, 32, 16), dtype=np.float32)
    v = rng.standard_normal((3, 2, 32, 16), dtype=np.float32)
    lengths = np.array([1, 32, 11], np.int32)
    args_j = [jnp.asarray(a) for a in (q, k, v, lengths)]
    args_t = [_t(a) for a in (q, k, v, lengths)]
    np.testing.assert_allclose(t_ref.decode_reference(*args_t).numpy(),
                               np.asarray(j_ref.decode_reference(*args_j)), atol=ATOL, rtol=0)
    for out, ref in zip(t_ref.decode_reference_with_stats(*args_t),
                        j_ref.decode_reference_with_stats(*args_j)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-6)


def test_lse_combine_matches_jax(rng):
    o = rng.standard_normal((3, 2, 4, 16), dtype=np.float32)
    m = rng.standard_normal((3, 2, 4), dtype=np.float32)
    l = rng.uniform(0.5, 4.0, (3, 2, 4)).astype(np.float32)
    m[1, 0, 0], l[1, 0, 0], o[1, 0, 0] = t_ref.NEG_INF, 0.0, 0.0  # an empty split drops out
    ref = j_ref.lse_combine(jnp.asarray(o), jnp.asarray(m), jnp.asarray(l))
    out = t_ref.lse_combine(_t(o), _t(m), _t(l))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_repeat_kv_matches_jax(rng):
    x = rng.standard_normal((2, 3, 5, 4), dtype=np.float32)
    np.testing.assert_array_equal(t_ref.repeat_kv(_t(x), 4).numpy(),
                                  np.asarray(j_ref.repeat_kv(jnp.asarray(x), 4)))


# ------------------------------------------------------------------ configuration


def _presets(cls):
    return sorted(name for name, member in inspect.getmembers(cls)
                  if inspect.ismethod(member) and member.__self__ is cls)


def test_model_config_presets_match_jax():
    assert _presets(t_params.ModelConfig) == _presets(j_params.ModelConfig)
    assert len(_presets(j_params.ModelConfig)) >= 12
    for name in _presets(j_params.ModelConfig):
        jc = getattr(j_params.ModelConfig, name)()
        tc = getattr(t_params.ModelConfig, name)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        assert tc.sm_scale() == jc.sm_scale(), name
        assert tc.kv_cache_dims() == jc.kv_cache_dims(), name
        assert dataclasses.asdict(tc.attention()) == dataclasses.asdict(jc.attention()), name


def test_config_fields_and_validation_match_jax():
    assert [f.name for f in dataclasses.fields(t_params.ModelConfig)] == \
        [f.name for f in dataclasses.fields(j_params.ModelConfig)]
    assert [f.name for f in dataclasses.fields(t_params.AttentionConfig)] == \
        [f.name for f in dataclasses.fields(j_params.AttentionConfig)]
    for bad in (dict(attention_sinks=4), dict(first_k_dense=1, num_experts=4)):
        with pytest.raises(ValueError):
            j_params.ModelConfig.tiny(**bad)
        with pytest.raises(ValueError):
            t_params.ModelConfig.tiny(**bad)
    assert t_params.AttentionConfig(4, 2, 16, rotary_dim=8).rot_dim == 8


@pytest.mark.parametrize("preset", ["mixtral_8x7b", "deepseek_v2_lite", "gemma2_9b", "mistral_7b"])
def test_unported_config_fields_raise(preset):
    with pytest.raises(NotImplementedError):
        t_llama.check_supported(getattr(t_params.ModelConfig, preset)())


@pytest.mark.parametrize("overrides", [dict(quant_mode="int8"), dict(w8a8_prefill=True),
                                       dict(mlp_activation="gelu_tanh"), dict(embed_scale=True)])
def test_unported_tiny_options_raise(overrides):
    with pytest.raises(NotImplementedError):
        t_llama.init_params(t_params.ModelConfig.tiny(**overrides), device="cpu")


# ------------------------------------------------------------------ bridge


def test_bridge_roundtrip_is_exact(rng):
    tree = {
        "f32": rng.standard_normal((3, 4), dtype=np.float32),
        "bf16": rng.standard_normal((5, 2), dtype=np.float32).astype(jnp.bfloat16),
        "i8": rng.integers(-127, 128, (4, 4)).astype(np.int8),
        "fp8": np.asarray(rng.standard_normal((6,), dtype=np.float32).astype(jnp.float8_e4m3fn)),
        "nested": {"i32": np.arange(5, dtype=np.int32)},
    }
    params = bridge.params_from_numpy(tree)
    assert params["bf16"].dtype == torch.bfloat16
    assert params["fp8"].dtype == torch.float8_e4m3fn
    assert params["i8"].dtype == torch.int8
    back = bridge.params_to_numpy(params)
    for key in ("f32", "bf16", "i8", "fp8"):
        np.testing.assert_array_equal(back[key], np.asarray(tree[key]).astype(back[key].dtype))
    np.testing.assert_array_equal(back["nested"]["i32"], tree["nested"]["i32"])
    # bit-exact through the integer views
    np.testing.assert_array_equal(params["bf16"].view(torch.int16).numpy(), tree["bf16"].view(np.int16))


def test_bridge_cache_roundtrip():
    from starflashattention_tpu.cache import contiguous as j_cache

    jc = j_cache.init_cache(2, 3, 2, 16, 8, dtype=jnp.bfloat16)
    tc = bridge.cache_from_numpy(np.asarray(jc.k), np.asarray(jc.v), np.asarray(jc.lengths))
    assert tc.k.shape == (2, 3, 2, 16, 8) and tc.k.dtype == torch.bfloat16
    assert tc.lengths.dtype == torch.int32 and tc.quant_mode == "none"
    ref = t_cache.init_cache(2, 3, 2, 16, 8, dtype=torch.bfloat16, device="cpu")
    assert torch.equal(tc.k, ref.k) and torch.equal(tc.lengths, ref.lengths)
    jq = j_cache.init_cache(2, 3, 2, 16, 8, quant_mode="int8", calibration_scale=5.0)
    tq = t_cache.init_cache(2, 3, 2, 16, 8, quant_mode="int8", calibration_scale=5.0, device="cpu")
    np.testing.assert_array_equal(tq.k_scales.numpy(), np.asarray(jq.k_scales))


# ------------------------------------------------------------------ package rules


def _port_sources():
    pkg = REPO / "starflashattention_tpu_torch"
    return sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    forbidden = ("jax", "jaxlib", "starflashattention_tpu")
    sources = _port_sources()
    assert len(sources) > 15
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in forbidden, f"{path.relative_to(REPO)} imports {name}"


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py prints no result and exits non-zero where no CUDA
    device is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert run.returncode != 0
    assert run.stdout == ""


def test_entry_points_do_not_fall_back_to_the_cpu():
    """Without a card, entry points given no device raise instead of
    quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg = t_params.ModelConfig.tiny(dtype="float32")
    params = t_llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_llama.generate(params, cfg, np.zeros((1, 4), np.int32), np.array([4], np.int32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cache.init_cache(1, 1, 1, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_llama.rope_tables(cfg)
