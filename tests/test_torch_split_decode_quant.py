"""The split-KV decode kernel's chunk walks on int8 / fp8 caches against the
JAX package, on the CPU: the plain split-and-merge of
``tests/split_decode_cases.py``, applying the (Hkv,) ``k_scales`` /
``v_scales`` in the kernel's order, equals JAX's
``flash_decode(num_splits=1)``, ``flash_verify`` and ``paged_flash_decode``
with the same scales (JAX's Pallas kernels in interpret mode) at head_dim
64, 128 and 256, on the edge cases that exercise a band across chunks with
sinks, a softcap on a band and a verify span (a row of length 0 in each).
The fp32 caches, the walks and the grid are in
``tests/test_torch_split_decode.py``. Tolerance: 1e-5 absolute, fp32 on
both sides.
"""

import pytest
import torch

from split_decode_cases import CASES, QUANT_CASES, check_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("name", QUANT_CASES)
def test_split_merge_on_quantized_kv_matches_jax(rng, name, d, kv):
    """int8 / fp8 caches with their scales applied in the kernel's order."""
    check_against_jax(rng, CASES[name], d, kv)
