"""Ops with a hand-written Hopper kernel each (sources in ``csrc/``) and a
plain PyTorch twin: ``cache_append`` (contiguous and paged), ``quant_matmul``,
``flash_decode``, ``paged_decode`` (the paged form of the same kernels),
``flash_prefill``, ``flash_bwd`` (the FA2 backward, and ``flash_attention``,
the differentiable attention of the training path) and ``fused_mlp`` (the
quantized SwiGLU MLP in one kernel, exported here). A CPU tensor takes the
twin, a CUDA tensor the kernel."""

from starflashattention_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain  # noqa: F401
