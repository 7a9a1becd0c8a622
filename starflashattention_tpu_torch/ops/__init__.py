"""Ops with a hand-written Hopper kernel each (sources in ``csrc/``) and a
plain PyTorch twin: ``cache_append`` (contiguous and paged), ``quant_matmul``,
``flash_decode``, ``paged_decode`` (the paged mode of ``csrc/flash_decode.cu``),
``flash_prefill`` and ``flash_bwd`` (the FA2 backward, and ``flash_attention``,
the differentiable attention of the training path). A CPU tensor takes the
twin, a CUDA tensor the kernel."""
