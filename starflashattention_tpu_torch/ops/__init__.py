"""Ops with a hand-written Hopper kernel each (sources in ``csrc/``) and a
plain PyTorch twin: ``cache_append``, ``quant_matmul``, ``flash_decode``,
``flash_prefill``. A CPU tensor takes the twin, a CUDA tensor the kernel."""
