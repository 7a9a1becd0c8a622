"""PyTorch + CUDA port of ``starflashattention_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package (``core/ ops/ cache/ runtime/ models/
utils/``) so each module has one JAX twin it is tested against. The
kernels under ``ops/`` are hand-written CUDA C++ for ``sm_90a`` (sources in
``csrc/``), built with ``nvcc`` at their first CUDA call; on CPU tensors
every op runs its plain PyTorch version instead. Importing the package
needs neither ``nvcc`` nor a card.
"""
