"""PyTorch + CUDA port of the ``repro`` package (serving and training).

The JAX package under ``src/repro`` is the reference; every module here
mirrors its counterpart of the same name.  The port imports ``torch``,
numpy and the standard library only -- never ``jax`` and never
``repro`` -- and its hot path runs hand-written CUDA kernels for Hopper
(``kernels/*/csrc``), built with ``nvcc`` at first use.
"""
