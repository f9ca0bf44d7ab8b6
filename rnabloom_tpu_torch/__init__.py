"""rnabloom_tpu_torch — the PyTorch/CUDA port of rnabloom_tpu.

The JAX package ``rnabloom_tpu`` is the reference; this package recomputes
its results with PyTorch tensors on one CUDA device (or the CPU, for tests),
with hand-written CUDA kernels where the JAX package had Pallas kernels.
It imports no JAX: the numpy-only host modules of the reference
(``rnabloom_tpu.io.native``, ``io.fastx``, ``utils.seq``, ``utils.timer``)
are reused by import.

Ported so far: paired-end stage 1, the graph build (``-stage 1``), and
stage 2, fragment assembly (``-stage 2``).
"""

__version__ = "0.1.0"
