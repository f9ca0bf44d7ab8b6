"""rnabloom_tpu_torch — the PyTorch/CUDA port of rnabloom_tpu.

The JAX package ``rnabloom_tpu`` is the reference; this package recomputes
its results with PyTorch tensors on one CUDA device (or the CPU, for tests),
with hand-written CUDA kernels where the JAX package had Pallas kernels.
It imports neither JAX nor any module of the JAX package: the host-only
code it needs from there (``io/{fastx,native,nbits}.py``,
``native/fastxio.cpp``, ``utils/{seq,polya,timer}.py``,
``assembly/fragstore.py``) is copied into it under the same module names.
Its entry points run on the card unless the caller asks for the CPU.

Ported so far: every short-read entry point of the JAX CLI, stages 1-3
with the non-redundant pass: paired-end (with ``-extend``, ``-rescue`` and
unpaired reads mixed in), single-end, and pooled samples with their merge,
and the k selection (``-k`` lists, ``-ntcard``); and the long-read path
(``-long``: correction, ``-lrsub`` subsampling, the internal uniqueOLC,
redundancy reduction, ``-paf``/``-pafin``).
"""

__version__ = "0.1.0"
