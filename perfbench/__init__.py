"""The benchmark of ``repro_torch``, the PyTorch/CUDA port (see README.md).

Nothing here imports ``jax`` or the JAX package ``repro``; the plain
reference (``reference.py``) and the generators (``corpus.py``,
``traffic.py``) import nothing of ``repro_torch`` either.
"""
