"""PyTorch + CUDA port of the GWLZ compression stack (``repro``).

The layout mirrors the JAX package module for module, so every port module
has one counterpart to be held against:

* ``sz/``      -- quantizer, Lorenzo tile predictor, entropy codec, GWTC engine,
* ``exec/``    -- the GWTC container writer,
* ``kernels/`` -- hand-written CUDA kernels (``csrc/``), their plain PyTorch
  versions (``kernels/ref.py``) and the device dispatchers (``kernels/ops.py``),
* ``data/``    -- synthetic Nyx-like fields.

Public entry points take ``device=None``, which means ``"cuda"``; with no
CUDA device they raise.  Pass ``device="cpu"`` to run the plain versions.
"""
