"""PyTorch + CUDA port of the GWLZ compression stack (``repro``).

The layout mirrors the JAX package module for module, so every port module
has one counterpart to be held against:

* ``api``, ``cli`` -- the façade (compress / save / open, lazy
  ``CompressedVolume`` slicing) and ``python -m repro_torch.cli``,
* ``sz/``      -- quantizer, Lorenzo predictor (whole volume and per tile),
  entropy codec, the monolithic SZJX compressor and the GWTC engine (with
  per-tile transforms for enhanced decode),
* ``core/``    -- GWLZ: metrics, grouping, the group-wise enhancer module, its
  trainer (training, BN calibration, gate, enhancement), the pipeline
  (``GWLZ`` on either container, model blob), and ``convert`` (weights from
  the reference's arrays),
* ``optim/``   -- the trainer's AdamW (float32 moments) and step-decay schedule,
* ``exec/``    -- the streaming executor, the GWTC container writer, the
  decoded-tile cache and the cross-request decode batcher,
* ``serve``    -- the multi-tenant region-decode daemon (``VolumePool``,
  admission, ETags, ``/metrics``) behind ``python -m repro_torch.cli serve``,
* ``kernels/`` -- hand-written CUDA kernels (``csrc/``), their plain PyTorch
  versions (``kernels/ref.py``) and the device dispatchers (``kernels/ops.py``),
* ``data/``    -- synthetic Nyx-like fields.

Public entry points take ``device=None``, which means ``"cuda"``; with no
CUDA device they raise.  Pass ``device="cpu"`` to run the plain versions.
"""
