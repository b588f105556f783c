"""GAPartNet in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `gapartnet_tpu`, which stays beside it as the
reference.  Module names follow the JAX package so each counterpart is easy
to find.  This package imports torch and numpy only; it never imports jax,
flax or anything of `gapartnet_tpu`.

It holds a counterpart of every module of the JAX package: the model
(SparseUNet or PointNet backbone, hash-grid or exact clustering, ScoreNet,
NPCSNet), training, the trainer and its data pipeline, data parallelism,
the inference API, dataset generation (`datagen/`), the native data library
(`data/native_loader.py`) and the profiling hooks (`utils/profiling.py`).
Its kernels are hand-written CUDA submanifold convolutions for sm_90a
(`ops/subm_conv.py`, `csrc/`), fp32 and bf16, forward and backward.
Entry points run on the card unless the caller passes `device="cpu"`.
"""
