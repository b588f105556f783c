"""GAPartNet in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `gapartnet_tpu`, which stays beside it as the
reference.  Module names follow the JAX package so each counterpart is easy
to find.  This package imports torch and numpy only; it never imports jax,
flax or anything of `gapartnet_tpu`.

What is ported so far is the flagship inference forward (eval mode, dense
proposal UNets): voxelization, rulebooks, the SparseUNet backbone through a
hand-written CUDA submanifold-conv kernel (`ops/subm_conv.py`,
`csrc/subm_conv.cu`), the semantic and offset heads, hash-grid dual-set
clustering, dense proposal re-voxelization, ScoreNet and NPCSNet.
Entry points run on the card unless the caller passes `device="cpu"`.
"""
