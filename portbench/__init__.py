"""The benchmark of the PyTorch / H100 port (gapartnet_tpu_torch).

`portbench/run.py` runs one cell of BENCHMARK.json once.  Nothing here
imports JAX or the JAX package; the plain reference under
`portbench/reference` imports nothing of the program either.
"""
