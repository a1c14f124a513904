"""The benchmark of the PyTorch and CUDA port (`sparknet_tpu_torch`).

`run.py` runs one cell; `BENCHMARK.json` at the checkout's root names the
cells, and the files here that each name finds (`load.py`). Nothing here
imports JAX or the JAX package, and `reference/` imports nothing of the
port.
"""
