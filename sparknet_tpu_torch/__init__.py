"""sparknet_tpu_torch — the PyTorch/CUDA port of sparknet_tpu.

A second package beside the JAX reference: the same NetSpec IR and model
zoo, Caffe-semantics layers on tensors with autograd, Caffe SGD, the
τ-round data-parallel trainer and its loop, and the dynamic-batching
inference server, with every Pallas TPU kernel replaced by a hand-written
CUDA kernel for Hopper (`csrc/`, built on first use by `ops/_build.py`).
It imports `torch`, never `jax`, and nothing of `sparknet_tpu`.

Importing the package loads nothing heavy; entry points (`net_api.TorchNet`,
`apps.train_loop.train`, `serve.app`) run on the CUDA card unless the
caller passes `device="cpu"`.
"""
