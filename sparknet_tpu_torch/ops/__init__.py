"""Ops behind the layers: LRN (with its CUDA kernel) and Caffe pooling."""
