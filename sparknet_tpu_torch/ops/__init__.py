"""Ops behind the layers: LRN and Caffe pooling, with their CUDA kernels."""
