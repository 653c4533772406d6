"""Kernels of the port: plain oracles, hand-written CUDA kernels, dispatch."""
