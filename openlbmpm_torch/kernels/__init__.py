"""Hand-written GPU kernels, their wrappers, plain versions and launch counts.

Each wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on a card; nothing is compiled or
loaded until the first CUDA tensor reaches a wrapper.
"""
