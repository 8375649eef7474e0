"""Hand-written Hopper kernels (``csrc/*.cu``) and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version, takes it
only for tensors on the CPU, launches the kernel for CUDA tensors (or
raises), and counts its launches in ``<wrapper>.launches``.
"""
