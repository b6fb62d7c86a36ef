"""Hand-written Hopper kernels, their wrappers and their plain versions.

Sources live in ``paddle_tpu_torch/csrc/``; ``build.py`` compiles them with
nvcc at first use. Nothing here imports or builds a kernel at import time.
"""
