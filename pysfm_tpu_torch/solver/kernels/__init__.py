"""Hand-written CUDA kernels for Hopper (``pysfm_tpu_torch/csrc``), each with
its plain PyTorch version beside it."""
