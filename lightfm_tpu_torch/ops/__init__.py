"""PyTorch / CUDA ops of lightfm_tpu_torch (kernels are built at first use)."""
