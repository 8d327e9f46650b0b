"""Hand-written CUDA kernels for Hopper (sources in `accunet_tpu_torch/csrc`),
each beside its plain PyTorch version. A wrapper runs the plain version only
for CPU tensors; for a CUDA tensor it launches the kernel or raises."""
