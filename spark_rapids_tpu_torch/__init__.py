"""spark_rapids_tpu_torch: the PyTorch / CUDA port of spark_rapids_tpu.

Device columns are ``torch`` tensors on an NVIDIA GPU; the two TPU
kernels of the JAX package are rewritten for Hopper (Triton and CUDA
C++, ``ops/device_kernels.py``). The package keeps the JAX package's
module layout and class names so each piece has a findable counterpart,
imports ``torch`` and numpy only, and never imports the JAX package.

Entry point: ``spark_rapids_tpu_torch.plan.session.TpuSession``.
"""
