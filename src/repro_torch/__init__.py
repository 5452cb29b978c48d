"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

Mirrors the JAX package's layout (``repro_torch.models.attention`` is the
counterpart of ``repro.models.attention``) and imports nothing of it, nor
jax. Kernels the JAX package wrote in Pallas for the TPU are hand-written
CUDA here (``csrc/``), each beside its plain PyTorch version
(``repro_torch.kernels``). Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""
