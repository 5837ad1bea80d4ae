"""lsnet-torch: the LSNet detector in PyTorch with hand-written CUDA
kernels for the NVIDIA H100 (Hopper, sm_90a).

A port of the JAX package ``lsnet_tpu`` with the same module names; it
imports neither JAX nor ``lsnet_tpu``. Entry points: :mod:`lsnet_torch.apis`
(``init_detector``, ``inference_detector``) and :mod:`lsnet_torch.configs`.
"""

__version__ = "0.1.0"
