"""lsnet-torch: the LSNet detector in PyTorch with hand-written CUDA
kernels for the NVIDIA H100 (Hopper, sm_90a).

A port of the JAX package ``lsnet_tpu`` with the same module names; it
imports neither JAX nor ``lsnet_tpu``. Entry points: :mod:`lsnet_torch.apis`
(``init_detector``, ``inference_detector``, ``aug_test``,
``aug_test_simple``, ``show_result``, ``train_detector``,
``evaluate_detector``, also as attributes of this package) and
:mod:`lsnet_torch.configs`.
"""

__version__ = "0.1.0"

_API = ("init_detector", "inference_detector", "async_inference_detector",
        "aug_test", "aug_test_simple", "show_result", "train_detector",
        "evaluate_detector")


def __getattr__(name):
    # lazy, so that ``import lsnet_torch`` does not import torch
    if name in _API:
        from . import apis
        return getattr(apis, name)
    raise AttributeError(name)
