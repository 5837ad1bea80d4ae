"""The port's ops (counterpart of ``lsnet_tpu/ops``); the optical-flow
helpers are exported here, as in the JAX package."""

from .optflow import (dequantize_flow, flow_warp, flowread,  # noqa: F401
                      flowwrite, quantize_flow)
