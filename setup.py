from setuptools import find_packages, setup

setup(
    name="lsnet-tpu",
    version="0.1.0",
    description=("TPU-native location-sensitive dense prediction: "
                 "detection / instance segmentation / pose with cross-IOU "
                 "loss on JAX/XLA/Pallas"),
    packages=find_packages(include=["lsnet_tpu", "lsnet_tpu.*",
                                    "lsnet_torch", "lsnet_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these sources at first use
    package_data={"lsnet_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "pillow"],
    include_package_data=True,
)
