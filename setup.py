from setuptools import find_packages, setup

setup(
    name="paddle_tpu",
    version="0.1.0",
    description="TPU-native deep learning framework (Paddle-capability "
                "rebuild on JAX/XLA/Pallas)",
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch", "paddle_tpu_torch.*"]),
    package_data={"paddle_tpu_torch.kernels": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax", "optax"],
)
