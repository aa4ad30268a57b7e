from setuptools import find_packages, setup

setup(
    name="vectorizedmultiagentsimulator_tpu",
    version="0.1.0",
    description=(
        "TPU-native vectorized differentiable multi-agent simulator (JAX)"
    ),
    packages=find_packages(
        include=[
            "vectorizedmultiagentsimulator_tpu*",
            "vectorizedmultiagentsimulator_tpu_torch*",
        ]
    ),
    include_package_data=True,
    package_data={
        "vectorizedmultiagentsimulator_tpu": [
            "scenarios_data/road_traffic/*.xml",
            "scenarios_data/road_traffic/*.md",
        ],
        "vectorizedmultiagentsimulator_tpu_torch": [
            "csrc/*.cu",
            "scenarios_data/road_traffic/*.xml",
            "scenarios_data/road_traffic/*.md",
        ],
    },
    python_requires=">=3.10",
    install_requires=["jax", "flax", "numpy"],
    extras_require={
        "gymnasium": ["gymnasium"],
        "render": ["matplotlib"],
        # The PyTorch/CUDA port (vectorizedmultiagentsimulator_tpu_torch)
        # needs torch and numpy only; nvcc builds its kernel at first use.
        "torch": ["torch", "numpy"],
    },
)
