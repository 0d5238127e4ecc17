from setuptools import find_packages, setup

setup(
    name="vision_mtl_tpu",
    version="0.1.0",
    description=(
        "TPU-native multi-task learning framework for dense scene "
        "understanding (JAX/Flax/Pallas)"
    ),
    packages=find_packages(
        include=[
            "vision_mtl_tpu",
            "vision_mtl_tpu.*",
            "vision_mtl_tpu_torch",
            "vision_mtl_tpu_torch.*",
        ]
    ),
    package_data={"vision_mtl_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pyyaml",
        "pillow",
        "matplotlib",
    ],
    extras_require={
        "tracking": ["tensorboardX", "comet-ml"],
        "tuning": ["optuna"],
        "nyuv2": ["h5py"],
    },
)
