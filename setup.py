#!/usr/bin/env python3
"""Package setup for tpu-demix (demucs_tpu).

Console entry mirrors the reference's `demucs` script (setup.py:64-66).
"""

from pathlib import Path

from setuptools import find_packages, setup

HERE = Path(__file__).parent

setup(
    name="demucs_tpu",
    version="0.1.0",
    description="TPU-native music source separation (JAX/XLA/Pallas) with the "
    "full capability surface of Demucs v4",
    long_description=(HERE / "README.md").read_text(),
    long_description_content_type="text/markdown",
    # demucs_tpu_torch: the PyTorch / CUDA port (its CUDA sources are built
    # with nvcc at the first CUDA call, so they ship as package data)
    packages=find_packages(include=["demucs_tpu", "demucs_tpu.*",
                                    "demucs_tpu_torch", "demucs_tpu_torch.*"]),
    package_data={"demucs_tpu": ["py.typed"], "demucs_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "einops",
        "pyyaml",
        "tqdm",
    ],
    extras_require={
        "zoo": ["torch"],  # only needed to decode the reference's .th checkpoints
        "eval": ["museval", "musdb"],
    },
    entry_points={
        "console_scripts": ["demucs-tpu = demucs_tpu.separate:main",
                            "demucs-tpu-torch = demucs_tpu_torch.separate:main"],
    },
)
