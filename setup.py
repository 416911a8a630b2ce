"""Packaging for petastorm_tpu (reference setup.py parity: extras + console scripts).

Console scripts mirror the reference's CLIs:
  petastorm-tpu-generate-metadata  (reference: petastorm-generate-metadata)
  petastorm-tpu-copy-dataset       (reference: petastorm-copy-dataset)
  petastorm-tpu-throughput         (reference: petastorm-throughput)
  petastorm-tpu-lint               (no reference analog: graftlint static analysis)
  petastorm-tpu-stats              (no reference analog: metrics snapshot viewer)
"""
from setuptools import find_packages, setup

setup(
    name="petastorm-tpu",
    version="0.2.0",
    description="TPU-native Parquet data-loading framework (Petastorm-class capabilities)",
    packages=find_packages(include=["petastorm_tpu", "petastorm_tpu.*",
                                    "petastorm_tpu_torch", "petastorm_tpu_torch.*"]),
    # the native C++ sources ship with the wheel: kernels compile at first use via g++;
    # the PyTorch port's CUDA sources compile at first use via nvcc (sm_90a)
    package_data={"petastorm_tpu.ops.native": ["*.cpp"],
                  "petastorm_tpu_torch": ["csrc/*.cu"],
                  "petastorm_tpu_torch.ops.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "pyarrow>=10",
        "fsspec",
    ],
    extras_require={
        "jax": ["jax", "flax", "optax"],
        "tf": ["tensorflow"],
        "torch": ["torch"],
        "opencv": ["opencv-python-headless"],
        "spark": ["pyspark>=3.0"],
        "gcs": ["gcsfs"],
        # everything the suite exercises (CI installs .[test])
        "test": ["pytest", "pytest-timeout", "jax", "flax", "optax", "pandas",
                 "opencv-python-headless", "torch", "tensorflow"],
    },
    entry_points={
        "console_scripts": [
            "petastorm-tpu-generate-metadata=petastorm_tpu.tools.generate_metadata:main",
            "petastorm-tpu-copy-dataset=petastorm_tpu.tools.copy_dataset:main",
            "petastorm-tpu-throughput=petastorm_tpu.benchmark.cli:main",
            "petastorm-tpu-bench=petastorm_tpu.benchmark.cli:main",
            "petastorm-tpu-lint=petastorm_tpu.analysis.cli:main",
            "petastorm-tpu-stats=petastorm_tpu.obs.stats_cli:main",
            "petastorm-tpu-torch-generate-metadata="
            "petastorm_tpu_torch.tools.generate_metadata:main",
            "petastorm-tpu-torch-copy-dataset=petastorm_tpu_torch.tools.copy_dataset:main",
        ],
    },
)
