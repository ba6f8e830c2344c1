"""Build: python setup.py build_ext --inplace   (or `make native`).

Builds the optional C++ metric-hot-path extension
recnet_tpu/native/_fastmetrics; everything else is pure Python + JAX.
"""

from setuptools import Extension, setup, find_packages

setup(
    name="recnet_tpu",
    version="0.1.0",
    description="TPU-native RecNet video-captioning framework (JAX/Pallas)",
    packages=find_packages(include=["recnet_tpu", "recnet_tpu.*",
                                    "recnet_tpu_torch", "recnet_tpu_torch.*"]),
    package_data={"recnet_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "recnet_tpu.native._fastmetrics",
            sources=["recnet_tpu/native/fastmetrics.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        ),
    ],
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy", "h5py", "pandas"],
    extras_require={
        "orbax": ["orbax-checkpoint"],     # async/multi-host checkpoints
        "tensorboard": ["torch"],          # SummaryWriter (JSONL always on)
    },
    entry_points={
        "console_scripts": [
            "recnet-split = recnet_tpu.cli.split:main",
            "recnet-bundle = recnet_tpu.cli.bundle:main",
            "recnet-train = recnet_tpu.cli.train:main",
            "recnet-eval = recnet_tpu.cli.eval:main",
            "recnet-caption = recnet_tpu.cli.caption:main",
            "recnet-serve = recnet_tpu.cli.serve:main",
            "recnet-import-torch = recnet_tpu.cli.import_torch:main",
            "recnet-export-torch = recnet_tpu.cli.export_torch:main",
            "recnet-torch-serve = recnet_tpu_torch.cli.serve:main",
            "recnet-torch-train = recnet_tpu_torch.cli.train:main",
        ],
    },
)
