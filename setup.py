"""Packaging.

Parity: reference python/setup.py (:44-144) — the wheel bundles the native
layer (there: JVM jars; here: the C++ shared-memory store, built from source
at install time or lazily on first use) and exposes the submit CLI.
"""

import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py

ROOT = Path(__file__).parent


class BuildNative(Command):
    """Build the C++ object-store library into the package tree."""

    description = "build native shared-memory store"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        native = ROOT / "raydp_tpu" / "store" / "native"
        subprocess.run(["sh", str(native / "build.sh")], check=True)


class BuildPyWithNative(build_py):
    def run(self):
        try:
            self.run_command("build_native")
        except Exception as exc:  # lazy build at first use still works
            print(f"warning: native build skipped ({exc})")
        super().run()


setup(
    name="raydp-tpu",
    version="0.1.0",
    description=(
        "TPU-native single-cluster ETL -> training framework "
        "(distributed Arrow DataFrames + JAX estimators with XLA collectives)"
    ),
    packages=find_packages(
        include=["raydp_tpu", "raydp_tpu.*", "raydp_tpu_torch", "raydp_tpu_torch.*"]
    ),
    package_data={
        "raydp_tpu.store": ["native/*.cpp", "native/build.sh"],
        "raydp_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "pyarrow>=4.0.1",
        "pandas",
        "cloudpickle",
        "psutil",
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
    ],
    extras_require={
        "torch": ["torch"],
        "tf": ["tensorflow"],
        "xgboost": ["xgboost"],
    },
    entry_points={
        "console_scripts": [
            "raydp-tpu-submit=raydp_tpu.submit:main",
            "raydp-tpu-torch-submit=raydp_tpu_torch.submit:main",
        ]
    },
    cmdclass={"build_native": BuildNative, "build_py": BuildPyWithNative},
)
