"""Package pyrhe_tpu (pip-installable; mirrors reference pyrhe/setup.py)."""
from setuptools import find_packages, setup

setup(
    name="pyrhe_tpu",
    version="0.1.0",
    description=("Randomized Haseman-Elston regression: RHE, RHE-DOM "
                 "and GENIE heritability estimation in JAX on the GPU"),
    packages=find_packages(include=["pyrhe_tpu", "pyrhe_tpu.*"]),
    package_data={"pyrhe_tpu.io": ["_native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy>=1.23.1",
        "scipy>=1.10.1",
    ],
    entry_points={
        "console_scripts": [
            "pyrhe-tpu = pyrhe_tpu.cli:cli_entry",
        ],
    },
)
