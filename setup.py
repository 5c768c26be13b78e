"""Package install for masr_tpu."""
from setuptools import find_packages, setup

setup(
    name="masr_tpu",
    version="0.1.0",
    description="TPU-native streaming speech recognition framework "
                "(JAX/XLA/Pallas) with the capability set of MASR",
    packages=find_packages(include=["masr_tpu", "masr_tpu.*", "masr_tpu_torch",
                                    "masr_tpu_torch.*"]),
    package_data={"masr_tpu.decoders.native": ["*.cc"],
                  "masr_tpu.infer": ["silero_vad.onnx"],
                  "masr_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "masr_tpu_torch.infer": ["silero_vad.onnx"],
                  "masr_tpu_torch.decoders.native": ["*.cc"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy",
        "pyyaml", "Levenshtein", "websockets", "tqdm",
    ],
    extras_require={
        "audio": ["soundfile", "av"],
        "itn": ["WeTextProcessing"],
    },
)
