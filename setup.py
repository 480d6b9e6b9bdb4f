from setuptools import find_packages, setup

setup(
    name="voicebox-tpu",
    packages=find_packages(exclude=["tests*"]),
    # the PyTorch port builds its CUDA kernels and its native WAV / FLAC
    # decoders from these sources at first use
    package_data={"voicebox_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp"]},
    version="0.1.0",
    license="MIT",
    description=(
        "Voicebox TTS with conditional flow matching — TPU-native "
        "(JAX / XLA / Pallas / pjit)"
    ),
    long_description_content_type="text/markdown",
    keywords=[
        "artificial intelligence",
        "deep learning",
        "text to speech",
        "flow matching",
        "tpu",
        "jax",
    ],
    install_requires=[
        "jax>=0.4.30",
        "flax>=0.8.0",
        "optax>=0.2.0",
        "einops>=0.6.1",
        "numpy",
        "scipy",
    ],
    extras_require={
        # the PyTorch/CUDA port (voicebox_tpu_torch); its kernels need nvcc
        "torch": ["torch>=2.1", "numpy"],
    },
    classifiers=[
        "Development Status :: 4 - Beta",
        "Intended Audience :: Developers",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
        "License :: OSI Approved :: MIT License",
        "Programming Language :: Python :: 3.10",
    ],
)
