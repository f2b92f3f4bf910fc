"""radvlm_tpu_torch: the PyTorch / CUDA port of radvlm_tpu for one NVIDIA H100.

The JAX package `radvlm_tpu` stays the reference; this package mirrors its
module names (`radvlm_tpu/models/qwen2.py` <-> `radvlm_tpu_torch/models/qwen2.py`)
and imports neither jax nor anything of `radvlm_tpu`. The kernels are written
by hand for Hopper in `csrc/` and built at first use (`kernels.py`).
"""

__version__ = "0.1.0"
