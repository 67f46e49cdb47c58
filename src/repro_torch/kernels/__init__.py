"""Hand-written Hopper kernels for the memory-processing hot spots (CUDA
sources in ``repro_torch/csrc``), each beside its plain-torch version. Public
API in ``ops``; oracles in ``ref``."""
from repro_torch.kernels import ops, ref  # noqa: F401
