"""Every architecture of ``repro_torch.configs.ARCHS`` at its own dtype
(bf16) in the port against the JAX package, on the CPU: ``train_loss``,
``prefill``'s last logits and ``decode_step``'s logits from the same
JAX-initialized weights, within the reference's bf16 tolerance of 0.25
(``tests/test_models.py``): both sides round every op to bf16, but XLA and
PyTorch sum in different orders. The fp32 configs, within 1e-4:
``test_torch_families.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from torch_family_cases import parity  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_family_matches_jax_bf16(name):
    parity(name, "bfloat16", 0.25)
