"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). Run on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerances as in ``chip_smoke.py``: both sides compute in fp32.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import relevancy_topk as rt  # noqa: E402
from repro_torch.kernels import sparse_decode_attention as sda  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,block,k", [(512, 512, 128), (300, 128, 20)])
def test_relevancy_topk_kernel(dev, dtype, S, block, k):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 64, 128, generator=g, device=dev).to(dtype)
    keys = torch.randn(2, S, 128, generator=g, device=dev).to(dtype)
    keys[1, S // 2:] = 0                         # exact ties at zero
    w = torch.softmax(torch.randn(2, 64, generator=g, device=dev), -1)
    n0 = rt.relevancy_topk_candidates.launches
    kv, ki = ops.relevancy_topk(q, keys, w, k, block=block)
    assert rt.relevancy_topk_candidates.launches == n0 + 1
    pv, pi = ref.relevancy_topk(q, keys, w, k)
    torch.testing.assert_close(kv, pv, rtol=TOL, atol=TOL)
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,nsel", [(16, 9), (4, 7), (128, 3)])
def test_paged_decode_attention_kernel(dev, dtype, ps, nsel):
    g = torch.Generator(device=dev).manual_seed(1)
    B, KV, G, dh, S = 3, 8, 4, 64, 1024
    q = torch.randn(B, KV * G, dh, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    pages = torch.stack([torch.randperm(S // ps, generator=g, device=dev)
                         [:nsel] for _ in range(B)]).to(torch.int32)
    pages[0, 1] = -1
    pages[2] = -1
    length = torch.tensor([S - ps // 2 - 1, S // 2 + 1, S],
                          dtype=torch.int32, device=dev)
    n0 = sda.paged_decode_attention.launches
    ko, kl = ops.paged_decode_attention(q, kc, vc, pages, length,
                                        page_size=ps)
    assert sda.paged_decode_attention.launches == n0 + 1
    po, pl_ = ref.paged_decode_attention(q, kc, vc, pages, ps, length)
    torch.testing.assert_close(ko, po, rtol=TOL, atol=TOL)
    torch.testing.assert_close(kl, pl_, rtol=TOL, atol=TOL)
