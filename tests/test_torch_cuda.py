"""The port's CUDA kernels against their plain versions, on the card, one
engine run with the retrieval service on its own stream, and one
smoke-width training step through the flash kernel against the plain path.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). Run on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerances as in ``chip_smoke.py``: both sides compute in fp32; page
min/max is exact (min and max of values cast exactly to fp32); BM25 ids
equal, exactly where scores tie; bf16 flash outputs within one bf16 ulp of
the plain version's (both round an fp32 result).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bm25_topk as bm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import page_pool as pp  # noqa: E402
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


def test_relevancy_topk_kernel_one_head(dev):
    """Seer's shapes: one gated query head, dk 128, unit weight, 128
    pooled blocks in one 128-block, top-64."""
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(4, 1, 128, generator=g, device=dev).bfloat16()
    keys = torch.randn(4, 128, 128, generator=g, device=dev).bfloat16()
    keys[2, 5:] = 0
    w = torch.ones(4, 1, device=dev)
    kv, ki = ops.relevancy_topk(q, keys, w, 64, block=128)
    pv, pi = ref.relevancy_topk(q, keys, w, 64)
    torch.testing.assert_close(kv, pv, rtol=TOL, atol=TOL)
    assert torch.equal(ki, pi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,nsel", [(16, 9), (4, 7), (128, 3), (64, 12)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,dh", [(24, 64), (32, 112)])
def test_paged_decode_attention_family_shapes(dev, dtype, KV, dh):
    """G = 1 (musicgen: 24 heads over 24 KV heads) and dh 112 (zamba2:
    32 over 32), DSA's 16-token pages, a hole, a length cut mid-page."""
    g = torch.Generator(device=dev).manual_seed(12)
    B, S, ps, nsel = 2, 1024, 16, 20
    q = torch.randn(B, KV, dh, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    pages = torch.stack([torch.randperm(S // ps, generator=g, device=dev)
                         [:nsel] for _ in range(B)]).to(torch.int32)
    pages[0, 3] = -1
    length = torch.tensor([S - 7, S // 2], dtype=torch.int32, device=dev)
    ko, kl = ops.paged_decode_attention(q, kc, vc, pages, length,
                                        page_size=ps)
    po, pl_ = ref.paged_decode_attention(q, kc, vc, pages, ps, length)
    torch.testing.assert_close(ko, po, rtol=TOL, atol=TOL)
    torch.testing.assert_close(kl, pl_, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("channels", [(8, 64), (3, 5), (32, 112)])
@pytest.mark.parametrize("n_pages", [4, 128])
def test_page_minmax_kernel(dev, dtype, ps, channels, n_pages):
    """Bit-exact against the plain version, on mixed-sign values with NaN
    and +-inf in some pages (NaN exactly where the plain version has NaN):
    the bulk route at KV x dh = 512 and at the hybrid's 3584 (4 pieces a
    row), with fewer tiles than SMs (4 pages a slot) and more than 2 x SMs
    (128), and the scalar route (KV x dh = 15)."""
    KV, dh = channels
    g = torch.Generator(device=dev).manual_seed(3)
    k = torch.randn(3, n_pages * ps, KV, dh, generator=g, device=dev) * 3 - 0.5
    k[1, ps:] = 0                                   # dead pages: 0 and 0
    k[0, ps + 3, 0, 1] = float("nan")               # page 1
    k[2, 2 * ps:2 * ps + 2, KV - 1] = float("inf")  # page 2
    k[2, 3 * ps + 1, :, dh // 2] = -float("inf")    # page 3
    k = k.to(dtype)
    n0 = pp.page_minmax.launches
    mn, mx = ops.page_minmax(k, page_size=ps)
    assert pp.page_minmax.launches == n0 + 1
    pmn, pmx = pp.page_minmax_plain(k, page_size=ps)
    assert mn.dtype == torch.float32 and mn.shape == (3, n_pages, KV, dh)
    for got, want in ((mn, pmn), (mx, pmx)):
        nan = want.isnan()
        assert nan.any() and torch.equal(got.isnan(), nan)
        assert torch.equal(got.masked_fill(nan, 0).view(torch.int32),
                           want.masked_fill(nan, 0).view(torch.int32))
    with pytest.raises(ValueError):
        pp.page_minmax(k[:, :ps + 1], page_size=ps)


def _bm25_panel(dev, B, D, T, seed, dup=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    tf = torch.poisson(torch.full((B, D, T), 0.7, device=dev), generator=g)
    dl = torch.randint(16, 64, (B, D), generator=g, device=dev).float()
    if dup:                           # rows in equal pairs: exact ties
        tf[:, 1::2], dl[:, 1::2] = tf[:, ::2], dl[:, ::2]
    idf = torch.rand(B, T, generator=g, device=dev) + 0.1
    return tf, dl, idf


@pytest.mark.parametrize("B,D,T,block,k,valid,dup", [
    (1, 262144, 8, 4096, 4, 250000, False),  # the serving shape
    (1, 16384, 16, 4096, 64, None, False),   # the paper's Fig. 10 shape
    (2, 4096, 8, 1024, 8, 3000, True),       # valid < D, ties
    (4, 4096, 1, 1024, 16, None, True),
    (2, 1024, 8, 256, 32, 5, False),         # fewer live docs than k
])
def test_bm25_topk_kernel(dev, B, D, T, block, k, valid, dup):
    tf, dl, idf = _bm25_panel(dev, B, D, T, seed=D + k, dup=dup)
    n0 = bm.bm25_topk_candidates.launches
    kv, ki = ops.bm25_topk(tf, dl, idf, k, block=block, avgdl=40.0,
                           valid=valid)
    assert bm.bm25_topk_candidates.launches == n0 + 1
    cv, ci = bm.bm25_topk_candidates(tf, dl, idf, block=block, c=k,
                                     avgdl=40.0, valid=valid or 0)
    pcv, pci = bm.bm25_topk_candidates_plain(tf, dl, idf, block=block, c=k,
                                             avgdl=40.0, valid=valid or 0)
    assert torch.equal(torch.isfinite(cv), torch.isfinite(pcv))
    fin = torch.isfinite(pcv)
    torch.testing.assert_close(cv[fin], pcv[fin], rtol=TOL, atol=TOL)
    ops.use_kernels(False)
    try:
        pv, pi = ops.bm25_topk(tf, dl, idf, k, block=block, avgdl=40.0,
                               valid=valid)
    finally:
        ops.use_kernels(True)
    fin = torch.isfinite(pv)
    torch.testing.assert_close(kv[fin], pv[fin], rtol=TOL, atol=TOL)
    assert torch.equal(ki, pi)
    assert torch.equal(ci, pci)


def _equal_outside_ties(kv, ki, pv, pi):
    """Candidate values within TOL of the plain version's (relative to the
    row's largest |score|); indices equal wherever the plain value is
    isolated by more than that from its neighbours, or exactly tied."""
    scale = pv.abs().nan_to_num(posinf=0.0, neginf=0.0).amax(
        -1, keepdim=True).clamp(min=1.0)
    assert torch.equal(torch.isfinite(kv), torch.isfinite(pv))
    fin = torch.isfinite(pv)
    err = ((kv - pv).abs() / scale)[fin]
    assert err.numel() == 0 or float(err.max()) <= TOL
    d = (pv[..., 1:] - pv[..., :-1]).abs().nan_to_num(nan=0.0)
    gap = torch.full_like(pv, float("inf"))
    gap[..., 1:] = torch.minimum(gap[..., 1:], d)
    gap[..., :-1] = torch.minimum(gap[..., :-1], d)
    tied = (pv == pv.roll(1, -1)) | (pv == pv.roll(-1, -1))
    keep = (gap > TOL * scale) | tied
    assert torch.equal(ki[keep], pi[keep])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,S,block,c,valid_len", [
    ("nb > 1 under a cluster split", 3, 2048, 512, 0, 0),
    ("valid_len inside a chunk", 2, 512, 512, 0, 300),
    ("c < block", 2, 1024, 512, 40, 700),
])
def test_relevancy_candidates_cluster_split(dev, dtype, name, B, S, block,
                                            c, valid_len):
    """DSA's index heads (64 x 128) on the tensor cores (bf16) or the CUDA
    cores (fp32), each block a cluster of split_plan CTAs; one launch."""
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(B, 64, 128, generator=g, device=dev).to(dtype)
    keys = torch.randn(B, S, 128, generator=g, device=dev).to(dtype)
    keys[-1, S // 4:] = 0                        # exact ties at zero
    w = torch.softmax(torch.randn(B, 64, generator=g, device=dev), -1)
    n_cta = rt.split_plan(B, S // block, block, c or block)
    assert n_cta > 1, name
    n0 = rt.relevancy_topk_candidates.launches
    kv, ki = rt.relevancy_topk_candidates(q, keys, w, block=block, c=c,
                                          valid_len=valid_len)
    assert rt.relevancy_topk_candidates.launches == n0 + 1
    pv, pi = rt.relevancy_topk_candidates_plain(q, keys, w, block=block,
                                                c=c, valid_len=valid_len)
    _equal_outside_ties(kv, ki, pv, pi)
    tied = pv[-1] == 0                           # the all-zero keys' rows
    assert bool(tied.any()) or c, "no tie compared"
    assert torch.equal(ki[-1][tied], pi[-1][tied])


@pytest.mark.parametrize("name,D,T,block,k,valid,min_chunk,dup", [
    # 8192 + 100 live: the count falls in the first CTA of block 2's cluster
    ("live count in a cluster's first CTA", 16384, 8, 4096, 16, 8292, None,
     False),
    # chunks of 2 docs (threads copy the slab): docs 0-1 | 2 | none | none
    ("3 live docs over two CTAs", 64, 8, 8, 8, 3, 2, False),
    # chunks of 4 docs (bulk copies, the second rounded up to 4 docs)
    ("6 live docs over two CTAs", 64, 8, 16, 8, 6, 4, False),
    ("c 64 at the Fig. 10 shape, duplicated rows", 16384, 16, 4096, 64,
     None, None, True),
])
def test_bm25_candidates_cluster_split(dev, monkeypatch, name, D, T, block,
                                       k, valid, min_chunk, dup):
    """Exact against the plain version, -inf entries and ties included;
    one launch a call."""
    if min_chunk:          # small chunks, so a few live docs span CTAs
        monkeypatch.setattr(rt, "MIN_CHUNK", min_chunk)
    n_cta = rt.split_plan(1, D // block, block, k)
    assert n_cta > 1, name
    tf, dl, idf = _bm25_panel(dev, 1, D, T, seed=D + k, dup=dup)
    n0 = bm.bm25_topk_candidates.launches
    cv, ci = bm.bm25_topk_candidates(tf, dl, idf, block=block, c=k,
                                     avgdl=40.0, valid=valid or 0)
    assert bm.bm25_topk_candidates.launches == n0 + 1
    pcv, pci = bm.bm25_topk_candidates_plain(tf, dl, idf, block=block, c=k,
                                             avgdl=40.0, valid=valid or 0)
    assert torch.equal(ci, pci)
    _equal_outside_ties(cv, ci, pcv, pci)
    if dup:
        assert bool((pcv[..., 1:] == pcv[..., :-1]).any()), "no tie compared"
    nd = torch.tensor(valid or 0, dtype=torch.int32, device=dev)
    cv2, ci2 = bm.bm25_topk_candidates(tf, dl, idf, block=block, c=k,
                                       avgdl=40.0, valid=nd)
    assert torch.equal(ci2, ci) and torch.equal(cv2, cv)


def test_engine_serves_rag_on_a_side_stream(dev):
    """Smoke-width engine with the RAG service in overlap mode on the card:
    the BM25 kernel launches once per query, and the tokens and doc ids
    equal the inline mode's."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data import build_corpus
    from repro_torch.models import init_params
    from repro_torch.retrieval import RetrievalConfig
    from repro_torch.serving import Engine, Request, ServeConfig

    cfg = get_arch("llama3.2-1b").smoke()
    params = init_params(cfg, 0, tp=4, device=dev)
    corpus = build_corpus(3000, retrieval_vocab=1024, doc_max=16,
                          gen_vocab=cfg.vocab_size, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (40, 24, 9)]
    out = {}
    for mode in ("inline", "overlap"):
        rcfg = RetrievalConfig(kind="rag", mode=mode, corpus=corpus, k=2,
                               tau=1.1, min_interval=3, max_retrievals=2,
                               validate=mode == "overlap")
        eng = Engine(cfg, params, ServeConfig(
            max_len=256, n_slots=3, method="dsa", tp=4, page=8,
            retrieval=rcfg), device=dev)
        n0 = bm.bm25_topk_candidates.launches
        hs = [eng.submit(Request(i, p, 8)) for i, p in enumerate(prompts)]
        eng.drain()
        events = [(e["slot"], e["ids"]) for e in eng.retrieval.events]
        assert events and all(h.done for h in hs)
        launches = bm.bm25_topk_candidates.launches - n0
        # validate replays each query through the kernel once more
        assert launches == len(events) * (2 if mode == "overlap" else 1)
        out[mode] = ([h.tokens for h in hs], events)
    assert out["inline"] == out["overlap"]


@pytest.mark.parametrize("B,S,H,KV,dh,window", [
    (1, 128, 4, 4, 32, 0),
    (2, 200, 8, 2, 64, 0),      # GQA + ragged tile
    (2, 256, 4, 4, 32, 48),     # sliding window below the tile
    (1, 37, 4, 1, 128, 0),      # S below the tile, one kv head
    (2, 1, 4, 2, 64, 0),        # one token
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, dtype, B, S, H, KV, dh, window):
    """Kernel against the plain version: fp32 within TOL; bf16 outputs
    within one bf16 ulp of the plain version's (both round an fp32
    result)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(B, S, n, dh, generator=g, device=dev).to(dtype)
               for n in (H, KV, KV))
    n0 = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window)
    assert fa.flash_attention.launches == n0 + 1
    want = ref.flash_attention(q, k, v, window=window or None)
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = (TOL, TOL) if dtype == torch.float32 else (2.0 ** -7,
                                                            2.0 ** -8)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_attention_kernel_reads_strides(dev):
    """q, k, v as views of one packed [B, S, H + 2 KV, dh] projection (not
    contiguous): the kernel reads them through their strides and equals
    the plain version on contiguous copies."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(5)
    B, S, H, KV, dh = 2, 130, 8, 2, 64
    qkv = torch.randn(B, S, H + 2 * KV, dh, generator=g, device=dev)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v, window=50)
    want = ref.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), window=50)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_flash_attention_gradients(dev):
    """``FlashAttention``'s dq/dk/dv against autograd through the plain
    version, fp32, GQA and a window."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(2, 150, n, 64, generator=g, device=dev)
               for n in (8, 2, 2))
    cot = torch.randn(2, 150, 8, 64, generator=g, device=dev)
    grads = []
    for fn in (lambda *a: fa.FlashAttention.apply(*a, 40),
               lambda *a: ref.flash_attention(*a, window=40)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*ts).backward(cot)
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def _bf16_close(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2.0 ** -8)


@pytest.mark.parametrize("B,S,H,KV,dh,window", [
    (4, 2048, 32, 8, 64, 0),      # training (llama3.2-1b)
    (2, 512, 32, 8, 64, 0),       # bucketed prefill
    (1, 8192, 32, 8, 128, 4096),  # mixtral's window
    (2, 6024, 32, 8, 64, 0),      # MemAgent's segment prefill
    (2, 1088, 32, 8, 64, 0),      # MemAgent's answer prefill
    (2, 200, 8, 2, 64, 0),        # ragged S
    (2, 37, 8, 8, 128, 0),        # S below the tile
    (2, 256, 8, 2, 64, 48),       # a window below the tile
    (1, 300, 4, 4, 64, 0),        # G = 1
    (1, 700, 8, 2, 128, 96),
    (2, 4480, 32, 32, 112, 0),    # zamba2's prefill (dh 112, G = 1)
    (2, 200, 8, 2, 112, 0),       # dh 112: ragged S, G = 4
    (2, 37, 8, 8, 112, 0),        # dh 112: S below the tile
    (2, 256, 8, 4, 112, 48),      # dh 112: a window below the tile, G = 2
    (1, 700, 8, 2, 112, 96),      # dh 112: a window
])
def test_flash_attention_tensor_core_route(dev, B, S, H, KV, dh, window):
    """bf16 at head dim 64, 112 and 128 takes the tensor-core kernel, within
    one bf16 ulp of the plain version."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(B, S, n, dh, generator=g, device=dev).bfloat16()
               for n in (H, KV, KV))
    n0 = dict(fa.ROUTE_LAUNCHES)
    got = fa.flash_attention(q, k, v, window=window)
    assert fa.ROUTE_LAUNCHES[fa.TENSOR_CORES] == n0[fa.TENSOR_CORES] + 1
    assert fa.ROUTE_LAUNCHES[fa.CUDA_CORES] == n0[fa.CUDA_CORES]
    _bf16_close(got, ref.flash_attention(q, k, v, window=window or None))


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 32)])
def test_flash_attention_cuda_core_route(dev, dtype, dh):
    """fp32, and bf16 at a head dim the tensor-core kernel does not take,
    stay on the CUDA-core kernel."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(1, 150, n, dh, generator=g, device=dev).to(dtype)
               for n in (4, 2, 2))
    n0 = dict(fa.ROUTE_LAUNCHES)
    got = fa.flash_attention(q, k, v)
    assert fa.ROUTE_LAUNCHES[fa.CUDA_CORES] == n0[fa.CUDA_CORES] + 1
    assert fa.ROUTE_LAUNCHES[fa.TENSOR_CORES] == n0[fa.TENSOR_CORES]
    want = ref.flash_attention(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dtype,window", [(torch.float32, 0),
                                          (torch.bfloat16, 0),
                                          (torch.float32, 96)])
def test_flash_attention_head_dim_112(dev, dtype, window):
    """zamba2's shared block: dh 112, G = 1, ragged S; bf16 on the
    tensor-core kernel (two 64-channel boxes a tile, zero past 112), fp32
    on the CUDA-core kernel (7 output channels a thread), the exact
    route."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(2, 300, 4, 112, generator=g, device=dev).to(dtype)
               for _ in range(3))
    route = fa.TENSOR_CORES if dtype == torch.bfloat16 else fa.CUDA_CORES
    n0 = dict(fa.ROUTE_LAUNCHES)
    got = fa.flash_attention(q, k, v, window=window)
    assert {r: fa.ROUTE_LAUNCHES[r] - n0[r] for r in n0} == {
        r: int(r == route) for r in n0}
    want = ref.flash_attention(q, k, v, window=window or None)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("dh", [64, 112])
def test_flash_attention_tensor_core_copies_misaligned_views(dev, dh):
    """bf16 views whose base is 2 bytes off 16 (no TMA) are copied, and the
    result equals the plain version on contiguous copies."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(9)
    B, S, H, KV = 2, 130, 8, 2
    qkv = torch.randn(B, S, H + 2 * KV + 1, dh, generator=g,
                      device=dev).bfloat16().reshape(-1)[1:]
    qkv = qkv[:B * S * (H + 2 * KV) * dh].view(B, S, H + 2 * KV, dh)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert q.data_ptr() % 16 != 0
    n0 = fa.ROUTE_LAUNCHES[fa.TENSOR_CORES]
    got = fa.flash_attention(q, k, v, window=50)
    assert fa.ROUTE_LAUNCHES[fa.TENSOR_CORES] == n0 + 1
    _bf16_close(got, ref.flash_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), window=50))


@pytest.mark.parametrize("B,n_sel,ps", [
    (4, 128, 16),     # DSA on llama3.2-1b: 8 splits of 16 pages
    (4, 64, 64),      # Seer / LServe: 16 splits of 4 pages
    (1, 128, 16),     # one slot: 19 splits, the last of 2 pages
    (4, 100, 16),     # n_sel x ps not a multiple of the split
])
def test_paged_decode_attention_split_shapes(dev, B, n_sel, ps):
    g = torch.Generator(device=dev).manual_seed(10)
    KV, G, dh, S = 8, 4, 64, 8192
    q = torch.randn(B, KV * G, dh, generator=g, device=dev).bfloat16()
    kc = torch.randn(B, S, KV, dh, generator=g, device=dev).bfloat16()
    vc = torch.randn(B, S, KV, dh, generator=g, device=dev).bfloat16()
    pages = torch.stack([torch.randperm(S // ps, generator=g, device=dev)
                         [:n_sel] for _ in range(B)]).to(torch.int32)
    length = torch.full((B,), S - 100, dtype=torch.int32, device=dev)
    ko, kl = sda.paged_decode_attention(q, kc, vc, pages, length,
                                        page_size=ps)
    po, pl_ = ref.paged_decode_attention(q, kc, vc, pages, ps, length)
    torch.testing.assert_close(ko, po, rtol=TOL, atol=TOL)
    torch.testing.assert_close(kl, pl_, rtol=TOL, atol=TOL)


def test_paged_decode_attention_all_masked_ragged_split(dev):
    """A slot whose selected pages all lie at or past its length, in splits
    of unequal size: the output is the mean of v over every loaded token
    (an (out, lse) merge of the splits would weight the splits equally)."""
    g = torch.Generator(device=dev).manual_seed(11)
    B, KV, G, dh, S, ps, n_sel = 3, 8, 4, 64, 1024, 16, 13
    pps, n_split = sda.split_plan(B, KV, G, n_sel, ps, n_sm=torch.cuda
                                  .get_device_properties(dev)
                                  .multi_processor_count)
    assert n_sel % pps != 0, (pps, n_split)      # a ragged last split
    q = torch.randn(B, KV * G, dh, generator=g, device=dev).bfloat16()
    kc = torch.randn(B, S, KV, dh, generator=g, device=dev).bfloat16()
    vc = torch.randn(B, S, KV, dh, generator=g, device=dev).bfloat16()
    pages = torch.arange(20, 20 + n_sel, dtype=torch.int32,
                         device=dev).repeat(B, 1)
    length = torch.tensor([100, 0, 320], dtype=torch.int32, device=dev)
    ko, kl = sda.paged_decode_attention(q, kc, vc, pages, length,
                                        page_size=ps)
    want = vc[:, 20 * ps:(20 + n_sel) * ps].float().mean(1)  # [B,KV,dh]
    torch.testing.assert_close(ko.reshape(B, KV, G, dh),
                               want[:, :, None].expand(B, KV, G, dh),
                               rtol=TOL, atol=TOL)
    po, pl_ = ref.paged_decode_attention(q, kc, vc, pages, ps, length)
    torch.testing.assert_close(kl, pl_, rtol=TOL, atol=TOL)


def test_train_step_kernel_matches_plain(dev):
    """Smoke-width fp32 loss and gradients through the flash kernel equal
    the plain path's; remat runs the kernel twice per layer."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params
    from repro_torch.train import TrainConfig, loss_and_grads
    from repro_torch.train.optimizer import leaves

    cfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    params = init_params(cfg, 0, tp=4, device=dev)
    b = TokenStream(cfg.vocab_size, 96, 2, seed=0).next_batch()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    tc = TrainConfig(tp=4, remat=True)
    n0 = fa.flash_attention.launches
    loss, grads = loss_and_grads(params, cfg, tc, batch)
    assert fa.flash_attention.launches - n0 == 2 * cfg.n_layers
    ops.use_kernels(False)
    try:
        ploss, pgrads = loss_and_grads(params, cfg, tc, batch)
    finally:
        ops.use_kernels(True)
    assert float(loss) == pytest.approx(float(ploss), rel=1e-5)
    for a, b_ in zip(leaves(grads), leaves(pgrads)):
        scale = max(float(b_.abs().max()), 1e-30)
        assert float((a - b_).abs().max()) <= 1e-4 * scale


def _smoke_engine(dev, arch="llama3.2-1b", **sc_kw):
    """Smoke-width engine of ``arch`` on the card (fp32: the comparisons
    below are bitwise), seeded weights."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_arch(arch).smoke().replace(dtype="float32")
    params = init_params(cfg, 0, tp=4, device=dev)
    sc = ServeConfig(**dict(dict(max_len=256, n_slots=3, tp=4, page=8,
                                 kv_page_size=16), **sc_kw))
    return Engine(cfg, params, sc, device=dev, seed=1)


def _smoke_prompts(eng, lens=(40, 24, 9)):
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, eng.cfg.vocab_size, size=n) for n in lens]


@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
def test_fused_graph_window_equals_stepped(dev, method):
    """A window replayed as a CUDA graph equals K stepped calls: after the
    same number of device steps the emitted tokens, the pending tokens and
    the KV pool pages are equal bit for bit; every window replays a graph
    (captures counted, no eager window), and the kernel launches counted
    for the replays are n_layers per sparse step the device computed."""
    _window_equals_stepped(dev, method, "llama3.2-1b")


def test_moe_fused_graph_window_equals_stepped(dev):
    """The same with granite's MoE inside the graph: index dispatch with
    fixed shapes and no host sync; dead slots' tokens route as in the
    stepped loop."""
    _window_equals_stepped(dev, "dsa", "granite-moe-1b-a400m")


def _window_equals_stepped(dev, method, arch):
    import numpy as np
    from repro_torch.serving import Request

    engs = {K: _smoke_engine(dev, arch, method=method, fused_steps=K)
            for K in (1, 8)}
    fused = engs[8]
    name = ("page_minmax" if method == "lserve"
            else "relevancy_topk_candidates")
    streams = {}
    for K, eng in engs.items():
        for i, p in enumerate(_smoke_prompts(eng)):
            eng.submit(Request(i, p, 24))
        streams[K] = {}
    n0 = ops.launch_counts()[name]
    s0 = fused.stats["sparse_device_steps"]
    while fused.busy():
        ev = fused.poll()
        for rid, _s, tok in ev:
            streams[8].setdefault(rid, []).append(tok)
        ref = engs[1]
        while ref.stats["decode_steps"] < fused.stats["decode_steps"]:
            for rid, _s, tok in ref.poll():
                streams[1].setdefault(rid, []).append(tok)
        assert streams[1] == streams[8]
        assert np.array_equal(ref._pending, fused._pending)
        for k in ("k_pages", "v_pages"):
            assert torch.equal(ref.pool.device[k], fused.pool.device[k])
    st = fused.stats
    assert st["host_steps"] < st["decode_steps"]
    assert st["graph_captures"] >= 1 and st["graph_capture_s"] > 0
    n_layers = fused.cfg.n_layers
    assert ops.launch_counts()[name] - n0 >= n_layers * (
        st["sparse_device_steps"] - s0) > 0


@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
@pytest.mark.parametrize("fused_steps", [1, 4])
def test_offload_overlap_two_streams_equals_sync(dev, method, fused_steps):
    """The offload side on a CUDA stream of its own: overlap (select on
    the offload stream under apply on the main stream) equals sync token
    for token, and every consumed selection replays bit for bit
    (validate)."""
    from repro_torch.serving import OffloadConfig, Request

    out = {}
    for mode in ("sync", "overlap"):
        eng = _smoke_engine(dev, method=method, fused_steps=fused_steps,
                            offload_cfg=OffloadConfig(
                                mode=mode, validate=mode == "overlap"))
        assert eng.hetero.report()["devices"]["offload_stream"]
        hs = [eng.submit(Request(i, p, 12))
              for i, p in enumerate(_smoke_prompts(eng))]
        eng.drain()
        assert all(h.done for h in hs)
        assert eng.hetero.profiler.offload_steps > 0
        out[mode] = [h.tokens for h in hs]
    assert out["sync"] == out["overlap"]


def test_fused_capture_failure_raises(dev, monkeypatch):
    """A window whose capture fails (a host read inside the captured
    region) raises out of ``poll``; nothing steps eagerly in its place."""
    from repro_torch.serving import Request
    from repro_torch.serving import fused as F

    real = F.make_fused_paged

    def syncing(*a, **kw):
        fn = real(*a, **kw)

        def window(ins):
            out = fn(ins)
            int(out["host"][0])          # a device->host read: uncapturable
            return out
        return window

    monkeypatch.setattr(F, "make_fused_paged", syncing)
    eng = _smoke_engine(dev, method="dsa", fused_steps=4)
    eng.submit(Request(0, _smoke_prompts(eng)[0], 8))
    with pytest.raises(RuntimeError):
        eng.poll()
    assert eng.stats["decode_steps"] == 0
    assert eng.stats["graph_captures"] == 0


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_paged_decode_on_one_card(dev, n):
    """``distributed_paged_sparse_decode`` over n shards of ``(cuda:0,) * n``
    (one paged-attention launch a shard) == the single kernel and == the
    plain version, for selections with -1 holes, ragged lengths and the
    force-included live page in every row."""
    from repro_torch.distributed.topk import distributed_paged_sparse_decode

    g = torch.Generator(device=dev).manual_seed(5)
    B, KV, G, dh, S, ps = 4, 8, 4, 64, 2048, 16
    lens = torch.tensor([2000, 1031, 517, 16], dtype=torch.int32,
                        device=dev)
    q = torch.randn(B, KV * G, dh, generator=g, device=dev).bfloat16()
    kc = torch.randn(B, S, KV, dh, generator=g, device=dev).bfloat16()
    vc = torch.randn(B, S, KV, dh, generator=g, device=dev).bfloat16()
    pages = torch.stack([torch.randperm(S // ps, generator=g, device=dev)
                         [:40] for _ in range(B)]).to(torch.int32)
    pages[:, ::3] = -1
    pages[:, -1] = ((lens - 1) // ps).to(torch.int32)   # the live page
    pages[:, :-1] = torch.where(pages[:, :-1] == pages[:, -1:], -1,
                                pages[:, :-1])
    mesh = (dev,) * n
    n0 = sda.paged_decode_attention.launches
    out, lse = distributed_paged_sparse_decode(q, kc, vc, pages, lens, mesh,
                                               page_size=ps)
    assert sda.paged_decode_attention.launches == n0 + n
    ko, kl = ops.paged_decode_attention(q, kc, vc, pages, lens, page_size=ps)
    po, pl_ = sda.paged_decode_attention_plain(q, kc, vc, pages, lens,
                                               page_size=ps)
    for a, b in ((out, ko), (lse, kl), (out, po), (lse, pl_)):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_relevancy_topk_on_one_card(dev, n):
    """``distributed_relevancy_topk`` over n shards on one card (one
    relevancy launch a shard) == ``ops.relevancy_topk``, values and
    indices bit for bit (each key's score does not depend on its shard)."""
    from repro_torch.distributed.topk import distributed_relevancy_topk

    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(4, 64, 128, generator=g, device=dev).bfloat16()
    keys = torch.randn(4, 512, 128, generator=g, device=dev).bfloat16()
    keys[3, 200:] = 0                                # ties at zero
    w = torch.softmax(torch.randn(4, 64, generator=g, device=dev), -1)
    n0 = rt.relevancy_topk_candidates.launches
    v, i = distributed_relevancy_topk(q, keys, w, 128, (dev,) * n)
    assert rt.relevancy_topk_candidates.launches == n0 + n
    kv, ki = ops.relevancy_topk(q, keys, w, 128)
    assert torch.equal(i, ki) and torch.equal(v, kv)


def test_sharded_offload_and_mesh_on_one_card(dev):
    """Two selection shards on streams of their own, and the main mesh
    clamped to the card: overlap == the single-shard sync run, stepped and
    in 4-step CUDA-graph windows."""
    from repro_torch.serving import OffloadConfig, Request

    out = {}
    for name, mode, shards, mesh, fused in (
            ("sync", "sync", 1, 1, 1), ("shards2", "overlap", 2, 1, 1),
            ("shards2-fused4", "overlap", 2, 1, 4),
            ("mesh2", "overlap", 1, 2, 1), ("both-fused4", "overlap", 2, 2,
                                            4)):
        eng = _smoke_engine(dev, method="dsa", fused_steps=fused,
                            offload_cfg=OffloadConfig(
                                mode=mode, shards=shards, main_mesh=mesh,
                                validate=mode == "overlap"))
        rep = eng.hetero.report()["devices"]
        if shards > 1:
            assert rep["offload_streams"] == shards
        if mesh > 1:
            assert len(rep["main_mesh"]) == 1          # one card
        hs = [eng.submit(Request(i, p, 12))
              for i, p in enumerate(_smoke_prompts(eng))]
        eng.drain()
        assert all(h.done for h in hs)
        out[name] = [h.tokens for h in hs]
    assert all(v == out["sync"] for v in out.values())


def test_router_two_replicas_on_one_card(dev):
    """Two replicas share the card and its weights; each replica's tokens
    equal a fresh engine's fed its requests in the same order."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, Request, Router, ServeConfig

    cfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    params = init_params(cfg, 0, tp=4, device=dev)
    sc = ServeConfig(max_len=256, n_slots=3, tp=4, page=8, kv_page_size=16,
                     method="dsa")
    router = Router.build(cfg, params, sc, 2, seed=1, device=dev)
    a, b = (r.engine for r in router.replicas)
    assert a.params["lm_head"]["w"].data_ptr() == \
        b.params["lm_head"]["w"].data_ptr()
    prompts = _smoke_prompts(a, (40, 24, 9, 33))
    hs = [router.submit(Request(i, p, 10)) for i, p in enumerate(prompts)]
    router.drain()
    assert {h.replica for h in hs} == {0, 1}
    for rep in router.replicas:
        mine = [h for h in hs if h.replica == rep.index]
        lone = Engine(cfg, params, sc, device=dev, seed=1)
        got = [lone.submit(Request(h.rid, prompts[h.rid], 10)) for h in mine]
        lone.drain()
        assert [h.tokens for h in got] == [h.tokens for h in mine]


def test_memagent_and_ttt_on_card_match_cpu(dev):
    """MemAgent's segment loop (fp32 smoke width, the prefills through the
    flash kernel, one launch a layer a prefill) gives the CPU run's answer
    tokens; ``ttt_forward`` on the card within 1e-5 of the CPU's."""
    from repro_torch.configs import get_arch
    from repro_torch.core.methods import memagent, ttt
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params

    cfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    ma = memagent.MemAgentConfig(segment_len=16, mem_len=4, max_answer=4)
    g = torch.Generator().manual_seed(3)
    doc = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    qn = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    answers = {}
    for d in ("cpu", dev):
        params = init_params(cfg, 0, tp=4, device="cpu")
        p, pf, df = memagent.role_fns(params, cfg, d, d, tp=4)
        n0 = fa.flash_attention.launches
        answers[str(d)] = memagent.run_memagent(
            p, cfg, doc.to(d), qn.to(d), ma, prefill_fn=pf,
            decode_fn=df).cpu()
        if d != "cpu":
            assert fa.flash_attention.launches == n0 + 3 * cfg.n_layers
    assert torch.equal(answers["cpu"], answers[str(dev)])
    p = ttt.ttt_init(cfg, 0, fast_dim=32, device="cpu")
    x = torch.randn(2, 128, cfg.d_model, generator=g)
    w0 = ttt.fast_state_init(cfg, 2, fast_dim=32, device="cpu")
    y, w = ttt.ttt_forward(p, x, w0, chunk=32)
    yc, wc = ttt.ttt_forward({k: v.to(dev) for k, v in p.items()}, x.to(dev),
                             w0.to(dev), chunk=32)
    torch.testing.assert_close(yc.cpu(), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wc.cpu(), w, rtol=1e-5, atol=1e-5)
