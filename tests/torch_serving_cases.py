"""Shared setup of the port's multi-device serving tests
(``test_torch_router.py``, ``test_torch_sharded.py``,
``test_torch_distributed.py``): the smoke config at float32 and tp=4 on both
sides, the JAX weights carried over by ``weights.from_jax_params``, the
JAX engine's method weights at ``PRNGKey(0)``, the 48-doc corpus of the
reference's tests, and the drivers both engines take."""
import functools

import numpy as np
import torch

import jax

from repro.configs import get_arch as jget_arch
from repro.data import build_corpus as jbuild_corpus
from repro.models import init_params as jinit
from repro.retrieval import RetrievalConfig as JRetrievalConfig
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs import get_arch
from repro_torch.data import build_corpus
from repro_torch.retrieval import RetrievalConfig
from repro_torch.weights import from_jax_params

TP = 4
CORPUS_KW = dict(retrieval_vocab=128, doc_max=8, embed_dim=16, seed=0)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def setup():
    """(jax cfg, port cfg, jax params, port params)."""
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), tp=TP)
    return jcfg, tcfg, jparams, from_jax_params(np_tree(jparams), "cpu")


@functools.lru_cache(maxsize=None)
def sparse_params(method):
    """The JAX engine's method weights at key PRNGKey(0): (jax, port)."""
    jcfg, _, jparams, _ = setup()
    jeng = JEngine(jcfg, jparams, JServeConfig(method=method, max_len=64,
                                               n_slots=2, tp=TP),
                   key=jax.random.PRNGKey(0))
    return jeng.sparse_params, from_jax_params(
        np_tree(jeng.sparse_params), "cpu")


@functools.lru_cache(maxsize=None)
def corpora(n_docs: int = 48):
    """The same corpus on both sides: (jax, port)."""
    vocab = setup()[0].vocab_size
    return (jbuild_corpus(n_docs, gen_vocab=vocab, **CORPUS_KW),
            build_corpus(n_docs, gen_vocab=vocab, device="cpu",
                         **CORPUS_KW))


def rcfg(mode, *, jax_side=False, **kw):
    """The reference tests' retrieval config: rag over the corpus, FLARE at
    tau 1.1 (every step fires), one retrieval a request."""
    jc, tc = corpora()
    cls = JRetrievalConfig if jax_side else RetrievalConfig
    return cls(mode=mode, kind="rag", corpus=jc if jax_side else tc, k=2,
               trigger="flare", tau=1.1, min_interval=3, max_retrievals=1,
               query_window=6, **kw)


def prompts(sizes, seed):
    rng = np.random.default_rng(seed)
    vocab = setup()[0].vocab_size
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in sizes]


def drain(eng, n_steps):
    """``n_steps`` polls -> {rid: [tokens]}."""
    got = {}
    for _ in range(n_steps):
        for rid, _slot, tok in eng.poll():
            got.setdefault(rid, []).append(int(tok))
    return got


def events(eng):
    return [(e["slot"], tuple(int(i) for i in e["ids"]))
            for e in eng.retrieval.events]


def free_pages_zero(pool) -> bool:
    """Every page on the free list (and the reserved page 0) is zero."""
    idx = torch.as_tensor([0] + pool.free, dtype=torch.long)
    return not pool.device["k_pages"][:, idx].any() and \
        not pool.device["v_pages"][:, idx].any()
