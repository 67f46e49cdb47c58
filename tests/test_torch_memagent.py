"""The port's MemAgent (``repro_torch.core.methods.memagent``) on the CPU
against the JAX package's, from the same JAX-initialized weights
(``from_jax_params``) on the same numpy document and question.

llama3.2-1b ``.smoke()`` at float32, tp 4, B 2, 16-token segments, a
4-token memory, 4-token answers, a 2-segment document. Greedy decoding on
both sides, so the answer tokens are compared exactly, with the counts of
``prefill_fn`` and ``decode_fn`` calls and the profilers' covers. The
pipeline descriptor's data flow is the reference's: apply prefills on the
raw memory, not on the synthesized one (ROADMAP Queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.methods import memagent as jma  # noqa: E402
from repro.core.pipeline import StageProfiler as JProfiler  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import methods as tmethods  # noqa: E402
from repro_torch.core.methods import memagent as tma  # noqa: E402
from repro_torch.core.pipeline import StageProfiler  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TP = 4
SEG, MEM, ANS, B = 16, 4, 4, 2


class Covers:
    """A profiler that keeps what it is told, in order."""

    def __init__(self):
        self.calls = []

    def record(self, method, covers, seconds):
        assert seconds >= 0
        self.calls.append((method, tuple(covers)))


def _counted(fn, counts, key):
    def wrapped(*a):
        counts[key] += 1
        return fn(*a)
    return wrapped


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    doc = rng.integers(0, jcfg.vocab_size, (B, 2 * SEG)).astype(np.int32)
    qn = rng.integers(0, jcfg.vocab_size, (B, 8)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, doc, qn


def _jax_run(setup, ma, profiler=None):
    jcfg, _, jparams, _, doc, qn = setup
    counts = {"prefill": 0, "decode": 0}
    pf = jax.jit(lambda p, t, ml: JM.prefill(p, jcfg, t, max_len=int(ml),
                                             tp=TP), static_argnums=(2,))
    df = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c, tp=TP))
    ans = jma.run_memagent(jparams, jcfg, jnp.asarray(doc), jnp.asarray(qn),
                           ma, prefill_fn=_counted(pf, counts, "prefill"),
                           decode_fn=_counted(df, counts, "decode"),
                           profiler=profiler)
    return np.asarray(ans), counts


def _torch_run(setup, ma, profiler=None):
    _, tcfg, _, tparams, doc, qn = setup
    counts = {"prefill": 0, "decode": 0}
    p, pf, df = tma.role_fns(tparams, tcfg, "cpu", "cpu", tp=TP)
    ans = tma.run_memagent(p, tcfg, torch.from_numpy(doc),
                           torch.from_numpy(qn), ma,
                           prefill_fn=_counted(pf, counts, "prefill"),
                           decode_fn=_counted(df, counts, "decode"),
                           profiler=profiler)
    return ans, counts


@pytest.mark.parametrize("n_seg", [1, 2])
def test_answers_and_call_counts_match_jax(setup, n_seg):
    ma = tma.MemAgentConfig(segment_len=SEG * 2 // n_seg, mem_len=MEM,
                            max_answer=ANS)
    jans, jcounts = _jax_run(setup, jma.MemAgentConfig(**vars(ma)))
    tans, tcounts = _torch_run(setup, ma)
    assert tans.dtype == torch.int32 and tans.shape == (B, ANS)
    np.testing.assert_array_equal(tans.numpy(), jans)
    assert tcounts == jcounts == {"prefill": n_seg + 1,
                                  "decode": n_seg * MEM + ANS - 1}


def test_profilers_record_the_same_covers(setup):
    ma = dict(segment_len=SEG, mem_len=MEM, max_answer=ANS)
    jc, tc = Covers(), Covers()
    _jax_run(setup, jma.MemAgentConfig(**ma), profiler=jc)
    _torch_run(setup, tma.MemAgentConfig(**ma), profiler=tc)
    assert tc.calls == jc.calls == [("memagent", ("prepare",))] * 2 + [
        ("memagent", ("apply",))]
    jp, tp_ = JProfiler(), StageProfiler()
    _jax_run(setup, jma.MemAgentConfig(**ma), profiler=jp)
    _torch_run(setup, tma.MemAgentConfig(**ma), profiler=tp_)
    live = lambda p: sorted(s for s, v in p.stage_seconds["memagent"].items()
                            if v > 0)
    assert live(tp_) == live(jp) == ["apply", "prepare"]


def test_each_segment_fills_its_cache_exactly(setup):
    """mem_len decode calls after a prefill of ctx tokens into a cache of
    ctx + mem_len: the last call writes the last row (its token is
    dropped); the answer's cache ends max_answer - 1 rows into its
    ctx + max_answer."""
    _, tcfg, _, tparams, doc, qn = setup
    ma = tma.MemAgentConfig(segment_len=SEG, mem_len=MEM, max_answer=ANS)
    p, pf, df = tma.role_fns(tparams, tcfg, "cpu", "cpu", tp=TP)
    phases = []          # per prefill: [max_len, (length, rows) at the end]

    def prefill(params, tokens, max_len):
        phases.append([max_len, None])
        return pf(params, tokens, max_len)

    def decode(params, tok, caches):
        logits, caches = df(params, tok, caches)
        phases[-1][1] = (caches["length"], caches["k"].shape[2])
        return logits, caches

    tma.run_memagent(p, tcfg, torch.from_numpy(doc), torch.from_numpy(qn),
                     ma, prefill_fn=prefill, decode_fn=decode)
    full = MEM + SEG + MEM
    q_len = MEM + qn.shape[1] + ANS
    assert phases == [[full, (full, full)]] * 2 + [
        [q_len, (q_len - 1, q_len)]]


def test_first_memory_is_zero_tokens(setup):
    """The first segment's prefill sees mem_len zero tokens before the
    segment, on both sides."""
    jcfg, tcfg, jparams, tparams, doc, qn = setup
    seen = {}

    def spy(side, pf):
        def fn(p, tokens, max_len):
            seen.setdefault(side, np.asarray(tokens))
            return pf(p, tokens, max_len)
        return fn

    ma = dict(segment_len=SEG, mem_len=MEM, max_answer=2)
    jpf = lambda p, t, ml: JM.prefill(p, jcfg, t, max_len=ml, tp=TP)
    jdf = lambda p, t, c: JM.decode_step(p, jcfg, t, c, tp=TP)
    jma.run_memagent(jparams, jcfg, jnp.asarray(doc), jnp.asarray(qn),
                     jma.MemAgentConfig(**ma), prefill_fn=spy("jax", jpf),
                     decode_fn=jdf)
    p, pf, df = tma.role_fns(tparams, tcfg, "cpu", "cpu", tp=TP)
    tma.run_memagent(p, tcfg, torch.from_numpy(doc), torch.from_numpy(qn),
                     tma.MemAgentConfig(**ma), prefill_fn=spy("torch", pf),
                     decode_fn=df)
    np.testing.assert_array_equal(seen["torch"], seen["jax"])
    assert not seen["torch"][:, :MEM].any()
    np.testing.assert_array_equal(seen["torch"][:, MEM:], doc[:, :SEG])


def test_build_pipeline_data_flow_matches_reference():
    """Relevancy is bypassed, so ``run`` hands apply the RAW memory: the
    synthesized one is dropped, in both packages."""
    synth = lambda M: ("synth", M)
    prefill = lambda Mp, x: ("prefill", Mp, x)
    want = jma.build_pipeline(synth, prefill).run("M0", "x")
    assert want == ("prefill", "M0", "x")
    pipe = tma.build_pipeline(synth, prefill)
    assert pipe.run("M0", "x") == want
    prof = StageProfiler()
    assert pipe.run("M0", "x", profiler=prof) == want
    assert [s for s, v in prof.stage_seconds["memagent"].items() if v > 0] \
        == ["prepare", "retrieve", "apply"]
    assert [s for s, _, _ in pipe.stages()] == \
        [s for s, _, _ in jma.build_pipeline(synth, prefill).stages()]


def test_registry_resolves_memagent():
    assert tmethods.module("memagent") is tma
    assert tmethods.offload_stages("memagent") == tma.OFFLOAD_STAGES == ()
    assert tma.MemAgentConfig() == tma.MemAgentConfig(5000, 1024, 32)
    assert vars(tma.MemAgentConfig()) == vars(jma.MemAgentConfig())
