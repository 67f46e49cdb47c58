"""The port's examples (``repro_torch.examples``) on the CPU: the MaC
training loss of ``train_mac_100m`` and its gradients against a JAX twin of
the reference example's ``loss_fn`` (written here: the example keeps it
inside ``main``), three AdamW steps' losses against JAX's, and each
example's ``main`` end to end with ``--device cpu`` at small arguments.

Tolerances as in ``tests/test_torch_train.py``: the loss within 1e-5
relative, each gradient leaf within 1e-4 of its largest |g|, three steps'
losses within 1e-4 relative (fp32 on both sides, different summation
order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.methods import mac as jmac  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import adamw_update as jadamw  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.methods import mac  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.examples import (quickstart, rag_pipeline,  # noqa: E402
                                  serve_sparse_attention, train_mac_100m)
from repro_torch.train import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TP, SEG, B, SEGMENTS = 4, 32, 2, 2
MC = dict(segment_len=SEG, memory_slots=16, retrieve_k=2)
OC = dict(lr=3e-3, warmup_steps=5, total_steps=10)   # the example's at 3 steps


def jax_mac_loss(p, cfg, mc, tokens, labels, segments):
    """``examples/train_mac_100m.py``'s ``loss_fn``, with its closure's
    config, segment count and batch as arguments."""
    bank = jmac.bank_init(cfg, mc, tokens.shape[0])
    total = jnp.zeros(())
    for s in range(segments):
        seg = jax.lax.dynamic_slice_in_dim(tokens, s * mc.segment_len,
                                           mc.segment_len, 1)
        lab = jax.lax.dynamic_slice_in_dim(labels, s * mc.segment_len,
                                           mc.segment_len, 1)
        emb = JL.embed(p["backbone"]["embed"], seg)
        ctx, _ = jmac.segment_step(p["mac"], bank, emb, mc)
        h, _, _ = JM.forward(p["backbone"], cfg,
                             jnp.zeros(ctx.shape[:2], jnp.int32),
                             img_embeds=ctx, tp=TP)
        h_seg = h[:, mc.retrieve_k:]
        logits = JL.lm_head(p["backbone"]["lm_head"], h_seg, cfg)
        total += JL.cross_entropy(logits, lab)
        bank = jmac.push(bank, jmac.prepare_memory(p["mac"], h_seg))
    return total / segments


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jp = {"backbone": JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP),
          "mac": jmac.mac_init(jax.random.PRNGKey(1), jcfg)}
    stream = TokenStream(tcfg.vocab_size, SEG * SEGMENTS, B, seed=0)
    batches = [stream.next_batch() for _ in range(3)]
    return jcfg, tcfg, jp, batches


def _tparams(jp):
    return from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("slots,segments", [(16, SEGMENTS), (2, 3)])
def test_mac_loss_and_grads_match_jax(setup, slots, segments):
    """The example's bank (16 slots, 2 segments) and a full one (2 slots, 3
    segments). ``retrieve`` counts live slots from index 0 while ``push``
    appends at the end, so until the bank is full the pushed memories are
    never gathered and ``w_mem``'s gradient is 0 in both packages (ROADMAP
    Queue 3); once it is full, the third segment's loss reaches the
    earlier segments through the gathered bank values and
    ``prepare_memory``."""
    jcfg, tcfg, jp, _ = setup
    mc = dict(MC, memory_slots=slots)
    b = TokenStream(tcfg.vocab_size, SEG * segments, B, seed=4).next_batch()
    jl, jg = jax.value_and_grad(jax_mac_loss)(
        jp, jcfg, jmac.MacConfig(**mc), jnp.asarray(b["tokens"]),
        jnp.asarray(b["labels"]), segments)
    tp_ = _tparams(jp)
    ps = leaves(tp_)
    for p in ps:
        p.requires_grad_(True)
    loss = train_mac_100m.mac_loss(tp_, tcfg, mac.MacConfig(**mc),
                                   torch.from_numpy(b["tokens"]),
                                   torch.from_numpy(b["labels"]), segments)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    got = torch.autograd.grad(loss, ps, allow_unused=True)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(got)
    for (path, want), g in zip(flat, got):
        want = np.asarray(want)
        name = jax.tree_util.keystr(path)
        if g is None:      # not reached: the top-k query projection
            assert name == "['mac']['w_query']" and not want.any(), name
            continue
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-4 * scale, f"{name}: err {err} vs max|g| {scale}"
    w_mem = float(np.abs(np.asarray(jg["mac"]["w_mem"])).max())
    assert (w_mem > 0) == (segments > slots)


def test_three_adamw_steps_match_jax(setup):
    jcfg, tcfg, jp, batches = setup
    jmc, tmc = jmac.MacConfig(**MC), mac.MacConfig(**MC)
    joc, toc = JOptConfig(**OC), OptConfig(**OC)
    jopt, tp_ = jinit_opt(jp), _tparams(jp)
    topt = init_opt_state(tp_)
    for b in batches:
        jl, jg = jax.value_and_grad(jax_mac_loss)(
            jp, jcfg, jmc, jnp.asarray(b["tokens"]),
            jnp.asarray(b["labels"]), SEGMENTS)
        jp, jopt, _ = jadamw(jg, jopt, jp, joc)
        tp_, topt, tl = train_mac_100m.train_step(
            tp_, topt, toc, tcfg, tmc, torch.from_numpy(b["tokens"]),
            torch.from_numpy(b["labels"]), SEGMENTS)
        assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    assert topt.step == int(jopt.step) == 3


def test_train_mac_main_runs_and_learns():
    out = train_mac_100m.main(["--steps", "8", "--device", "cpu"])
    assert len(out["losses"]) == len(out["step_s"]) == 8
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    cfg, mc, batch = train_mac_100m.setup(full=True)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab_size, mc.segment_len, batch) == (12, 768, 12, 12,
                                                       32000, 256, 4)


def test_quickstart_main_runs():
    out = quickstart.main(["--device", "cpu"])
    assert out.shape == (4, 8) and (out >= 0).all()


def test_serve_sparse_attention_main_runs():
    handles = serve_sparse_attention.main(
        ["--requests", "5", "--max-new", "4", "--prompt-len", "20",
         "--device", "cpu"])
    assert len(handles) == 5 and all(h.done for h in handles)
    assert all(len(h.tokens) == 4 for h in handles)


def test_rag_pipeline_main_runs():
    rep = rag_pipeline.main(["--docs", "256", "--device", "cpu"])
    assert rep["n_replicas"] == 2 and rep["requests_done"] == 4
    assert rep["shared_corpus"]["n_docs"] == 256


@pytest.mark.parametrize("example", [quickstart, serve_sparse_attention,
                                     rag_pipeline, train_mac_100m])
def test_examples_default_to_the_card(example, monkeypatch):
    """No fallback: ``--device`` defaults to cuda, which raises without a
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        example.main([])
