"""Memory-processing methods (twin of ``repro.core.methods``).
``get_sparse_method(name)`` returns (init_fn, make_sparse_fn) for the
sparse-attention family (dsa, seer, lserve); ``module(name)`` the method's
module (its ``build_pipeline``); ``sparse_kwargs(name, page)`` the keywords
its ``make_sparse_fn`` / ``build_pipeline`` take beyond the configs;
``offload_stages(name)`` the pipeline stages a method may move off the
KV-owning device; ``split_sparse(cfg, mem, page=)`` the method of
``mem.method`` over a sequence-split cache (``models.model.
decode_step_tp``). rag and mac (the document-memory family), memagent
(synthesized memory) and ttt (parameterized memory) have their own
application-level APIs and no sparse_fn."""
from repro_torch.core.methods import (dsa, lserve, mac, memagent, rag, seer,
                                      ttt)

_METHOD_MODULES = {"dsa": dsa, "seer": seer, "lserve": lserve, "rag": rag,
                   "memagent": memagent, "mac": mac, "ttt": ttt}

SPARSE_METHODS = {name: (getattr(mod, f"{name}_init"), mod.make_sparse_fn)
                  for name, mod in _METHOD_MODULES.items()
                  if name in ("dsa", "seer", "lserve")}


def module(name: str):
    if name not in _METHOD_MODULES:
        raise KeyError(f"unknown method {name!r}: "
                       f"{sorted(_METHOD_MODULES)}")
    return _METHOD_MODULES[name]


def get_sparse_method(name: str):
    if name not in SPARSE_METHODS:
        raise KeyError(f"unknown sparse method {name!r}: "
                       f"{sorted(SPARSE_METHODS)}")
    return SPARSE_METHODS[name]


def sparse_kwargs(name: str, page: int) -> dict:
    """Only DSA takes the micro-page size ``page``: Seer and LServe select
    whole ``block_size`` blocks, as in the reference's signatures."""
    return {"page": page} if name == "dsa" else {}


def offload_stages(name: str) -> tuple:
    """Stages of ``name`` that read only the compressed index (paper §5.2),
    declared per method as ``OFFLOAD_STAGES``. memagent and ttt declare
    none (their stages are model passes, paper §4), and unknown names like
    'none' offload nothing."""
    mod = _METHOD_MODULES.get(name)
    return getattr(mod, "OFFLOAD_STAGES", ()) if mod else ()


def split_sparse(cfg, mem, *, page: int, stateful: bool = False,
                 record: bool = False):
    """The split decode's counterpart of ``get_sparse_method``: ``mem.
    method`` over a sequence-split cache, ``dsa.SplitDSA`` at micro-pages
    of ``page`` tokens (``stateful``: its pooled index cache),
    ``seer.SplitSeer`` or ``lserve.SplitLServe`` at whole ``mem.
    block_size`` blocks (``sparse_kwargs``' rule: only DSA takes
    ``page``). Only DSA has a stateful form."""
    name = mem.method
    if name not in SPARSE_METHODS:
        raise KeyError(f"unknown sparse method {name!r}: "
                       f"{sorted(SPARSE_METHODS)}")
    if stateful and name != "dsa":
        raise ValueError(f"{name} has no stateful split: only DSA keeps an "
                         f"index cache")
    if name == "dsa":
        return dsa.SplitDSA(cfg, mem, page=page, stateful=stateful,
                            record=record)
    cls = seer.SplitSeer if name == "seer" else lserve.SplitLServe
    return cls(cfg, mem, record=record)
