"""Memory-processing methods (twin of ``repro.core.methods``).
``get_sparse_method(name)`` returns (init_fn, make_sparse_fn) for the
sparse-attention family; the port has DSA so far."""
from repro_torch.core.methods import dsa

SPARSE_METHODS = {
    "dsa": (dsa.dsa_init, dsa.make_sparse_fn),
}
_NOT_PORTED = ("seer", "lserve")


def get_sparse_method(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"sparse method {name!r} is not ported yet (ROADMAP Queue 1 "
            f"item 6)")
    if name not in SPARSE_METHODS:
        raise KeyError(f"unknown sparse method {name!r}: "
                       f"{sorted(SPARSE_METHODS)}")
    return SPARSE_METHODS[name]
