"""Dense-family model for the port (twin of ``repro.models``)."""
from repro_torch.models.model import (  # noqa: F401
    init_params,
    forward,
    last_logits,
    make_cache,
    prefill,
    decode_step,
    make_page_pool,
    decode_step_paged,
    decode_step_paged_presel,
    extend_paged,
    prefill_bucketed,
)
