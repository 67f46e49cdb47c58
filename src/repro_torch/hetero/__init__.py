"""Device placement helpers of the port (twin of parts of ``repro.hetero``):
the transfer ledger and the device / CLI policy the retrieval subsystem
uses. The offload executor waits for ROADMAP Queue 1 item 8."""
from repro_torch.hetero.policy import pick_devices, resolve_cli_retrieval
from repro_torch.hetero.transfer import TransferLedger, pytree_bytes

__all__ = ["TransferLedger", "pick_devices", "pytree_bytes",
           "resolve_cli_retrieval"]
