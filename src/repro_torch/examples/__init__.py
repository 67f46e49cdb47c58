"""The port's twins of the repo's ``examples/*.py``, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.serve_sparse_attention
    PYTHONPATH=src python -m repro_torch.examples.rag_pipeline
    PYTHONPATH=src python -m repro_torch.examples.train_mac_100m

Each takes the reference example's arguments and defaults, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
path), and its ``main(argv=None)`` takes an argument list.
"""
