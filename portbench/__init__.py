"""The benchmark of the PyTorch and CUDA port (``gnn_tracking_tpu_torch``) on
one NVIDIA H100: ``run.py`` runs one cell; see ``core.py``."""
