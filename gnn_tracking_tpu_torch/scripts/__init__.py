"""The real-data training drivers (counterparts of the JAX package's
``scripts/train_trackml.py`` and ``scripts/train_multievent.py``), run as
``python -m gnn_tracking_tpu_torch.scripts.<name>``."""
