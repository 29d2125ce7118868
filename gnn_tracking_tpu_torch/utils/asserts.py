"""Shape assertions (counterpart of the JAX ``utils/asserts.py``)."""

from __future__ import annotations


def assert_feat_dim(feat_vec, dim: int) -> None:
    """The last dimension of ``feat_vec`` is ``dim``."""
    assert feat_vec.shape[-1] == dim, f"Expected feature dimension {dim}, got {feat_vec.shape[-1]}"
