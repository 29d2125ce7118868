"""Version and commit helpers (counterpart of the JAX ``utils/versioning.py``),
with plain ``git`` subprocess calls."""

from __future__ import annotations

import logging
import os
import subprocess
from pathlib import Path

import gnn_tracking_tpu_torch

logger = logging.getLogger(__name__)


def get_commit_hash(path=None) -> str:
    """Git commit hash of the repository holding ``path`` (the port's
    package directory by default); ``"invalid"`` outside a repository.
    Warns when the repository has uncommitted changes."""
    env = None
    if path is None:
        path = Path(gnn_tracking_tpu_torch.__file__).resolve().parent
        # look no further up than the checkout that holds the package
        env = {**os.environ, "GIT_CEILING_DIRECTORIES": str(path.parent.parent)}
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=str(path), capture_output=True, text=True, timeout=10, check=True,
            env=env,
        )
    except (subprocess.SubprocessError, FileNotFoundError, NotADirectoryError):
        logger.warning("Could not find git repository at %s.", path)
        return "invalid"
    dirty = subprocess.run(
        ["git", "status", "--porcelain"], cwd=str(path), capture_output=True, text=True, timeout=10, env=env,
    ).stdout.strip()
    if dirty:
        logger.warning("Repository %s is dirty, commit hash may not be accurate.", path)
    return out.stdout.strip()


def _parse_version(v: str) -> tuple[int, ...]:
    return tuple(int(p) for p in v.split(".") if p.isdigit())


def assert_version_geq(require: str) -> None:
    """Fail unless the port's ``__version__`` is at least ``require``."""
    assert _parse_version(gnn_tracking_tpu_torch.__version__) >= _parse_version(require), (
        f"Please update gnn_tracking_tpu_torch from {gnn_tracking_tpu_torch.__version__} "
        f"to at least version {require}."
    )
