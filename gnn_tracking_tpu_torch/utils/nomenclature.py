"""Metric and run naming (counterpart of the JAX ``utils/nomenclature.py``):
``denote_pt``, ``random_trial_name`` and the plot-label registry."""

from __future__ import annotations

import math
import random


def denote_pt(name: str, pt_min: float = 0.0) -> str:
    """Suffix a metric name with a pt threshold (e.g. ``_pt0.9``); none at 0."""
    if math.isclose(pt_min, 0.0):
        return name
    return f"{name}_pt{pt_min}"


_ADJECTIVES = (
    "swift", "quiet", "bright", "bold", "calm", "brisk", "deft", "keen",
    "lucid", "merry", "noble", "prime", "rapid", "solid", "vivid", "witty",
)
_NOUNS = (
    "falcon", "quark", "gluon", "pion", "meson", "tensor", "vertex", "sector",
    "barrel", "endcap", "pixel", "strip", "helix", "track", "lepton", "orbit",
)


def random_trial_name(rng: random.Random | None = None) -> str:
    """A short readable run name, ``<adjective>-<noun>-<nnn>``, drawn from
    ``rng`` (a fresh ``random.Random`` by default); the JAX package draws
    the same words from the same generator state."""
    rng = rng or random.Random()
    return f"{rng.choice(_ADJECTIVES)}-{rng.choice(_NOUNS)}-{rng.randint(0, 999):03d}"


class Variable:
    """A variable's name with its display string and unit."""

    def __init__(self, name: str, latex: str = "", unit: str = ""):
        self.name = name
        self.latex = latex or name
        self.unit = unit

    @property
    def latex_with_unit(self) -> str:
        if self.unit:
            return f"{self.latex} [{self.unit}]"
        return self.latex


class VariableManager:
    """Display names of the variables that plots label; an unknown name
    gives a plain :class:`Variable`."""

    def __init__(self):
        self._vars: dict[str, Variable] = {}
        for name, latex, unit in [
            ("pt", r"$p_T$", "GeV"),
            ("eta", r"$\eta$", ""),
            ("phi", r"$\phi$", "rad"),
            ("r", "$r$", "mm"),
            ("z", "$z$", "mm"),
            ("double_majority", "double majority eff.", ""),
            ("perfect", "perfect match eff.", ""),
            ("lhc", "LHC match eff.", ""),
        ]:
            self.register(Variable(name, latex, unit))

    def register(self, var: Variable) -> None:
        self._vars[var.name] = var

    def __getitem__(self, name: str) -> Variable:
        return self._vars.get(name, Variable(name))


variable_manager = VariableManager()
