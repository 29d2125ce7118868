"""Keyword-tolerance helpers (counterpart of the JAX ``utils/signature.py``):
call a function with a superset of its keyword arguments."""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable


def get_all_argument_names(func: Callable) -> list[str]:
    """The names of ``func``'s positional-or-keyword and keyword-only
    arguments."""
    sig = inspect.signature(func)
    return [
        p.name
        for p in sig.parameters.values()
        if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
    ]


def remove_irrelevant_arguments(func: Callable, kwargs: dict[str, Any]) -> dict[str, Any]:
    """``kwargs`` without the keys that are not named arguments of ``func``."""
    names = set(get_all_argument_names(func))
    return {k: v for k, v in kwargs.items() if k in names}


def tolerate_additional_kwargs(func: Callable) -> Callable:
    """Decorator: the function takes keyword arguments only and ignores
    those it does not name."""

    @functools.wraps(func)
    def wrapped(**kwargs):
        return func(**remove_irrelevant_arguments(func, kwargs))

    return wrapped
