"""Color helpers for plotting (counterpart of the JAX ``utils/colors.py``)."""

from __future__ import annotations

import colorsys


def lighten_color(color, amount: float = 0.5):
    """Lighten a color by scaling (1 - luminosity). Accepts matplotlib color
    names, hex strings or RGB tuples."""
    import matplotlib.colors as mc

    try:
        c = mc.cnames[color]
    except (KeyError, TypeError):
        c = color
    c = colorsys.rgb_to_hls(*mc.to_rgb(c))
    return colorsys.hls_to_rgb(c[0], 1 - amount * (1 - c[1]), c[2])
