"""The one traffic generator: synthetic full-detector events, drawn from a
seed by the parameters of a workload file.

The event is the full-detector driver's (``scripts/train_fulldetector.py``
of the port, and of the JAX package before it): ``n_tracks *
hits_per_track`` hits on azimuthally ordered tracks plus ``noise_frac`` noise
hits, ``k_edges`` locality-structured candidate edges a hit (neighbours in
the azimuthal order within +-64 positions, 2 % far pairs), per-track
embedding features. This is a copy, so that the yardstick does not move
when the program's generator does; it returns host numpy arrays, which both
the program and the reference take.

A workload's ``events`` block sets the pool: ``pool`` events, each with
``n_tracks`` tracks, or, with ``n_tracks_range: [lo, hi]``, sizes spread
evenly over the range. The seed draws each event's arrays and the order of
the sizes, never the sizes themselves, so every seed does the same work.
"""

from __future__ import annotations

import numpy as np

FEAT_DIM = 8
#: the stream of the sizes' order (beyond any pool's event numbers)
ORDER_STREAM = 2**32 - 1


def event_seed(seed: int, i: int) -> np.random.SeedSequence:
    """The seed of pool event ``i`` of a run seeded ``seed`` (any size of
    non-negative integer)."""
    return np.random.SeedSequence([int(seed), int(i)])


def full_detector_event(rng: np.random.Generator, *, n_tracks: int, hits_per_track: int = 16,
                        k_edges: int = 8, noise_frac: float = 0.02) -> dict[str, np.ndarray]:
    """One event as host arrays: ``x [N, 8]``, ``edge_index [2, E]`` int32,
    ``edge_attr [E, 4]``, ``y [E]``, ``particle_id [N]``, ``pt [N]``,
    ``eta [N]``, ``reconstructable [N]`` (float32 unless named)."""
    n_hits = n_tracks * hits_per_track
    phi_track = rng.uniform(0, 2 * np.pi, n_tracks)
    embed = rng.normal(size=(n_tracks, FEAT_DIM - 4)).astype(np.float32)
    pt_track = (0.3 + rng.exponential(0.9, n_tracks)).astype(np.float32)

    pid = np.repeat(np.arange(1, n_tracks + 1), hits_per_track)
    t = np.tile(np.linspace(0.0, 1.0, hits_per_track), n_tracks).astype(np.float32)
    phi = phi_track[pid - 1] + 0.03 * t * rng.normal(size=n_hits)

    n_noise = int(noise_frac * n_hits)
    phi = np.concatenate([phi, rng.uniform(0, 2 * np.pi, n_noise)])
    t = np.concatenate([t, rng.uniform(0, 1, n_noise).astype(np.float32)])
    pid = np.concatenate([pid, np.zeros(n_noise, dtype=pid.dtype)])
    n = len(pid)

    x = np.concatenate([
        np.cos(phi)[:, None], np.sin(phi)[:, None], t[:, None], (t**2)[:, None],
        np.where((pid > 0)[:, None], embed[np.clip(pid - 1, 0, None)], rng.normal(size=(n, FEAT_DIM - 4)))
        + 0.15 * rng.normal(size=(n, FEAT_DIM - 4)),
    ], axis=1).astype(np.float32)

    order = np.argsort(phi, kind="stable")
    x, pid = x[order], pid[order]

    e = n * k_edges
    dst = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    src = np.clip(dst + rng.integers(-64, 64, size=e), 0, n - 1).astype(np.int32)
    far = rng.random(e) < 0.02
    src = np.where(far, rng.integers(0, n, size=e), src).astype(np.int32)
    y = (pid[src] == pid[dst]) & (pid[src] > 0) & (src != dst)
    return {
        "x": x,
        "edge_index": np.stack([src, dst]),
        "edge_attr": (x[src, :4] - x[dst, :4]).astype(np.float32),
        "y": y.astype(np.float32),
        "particle_id": pid.astype(np.int64),
        "pt": np.concatenate([pt_track, [0.0]])[np.where(pid > 0, pid - 1, n_tracks)].astype(np.float32),
        "eta": np.zeros(n, dtype=np.float32),
        "reconstructable": (pid > 0).astype(np.float32),
    }


def pool_sizes(spec: dict, seed: int) -> list[int]:
    """The ``n_tracks`` of each pool event: one size, or sizes spread evenly
    over ``n_tracks_range`` in an order drawn from the seed."""
    pool = int(spec["pool"])
    if "n_tracks_range" not in spec:
        return [int(spec["n_tracks"])] * pool
    lo, hi = spec["n_tracks_range"]
    sizes = np.linspace(lo, hi, pool).round().astype(int)
    return [int(s) for s in np.random.default_rng(event_seed(seed, ORDER_STREAM)).permutation(sizes)]


def make_pool(spec: dict, seed: int) -> list[dict[str, np.ndarray]]:
    """The workload's pool of events for ``seed``."""
    kw = {k: spec[k] for k in ("hits_per_track", "k_edges", "noise_frac") if k in spec}
    return [full_detector_event(np.random.default_rng(event_seed(seed, i)), n_tracks=n, **kw)
            for i, n in enumerate(pool_sizes(spec, seed))]
