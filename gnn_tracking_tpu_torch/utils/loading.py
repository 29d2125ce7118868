"""Event graphs on disk: the ``.npz`` archives that the JAX package's
``utils/loading.py:save_graph`` writes, read and written without JAX; and
the datasets, loaders and data module that feed the trainer (JAX
``utils/loading.py:148-335``)."""

from __future__ import annotations

import random
from collections import deque
from collections.abc import Iterator, Sequence
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import ARRAY_FIELDS, EventGraph, batch_graphs
from gnn_tracking_tpu_torch.utils.device import resolve_device


def save_graph(graph: EventGraph, path: str | Path) -> None:
    """Serialize an EventGraph to an ``.npz`` archive (JAX-compatible)."""
    arrays = {f: getattr(graph, f).detach().cpu().numpy() for f in ARRAY_FIELDS}
    for k, v in graph.extras.items():
        arrays[f"extra_{k}"] = v.detach().cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_graph(path: str | Path, *, device: str | torch.device = "cuda") -> EventGraph:
    """Load an EventGraph from an ``.npz`` archive onto ``device``."""
    dev = resolve_device(device)
    with np.load(path) as data:
        fields = {
            f: torch.from_numpy(np.array(data[f])).to(dev)
            for f in ARRAY_FIELDS
            if f in data
        }
        extras = {
            k[len("extra_") :]: torch.from_numpy(np.array(data[k])).to(dev)
            for k in data.files
            if k.startswith("extra_")
        }
    return EventGraph(**fields, extras=extras)


class TrackingDataset:
    """Sorted ``.npz`` graph files from one or more directories, with
    start/stop windowing (JAX ``TrackingDataset``). Each graph is loaded on
    the host and sorted by target (``EventGraph.sort_edges_by_target``), so
    it carries the CSR arrays that the CUDA kernels need."""

    def __init__(
        self,
        in_dir: str | Path | Sequence[str | Path],
        *,
        start: int = 0,
        stop: int | None = None,
        sector: int | None = None,
        suffix: str = "*.npz",
    ):
        dirs = [in_dir] if isinstance(in_dir, (str, Path)) else list(in_dir)
        available: list[Path] = []
        for d in map(Path, dirs):
            if not d.exists():
                msg = f"Directory {d} does not exist"
                raise FileNotFoundError(msg)
            glob = suffix if sector is None else f"*_s{sector}{suffix.lstrip('*')}"
            available.extend(sorted(d.glob(glob)))
        if stop is not None and stop > len(available):
            msg = f"stop={stop} exceeds number of available files ({len(available)})"
            raise ValueError(msg)
        self._paths = available[start:stop]

    def __len__(self) -> int:
        return len(self._paths)

    def __getitem__(self, idx: int) -> EventGraph:
        return load_graph(self._paths[idx], device="cpu").sort_edges_by_target()


class GraphLoader:
    """Host-side loader: optional shuffling (``random.Random(seed)``, made
    once per loader, so an epoch's order is the JAX loader's), subsampling,
    batches of ``batch_size`` graphs (above 1: their disjoint union,
    ``graphs.batch_graphs``, sorted by target, as the JAX loader batches
    them) and ``prefetch`` batches made ahead in background threads (npz
    decompression releases the GIL). The JAX loader's padding is not
    ported."""

    def __init__(
        self,
        dataset,
        *,
        batch_size: int = 1,
        shuffle: bool = False,
        sample_size: int | None = None,
        seed: int = 0,
        prefetch: int = 2,
    ):
        if batch_size < 1:
            msg = f"batch_size must be at least 1, got {batch_size}"
            raise ValueError(msg)
        self._dataset = dataset
        self._shuffle = shuffle
        self._sample_size = sample_size
        self._rng = random.Random(seed)
        self._prefetch = prefetch
        self.batch_size = batch_size

    def _n_graphs(self) -> int:
        n = len(self._dataset)
        return n if self._sample_size is None else min(n, self._sample_size)

    def __len__(self) -> int:
        return -(-self._n_graphs() // self.batch_size)

    def _batches(self) -> list[list[int]]:
        order = list(range(len(self._dataset)))
        if self._shuffle:
            self._rng.shuffle(order)
        order = order[: self._n_graphs()]
        return [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]

    def _batch(self, indices: list[int]) -> EventGraph:
        graphs = [self._dataset[i] for i in indices]
        if len(graphs) == 1:
            return graphs[0]
        return batch_graphs(graphs).sort_edges_by_target()

    def __iter__(self) -> Iterator[EventGraph]:
        batches = self._batches()
        if self._prefetch <= 0:
            for b in batches:
                yield self._batch(b)
            return
        with ThreadPoolExecutor(max_workers=self._prefetch) as pool:
            ahead = deque(pool.submit(self._batch, b) for b in batches[: self._prefetch])
            for k in range(len(batches)):
                graph = ahead.popleft().result()
                if k + self._prefetch < len(batches):
                    ahead.append(pool.submit(self._batch, batches[k + self._prefetch]))
                yield graph


class TrackingDataModule:
    """Train/val/test loaders from dict configs (JAX ``TrackingDataModule``)::

        dm = TrackingDataModule(
            train=dict(dirs=["/data/train"], stop=900),
            val=dict(dirs=["/data/val"], stop=50),
        )

    Config keys: ``dirs``, ``start``, ``stop``, ``sector``, ``batch_size``,
    ``sample_size``. The training loader shuffles with
    ``random.Random(seed)``, as the JAX loader does. ``PaddingConfig`` is a TPU static-shape
    device and is not ported.
    """

    def __init__(
        self,
        *,
        train: dict | None = None,
        val: dict | None = None,
        test: dict | None = None,
        seed: int = 0,
    ):
        self._configs = {"train": train, "val": val, "test": test}
        self._seed = seed
        self._datasets: dict[str, TrackingDataset | None] = {}

    def setup(self, stage: str = "fit") -> None:
        wanted = {"fit": ["train", "val"], "validate": ["val"], "test": ["test"]}[stage]
        for key in wanted:
            config = self._configs.get(key)
            if config is None:
                if key == "train":
                    msg = f"DataModule not configured for {key} data"
                    raise ValueError(msg)
                self._datasets[key] = None
                continue
            self._datasets[key] = TrackingDataset(
                config["dirs"],
                start=config.get("start", 0),
                stop=config.get("stop"),
                sector=config.get("sector"),
            )

    def has(self, key: str) -> bool:
        """Whether ``key`` ("train", "val", "test") is set up."""
        return self._datasets.get(key) is not None

    def _loader(self, key: str, shuffle: bool) -> GraphLoader:
        if not self.has(key):
            msg = f"DataModule not configured for {key} data"
            raise ValueError(msg)
        config = self._configs[key]
        return GraphLoader(
            self._datasets[key],
            batch_size=config.get("batch_size", 1),
            sample_size=config.get("sample_size"),
            shuffle=shuffle,
            seed=self._seed,
        )

    def train_dataloader(self) -> GraphLoader:
        return self._loader("train", shuffle=True)

    def val_dataloader(self) -> GraphLoader:
        return self._loader("val", shuffle=False)

    def test_dataloader(self) -> GraphLoader:
        return self._loader("test", shuffle=False)


class TestTrackingDataModule(TrackingDataModule):
    """In-memory data module for tests: the same graphs serve as the
    training, validation and test splits (each sorted by target, as
    :class:`TrackingDataset` sorts the graphs it loads), the training split
    shuffled as :class:`TrackingDataModule` shuffles it. ``padding`` is the
    JAX module's TPU static-shape device and must stay ``None``."""

    __test__ = False  # not a pytest test class

    class _ListDataset:
        def __init__(self, graphs):
            self._graphs = graphs

        def __len__(self):
            return len(self._graphs)

        def __getitem__(self, idx):
            return self._graphs[idx]

    def __init__(self, graphs: list[EventGraph], padding=None, seed: int = 0):
        if padding is not None:
            msg = "padding is not ported: the port runs every event at its own size"
            raise ValueError(msg)
        super().__init__(train={}, val={}, test={}, seed=seed)
        ds = self._ListDataset([g.sort_edges_by_target() for g in graphs])
        self._datasets = {"train": ds, "val": ds, "test": ds}

    def setup(self, stage: str = "fit") -> None:
        pass
