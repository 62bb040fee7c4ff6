"""Input pipeline (port of ``ocflow_tpu/data/pipeline.py``): seeded splits,
a threaded loader, the device-resident cache and device placement.

The splits and the shuffles are the JAX package's numpy permutations, so
both packages see the same samples in the same order. Batches are dicts of
stacked tensors ``[B, ...]``.

Several ranks (``parallel.mesh``): ``batch_size`` is the global batch, and
rank ``r`` of ``N`` takes the contiguous block ``[r B / N, (r + 1) B / N)``
of each one, as the JAX package places a batch over one host's devices. A
loader built with ``block=(r, N)`` loads only that block of every global
batch; ``device_iterator(loader, device, mesh)`` takes the block from a
loader that loads whole batches. A ragged last eval batch is first padded to
a multiple of ``N`` by repeating its last sample, as the JAX
``device_iterator`` pads it (the val means include the repeated sample).
``shard_index`` / ``num_shards`` is the JAX package's per-process split of
the indices (``idx[shard_index::num_shards]``).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

from ocflow_torch import resolve_device
from ocflow_torch.data.datasets import DATASET_REGISTRY, Dataset
from ocflow_torch.parallel.mesh import Mesh, shard_batch


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)
        self.size = len(self.indices)
        self.replicates = 1

    def __getitem__(self, index):
        return self.dataset[self.indices[index % self.size]]


class CacheDataset(Dataset):
    """In-memory sample cache around any dataset: the first access of an
    index generates it, later ones return the kept sample. Thread-safe for
    the loader's worker pool (at worst a sample is generated twice)."""

    def __init__(self, dataset: Dataset):
        self.dataset = dataset
        self._cache: dict = {}
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        with self._lock:
            sample = self._cache.get(index)
        if sample is None:
            sample = self.dataset[index]
            with self._lock:
                self._cache[index] = sample
        return sample


def random_split(dataset: Dataset, fractions=(0.8, 0.1, 0.1), seed: int = 42):
    """Deterministic split by ``np.random.default_rng(seed).permutation``:
    the same indices as the JAX package's."""
    n = len(dataset)
    perm = np.random.default_rng(seed).permutation(n)
    sizes = [int(f * n) for f in fractions[:-1]]
    sizes.append(n - sum(sizes))
    out, start = [], 0
    for s in sizes:
        out.append(Subset(dataset, perm[start:start + s]))
        start += s
    return out


def _stack(samples: list[dict]) -> dict:
    return {k: torch.stack([torch.as_tensor(s[k]) for s in samples]) for k in samples[0]}


def _pad_ragged(n: int, world: int) -> int:
    """The samples to repeat so that a batch of ``n`` splits over ``world``."""
    return -n % world


class DataLoader:
    """Map-style loader: shuffling by ``default_rng((seed, epoch))``,
    batching, a worker thread pool, ``drop_last`` (train) or a kept ragged
    last batch (eval). Yields dicts of stacked tensors on the device the
    dataset generates on (the CPU for the file-backed datasets, whose
    decoders release the GIL, so the threads decode in parallel).

    ``shard_index`` / ``num_shards``: this process's strided share of the
    indices (the JAX multi-host split). ``block=(rank, world)``: only this
    rank's block of each global batch of ``batch_size`` (the module
    docstring; ``drop_last`` needs ``batch_size`` divisible by ``world``)."""

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 6, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1,
                 block: tuple[int, int] | None = None):
        if block is not None and drop_last and batch_size % block[1]:
            raise ValueError(f"a batch of {batch_size} does not split over {block[1]} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.block = block
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        else:
            idx = np.arange(n)
        return idx[self.shard_index::self.num_shards]

    def _chunks(self) -> Iterator[np.ndarray]:
        idx = self._indices()
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if self.block is not None:
                rank, world = self.block
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], _pad_ragged(len(chunk),
                                                                                 world))])
                chunk = shard_batch(torch.from_numpy(chunk), Mesh(rank, world)).numpy()
            yield chunk

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers <= 0:
            # loads in the calling thread (debugging, determinism)
            for chunk in self._chunks():
                yield _stack([self.dataset[int(i)] for i in chunk])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for chunk in self._chunks():
                yield _stack(list(pool.map(self.dataset.__getitem__, map(int, chunk))))


class DeviceCacheLoader(DataLoader):
    """The whole dataset resident on ``device``, batches served as gathers
    there: nothing crosses from the host in the step loop.

    Floating entries are kept in ``cache_dtype`` (bf16 halves the resident
    bytes) except the keys in ``fp32_keys``, supervision and metric targets
    (a bf16 flow of 30 px would sit on a 0.125 px grid and bias every EPE
    taken against it); other dtypes are kept as they are. Batches are
    ``index_select`` on the device, floats cast to fp32.

    Budget for ``configs/longrun_synthetic.yaml`` (160 samples at
    448x1024): images 160x448x1024x6 bf16 = 0.88 GB, flow fp32 0.59 GB, on
    an 80 GB H100 beside the training state.
    """

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 6, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1,
                 block: tuple[int, int] | None = None,
                 cache_dtype="bfloat16", fp32_keys=("flow", "occlusion", "valid"),
                 device=None):
        super().__init__(dataset, batch_size, shuffle, seed, num_workers, drop_last,
                         shard_index, num_shards, block)
        self.cache_dtype = getattr(torch, cache_dtype)
        self.fp32_keys = frozenset(fp32_keys)
        self.device = resolve_device(device)
        self._arrays = None

    def cache(self) -> dict:
        """The resident arrays per key, ``[N, ...]`` on ``device`` (built on
        first use: every sample generated, stacked and cast)."""
        if self._arrays is None:
            n = len(self.dataset)
            if self.num_workers > 0:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    samples = list(pool.map(self.dataset.__getitem__, range(n)))
            else:
                samples = [self.dataset[i] for i in range(n)]
            arrays = {}
            for k in samples[0] if samples else ():  # an empty split caches nothing
                stacked = torch.stack([torch.as_tensor(s[k]) for s in samples])
                if stacked.is_floating_point():
                    target = torch.float32 if k in self.fp32_keys else self.cache_dtype
                    stacked = stacked.to(target)
                arrays[k] = stacked.to(self.device)
            self._arrays = arrays
        return self._arrays

    def __iter__(self) -> Iterator[dict]:
        arrays = self.cache()
        for chunk in self._chunks():
            ci = torch.as_tensor(chunk, dtype=torch.long).to(self.device)
            out = {}
            for k, v in arrays.items():
                t = v.index_select(0, ci)
                out[k] = t.float() if t.is_floating_point() else t
            yield out


def prefetch(iterator, size: int = 2):
    """Run ``iterator`` in a background thread, ``size`` items ahead. An
    exception in the producer is raised in the consumer: a failing loader
    stops the training loop, it does not cut the epoch short."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    end = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 -- forwarded to the consumer
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def device_iterator(loader, device, mesh: Mesh | None = None, prefetch_size: int = 2):
    """Batches of ``loader`` on ``device``, prepared ``prefetch_size`` ahead
    in a background thread. Host batches bound for a GPU are pinned and
    copied without blocking; batches already there pass through.

    With a ``mesh`` of several ranks each batch is this rank's block: a
    loader built with ``block=(mesh.rank, mesh.size)`` yields it already;
    from any other loader the whole batch is padded (a ragged one, by
    repeating its last sample) and the block taken."""
    dev = resolve_device(device)
    split = mesh is not None and mesh.size > 1
    if split and getattr(loader, "block", None) is not None:
        if tuple(loader.block) != (mesh.rank, mesh.size):
            raise ValueError(f"loader block {loader.block} on rank {mesh.rank} of {mesh.size}")
        split = False

    def place(batch):
        if split:
            pad = _pad_ragged(next(iter(batch.values())).shape[0], mesh.size)
            if pad:
                batch = {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])])
                         for k, v in batch.items()}
            batch = shard_batch(batch, mesh)
        if dev.type == "cuda":
            return {k: v.pin_memory().to(dev, non_blocking=True) if v.device.type == "cpu"
                    else v.to(dev) for k, v in batch.items()}
        return {k: v.to(dev) for k, v in batch.items()}

    yield from prefetch((place(b) for b in loader), prefetch_size)


def build_dataset(name: str, **kwargs):
    try:
        ctor = DATASET_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown dataset {name!r}; the port has {sorted(DATASET_REGISTRY)}") from None
    return ctor(**kwargs)
