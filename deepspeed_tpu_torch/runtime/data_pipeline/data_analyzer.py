"""Offline dataset analysis and the indexed metric store (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_analyzer.py``).

Metric functions are mapped over a dataset with worker sharding, each worker
writes its shard files, and :meth:`DataAnalyzer.merge` joins them. Metrics
are per-sample scalars stored as one memory-mapped ``.npy`` per metric plus
the JSON manifest ``ds_metric_index.json``; variable-length rows (the
inverted metric-to-sample index) go in ``<prefix>.bin`` + ``<prefix>.idx.npz``.
The files are the reference's, so each package reads what the other wrote.
The curriculum sampler consumes a stored metric as its ``difficulty_fn``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np

_MANIFEST = "ds_metric_index.json"


def seqlen_metric(sample) -> float:
    """The stock difficulty metric: token count (curriculum seqlen)."""
    if isinstance(sample, Mapping):
        sample = sample.get("input_ids", next(iter(sample.values())))
    return float(np.asarray(sample).reshape(-1).shape[0])


class IndexedMetricStore:
    """Memory-mapped per-sample metric values.

    Random access without loading the file; one file per metric, a JSON
    manifest tying them together.
    """

    def __init__(self, path: str):
        self.path = path
        manifest = os.path.join(path, _MANIFEST)
        if not os.path.exists(manifest):
            raise FileNotFoundError(f"no metric index at {path}")
        with open(manifest) as f:
            self.manifest = json.load(f)
        self._arrays: Dict[str, np.ndarray] = {}

    @property
    def num_samples(self) -> int:
        return int(self.manifest["num_samples"])

    @property
    def metrics(self) -> Sequence[str]:
        return list(self.manifest["metrics"])

    def values(self, metric: str) -> np.ndarray:
        if metric not in self._arrays:
            if metric not in self.manifest["metrics"]:
                raise KeyError(f"metric {metric!r} not in {self.metrics}")
            self._arrays[metric] = np.load(
                os.path.join(self.path, f"{metric}.npy"), mmap_mode="r")
        return self._arrays[metric]

    def difficulty_fn(self, metric: str) -> Callable[[int], float]:
        """The curriculum sampler's per-index difficulty lookup."""
        vals = self.values(metric)
        return lambda idx: float(vals[idx])

    def buckets(self, metric: str, edges: Sequence[float]) -> Dict[int, np.ndarray]:
        """Sample indices grouped by difficulty bucket (the reference's
        seqlen -> sample-index map used for curriculum batching)."""
        vals = np.asarray(self.values(metric))
        which = np.digitize(vals, np.asarray(edges))
        return {b: np.nonzero(which == b)[0] for b in range(len(edges) + 1)}

    def value_percentiles(self, metric: str,
                          percentiles: Sequence[float] = (1, 5, 25, 50, 75,
                                                          95, 99)
                          ) -> Dict[float, float]:
        """Metric value at each percentile: the summary the curriculum
        schedule's min/max difficulty knobs are set from."""
        vals = np.asarray(self.values(metric))
        out = np.percentile(vals, list(percentiles))
        return {float(p): float(v) for p, v in zip(percentiles, out)}

    def metric_to_sample(self, metric: str) -> "MMapIndexedDataset":
        """The inverted metric->sample-indices store (built at merge time)."""
        prefix = os.path.join(self.path, f"{metric}_to_sample")
        return MMapIndexedDataset(prefix)


class MMapIndexedDatasetBuilder:
    """Append-only builder for a variable-length-row memory-mapped store.

    ``<prefix>.bin`` is the raw concatenated payload, ``<prefix>.idx.npz``
    holds the dtype, the per-row sizes and the exclusive-scan byte pointers:
    O(1) random access to variable-length rows without loading the file.
    """

    def __init__(self, prefix: str, dtype=np.int32):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        self._bin = open(f"{prefix}.bin", "wb")
        self._sizes: list = []

    def add_item(self, values) -> None:
        arr = np.ascontiguousarray(np.asarray(values), dtype=self.dtype)
        self._bin.write(arr.tobytes())
        self._sizes.append(int(arr.size))

    def merge_file_(self, other_prefix: str) -> None:
        """Append another finalized store's rows (the multi-worker reduce path)."""
        other = MMapIndexedDataset(other_prefix)
        if other.dtype != self.dtype:
            # raw-byte append with a different itemsize would silently
            # corrupt every merged row's pointer math
            raise ValueError(
                f"dtype mismatch: merging {other.dtype} store into "
                f"{self.dtype} builder")
        with open(f"{other_prefix}.bin", "rb") as f:
            while True:
                chunk = f.read(1 << 24)
                if not chunk:
                    break
                self._bin.write(chunk)
        self._sizes.extend(int(s) for s in other.sizes)

    def finalize(self) -> "MMapIndexedDataset":
        self._bin.close()
        sizes = np.asarray(self._sizes, np.int64)
        pointers = np.zeros_like(sizes)
        if sizes.size:
            np.cumsum(sizes[:-1] * self.dtype.itemsize, out=pointers[1:])
        np.savez(f"{self.prefix}.idx.npz", dtype=str(self.dtype),
                 sizes=sizes, pointers=pointers)
        return MMapIndexedDataset(self.prefix)


class MMapIndexedDataset:
    """Random access to variable-length rows without loading the file.

    Rows are numpy views into one ``np.memmap``: zero-copy reads.
    """

    def __init__(self, prefix: str):
        if not self.exists(prefix):
            raise FileNotFoundError(f"no indexed dataset at {prefix}")
        with np.load(f"{prefix}.idx.npz") as idx:
            self.dtype = np.dtype(str(idx["dtype"]))
            self.sizes = idx["sizes"]
            self.pointers = idx["pointers"]
        if os.path.getsize(f"{prefix}.bin") == 0:
            # a store of zero rows / all-empty rows is valid; memmap refuses
            # zero-byte files
            self._data = np.empty(0, self.dtype)
        else:
            self._data = np.memmap(f"{prefix}.bin", dtype=self.dtype,
                                   mode="r")

    def __len__(self) -> int:
        return int(self.sizes.shape[0])

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self):
            raise IndexError(i)
        start = int(self.pointers[i]) // self.dtype.itemsize
        return self._data[start:start + int(self.sizes[i])]

    def size(self, i: int) -> int:
        return int(self.sizes[i])

    num_tokens = size  # reference API alias (indexed_dataset.py:207)

    @staticmethod
    def exists(prefix: str) -> bool:
        return (os.path.exists(f"{prefix}.bin")
                and os.path.exists(f"{prefix}.idx.npz"))


def build_metric_to_sample(values, prefix: str) -> MMapIndexedDataset:
    """Inverted index: row v = the sample indices whose (integer-quantized)
    metric value is v, which curriculum batching uses to draw all samples of
    a given difficulty without scanning.
    """
    vals = np.asarray(values)
    iv = vals.astype(np.int64)
    if not np.allclose(vals, iv):
        raise ValueError(
            "metric_to_sample needs integer-valued metrics (quantize first); "
            f"got non-integral values, e.g. {vals[~np.isclose(vals, iv)][:3]}")
    if iv.size and iv.min() < 0:
        raise ValueError("metric values must be >= 0")
    builder = MMapIndexedDatasetBuilder(prefix, dtype=np.int64)
    order = np.argsort(iv, kind="stable")
    sorted_vals = iv[order]
    bounds = np.searchsorted(sorted_vals,
                             np.arange((iv.max() + 1) if iv.size else 0))
    bounds = np.append(bounds, iv.size)
    for v in range(len(bounds) - 1):
        builder.add_item(np.sort(order[bounds[v]:bounds[v + 1]]))
    return builder.finalize()


class DataAnalyzer:
    """Map metric functions over a dataset; write the indexed store.

    ``worker_id``/``num_workers`` shard the dataset into contiguous ranges,
    each worker writes its shard files, and :meth:`merge` concatenates them
    into the final store.
    """

    def __init__(self, metric_fns: Optional[Dict[str, Callable[[Any], float]]] = None,
                 worker_id: int = 0, num_workers: int = 1):
        self.metric_fns = dict(metric_fns or {"seqlen": seqlen_metric})
        self.worker_id = int(worker_id)
        self.num_workers = int(num_workers)

    def _shard_range(self, n: int):
        per = -(-n // self.num_workers)
        lo = min(n, self.worker_id * per)
        return lo, min(n, lo + per)

    def run(self, dataset, out_dir: str) -> Dict[str, np.ndarray]:
        """Analyze this worker's shard; write ``<metric>.worker<id>.npy``."""
        os.makedirs(out_dir, exist_ok=True)
        n = len(dataset)
        lo, hi = self._shard_range(n)
        out = {m: np.empty(hi - lo, np.float32) for m in self.metric_fns}
        for i in range(lo, hi):
            sample = dataset[i]
            for m, fn in self.metric_fns.items():
                out[m][i - lo] = fn(sample)
        for m, vals in out.items():
            np.save(os.path.join(out_dir, f"{m}.worker{self.worker_id}.npy"),
                    vals)
        with open(os.path.join(
                out_dir, f"shard{self.worker_id}.json"), "w") as f:
            json.dump({"worker": self.worker_id, "lo": lo, "hi": hi,
                       "num_workers": self.num_workers}, f)
        return out

    @staticmethod
    def merge(out_dir: str, build_inverted: bool = False,
              invert_max_rows: int = 1_000_000) -> IndexedMetricStore:
        """Concatenate every worker's shard files into the final store.

        ``build_inverted`` additionally writes a ``<metric>_to_sample``
        indexed store per integer-valued metric (the reference's
        merge_metric_to_sample reduce output). The inverted store is dense
        over [0, max_value]; metrics whose max exceeds ``invert_max_rows``
        (id-like values) are skipped — call :func:`build_metric_to_sample`
        on a quantized copy instead."""
        shards = []
        for f in os.listdir(out_dir):
            if f.startswith("shard") and f.endswith(".json"):
                with open(os.path.join(out_dir, f)) as fh:
                    shards.append(json.load(fh))
        shards.sort(key=lambda s: s["worker"])
        if not shards:
            raise FileNotFoundError(f"no analyzer shards in {out_dir}")
        expect = shards[0]["num_workers"]
        if (len(shards) != expect
                or [s["worker"] for s in shards] != list(range(expect))
                or any(s["num_workers"] != expect for s in shards)):
            raise ValueError(
                f"incomplete analysis: found workers "
                f"{[(s['worker'], s['num_workers']) for s in shards]} "
                f"of {expect}")
        # shards must tile [0, total) contiguously — stale files from a run
        # with a different sharding would silently mis-index the dataset
        pos = 0
        for s in shards:
            if s["lo"] != pos:
                raise ValueError(
                    f"incomplete analysis: worker {s['worker']} covers "
                    f"[{s['lo']}, {s['hi']}) but expected start {pos} — "
                    "stale shard files from a different run?")
            pos = s["hi"]
        total = pos
        metrics = sorted({f.split(".worker")[0] for f in os.listdir(out_dir)
                          if ".worker" in f and f.endswith(".npy")})
        for m in metrics:
            parts = [np.load(os.path.join(out_dir, f"{m}.worker{s['worker']}.npy"))
                     for s in shards]
            full = np.concatenate(parts)
            if full.shape[0] != total:
                raise ValueError(
                    f"metric {m!r}: {full.shape[0]} values for {total} samples "
                    "— stale worker files from a different analysis?")
            np.save(os.path.join(out_dir, f"{m}.npy"), full)
            if (build_inverted and np.allclose(full, full.astype(np.int64))
                    and (full.size == 0
                         or (full.min() >= 0
                             and full.max() < invert_max_rows))):
                # mirror build_metric_to_sample's preconditions and cap the
                # dense row count: a metric that can't (negatives) or
                # shouldn't (id-like, max >= cap) be inverted is skipped,
                # not a merge failure
                build_metric_to_sample(
                    full, os.path.join(out_dir, f"{m}_to_sample"))
        with open(os.path.join(out_dir, _MANIFEST), "w") as f:
            json.dump({"num_samples": total, "metrics": metrics}, f)
        return IndexedMetricStore(out_dir)
