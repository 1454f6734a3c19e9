"""The port's asynchronous I/O pool and NVMe leaf store against the JAX
package's.

The pool (``csrc/host/aio.cpp``) round-trips buffers, many requests in
flight, and reports a missing file (and a drain raises for a failed request
nobody waited on). The store's on-disk layout is the reference's: a store
either package writes, the other reads bitwise, and the port's pipelined
prefetch / write-back keeps every leaf. The ``aio`` block parses with its
known keys and sets the NVMe stores' thread count.
"""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.swap_tensor import NVMeLeafStore as JaxLeafStore
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.swap_tensor import NVMeLeafStore


def test_aio_roundtrip(tmp_path):
    h = AsyncIOHandle(num_threads=2)
    data = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    path = str(tmp_path / "blob.bin")
    assert h.wait(h.pwrite(path, data, fsync=True)) == 0
    out = np.empty_like(data)
    assert h.wait(h.pread(path, out)) == 0
    np.testing.assert_array_equal(out, data)
    assert h.wait(12345) == -22  # unknown id
    h.close()


def test_aio_reads_into_a_pinnable_tensor_view(tmp_path):
    """A host tensor's numpy view (what the runners hand the pool)."""
    h = AsyncIOHandle(num_threads=1)
    src = torch.arange(1000, dtype=torch.float32)
    path = str(tmp_path / "t.bin")
    assert h.wait(h.pwrite(path, src.numpy())) == 0
    dst = torch.empty(1000, dtype=torch.float32)
    assert h.wait(h.pread(path, dst.numpy())) == 0
    assert torch.equal(src, dst)


def test_aio_many_in_flight(tmp_path):
    h = AsyncIOHandle(num_threads=4)
    r = np.random.default_rng(1)
    blobs = [r.normal(size=1024 * (i + 1)).astype(np.float32) for i in range(16)]
    for i, b in enumerate(blobs):
        h.pwrite(str(tmp_path / f"b{i}.bin"), b)
    h.drain()
    outs = [np.empty_like(b) for b in blobs]
    rids = [h.pread(str(tmp_path / f"b{i}.bin"), o) for i, o in enumerate(outs)]
    for rid in reversed(rids):  # waited on out of submission order
        assert h.wait(rid) == 0
    for o, b in zip(outs, blobs):
        np.testing.assert_array_equal(o, b)
    h.close()


def test_aio_missing_file_and_failed_drain(tmp_path):
    h = AsyncIOHandle(num_threads=1)
    buf = np.empty(16, np.float32)
    assert h.wait(h.pread(str(tmp_path / "nope.bin"), buf)) < 0
    # a fire-and-forget write into a missing directory fails; the drain says so
    h.pwrite(str(tmp_path / "no_dir" / "x.bin"), buf)
    with pytest.raises(IOError, match="1 asynchronous request"):
        h.drain()
    h.drain()  # the failure was counted once
    # a short read (the file holds less than the buffer) is an error too
    small = str(tmp_path / "small.bin")
    assert h.wait(h.pwrite(small, np.zeros(4, np.float32))) == 0
    assert h.wait(h.pread(small, buf)) < 0


def _leaves(seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=(8, 4)).astype(np.float32), r.normal(size=(16,)).astype(np.float32),
            r.normal(size=(3, 5, 7)).astype(np.float32)]


def test_leaf_store_roundtrip_and_pipeline(tmp_path):
    store = NVMeLeafStore(str(tmp_path / "opt"), aio_threads=2)
    leaves = _leaves(0)
    store.write_init(leaves)
    assert store.num_leaves == 3
    m0, mm0, vv0 = store.get(0)
    np.testing.assert_array_equal(m0, leaves[0])
    np.testing.assert_array_equal(mm0, np.zeros_like(leaves[0]))
    # the optimizer loop's pattern: prefetch i+1, step i, write i back
    store.prefetch(0)
    for i in range(3):
        store.prefetch(i + 1)  # past the end: ignored
        mst, m, v = store.get(i)
        mst += 1.0
        m += 2.0
        store.writeback(i, mst, m, v)
    store.drain()
    d = store.read_all()
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(d[f"master_{i}"], leaf + 1.0)
        np.testing.assert_array_equal(d[f"m_{i}"], np.full_like(leaf, 2.0))
    store.write_all({**d, "master_1": d["master_1"] * 0})
    np.testing.assert_array_equal(store.get(1)[0], np.zeros_like(leaves[1]))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_leaf_store_crosses_between_the_packages(tmp_path, writer):
    """One store directory, written by one package, read by the other."""
    leaves = _leaves(1)
    path = str(tmp_path / "store")
    make = {"port": NVMeLeafStore, "jax": JaxLeafStore}
    w = make[writer](path, aio_threads=2)
    w.write_init(leaves)
    mst, m, v = w.get(2)
    w.writeback(2, mst * 3, m + 1, v + 2)
    w.drain()
    r = make["jax" if writer == "port" else "port"](path, aio_threads=2)
    r.shapes = [leaf.shape for leaf in leaves]
    got = r.read_all()
    want = w.read_all()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["master_2"], leaves[2] * 3)
    assert sorted(os.listdir(path)) == sorted(f"leaf_{i}_{s}.bin" for i in range(3)
                                               for s in ("master", "m", "v"))


def test_aio_block_parses_and_sets_the_store_threads():
    c = DeepSpeedConfig.load({"aio": {"thread_count": 3, "block_size": 262144}})
    assert c.aio_threads(8) == 3
    assert DeepSpeedConfig.load({}).aio_threads(5) == 5  # the offload block's buffer_count
    assert DeepSpeedConfig.load({}).aio_threads(0) == 1
    with pytest.raises(ValueError, match="unknown keys"):
        DeepSpeedConfig.load({"aio": {"threads": 2}})
    with pytest.raises(ValueError, match="thread_count"):
        DeepSpeedConfig.load({"aio": {"thread_count": 0}})
