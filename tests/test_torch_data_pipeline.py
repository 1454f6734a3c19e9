"""The port's data side against the JAX package's: the DeepSpeed data
loader, the curriculum scheduler, the curriculum-gated sampler, the offline
analyzer and its stores, random-LTD's schedule and token routing, and the
progressive-layer-drop tracker.

Every piece is device-free numpy in both packages, so each is held bitwise:
the same batches, index lists, schedule values and files. Random-LTD's
gather and scatter take the indices JAX's ``random_ltd_gather`` drew (the
port draws from torch generators, another stream). The analyzer's files
cross both ways. Last, the loader through ``initialize`` at dp2: two gloo
ranks (spawned once, ``_torch_engine_features_workers.py``) against the
JAX engine on a 2-device mesh fed by its own loader: the same global
batches and each rank the rows of its device, bitwise; losses rtol 1e-5.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import _torch_engine_features_workers as workers
import deepspeed_tpu
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import data_pipeline as jdp
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.data_pipeline.data_routing import random_ltd as jltd
from deepspeed_tpu.runtime.progressive_layer_drop import ProgressiveLayerDrop as JaxPLD
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu_torch.runtime import data_pipeline as tdp
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import random_ltd as tltd
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop

W = 2
JOIN_TIMEOUT_S = 120.0


def _samples(n, seq=5, kind="dict"):
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        ids = rng.integers(0, 100, seq).astype(np.int32)
        out.append({"input_ids": ids, "label": np.int64(i)} if kind == "dict"
                   else (ids, np.float32(i)) if kind == "tuple" else ids)
    return out


def _same(a, b):
    """Two collated batches (dicts, tuples or arrays of numpy) bitwise equal."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- loader
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_loader_batches_bitwise(shuffle, drop_last, replicas):
    data = _samples(23)
    for seed in (0, 7):
        for rank in range(replicas):
            kw = dict(batch_size=4, shuffle=shuffle, seed=seed, drop_last=drop_last,
                      num_replicas=replicas, rank=rank)
            ref, port = jdl.DeepSpeedDataLoader(data, **kw), tdl.DeepSpeedDataLoader(data, **kw)
            assert len(port) == len(ref)
            for epoch in (0, 1, 2):
                ref.set_epoch(epoch)
                port.set_epoch(epoch)
                got, want = list(port), list(ref)
                assert len(got) == len(want) == len(ref)
                for g, w in zip(got, want):
                    _same(g, w)


@pytest.mark.parametrize("kind", ["dict", "tuple", "array"])
def test_default_collate_and_repeating_loader_wrap_epochs(kind):
    data = _samples(9, kind=kind)
    ref = jdl.RepeatingLoader(jdl.DeepSpeedDataLoader(data, 4, seed=3, num_replicas=1, rank=0))
    port = tdl.RepeatingLoader(tdl.DeepSpeedDataLoader(data, 4, seed=3, num_replicas=1,
                                                       rank=0))
    for _ in range(7):  # two batches an epoch: the wrap moves to epochs 1, 2, 3
        _same(next(port), next(ref))
    assert port.loader.epoch == ref.loader.epoch == 3


def test_loader_defaults_to_the_process_group():
    loader = tdl.DeepSpeedDataLoader(_samples(8), 2)
    assert (loader.num_replicas, loader.rank) == (1, 0)  # no process group joined


# ------------------------------------------------------------------- curriculum
_SCHEDULES = [
    {"min_difficulty": 8, "max_difficulty": 64, "schedule_type": "fixed_linear",
     "schedule_config": {"total_curriculum_step": 100, "difficulty_step": 8}},
    {"min_difficulty": 8, "max_difficulty": 512, "schedule_type": "fixed_root",
     "schedule_config": {"total_curriculum_step": 1000, "difficulty_step": 8,
                         "root_degree": 2}},
    {"min_difficulty": 8, "max_difficulty": 64, "schedule_type": "fixed_discrete",
     "schedule_config": {"difficulty": [8, 32, 64], "max_step": [10, 20]}},
    {"min_difficulty": 128, "max_difficulty": 512, "schedule_type": "fixed_linear",
     "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 128}},
    {"min_difficulty": 4, "max_difficulty": 96, "schedule_type": "custom"},
]


@pytest.mark.parametrize("cfg", _SCHEDULES, ids=lambda c: c["schedule_type"]
                         + str(c["max_difficulty"]))
def test_curriculum_scheduler_values_and_state(cfg):
    ref, port = jdp.CurriculumScheduler(cfg), tdp.CurriculumScheduler(cfg)
    if cfg["schedule_type"] == "custom":
        for s in (ref, port):
            s.set_custom_get_difficulty(lambda t: min(96, 4 + 3 * t))
    steps = range(0, 1200, 7) if cfg["max_difficulty"] == 512 else range(0, 130)
    assert [port.get_difficulty(t) for t in steps] == [ref.get_difficulty(t) for t in steps]
    assert port.update_difficulty(57) == ref.update_difficulty(57)
    again = tdp.CurriculumScheduler(cfg)
    again.load_state_dict(port.state_dict())
    assert port.state_dict() == ref.state_dict()
    assert again.get_current_difficulty() == ref.get_current_difficulty()


def test_curriculum_scheduler_refusals_match():
    for bad in ({"schedule_type": "nope"},
                {"schedule_type": "fixed_discrete",
                 "schedule_config": {"difficulty": [1, 2], "max_step": []}}):
        with pytest.raises(ValueError):
            jdp.CurriculumScheduler(bad)
        with pytest.raises(ValueError):
            tdp.CurriculumScheduler(bad)
    s = tdp.CurriculumScheduler({"schedule_type": "custom"})
    with pytest.raises(RuntimeError):
        s.get_difficulty(0)


# ------------------------------------------------------------------- sampler
def _sampler_pair(**kw):
    return jdp.DeepSpeedDataSampler(**kw), tdp.DeepSpeedDataSampler(**kw)


def test_sampler_ranks_disjoint_and_bitwise():
    seen = set()
    for rank in range(2):
        ref, port = _sampler_pair(total_samples=64, micro_batch_size=4, data_parallel_rank=rank,
                                  data_parallel_size=2, seed=7)
        got = list(port)
        assert got == list(ref) and len(got) == 8
        for b in got:
            assert seen.isdisjoint(b)
            seen.update(b)
    assert seen == set(range(64))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True), (True, False)])
def test_sampler_deterministic_and_resumes_bitwise(shuffle, drop_last):
    kw = dict(total_samples=30, micro_batch_size=4, seed=3, shuffle=shuffle,
              drop_last=drop_last)
    ref, port = _sampler_pair(**kw)
    assert list(port) == list(ref) and len(port) == len(ref)
    s2 = tdp.DeepSpeedDataSampler(**kw)
    it = iter(s2)
    first = [next(it) for _ in range(3)]
    s3 = tdp.DeepSpeedDataSampler(**kw)
    s3.load_state_dict(s2.state_dict())
    assert first + list(s3) == list(tdp.DeepSpeedDataSampler(**kw))


def _gated(pkg, step, **kw):
    sched = pkg.CurriculumScheduler({
        "min_difficulty": 20, "max_difficulty": 100, "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 20}})
    return pkg.DeepSpeedDataSampler(total_samples=40, micro_batch_size=4, seed=5,
                                    curriculum_scheduler=sched, difficulty_fn=lambda i: i,
                                    global_steps_fn=lambda: step["n"], **kw)


def test_sampler_curriculum_gates_and_resumes_without_duplicates():
    lists = {}
    for name, pkg in (("ref", jdp), ("port", tdp)):
        step = {"n": 0}
        s = _gated(pkg, step)
        it = iter(s)
        consumed = []
        for _ in range(3):
            b = next(it)
            assert all(i <= 20 + 20 * step["n"] for i in b)  # only easy-enough samples
            consumed += b
            step["n"] += 1
        s2 = _gated(pkg, step)
        s2.load_state_dict(s.state_dict())
        rest = []
        for b in s2:
            rest += b
            step["n"] += 1
        assert set(consumed).isdisjoint(rest)
        assert sorted(consumed + rest) == list(range(40))
        lists[name] = (consumed, rest)
    assert lists["port"] == lists["ref"]


# ------------------------------------------------------------------- analyzer
def _analyze(pkg, data, out, workers_n):
    for w in range(workers_n):
        pkg.DataAnalyzer({"seqlen": pkg.seqlen_metric}, worker_id=w,
                         num_workers=workers_n).run(data, out)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_analyzer_files_cross_both_ways(tmp_path, writer):
    """Shards written by one package merge in the other, and the merged
    store (manifest, metric arrays, the inverted index) reads the same in
    both."""
    lengths = np.random.default_rng(0).integers(4, 33, size=23)
    data = [{"input_ids": np.zeros(n, np.int32)} for n in lengths]
    w_pkg, r_pkg = (tdp, jdp) if writer == "port" else (jdp, tdp)
    out = str(tmp_path / "a")
    _analyze(w_pkg, data, out, 3)
    store = r_pkg.DataAnalyzer.merge(out, build_inverted=True)
    other = w_pkg.IndexedMetricStore(out)
    assert store.num_samples == other.num_samples == 23
    assert store.metrics == other.metrics == ["seqlen"]
    assert os.path.exists(os.path.join(out, "ds_metric_index.json"))
    np.testing.assert_array_equal(store.values("seqlen"), lengths.astype(np.float32))
    np.testing.assert_array_equal(other.values("seqlen"), store.values("seqlen"))
    inv, inv2 = store.metric_to_sample("seqlen"), other.metric_to_sample("seqlen")
    assert len(inv) == len(inv2) == 33
    for v in range(33):
        np.testing.assert_array_equal(inv[v], inv2[v])
        np.testing.assert_array_equal(inv[v], np.nonzero(lengths == v)[0])
    assert store.value_percentiles("seqlen") == other.value_percentiles("seqlen")
    b1, b2 = store.buckets("seqlen", [16]), other.buckets("seqlen", [16])
    assert b1.keys() == b2.keys() and all(np.array_equal(b1[k], b2[k]) for k in b1)
    os.remove(os.path.join(out, "shard1.json"))
    with pytest.raises(ValueError, match="incomplete"):
        r_pkg.DataAnalyzer.merge(out)


def test_analyzer_store_feeds_the_curriculum_sampler(tmp_path):
    lengths = np.random.default_rng(1).integers(4, 33, size=23)
    data = [{"input_ids": np.zeros(n, np.int32)} for n in lengths]
    out = str(tmp_path / "s")
    _analyze(tdp, data, out, 2)
    store = tdp.DataAnalyzer.merge(out)
    batches = {}
    for name, pkg in (("ref", jdp), ("port", tdp)):
        sched = pkg.CurriculumScheduler({
            "min_difficulty": 8, "max_difficulty": 33, "schedule_type": "fixed_linear",
            "schedule_config": {"total_curriculum_step": 10, "difficulty_step": 1}})
        sampler = pkg.DeepSpeedDataSampler(total_samples=23, micro_batch_size=4,
                                           curriculum_scheduler=sched,
                                           difficulty_fn=store.difficulty_fn("seqlen"),
                                           global_steps_fn=lambda: 1)
        batches[name] = next(iter(sampler))
        assert all(lengths[i] <= sched.get_current_difficulty() < 33 for i in batches[name])
    assert batches["port"] == batches["ref"]


def test_indexed_dataset_edge_cases_and_crossing(tmp_path):
    rows = [np.random.default_rng(2).integers(0, 1000, size=n).astype(np.int32)
            for n in (5, 0, 3, 128, 1)]
    b = tdp.MMapIndexedDatasetBuilder(str(tmp_path / "a"), dtype=np.int32)
    for r in rows:
        b.add_item(r)
    ds = b.finalize()
    ref = jdp.MMapIndexedDataset(str(tmp_path / "a"))  # the port's files, read by JAX's
    assert len(ds) == len(ref) == len(rows)
    for i, r in enumerate(rows):
        assert ds.size(i) == ds.num_tokens(i) == r.size
        np.testing.assert_array_equal(ds[i], r)
        np.testing.assert_array_equal(ref[i], r)
    with pytest.raises(IndexError):
        ds[len(rows)]
    jb = jdp.MMapIndexedDatasetBuilder(str(tmp_path / "b"), dtype=np.int32)
    jb.add_item([7, 8])
    jb.finalize()
    merged = tdp.MMapIndexedDatasetBuilder(str(tmp_path / "c"), dtype=np.int32)
    merged.merge_file_(str(tmp_path / "b"))  # JAX's rows, appended by the port
    merged.merge_file_(str(tmp_path / "a"))
    m = merged.finalize()
    assert len(m) == 1 + len(rows)
    np.testing.assert_array_equal(m[0], [7, 8])
    np.testing.assert_array_equal(m[4], rows[3])
    empty = tdp.build_metric_to_sample(np.asarray([]), str(tmp_path / "empty"))
    assert len(empty) == 0
    with pytest.raises(ValueError, match="integer-valued"):
        tdp.build_metric_to_sample(np.asarray([0.5]), str(tmp_path / "bad"))
    b64 = tdp.MMapIndexedDatasetBuilder(str(tmp_path / "i64"), np.int64)
    b64.add_item([1, 2, 3])
    b64.finalize()
    with pytest.raises(ValueError, match="dtype mismatch"):
        tdp.MMapIndexedDatasetBuilder(str(tmp_path / "i32"), np.int32).merge_file_(
            str(tmp_path / "i64"))
    data = [{"input_ids": np.zeros(4, np.int32)} for _ in range(3)]
    out = str(tmp_path / "skip")
    tdp.DataAnalyzer({"score": lambda s: -1.0, "sample_id": lambda s: 1e8,
                      "seqlen": lambda s: 4.0}).run(data, out)
    tdp.DataAnalyzer.merge(out, build_inverted=True)
    for metric, inverted in (("score", False), ("sample_id", False), ("seqlen", True)):
        assert tdp.MMapIndexedDataset.exists(os.path.join(out, f"{metric}_to_sample")) \
            == inverted


# ------------------------------------------------------------------- schedules
def test_random_ltd_scheduler_and_pld_tracker_match():
    cfg = {"random_ltd_schedule": {"min_value": 64, "max_value": 256,
                                   "schedule_config": {"seq_per_step": 32,
                                                       "require_steps": 100}}}
    ref, port = jltd.RandomLTDScheduler(cfg), tltd.RandomLTDScheduler(cfg)
    assert [port.get_value(t) for t in range(130)] == [ref.get_value(t) for t in range(130)]
    card = {"random_ltd_schedule": {"min_value": 128, "max_value": 512,
                                    "schedule_config": {"seq_per_step": 128,
                                                        "require_steps": 4}}}
    assert [tltd.RandomLTDScheduler(card).get_value(t) for t in range(6)] == \
        [128, 128, 256, 384, 512, 512]
    port.update(57)
    again = tltd.RandomLTDScheduler(cfg)
    again.load_state_dict(port.state_dict())
    assert again.current_value == ref.update(57) == port.current_value
    jp, tp = JaxPLD(0.5, 0.01), ProgressiveLayerDrop(0.5, 0.01)
    for step in range(0, 300, 3):
        jp.update_state(step)
        tp.update_state(step)
        assert tp.get_theta() == jp.get_theta()
        assert tp.get_state() == jp.get_state()


# ------------------------------------------------------------------- random-LTD
@pytest.mark.parametrize("keep", [1, 6, 15])
def test_random_ltd_gather_scatter_with_jax_indices_bitwise(keep):
    x = np.random.default_rng(keep).normal(size=(3, 16, 8)).astype(np.float32)
    kept_j, idx_j = jltd.random_ltd_gather(jnp.asarray(x), keep, jax.random.PRNGKey(keep))
    idx = torch.from_numpy(np.array(idx_j))
    kept, idx_t = tltd.random_ltd_gather(torch.from_numpy(x), keep, idx=idx)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(kept_j))
    y = np.random.default_rng(99).normal(size=(3, keep, 8)).astype(np.float32)
    out_j = jltd.random_ltd_scatter(jnp.asarray(y), idx_j, jnp.asarray(x))
    out = tltd.random_ltd_scatter(torch.from_numpy(y), idx_t, torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))


def test_random_ltd_draw_and_layer_pass_through():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 16, 8)).astype(np.float32))
    gen = torch.Generator().manual_seed(5)
    idx = tltd.random_ltd_indices(2, 16, 6, gen)
    assert idx.shape == (2, 6) and (idx.diff(dim=1) > 0).all()  # sorted, no repeats
    again = tltd.random_ltd_indices(2, 16, 6, torch.Generator().manual_seed(5))
    assert torch.equal(idx, again)
    out = tltd.random_ltd_layer(lambda t: t * 2.0, x, 6, idx=idx)
    doubled = (out == 2 * x).all(-1)
    untouched = (out == x).all(-1)
    assert int(doubled.sum()) == 12 and bool((doubled | untouched).all())
    assert torch.equal(tltd.random_ltd_layer(lambda t: t * 2.0, x, 16, gen), 2 * x)


# ------------------------------------------------------------------- dp2 loader
def test_initialize_loader_at_dp2_gives_each_rank_its_device_rows(tmp_path):
    model, _ = build_gpt(JaxGPTConfig(**workers.TINY))
    engine, _, loader, _ = deepspeed_tpu.initialize(
        model=model, config=JaxDeepSpeedConfig.load(workers.config(), world_size=W),
        topology=MeshTopology.create(dp=W, devices=jax.devices()[:W]), seed=0,
        training_data=workers.dataset())
    state0 = jax.tree_util.tree_map(np.asarray, engine.state)
    ctx = mp.start_processes(workers.rank_main,
                             args=(W, str(tmp_path / "init"), str(tmp_path), state0),
                             nprocs=W, join=False, start_method="spawn")
    try:
        it = jdl.RepeatingLoader(loader)
        batches, losses = [], []
        for _ in range(workers.STEPS):
            b = next(it)
            batches.append(b["input_ids"])
            losses.append(float(engine.train_batch(b)["loss"]))
    finally:
        end = time.monotonic() + JOIN_TIMEOUT_S
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            if time.monotonic() >= end:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the 2-rank run did not finish within {JOIN_TIMEOUT_S} s")
    for r in range(W):
        got = np.load(os.path.join(tmp_path, f"loader_rank{r}.npz"))
        for s in range(workers.STEPS):
            np.testing.assert_array_equal(got[f"batch{s}"], batches[s])
            rows = batches[s][r * workers.MICRO:(r + 1) * workers.MICRO]
            np.testing.assert_array_equal(got[f"rows{s}"], rows)
        np.testing.assert_allclose([got[f"loss{s}"] for s in range(workers.STEPS)], losses,
                                   rtol=1e-5)
    assert not np.array_equal(batches[0], batches[2])  # the loader wrapped its epoch
