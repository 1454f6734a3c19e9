"""Data parallelism below stage 3 and the ZeRO++ quantized gradient
exchange, in one process: the port against the JAX package at world size
1 (fp32, the ``tiny`` GPT of ``_torch_zero_dp_workers.py``). Two ranks are
``test_torch_zero_dp_dist.py``.

- Device-free parts, bitwise: ``runtime/zero/reshard.py``'s flat partition,
  merge and repartition (uneven sizes, raw dtypes, a hypothesis property)
  and ``rescale_cursor`` against the reference module; ``load_resolver``'s
  policy; the memory estimators' numbers and tables; the policy's split
  dimensions at stages 0-3 for W 2 and 4, every slice joining back to its
  leaf.
- The exchanges: ``grad_bucket_reduce`` and the monolithic
  ``qreduce_scatter`` + ``qall_gather`` on one rank send bitwise the int
  payloads JAX's quantizer makes of the same buffers, and their values
  equal the JAX functions' on a dp1 mesh within 2e-6 (under ``jit`` XLA
  fuses the dequantize into one FMA where the port rounds twice, see
  ``test_torch_zero3_dist.py``), with and without a residual, at a loss
  scale of 2^10.
- The engine at world 1 against the JAX engine on a dp1 mesh, 3 steps of
  AdamW + clipping from the JAX engine's start state. Stages 0, 1 and 2
  (dense; on one device the JAX stages are one program): losses 1e-5
  relative, grad norms 1e-4, the final state 2e-5. Stage 2 with int8
  quantized gradients, monolithic (``overlap_comm: false``) and per-layer
  buckets, with and without error feedback: step 1's loss within 1e-6
  (the forward is untouched); step 1's exchanged gradients within one
  quantization step of their block (of the rs and of the ag payload,
  bounded by two steps of the exchanged block's range: a last-bit
  difference in the backward may flip one rounding); steps 2-3's losses
  within 1e-4 and grad norms within 1e-3 relative (a flipped level moves a
  gradient entry by at most 1/255 of its block's range, far below the
  Adam step's own scale); the residuals of the reference's shapes and
  nonzero. int4 buckets: 2 finite steps. Stochastic rounding at gas 2: the
  loss falls over 6 steps. fp16 with a NaN residual: the step is skipped,
  the residuals end zero and the next step is finite.
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

import _torch_zero_dp_workers as workers
from _torch_zero_dp_ref import (
    ATOL,
    QCASES,
    exchanged_within_a_step,
    expected_payloads,
    jax_engine,
    jax_exchanged_grads,
    jax_exchanges,
    jax_run,
)
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.runtime.zero import mem_estimator as jmem
from deepspeed_tpu.runtime.zero import reshard as jreshard
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.comm.runtime_accounting import wire_ledger
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.runtime.zero import mem_estimator as tmem
from deepspeed_tpu_torch.runtime.zero import reshard as treshard
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.policy import ZeroShardingPolicy



# ------------------------------------------------------------------ reshard math
@pytest.mark.parametrize("n,old,new", [(17, 4, 3), (16, 4, 2), (15, 3, 5), (1, 4, 2),
                                       (7, 1, 6), (7, 6, 1), (1024, 8, 5)])
def test_repartition_is_the_reference_bitwise(n, old, new):
    flat = np.random.default_rng(n * 31 + old).standard_normal(n).astype(np.float32)
    for got, want in ((treshard.partition_flat(flat, old), jreshard.partition_flat(flat, old)),
                      (treshard.repartition_flat(treshard.partition_flat(flat, old), new, n),
                       jreshard.repartition_flat(jreshard.partition_flat(flat, old), new, n))):
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    shards = treshard.partition_flat(flat, old)
    assert treshard.repartition_flat(treshard.repartition_flat(shards, new, n), old,
                                     n).tobytes() == shards.tobytes()
    assert treshard.merge_flat(shards, n).tobytes() == flat.tobytes()
    assert treshard.shard_len(n, new) == jreshard.shard_len(n, new)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(0, 300), old=st.integers(1, 9), new=st.integers(1, 9),
       dtype=st.sampled_from([np.uint16, np.int8, np.float32, np.float64]))
def test_repartition_property_raw_dtypes(n, old, new, dtype):
    raw = np.random.default_rng(n).bytes(n * np.dtype(dtype).itemsize)
    flat = np.frombuffer(raw, dtype=dtype).copy()
    got = treshard.repartition_flat(treshard.partition_flat(flat, old), new, n)
    want = jreshard.repartition_flat(jreshard.partition_flat(flat, old), new, n)
    assert got.dtype == dtype and got.tobytes() == want.tobytes()
    assert treshard.merge_flat(got, n).tobytes() == flat.tobytes()


def test_partition_rejects_bad_shapes():
    for bad in (lambda: treshard.partition_flat(np.zeros((2, 3)), 2),
                lambda: treshard.merge_flat(np.zeros(6), 6),
                lambda: treshard.partition_flat(np.zeros(4), 0),
                lambda: treshard.merge_flat(np.zeros((2, 2)), 5)):
        with pytest.raises(treshard.ReshardError):
            bad()


@pytest.mark.parametrize("cursor,old,new", [
    (0, 8, 8), (7, 8, 8),          # the identity at a constant global batch
    (3, 4, 2), (6, 2, 4), (4, 8, 16), (10, 6, 4),  # exact rescales
    (5, 2 * 3 * 1, 3 * 2 * 1),     # gas 2 x micro 3 x dp 1 -> gas 1 x micro 2 x dp 3
])
def test_rescale_cursor_matches_the_reference(cursor, old, new):
    assert treshard.rescale_cursor(cursor, old, new) == jreshard.rescale_cursor(cursor, old, new)


@pytest.mark.parametrize("cursor,old,new", [(3, 4, 8), (1, 6, 4), (5, 2, 0)])
def test_rescale_cursor_refuses_sample_splits(cursor, old, new):
    with pytest.raises(treshard.ReshardError):
        treshard.rescale_cursor(cursor, old, new)
    with pytest.raises(jreshard.ReshardError):
        jreshard.rescale_cursor(cursor, old, new)


def test_load_resolver_resets_residuals_and_refuses_the_rest():
    resolve = treshard.load_resolver(4, 2)
    with pytest.raises(treshard.ReshardError, match="mystery"):
        resolve("opt/mystery", np.zeros((4, 3), np.float32), np.zeros((2, 6), np.float32))
    for key in treshard.RESIDUAL_RESET_KEYS:
        out = resolve(key, np.ones((4, 8), np.float32), torch.empty((2, 16), device="meta"))
        assert out.shape == (2, 16) and not out.any()
    assert treshard.RESIDUAL_RESET_KEYS == jreshard.RESIDUAL_RESET_KEYS
    assert treshard.PARTITION_FORMAT == jreshard.PARTITION_FORMAT


# ------------------------------------------------------------------ mem estimator
@pytest.mark.parametrize("kw", [dict(), dict(num_chips_per_host=8, num_hosts=2),
                                dict(cpu_offload=False, num_hosts=3)])
def test_mem_estimator_numbers_are_the_reference(kw):
    n, layer = 124_439_808, 7_087_872
    assert tmem.estimate_zero2_model_states_mem_needs(n, **kw) == \
        jmem.estimate_zero2_model_states_mem_needs(n, **kw)
    for params in (False, True):
        assert tmem.estimate_zero3_model_states_mem_needs(n, layer, cpu_offload_params=params,
                                                          **kw) == \
            jmem.estimate_zero3_model_states_mem_needs(n, layer, cpu_offload_params=params, **kw)
    assert tmem._fmt(3.5 * 2**30) == jmem._fmt(3.5 * 2**30)


def test_mem_estimator_tables_are_the_reference(capsys):
    cfg = gpt.GPTConfig(**workers.TINY)
    tree = gpt.init_params(cfg, 0, device="cpu")
    jtree = build_gpt(JaxGPTConfig(**workers.TINY))[0]
    printed = []
    for fn2, fn3, arg in ((tmem.estimate_zero2_model_states_mem_needs_all_live,
                           tmem.estimate_zero3_model_states_mem_needs_all_live, tree),
                          (jmem.estimate_zero2_model_states_mem_needs_all_live,
                           jmem.estimate_zero3_model_states_mem_needs_all_live, jtree)):
        fn2(arg, num_chips_per_host=2)
        fn3(arg, num_chips_per_host=2)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "offload_param=True" in printed[0]
    assert tmem._largest_layer_of(tree) == sum(v[0].numel() for v in tree["blocks"].values())


# ------------------------------------------------------------------ policy
@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_policy_dims_by_stage_and_slices_join(stage, W):
    params = gpt.init_params(gpt.GPTConfig(**workers.TINY), 0, device="cpu")
    zc = DeepSpeedZeroConfig.from_dict({"stage": stage,
                                        "stage3_param_persistence_threshold": 10_000})
    pols = [ZeroShardingPolicy(zc, W, r) for r in range(W)]
    specs = {k: getattr(pols[0], f"tree_{k}_specs")(params) for k in ("param", "grad", "opt")}
    for kind, on in (("param", stage >= 3), ("grad", stage >= 2), ("opt", stage >= 1)):
        for (name, leaf), (_, d) in zip(_named(params), _named(specs[kind])):
            stacked = name.startswith("blocks")
            if not on or leaf.dim() - stacked < 2 or (kind == "param" and leaf.numel() <= 10_000):
                assert d is None, (kind, name)
                continue
            assert d is not None and d != leaf.dim() - 1 and not (stacked and d == 0), name
            slices = [p.shard(leaf, d) for p in pols]
            assert all(s.shape[d] == leaf.shape[d] // W for s in slices)
            assert torch.equal(torch.cat(slices, dim=d), leaf), (kind, name)


def _named(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _named(v, f"{prefix}{k}.") if isinstance(v, dict) else [(f"{prefix}{k}", v)]
    return out


# ------------------------------------------------------------------ exchanges
def test_exchanges_at_one_rank_match_jax():
    ins = workers.exchange_inputs()
    got = {k: v.numpy() for k, v in workers.run_exchanges(0, ins).items()}
    ref = jax_exchanges(ins, 1)
    payloads = expected_payloads(ins, 1, 0)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v[0], rtol=0, atol=ATOL, err_msg=k)
    for k, v in payloads.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the exchange quantized: not the identity even at one rank
    assert not np.array_equal(got["flat0"], ins["flat"][0])


# ------------------------------------------------------------------ engines
@pytest.fixture(scope="module")
def world1():
    """The JAX dp1 runs (one dense run for stages 0-2, each quantized
    case) and the port's, from the JAX engine's start state."""
    dense = jax_engine("s2")
    state0 = jax.tree_util.tree_map(np.asarray, dense.state)
    runs = {"jax": {"s2": jax_run(dense, "s2")}, "grad1": {}}
    for name in QCASES:
        je = jax_engine(name)
        if name.endswith("_ef"):  # step 1's residual is zero: the same exchange without EF
            runs["grad1"][name] = runs["grad1"][name[:-3]] = jax_exchanged_grads(
                je, workers.batches(name)[0])
        runs["jax"][name] = jax_run(je, name)
    port = {}
    for name in ("s0", "s1", "s2") + QCASES:
        out = {}
        wire_ledger.reset()
        e = workers.run_case(0, name, state0, out)
        out["ledger"] = wire_ledger.summary_dict()
        out["state_shapes"] = {k: tuple(v.shape) for k, v in e.state.items()
                               if k.startswith("qgrad")}
        port[name] = out
    runs["port"] = port
    runs["jax_shapes"] = {name: {k: tuple(v.shape) for k, v in runs["jax"][name][2].items()
                                 if k.startswith("qgrad")} for name in QCASES}
    return runs


@pytest.mark.parametrize("name", ["s0", "s1", "s2"])
def test_dense_stages_match_jax(world1, name):
    losses, norms, final = world1["jax"]["s2"]
    out = world1["port"][name]
    np.testing.assert_allclose(out[f"{name}.losses"].numpy(), losses, rtol=1e-5)
    np.testing.assert_allclose(out[f"{name}.grad_norms"].numpy(), norms, rtol=1e-4)
    want = dict(_named(final["params"]))
    for k, v in want.items():
        np.testing.assert_allclose(out[f"{name}.params.{k.replace('.', '/')}"].numpy(), v,
                                   rtol=0, atol=2e-5, err_msg=k)
    for k, v in _named(final["opt"].mu):
        np.testing.assert_allclose(out[f"{name}.local.mu.{k.replace('.', '/')}"].numpy(), v,
                                   rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("name", QCASES)
def test_quantized_gradients_match_jax(world1, name):
    losses, norms, _ = world1["jax"][name]
    out = world1["port"][name]
    got = out[f"{name}.losses"].numpy()
    np.testing.assert_allclose(got[0], losses[0], rtol=1e-6)
    np.testing.assert_allclose(got[1:], losses[1:], rtol=1e-4)
    np.testing.assert_allclose(out[f"{name}.grad_norms"].numpy(), norms, rtol=1e-3)
    exchanged_within_a_step({k: out[f"{name}.grad1.{k}"].numpy() for k in world1["grad1"][name]},
                            world1["grad1"][name])
    # the residuals: the reference's shapes, live
    assert out["state_shapes"] == world1["jax_shapes"][name]
    for key in out["state_shapes"]:
        assert out[f"{name}.{key}"].abs().max() > 0
    # the wire: per step one bucket pair per layer and one monolithic pair
    ledger, L = out["ledger"], workers.TINY["n_layer"]
    bucketed = name.startswith("q_bucket")
    want = {"qgrad_reduce_scatter[dp]": 3, "qgrad_all_gather[dp]": 3}
    if bucketed:
        want.update({"qgrad_bucket_rs[dp]": 3 * L, "qgrad_bucket_ag[dp]": 3 * L})
    assert {k: v["count"] for k, v in ledger.items()} == want
    assert all(v["ratio"] >= 3.5 for v in ledger.values()), ledger


def test_int4_buckets_and_stochastic_rounding_train():
    """int4 per-layer buckets: 2 finite steps at ratios >= 7; stochastic
    rounding (monolithic, a generator per rank) at gas 2: the loss falls
    over 6 steps on one batch, and the residual is live."""
    wire_ledger.reset()
    e = workers.make_engine(workers.config({"stage": 2, **workers.QGRAD, **workers.EF,
                                            "zero_quantize_bits": 4}))
    b = workers.batches("s2")
    losses = [float(e.train_batch(b[i])["loss"]) for i in range(2)]
    assert np.isfinite(losses).all()
    assert min(r["ratio"] for r in wire_ledger.summary_dict().values()) >= 7
    e = workers.make_engine(workers.config({"stage": 2, **workers.QGRAD, **workers.EF,
                                            "zero_quantize_stochastic": True}, micro=2, gas=2))
    assert e._qgrad_bucket_key is None and e._qgrad_gen is not None
    ids = {"input_ids": b[0]["input_ids"].reshape(2, 2, workers.SEQ)}
    losses = [float(e.train_batch(ids)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert e.state["qgrad_residual"].abs().max() > 0


def test_overflow_resets_the_residuals():
    """A NaN residual (what an fp16 overflow leaves) makes the step
    overflow; it is skipped and both residuals end zero; the next step
    recovers."""
    e = workers.make_engine(workers.config(
        {"stage": 2, **workers.QGRAD, **workers.EF}, fp16={"enabled": True, "loss_scale": 0.0}))
    e.state["qgrad_residual"].fill_(float("nan"))
    b = workers.batches("s2")
    m1 = e.train_batch(b[0])
    assert bool(m1["overflow"]) and e.skipped_steps == 1
    for key in ("qgrad_residual", "qgrad_bucket_residual"):
        assert torch.isfinite(e.state[key]).all() and not e.state[key].any()
    m2 = e.train_batch(b[1])
    assert not bool(m2["overflow"]) and np.isfinite(float(m2["loss"]))


def test_world1_tag_stores_the_reference_residual_shapes(world1, tmp_path):
    """A world-1 qgrad + EF tag: the residuals stored at the reference's
    global shapes, the partition record's flat geometry the JAX engine's."""
    from deepspeed_tpu_torch.checkpoint import serialization

    e = workers.make_engine(workers.config(workers.CASES["q_bucket_ef"][0]))
    e.train_batch(workers.batches("s2")[0])
    e.save_checkpoint(str(tmp_path))
    tag = tmp_path / "global_step1"
    shapes = {m["key"]: tuple(m["shape"]) for m in
              serialization.read_meta(str(tag / "state"))["leaves"]}
    assert {k: v for k, v in shapes.items() if k.startswith("qgrad")} == \
        world1["jax_shapes"]["q_bucket_ef"]
    part = json.loads((tag / "meta.json").read_text())["partition"]
    je = jax_engine("q_bucket_ef")
    assert part["qgrad"] == {"n": je._qgrad_n, "npad": je._qgrad_npad}
    assert part["qgrad_bucket"] == {"L": je._qgrad_bucket_L, "npad": je._qgrad_bucket_npad}
    # the tag round-trips into the JAX engine at dp1
    je.load_checkpoint(str(tmp_path))
    st = bridge.train_state_to_numpy(e.state)
    np.testing.assert_array_equal(np.asarray(je.state["qgrad_residual"]), st["qgrad_residual"])
    np.testing.assert_array_equal(np.asarray(je.state["params"]["wte"]), st["params"]["wte"])
