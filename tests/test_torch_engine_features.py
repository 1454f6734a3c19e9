"""The port's layer-level training features against the JAX package's:
random-LTD, progressive layer drop, the seqlen curriculum, every remat
policy and the activation-checkpointing API, in fp32 on ``tiny``-sized GPTs
with inputs made from a seed.

- Random-LTD: the port's forward, handed the indices JAX's
  ``random_ltd_gather`` draws for each layer's key, equals JAX's forward
  (learned positions and rotary) to 1e-6 in the hidden states; one block
  through the port's ``random_ltd_layer`` equals JAX's to 1e-6; dropped
  positions pass each LTD layer bitwise, the layers before the first LTD
  layer are the dense forward's bitwise, and ``keep >= T`` is the dense
  forward bitwise. The engine walks the schedule and refuses what the
  reference refuses.
- Progressive layer drop: theta 1 is the plain forward bitwise and JAX's to
  1e-6; theta 0 always drops the last layer and, where both draws keep the
  other layer, equals JAX's to 1e-6; over 2000 draws each layer keeps
  within 4 binomial standard deviations of p_i; the engine hands the model
  theta at the reference's step, and ``Train/pld_theta`` is the JAX
  engine's event for event.
- Curriculum: 4 engine steps from the JAX engine's state give JAX's T per
  step (64, 96, 128, 128), losses rtol 1e-5 and grad norms rtol 1e-4; the
  ``data_efficiency`` spelling gives the legacy block's trajectory bitwise;
  a non-seqlen metric raises as in JAX.
- Remat: under each policy 3 steps are bitwise the port's run without remat
  (dropout on) and JAX's run under the same policy within 1e-5 (losses) and
  2e-5 (state); the bytes kept from the forward for the backward follow the
  policy. The bytes are the storages still alive after the forward among
  those its ops created, tracked with weak references: PyTorch's selective
  checkpointing keeps what it saves in its own cache, which no saved-tensor
  hook sees.
"""

import dataclasses
import gc
import os

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPTConfig as JaxGPTConfig
from deepspeed_tpu.models import build_gpt
from deepspeed_tpu.models import gpt as jax_gpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.data_pipeline.data_routing import random_ltd as jltd
from deepspeed_tpu.runtime.topology import MeshTopology
from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.checkpoint.serialization import flatten_with_paths
from deepspeed_tpu_torch.models import gpt
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import random_ltd as tltd
from deepspeed_tpu_torch.utils.tree import tree_map

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq_len=128)
SEQ = 32
# fp32 hidden states (O(1)) after the final LN: another summation order,
# doubled where a kept PLD delta is scaled by 1/p
HIDDEN_TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(**over):
    """(jax cfg, jax params, port cfg, port params) from one JAX init."""
    kw = {**TINY, **over}
    jcfg = JaxGPTConfig(**kw)
    jparams = jax_gpt.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, gpt.GPTConfig(**kw), bridge.params_from_numpy(tree, "cpu")


def _ids(seed=0, B=2, T=SEQ):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, T)).astype(np.int32)


def _config(micro=2, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "optimizer": {"type": "AdamW", "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    cfg.update(over)
    return cfg


def _engines(cfg, seed=0, **gpt_over):
    """(JAX engine, port engine started from the JAX engine's state)."""
    jmodel, _ = build_gpt(JaxGPTConfig(**TINY, **gpt_over))
    jengine = deepspeed_tpu.initialize(
        model=jmodel, config=JaxDeepSpeedConfig.load(cfg, world_size=1),
        topology=MeshTopology.single_device(), seed=seed)[0]
    engine = _port_engine(cfg, jengine, **gpt_over)
    return jengine, engine


def _port_engine(cfg, jengine, **gpt_over):
    model, _ = gpt.build(gpt.GPTConfig(**TINY, **gpt_over))
    engine = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu", seed=0)[0]
    state = jax.tree_util.tree_map(np.asarray, jengine.state)
    engine.load_state(bridge.train_state_from_numpy(state, "cpu"))
    return engine


def _recording_model(engine, seen):
    """Make the engine's model record each micro-batch's T."""
    apply = engine.model.apply

    def rec(params, batch, **kw):
        seen.append(int(batch["input_ids"].shape[-1]))
        return apply(params, batch, **kw)

    engine.model = dataclasses.replace(engine.model, apply=rec)


# ------------------------------------------------------------------ random-LTD
def _jax_ltd_indices(drng, i, B, T, keep):
    """The indices JAX's forward draws in LTD layer ``i`` (its key is
    fold_in(fold_in(drng, i), i)); they depend only on the key and (B, T)."""
    key = jax.random.fold_in(jax.random.fold_in(drng, i), i)
    return np.array(jltd.random_ltd_gather(jnp.zeros((B, T, 1)), keep, key)[1])


@pytest.mark.parametrize("over", [{}, {"rotary": True, "rotary_pct": 0.5}],
                         ids=["learned", "rotary"])
def test_ltd_forward_with_jax_indices_matches_jax(monkeypatch, over):
    jcfg, jparams, cfg, params = _pair(n_layer=3, **over)
    keep, ids_ltd = 12, (1, 2)
    jcfg = dataclasses.replace(jcfg, random_ltd_keep=keep, random_ltd_layer_ids=ids_ltd)
    cfg = dataclasses.replace(cfg, random_ltd_keep=keep, random_ltd_layer_ids=ids_ltd)
    ids = _ids(1)
    drng = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, i: jax_gpt.forward(jcfg, p, i, rngs={"dropout": drng}, train=True,
                                                return_hidden=True))(jparams, jnp.asarray(ids))
    given = {i: torch.from_numpy(_jax_ltd_indices(drng, i, 2, SEQ, keep)) for i in ids_ltd}
    monkeypatch.setattr(gpt, "ltd_indices", lambda B, T, k, seed, i, device: given[i])
    got = gpt.forward(cfg, params, torch.from_numpy(ids), rngs={"dropout": 3}, train=True,
                      return_hidden=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HIDDEN_TOL)


def test_ltd_block_matches_jax_random_ltd_layer():
    jcfg, jparams, cfg, params = _pair()
    x = np.random.default_rng(2).normal(size=(2, SEQ, TINY["d_model"])).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jw = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])
    pos = jnp.broadcast_to(jnp.arange(10)[None], (2, 10))
    want = jax.jit(lambda w, xx: jltd.random_ltd_layer(
        lambda kept: jax_gpt._block(jcfg, kept, w, pos, None, False), xx, 10, key))(
            jw, jnp.asarray(x))
    idx = torch.from_numpy(np.array(jltd.random_ltd_gather(jnp.asarray(x), 10, key)[1]))
    w = {k: v[0] for k, v in params["blocks"].items()}
    tpos = torch.arange(10).expand(2, 10)
    got = tltd.random_ltd_layer(lambda kept: gpt._block(cfg, kept, w, tpos), torch.from_numpy(x),
                                10, idx=idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HIDDEN_TOL)


def test_ltd_forward_passes_dropped_tokens_and_keeps_dense_layers(monkeypatch):
    _, _, cfg, params = _pair(n_layer=3)
    ids = torch.from_numpy(_ids(3))
    outs, scatters = [], []
    block, scatter = gpt._block, gpt.random_ltd_scatter

    def rec_block(*a, **kw):
        outs.append(block(*a, **kw))
        return outs[-1]

    def rec_scatter(out, idx, x_full):
        y = scatter(out, idx, x_full)
        scatters.append((x_full, idx, y))
        return y

    monkeypatch.setattr(gpt, "_block", rec_block)
    monkeypatch.setattr(gpt, "random_ltd_scatter", rec_scatter)
    dense = gpt.forward(cfg, params, ids, rngs={"dropout": 5})
    dense_outs = list(outs)
    ltd_cfg = dataclasses.replace(cfg, random_ltd_keep=8, random_ltd_layer_ids=(1, 2))
    outs.clear()
    ltd = gpt.forward(ltd_cfg, params, ids, rngs={"dropout": 5})
    assert torch.equal(outs[0], dense_outs[0])  # layer 0 is outside the ids
    assert [o.shape[1] for o in outs] == [SEQ, 8, 8]
    assert len(scatters) == 2
    for x_full, idx, y in scatters:
        dropped = torch.ones(x_full.shape[:2], dtype=torch.bool)
        dropped.scatter_(1, idx, False)
        assert int(dropped.sum()) == 2 * (SEQ - 8)
        assert torch.equal(y[dropped], x_full[dropped])
    assert not torch.equal(ltd, dense)
    full = dataclasses.replace(cfg, random_ltd_keep=SEQ, random_ltd_layer_ids=(1, 2))
    monkeypatch.undo()
    assert torch.equal(gpt.forward(full, params, ids, rngs={"dropout": 5}), dense)
    # eval ignores random-LTD, and a training forward without a seed refuses
    assert torch.equal(gpt.forward(ltd_cfg, params, ids, train=False),
                       gpt.forward(cfg, params, ids, train=False))
    with pytest.raises(ValueError, match="dropout seed"):
        gpt.forward(ltd_cfg, params, ids)
    # the subset changes with the step's seed
    a = gpt.ltd_indices(2, SEQ, 8, 1, 1, "cpu")
    assert torch.equal(a, gpt.ltd_indices(2, SEQ, 8, 1, 1, "cpu"))
    assert not torch.equal(a, gpt.ltd_indices(2, SEQ, 8, 2, 1, "cpu"))


def _ltd_config(**rl_over):
    rl = {"enabled": True, "total_layer_num": 3, "random_ltd_layer_num": 1,
          "random_ltd_schedule": {"min_value": 16, "max_value": 32, "schedule_type":
                                  "fixed_linear",
                                  "schedule_config": {"seq_per_step": 8, "require_steps": 4}}}
    rl.update(rl_over)
    return _config(data_efficiency={"enabled": True, "data_routing": {"enabled": True,
                                                                     "random_ltd": rl}})


def test_engine_random_ltd_walks_the_schedule_and_refuses_as_the_reference():
    model, _ = gpt.build(gpt.GPTConfig(**{**TINY, "n_layer": 3}))
    engine = deepspeed_tpu_torch.initialize(model=model, config=_ltd_config(), device="cpu")[0]
    assert engine._random_ltd.layer_ids == [1]  # the default sandwich
    keeps, losses = [], []
    b = {"input_ids": _ids(4)}
    for _ in range(6):
        losses.append(float(engine.train_batch(b)["loss"]))
        keeps.append(engine.model.gpt_config.random_ltd_keep)
    assert keeps == [engine._random_ltd.get_value(s) for s in range(6)] == \
        [16, 16, 24, 24, 32, 32]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for bad, err, match in (
            (dict(random_ltd_layer_num=0), ValueError, "ZERO layers"),
            (dict(random_ltd_layer_id=[]), ValueError, "ZERO layers")):
        cfg = _ltd_config(**bad)
        if "random_ltd_layer_num" not in bad:
            del cfg["data_efficiency"]["data_routing"]["random_ltd"]["random_ltd_layer_num"]
        with pytest.raises(err, match=match):
            deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
        jmodel, _ = build_gpt(JaxGPTConfig(**{**TINY, "n_layer": 3}))
        with pytest.raises(err, match=match):
            deepspeed_tpu.initialize(model=jmodel, config=JaxDeepSpeedConfig.load(cfg, 1),
                                     topology=MeshTopology.single_device())
    with pytest.raises(ValueError, match="with_ltd_keep"):
        deepspeed_tpu_torch.initialize(model=dataclasses.replace(model, with_ltd_keep=None),
                                       config=_ltd_config(), device="cpu")
    # ZeRO-Offload refuses random-LTD, with the reference's ValueError
    offload = {**_ltd_config(), "zero_optimization": {"stage": 2, "offload_optimizer": {
        "device": "cpu"}}}
    with pytest.raises(ValueError, match="random_ltd is not supported together with ZeRO-Offload"):
        deepspeed_tpu_torch.initialize(model=model, config=offload, device="cpu")
    with pytest.raises(ValueError, match="random_ltd is not supported together with ZeRO-Offload"):
        deepspeed_tpu.initialize(model=jmodel, config=JaxDeepSpeedConfig.load(offload, 1),
                                 topology=MeshTopology.single_device())


# ------------------------------------------------------------------ PLD
def _jax_pld_kept(drng, L, theta):
    kept = []
    for i in range(L):
        p = 1.0 - (np.float32(i + 1) / L) * (1.0 - np.float32(theta))
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(drng, i), 0x91D), i)
        kept.append(bool(jax.random.bernoulli(key, p)))
    return tuple(kept)


def test_pld_theta_one_is_the_plain_forward_and_jax():
    jcfg, jparams, cfg, params = _pair()
    ids = _ids(5)
    plain = gpt.forward(cfg, params, torch.from_numpy(ids), rngs={"dropout": 9},
                        return_hidden=True)
    got = gpt.forward(cfg, params, torch.from_numpy(ids), rngs={"dropout": 9}, pld_theta=1.0,
                      return_hidden=True)
    assert torch.equal(got, plain)
    want = jax.jit(lambda p, i: jax_gpt.forward(
        jcfg, p, i, rngs={"dropout": jax.random.PRNGKey(1)}, train=True, return_hidden=True,
        pld_theta=jnp.float32(1.0)))(jparams, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HIDDEN_TOL)


def test_pld_theta_zero_drops_the_last_layer_and_matches_jax():
    jcfg, jparams, cfg, params = _pair()
    ids = _ids(6)
    L = cfg.n_layer
    # the draws of layer 0 (p = 1/2): a port seed and a JAX key that keep it,
    # and a port seed that drops it
    keep_seed = next(s for s in range(100) if gpt.pld_kept_layers(L, 0.0, s)[0])
    drop_seed = next(s for s in range(100) if not gpt.pld_kept_layers(L, 0.0, s)[0])
    jkey = next(jax.random.PRNGKey(s) for s in range(100)
                if _jax_pld_kept(jax.random.PRNGKey(s), L, 0.0)[0])
    assert all(not gpt.pld_kept_layers(L, 0.0, s)[-1] for s in range(200))
    got = gpt.forward(cfg, params, torch.from_numpy(ids), rngs={"dropout": keep_seed},
                      pld_theta=0.0, return_hidden=True)
    want = jax.jit(lambda p, i: jax_gpt.forward(
        jcfg, p, i, rngs={"dropout": jkey}, train=True, return_hidden=True,
        pld_theta=jnp.float32(0.0)))(jparams, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HIDDEN_TOL)
    # the first layer's delta doubled, the last layer skipped
    one = dataclasses.replace(cfg, n_layer=1)
    first = {**params, "blocks": {k: v[:1] for k, v in params["blocks"].items()}}
    x = gpt._embed(cfg, params, torch.from_numpy(ids).long(), torch.arange(SEQ).expand(2, SEQ))
    y = gpt._block(one, x, {k: v[0] for k, v in params["blocks"].items()},
                   torch.arange(SEQ).expand(2, SEQ), None, True, layer_idx=0)
    expect = gpt.layer_norm(x + (y - x) / 0.5, params["lnf_scale"], params["lnf_bias"],
                            cfg.layer_norm_eps)
    assert torch.equal(got, expect)
    none = gpt.forward(cfg, params, torch.from_numpy(ids), rngs={"dropout": drop_seed},
                       pld_theta=0.0, return_hidden=True)
    assert torch.equal(none, gpt.layer_norm(x, params["lnf_scale"], params["lnf_bias"],
                                            cfg.layer_norm_eps))
    del first


def test_pld_keep_rates_follow_p_i_and_the_refusals():
    L, theta, n = 12, 0.5, 2000
    draws = np.array([gpt.pld_kept_layers(L, theta, s) for s in range(n)])
    for i in range(L):
        p = gpt.pld_keep_prob(i, L, theta)
        assert p == pytest.approx(1 - (i + 1) / L * (1 - theta), abs=1e-7)
        assert abs(draws[:, i].mean() - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1e-12
    _, _, cfg, params = _pair()
    ids = torch.from_numpy(_ids(7))
    for c, kw, match in ((dataclasses.replace(cfg, stochastic_depth=0.1),
                          dict(rngs={"dropout": 1}), "stochastic_depth"),
                         (cfg, dict(rngs={"dropout": 1}, train=False), "train-only"),
                         (cfg, {}, "dropout seed")):
        with pytest.raises(ValueError, match=match):
            gpt.forward(c, params, ids, pld_theta=0.5, **kw)


def test_engine_pld_theta_follows_the_reference_step_and_its_monitor_events(tmp_path):
    pld = {"enabled": True, "theta": 0.5, "gamma": 0.5}
    cfg = _config(progressive_layer_drop=pld, csv_monitor={
        "enabled": True, "output_path": str(tmp_path / "port"), "job_name": "j"})
    jcfg = {**cfg, "csv_monitor": {"enabled": True, "output_path": str(tmp_path / "jax"),
                                   "job_name": "j"}}
    jengine = deepspeed_tpu.initialize(
        model=build_gpt(JaxGPTConfig(**TINY))[0], config=JaxDeepSpeedConfig.load(jcfg, 1),
        topology=MeshTopology.single_device(), seed=0)[0]
    engine = _port_engine(cfg, jengine)
    thetas = []
    apply = engine.model.apply
    engine.model = dataclasses.replace(
        engine.model, apply=lambda p, b, **kw: (thetas.append(kw["pld_theta"]), apply(p, b, **kw))[1])
    b = {"input_ids": _ids(8)}
    for _ in range(4):
        jengine.train_batch(b)
        engine.train_batch(b)
    assert thetas == [0.5 * np.exp(-0.5 * s) + 0.5 for s in range(4)]
    assert engine.progressive_layer_drop.get_theta() == 0.5 * np.exp(-0.5 * 4) + 0.5

    def rows(root):
        with open(os.path.join(root, "j", "Train_pld_theta.csv")) as f:
            return [tuple(map(float, line.split(","))) for line in f.read().split()[1:]]

    got, want = rows(tmp_path / "port"), rows(tmp_path / "jax")
    assert [r[0] for r in got] == [r[0] for r in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], rtol=1e-6)


def test_pld_refuses_the_quantized_gradient_exchange():
    model, _ = gpt.build("tiny")
    with pytest.raises(ValueError, match="progressive_layer_drop"):
        deepspeed_tpu_torch.initialize(model=model, config=_config(
            progressive_layer_drop={"enabled": True},
            zero_optimization={"stage": 2, "zero_quantized_gradients": True}), device="cpu")


# ------------------------------------------------------------------ curriculum
_CL = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 32,
       "max_difficulty": 128, "schedule_type": "fixed_linear",
       "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 32}}
_DE = {"enabled": True, "data_sampling": {"curriculum_learning": {
    "enabled": True, "curriculum_metrics": {"seqlen": {
        "min_difficulty": 32, "max_difficulty": 128, "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 32}}}}}}


def test_engine_curriculum_matches_jax_and_both_spellings():
    jengine, engine = _engines(_config(curriculum_learning=_CL))
    spelled = {"legacy": _port_engine(_config(curriculum_learning=_CL), jengine),
               "data_efficiency": _port_engine(_config(data_efficiency=_DE), jengine)}
    seen = []
    _recording_model(engine, seen)
    batches = [{"input_ids": _ids(10 + s, T=128)} for s in range(4)]
    jm = [jengine.train_batch(b) for b in batches]
    m = [engine.train_batch(b) for b in batches]
    assert seen == [jengine.curriculum_scheduler.get_difficulty(s + 1) for s in range(4)] \
        == [64, 96, 128, 128]
    np.testing.assert_allclose([float(x["loss"]) for x in m], [float(x["loss"]) for x in jm],
                               rtol=1e-5)
    np.testing.assert_allclose([float(x["grad_norm"]) for x in m],
                               [float(x["grad_norm"]) for x in jm], rtol=1e-4)
    runs = {k: [float(e.train_batch(b)["loss"]) for b in batches] for k, e in spelled.items()}
    assert runs["legacy"] == runs["data_efficiency"] == [float(x["loss"]) for x in m]
    bad = {"enabled": True, "data_sampling": {"curriculum_learning": {
        "enabled": True, "curriculum_metrics": {"vocab_rarity": {}}}}}
    model = gpt.build(gpt.GPTConfig(**TINY))[0]
    with pytest.raises(NotImplementedError, match="unsupported in-engine"):
        deepspeed_tpu_torch.initialize(model=model, config=_config(data_efficiency=bad),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="unsupported in-engine"):
        deepspeed_tpu.initialize(model=build_gpt(JaxGPTConfig(**TINY))[0],
                                 config=JaxDeepSpeedConfig.load(_config(data_efficiency=bad), 1),
                                 topology=MeshTopology.single_device())


# ------------------------------------------------------------------ remat
POLICIES = ("nothing_saveable", "save_attn_mlp_out", "dots_with_no_batch_dims_saveable",
            "dots_saveable", "everything_saveable")


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages the ops under it create that are still
    alive when read (weak references, so holding them keeps nothing)."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.refs[st._cdata] = (StorageWeakRef(st), st.nbytes())
        return out

    def live(self) -> int:
        gc.collect()
        return sum(n for ref, n in self.refs.values() if not ref.expired())


def _saved_bytes(cfg, params, ids):
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    mode = _LiveBytes()
    with mode:
        loss, _ = gpt.loss_fn(cfg, leaves, {"input_ids": ids}, rngs={"dropout": 1})
    kept = mode.live()
    loss.backward()
    return kept


def _trajectory(engine, batches):
    ms = [engine.train_batch(b) for b in batches]
    return ([float(m["loss"]) for m in ms], [float(m["grad_norm"]) for m in ms],
            dict(flatten_with_paths(bridge.train_state_to_numpy(engine.state))))


@pytest.fixture(scope="module")
def remat_runs():
    """Per policy: the port's 3 steps with dropout 0.1, and JAX's and the
    port's 3 steps without dropout, all from one JAX start state."""
    batches = [{"input_ids": _ids(20 + s, B=4)} for s in range(3)]
    # test_torch_engine.py's configuration: WarmupLR keeps the first steps
    # small, so that Adam's normalised update does not blow a last-bit
    # difference of a nearly cancelling gradient entry up to lr
    cfg = _config(micro=4, scheduler={"type": "WarmupLR", "params": {
        "warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3, "warmup_num_steps": 4}})
    start = None
    runs = {}
    for policy in POLICIES + (None,):
        over = {} if policy is None else {"remat": True, "remat_policy": policy}
        jengine = deepspeed_tpu.initialize(
            model=build_gpt(JaxGPTConfig(**TINY, **over))[0],
            config=JaxDeepSpeedConfig.load(cfg, 1), topology=MeshTopology.single_device(),
            seed=0)[0] if policy is not None else None
        if start is None:  # every JAX engine starts from this state (seed 0)
            start = jax.tree_util.tree_map(np.asarray, jengine.state)
        port = {}
        for dropout in (0.0, 0.1):
            model, _ = gpt.build(gpt.GPTConfig(**TINY, dropout=dropout, **over))
            engine = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu",
                                                    seed=0)[0]
            engine.load_state(bridge.train_state_from_numpy(start, "cpu"))
            port[dropout] = _trajectory(engine, batches)
        jrun = None
        if jengine is not None:
            jm = [jengine.train_batch(b) for b in batches]
            jrun = ([float(m["loss"]) for m in jm], dict(flatten_with_paths(
                jax.tree_util.tree_map(np.asarray, jengine.state))))
        runs[policy] = (port, jrun)
    return runs


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_is_bitwise_no_remat_and_matches_jax(remat_runs, policy):
    (port, jrun), (base, _) = remat_runs[policy], remat_runs[None]
    for dropout in (0.0, 0.1):
        losses, norms, state = port[dropout]
        assert losses == base[dropout][0] and norms == base[dropout][1]
        assert state.keys() == base[dropout][2].keys()
        for k, v in state.items():
            np.testing.assert_array_equal(v, base[dropout][2][k], err_msg=k)
    jl, jstate = jrun
    np.testing.assert_allclose(port[0.0][0], jl, rtol=1e-5)
    assert set(jstate) == set(port[0.0][2])
    for k, v in port[0.0][2].items():
        np.testing.assert_allclose(np.asarray(v, np.float32), np.asarray(jstate[k], np.float32),
                                   rtol=0, atol=2e-5, err_msg=k)


def test_remat_saved_bytes_follow_the_policy_and_unknown_names_raise():
    _, _, cfg, params = _pair()
    ids = torch.from_numpy(_ids(30, T=64))
    got = {p: _saved_bytes(dataclasses.replace(cfg, remat=True, remat_policy=p), params, ids)
           for p in POLICIES}
    got["no remat"] = _saved_bytes(cfg, params, ids)
    assert got["nothing_saveable"] < got["save_attn_mlp_out"] \
        < got["dots_with_no_batch_dims_saveable"] <= got["dots_saveable"] \
        < got["everything_saveable"] == got["no remat"], got
    for alias, name in (("checkpoint_dots", "dots_saveable"),
                        ("checkpoint_dots_with_no_batch_dims",
                         "dots_with_no_batch_dims_saveable")):
        assert _saved_bytes(dataclasses.replace(cfg, remat=True, remat_policy=alias), params,
                            ids) == got[name]
    with pytest.raises(ValueError, match="unknown remat_policy"):
        gpt.forward(dataclasses.replace(cfg, remat=True, remat_policy="save_only_these_names"),
                    params, ids)


# ------------------------------------------------------------------ the checkpointing API
@pytest.fixture()
def _clean_ac():
    ac.reset()
    yield
    ac.reset()


def _mlp(p, x):
    return (torch.tanh(x @ p["w1"]) @ p["w2"]).sum()


def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": torch.tensor(rng.normal(size=(16, 32)), dtype=torch.float32,
                               requires_grad=True),
            "w2": torch.tensor(rng.normal(size=(32, 8)), dtype=torch.float32,
                               requires_grad=True)}


@pytest.mark.parametrize("knobs", [{}, {"policy_name": "dots_saveable"},
                                   {"cpu_checkpointing": True, "profile": True},
                                   {"partition_activations": True},
                                   {"policy_name": "everything_saveable"}],
                         ids=["plain", "dots", "cpu-profile", "partition", "everything"])
def test_checkpoint_is_bitwise_the_plain_gradient(_clean_ac, knobs):
    p = _mlp_params()
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32))
    g1 = torch.autograd.grad(_mlp(p, x), list(p.values()))
    f = ac.checkpoint_wrapper(lambda q, xx: _mlp(q, xx), ac.CheckpointConfig(**knobs))
    g2 = torch.autograd.grad(f(p, x), list(p.values()))
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    # eager composition (the reference's jit / scan case): a loop of wrapped calls
    xs = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 4, 16)).astype(np.float32))
    tot = sum(f(p, xx) for xx in xs)
    want = sum(_mlp(p, xx) for xx in xs)
    for a, b in zip(torch.autograd.grad(tot, list(p.values())),
                    torch.autograd.grad(want, list(p.values()))):
        assert torch.equal(a, b)
    ac.configure(checkpoint_in_cpu=knobs.get("cpu_checkpointing"))
    g3 = torch.autograd.grad(ac.checkpoint(lambda q: _mlp(q, x), p), list(p.values()))
    for a, b in zip(g1, g3):
        assert torch.equal(a, b)


def test_configure_from_config_and_overrides_and_the_engine(_clean_ac):
    cfg = DeepSpeedConfig.load({"train_micro_batch_size_per_gpu": 1, "activation_checkpointing": {
        "partition_activations": True, "cpu_checkpointing": False, "number_checkpoints": 4}})
    ac.configure(deepspeed_config=cfg)
    assert ac.is_configured()
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as m

    assert m._config.partition_activations is True and m._config.number_checkpoints == 4
    ac.configure(partition_activations=False, num_checkpoints=2, profile=True)
    assert m._config.profile is True and m._config.number_checkpoints == 2
    ac.reset()
    assert not ac.is_configured()
    model, _ = gpt.build("tiny")
    deepspeed_tpu_torch.initialize(model=model, config=_config(activation_checkpointing={
        "partition_activations": True}), device="cpu")
    assert ac.is_configured() and m._config.partition_activations is True
    ac.configure(num_checkpoints=7)  # a user's configure survives a default block
    deepspeed_tpu_torch.initialize(model=model, config=_config(), device="cpu")
    assert m._config.number_checkpoints == 7
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        ac.policy_from_config(ac.CheckpointConfig(policy_name="nope"))


def test_rng_tracker_fork_determinism_and_states(_clean_ac):
    tr = ac.get_rng_tracker()
    tr.reset()
    tr.add("model-parallel-rng", 42)
    saved = tr.get_states()
    k1, k2 = tr.fork(), tr.fork()
    assert k1 != k2
    tr.set_states(saved)
    assert tr.fork() == k1
    tr.reset()
    tr.add("model-parallel-rng", 42)
    assert tr.fork() == k1
    with pytest.raises(Exception):
        tr.add("model-parallel-rng", 1)
    assert ac.model_parallel_reseed(123) == 123  # no model-parallel axis
    tr.reset()
