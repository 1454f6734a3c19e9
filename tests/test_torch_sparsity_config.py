"""The port's sparsity layouts vs the JAX package's.

``deepspeed_tpu_torch.ops.sparse_attention.sparsity_config`` is the port's own
copy of the reference's numpy layout builders: every config must give the
reference's ``[H, T/block, T/block]`` int64 layout bit for bit, the index
tables of ``ops/cuda/blocksparse_attention.layout_tables`` must be the
reference's, and every constructor or ``setup_layout`` error must be raised
where the reference raises it.
"""

import numpy as np
import pytest

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas.blocksparse_attention import layout_tables as jax_layout_tables
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.cuda.blocksparse_attention import layout_tables

# (class name, constructor kwargs); num_heads 4 unless given
CONFIGS = [
    ("DenseSparsityConfig", {}),
    ("DenseSparsityConfig", {"block": 16, "different_layout_per_head": True}),
    ("FixedSparsityConfig", {"block": 16}),
    ("FixedSparsityConfig", {"block": 16, "attention": "unidirectional"}),
    ("FixedSparsityConfig", {"block": 8, "num_local_blocks": 4, "num_global_blocks": 2}),
    ("FixedSparsityConfig", {"block": 8, "different_layout_per_head": True,
                             "num_local_blocks": 6, "num_global_blocks": 2,
                             "num_different_global_patterns": 3}),
    ("FixedSparsityConfig", {"block": 8, "different_layout_per_head": True,
                             "num_different_global_patterns": 4,
                             "attention": "unidirectional"}),
    ("FixedSparsityConfig", {"block": 8, "horizontal_global_attention": True}),
    ("VariableSparsityConfig", {"block": 16}),
    ("VariableSparsityConfig", {"block": 8, "num_random_blocks": 2,
                                "local_window_blocks": [1, 2, 3],
                                "global_block_indices": [0, 5],
                                "different_layout_per_head": True, "seed": 3}),
    ("VariableSparsityConfig", {"block": 8, "global_block_indices": [1, 6],
                                "global_block_end_indices": [3, 9],
                                "horizontal_global_attention": True}),
    ("VariableSparsityConfig", {"block": 8, "num_random_blocks": 1,
                                "attention": "unidirectional"}),
    ("BigBirdSparsityConfig", {"block": 16}),
    ("BigBirdSparsityConfig", {"block": 8, "different_layout_per_head": True, "seed": 7,
                               "num_random_blocks": 2, "num_global_blocks": 2}),
    ("BigBirdSparsityConfig", {"block": 8, "attention": "unidirectional",
                               "different_layout_per_head": True, "seed": 11}),
    ("BigBirdSparsityConfig", {"block": 8, "num_sliding_window_blocks": 5, "seed": 1}),
    ("BSLongformerSparsityConfig", {"block": 16}),
    ("BSLongformerSparsityConfig", {"block": 8, "global_block_indices": [0, 4],
                                    "global_block_end_indices": [2, 7],
                                    "attention": "unidirectional"}),
    ("LocalSlidingWindowSparsityConfig", {"block": 16}),
    ("LocalSlidingWindowSparsityConfig", {"block": 8, "num_sliding_window_blocks": 4,
                                          "attention": "bidirectional"}),
]


def _both(name, kwargs, num_heads=4):
    return (getattr(jsa, name)(num_heads=num_heads, **kwargs),
            getattr(sa, name)(num_heads=num_heads, **kwargs))


@pytest.mark.parametrize("name,kwargs", CONFIGS,
                         ids=[f"{n[:-len('SparsityConfig')]}-{i}"
                              for i, (n, _) in enumerate(CONFIGS)])
def test_layouts_bitwise_jax(name, kwargs):
    ref_cfg, cfg = _both(name, kwargs)
    for T in (cfg.block * n for n in (1, 4, 8, 13)):  # partial windows at 13 blocks
        ref = ref_cfg.make_layout(T)
        out = cfg.make_layout(T)
        assert out.dtype == ref.dtype == np.int64
        assert out.shape == ref.shape == (4, T // cfg.block, T // cfg.block)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", [0, 1, 5, 42])
def test_bigbird_seeds_bitwise_jax(seed):
    """BigBird's random blocks come from np.random.default_rng(seed), in the
    reference's order of draws."""
    ref_cfg, cfg = _both("BigBirdSparsityConfig", {
        "block": 16, "seed": seed, "num_random_blocks": 3,
        "different_layout_per_head": True})
    np.testing.assert_array_equal(cfg.make_layout(512), ref_cfg.make_layout(512))
    assert cfg.make_layout(512).tobytes() == ref_cfg.make_layout(512).tobytes()


@pytest.mark.parametrize("name,kwargs", [CONFIGS[i] for i in (3, 5, 9, 13, 17)],
                         ids=["fixed-uni", "fixed-patterns", "variable-random",
                              "bigbird-per-head", "longformer-ranges"])
def test_layout_tables_bitwise_jax(name, kwargs):
    ref_cfg, cfg = _both(name, kwargs)
    layout = cfg.make_layout(128)
    for ref, out in zip(jax_layout_tables(ref_cfg.make_layout(128)), layout_tables(layout)):
        assert out.dtype == ref.dtype == np.int32 and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)


def test_layout_tables_of_an_empty_row():
    layout = np.ones((2, 4, 4), np.int64)
    layout[1, 2] = 0
    layout[0, :, 3] = 0
    for ref, out in zip(jax_layout_tables(layout), layout_tables(layout)):
        np.testing.assert_array_equal(out, ref)
    kidx, kcnt, qidx, qcnt = layout_tables(layout)
    assert kcnt[1, 2] == 0 and qcnt[0, 3] == 0


@pytest.mark.parametrize("name,kwargs", [
    ("FixedSparsityConfig", {"num_local_blocks": 4, "num_global_blocks": 3}),
    ("FixedSparsityConfig", {"attention": "sideways"}),
    ("FixedSparsityConfig", {"attention": "unidirectional",
                             "horizontal_global_attention": True}),
    ("FixedSparsityConfig", {"num_different_global_patterns": 2}),
    ("FixedSparsityConfig", {"different_layout_per_head": True,
                             "num_different_global_patterns": 5}),
    ("VariableSparsityConfig", {"attention": "unidirectional",
                                "horizontal_global_attention": True}),
    ("VariableSparsityConfig", {"global_block_indices": [0, 2],
                                "global_block_end_indices": [1]}),
    ("VariableSparsityConfig", {"attention": "causal"}),
    ("BigBirdSparsityConfig", {"attention": "none"}),
    ("BSLongformerSparsityConfig", {"global_block_end_indices": [1, 2]}),
    ("LocalSlidingWindowSparsityConfig", {"attention": "both"}),
])
def test_constructor_errors_match_jax(name, kwargs):
    with pytest.raises(ValueError) as ref:
        getattr(jsa, name)(num_heads=4, **kwargs)
    with pytest.raises(ValueError) as out:
        getattr(sa, name)(num_heads=4, **kwargs)
    assert str(out.value) == str(ref.value)


@pytest.mark.parametrize("name", ["DenseSparsityConfig", "FixedSparsityConfig",
                                  "VariableSparsityConfig", "BigBirdSparsityConfig",
                                  "BSLongformerSparsityConfig",
                                  "LocalSlidingWindowSparsityConfig"])
def test_setup_layout_errors_match_jax(name):
    ref_cfg, cfg = _both(name, {"block": 16})
    with pytest.raises(ValueError) as ref:
        ref_cfg.make_layout(60)
    with pytest.raises(ValueError) as out:
        cfg.make_layout(60)
    assert str(out.value) == str(ref.value)
    with pytest.raises(NotImplementedError):
        sa.SparsityConfig(num_heads=2).make_layout(128)
