"""The port's host SIMD optimizers against the JAX package's.

Both packages compile the same C++ (``deepspeed_tpu_torch/csrc/host/
cpu_adam.cpp`` is the JAX package's ``csrc/cpu_adam.cpp`` with another
header comment) with the same probed flags, so every Adam / AdamW / Adagrad
step is held BITWISE against the reference's ``DeepSpeedCPUAdam`` /
``DeepSpeedCPUAdagrad`` on the same numpy inputs, the bf16 copy-back
included. The numpy reference (``adam_step_numpy``) is held at the
reference's own bar (rtol 2e-5, atol 2e-6). The bf16 copy-back is bitwise
``torch.Tensor.to(torch.bfloat16)`` for finite values; its NaN behaviour is
pinned as documented. A failed build raises with the compiler's output.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam import DeepSpeedCPUAdagrad as JaxCPUAdagrad
from deepspeed_tpu.ops.adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu.ops.op_builder import get_builder
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.cpu_adam import adagrad_step_numpy, adam_step_numpy

N = 10_001  # odd: the SIMD loop's remainder runs too


def _inputs(seed, n=N):
    r = np.random.default_rng(seed)
    p = r.normal(size=n).astype(np.float32)
    grads = [r.normal(size=n).astype(np.float32) for _ in range(3)]
    return p, grads


def test_host_library_builds_with_the_reference_flags():
    """Same compiler flags as the reference's builder probes, and the SIMD
    path where the host has it."""
    ref = get_builder("ds_cpu_ops")
    assert _build.host_flags() == ("-O3", "-shared", "-fPIC", "-std=c++17",
                                   *ref.simd_flags())
    lib = _build.load_host("cpu_adam")
    assert lib.ds_cpu_ops_version() == 1
    assert lib.ds_cpu_ops_simd() == ref.load().ds_cpu_ops_simd()
    assert _build.load_host("cpu_adam") is lib  # loaded once
    assert _build.sources() == sorted(p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "adam-l2"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16-out"])
def test_adam_bitwise_the_reference(adamw, wd, bf16):
    p, grads = _inputs(0)
    port = [p.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)]
    ref = [p.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)]
    outs = (np.zeros(N, np.uint16), np.zeros(N, np.uint16)) if bf16 else (None, None)
    po = DeepSpeedCPUAdam(lr=1e-3, weight_decay=wd, adamw_mode=adamw)
    ro = JaxCPUAdam(lr=1e-3, weight_decay=wd, adamw_mode=adamw)
    assert ro.is_native
    for t, g in enumerate(grads, 1):
        po.step(*port, g, t, bf16_out=outs[0])
        ro.step(*ref, g, t, bf16_out=outs[1])
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    if bf16:
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("kw", [{"bias_correction": False}, {"betas": (0.8, 0.99), "eps": 1e-6},
                                {"lr": 3e-2}], ids=["no-bias-correction", "betas-eps", "lr"])
def test_adam_options_bitwise_the_reference(kw):
    p, grads = _inputs(1)
    port = [p.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)]
    ref = [x.copy() for x in port]
    po, ro = DeepSpeedCPUAdam(**kw), JaxCPUAdam(**kw)
    for t, g in enumerate(grads, 1):
        po.step(*port, g, t, lr=kw.get("lr"))
        ro.step(*ref, g, t, lr=kw.get("lr"))
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16-out"])
def test_adagrad_bitwise_the_reference(wd, bf16):
    p, grads = _inputs(2)
    port, ref = [p.copy(), np.zeros(N, np.float32)], [p.copy(), np.zeros(N, np.float32)]
    outs = (np.zeros(N, np.uint16), np.zeros(N, np.uint16)) if bf16 else (None, None)
    po, ro = DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=wd), JaxCPUAdagrad(lr=1e-2, weight_decay=wd)
    for g in grads:
        po.step(*port, g, bf16_out=outs[0])
        ro.step(*ref, g, bf16_out=outs[1])
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    if bf16:
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("adamw,wd", [(True, 0.0), (True, 0.01), (False, 0.01)])
def test_adam_matches_the_numpy_reference(adamw, wd):
    p, grads = _inputs(3)
    native = [p.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)]
    plain = [x.copy() for x in native]
    opt = DeepSpeedCPUAdam(lr=1e-3, weight_decay=wd, adamw_mode=adamw)
    for t, g in enumerate(grads, 1):
        opt.step(*native, g, t)
        adam_step_numpy(*plain, g, t, 1e-3, weight_decay=wd, adamw_mode=adamw)
    for a, b in zip(native, plain):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


def test_adagrad_matches_the_numpy_reference():
    p, grads = _inputs(4)
    native, plain = [p.copy(), np.zeros(N, np.float32)], [p.copy(), np.zeros(N, np.float32)]
    opt = DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=0.01)
    for g in grads:
        opt.step(*native, g)
        adagrad_step_numpy(*plain, g, 1e-2, weight_decay=0.01)
    for a, b in zip(native, plain):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


def test_bf16_copy_back_is_torch_rounding_on_finite_values():
    """The copy-back written in the optimizer's pass is bitwise the master's
    torch cast, over ordinary values, exact ties (round half to even) and
    the largest finite fp32 (to infinity in both); it lands in a bf16
    tensor's memory through its numpy view."""
    r = np.random.default_rng(5)
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x7F7FFFFF, 0x00000001, 0x80000000],
                    np.uint32).view(np.float32)
    p = np.concatenate([r.normal(size=N).astype(np.float32) * 10.0 ** r.integers(-8, 8, N),
                        ties]).astype(np.float32)
    n = p.size
    out = torch.empty(n, dtype=torch.bfloat16)
    from deepspeed_tpu_torch.runtime.zero.stream import uint16_view

    # lr 0: the master stays as given, so the copy-back rounds exactly it
    DeepSpeedCPUAdagrad(lr=0.0).step(p, np.zeros(n, np.float32), np.ones(n, np.float32),
                                     bf16_out=uint16_view(out))
    want = torch.from_numpy(p).to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def test_bf16_copy_back_of_nan_is_as_documented():
    """The quiet NaN stays a NaN; a NaN whose payload's upper half is all
    ones carries out into a signed zero (torch gives a NaN)."""
    p = np.array([0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF], np.uint32).view(np.float32).copy()
    out = np.zeros(3, np.uint16)
    DeepSpeedCPUAdagrad(lr=0.0).step(p, np.zeros(3, np.float32), np.ones(3, np.float32),
                                     bf16_out=out)
    assert out.tolist() == [0x7FC0, 0x8000, 0x0000]
    assert torch.from_numpy(p).to(torch.bfloat16).isnan().all()


def test_invalid_arrays_raise():
    opt = DeepSpeedCPUAdam()
    p = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="float32"):
        opt.step(p, p.copy(), p.copy(), np.zeros(8, np.float64), 1)
    with pytest.raises(ValueError, match="differ in size"):
        opt.step(p, p.copy(), p.copy(), np.zeros(9, np.float32), 1)
    with pytest.raises(ValueError, match="bf16_out"):
        opt.step(p, p.copy(), p.copy(), p.copy(), 1, bf16_out=np.zeros(8, np.float32))


def test_failed_host_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises, naming the
    compiler's error."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("extern \"C\" int f() { return not_declared; }\n")
    monkeypatch.setattr(_build, "HOST_CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="not_declared"):
        _build.load_host("broken")
    assert not list((tmp_path / "build").glob("*.so"))  # no partial library left
