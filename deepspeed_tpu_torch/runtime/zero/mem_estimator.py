"""ZeRO memory-requirement estimators (counterpart of
``deepspeed_tpu/runtime/zero/mem_estimator.py``): the reference's closed
forms for the per-device bytes of the model states under each stage and
offload setting, printed as the option table users size a data-parallel job
with. Device-free arithmetic, the reference's numbers exactly.

The accounting is bf16 training:

==========================  bytes/param  lives
bf16 params                 2            device
fp32 gradient accumulator   4            device, within the step
fp32 master copy            4            device, or host when offloaded
Adam moments (2 x fp32)     8            device, or host when offloaded
==========================  ==========

``compiled_memory_analysis`` (the reference asks XLA for a compiled step's
buffers) is ROADMAP.md A14.
"""

from __future__ import annotations

from ...utils.errors import unported
from ...utils.tree import tree_leaves

GB = 2**30


def _params_of(tree) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))


def _largest_layer_of(tree) -> int:
    """The largest per-layer parameter count: one slice of the layer-stacked
    ``blocks`` leaves, every other leaf whole."""
    largest = 0
    if isinstance(tree, dict) and "blocks" in tree:
        largest = int(sum(x.numel() // x.shape[0] for x in tree_leaves(tree["blocks"])))
        tree = {k: v for k, v in tree.items() if k != "blocks"}
    for x in tree_leaves(tree):
        largest = max(largest, int(x.numel()))
    return largest


def estimate_zero2_model_states_mem_needs(total_params: int, num_chips_per_host: int = 4,
                                          num_hosts: int = 1, cpu_offload: bool = True,
                                          additional_buffer_factor: float = 1.5):
    """``(host_mem, chip_mem)`` bytes per device for ZeRO-1/2."""
    total_chips = num_chips_per_host * num_hosts
    if cpu_offload:
        # device: bf16 params and the fp32 grads; host: master and moments
        chip_mem = (2 + 4) * total_params
        host_mem = total_params * 12 * additional_buffer_factor / num_hosts
    else:
        chip_mem = (2 + 4) * total_params + int(12 * total_params / total_chips)
        host_mem = total_params * 4 * additional_buffer_factor  # init staging
    return int(host_mem), int(chip_mem)


def estimate_zero3_model_states_mem_needs(total_params: int, largest_layer_params: int,
                                          num_chips_per_host: int = 4, num_hosts: int = 1,
                                          cpu_offload: bool = True,
                                          cpu_offload_params: bool = False,
                                          additional_buffer_factor: float = 1.5):
    """``(host_mem, chip_mem, largest_layer_mem)`` bytes for ZeRO-3: the
    gathered working set is one layer's bf16 params and its fp32 grads."""
    total_chips = num_chips_per_host * num_hosts
    largest_layer_mem = (2 + 4) * largest_layer_params
    if cpu_offload:
        if cpu_offload_params:
            chip_mem = largest_layer_mem
            host_mem = (total_params * 18 / num_hosts) * additional_buffer_factor
        else:
            chip_mem = largest_layer_mem + int(2 * total_params / total_chips)
            host_mem = (total_params * 16 / num_hosts) * additional_buffer_factor
    else:
        chip_mem = largest_layer_mem + int(18 * total_params / total_chips)
        host_mem = largest_layer_params * 4 * num_chips_per_host * additional_buffer_factor
    return int(host_mem), int(chip_mem), int(largest_layer_mem)


def _fmt(n: float) -> str:
    return f"{n / GB:7.2f}GB"


def _resolve_tree(model_or_params):
    """A parameter tree: a Module's ``init`` drawn on the host CPU, or the
    tree given (only the leaves' shapes are read)."""
    init = getattr(model_or_params, "init", None)
    if callable(init):
        return init(0, device="cpu")
    return model_or_params


def estimate_zero2_model_states_mem_needs_all_live(model_or_params, num_chips_per_host: int = 4,
                                                   num_hosts: int = 1,
                                                   additional_buffer_factor: float = 1.5) -> None:
    """The ZeRO-1/2 option table for a model or parameter tree."""
    estimate_zero2_model_states_mem_needs_all_cold(
        _params_of(_resolve_tree(model_or_params)), num_chips_per_host=num_chips_per_host,
        num_hosts=num_hosts, additional_buffer_factor=additional_buffer_factor)


def estimate_zero2_model_states_mem_needs_all_cold(total_params: int,
                                                   num_chips_per_host: int = 4,
                                                   num_hosts: int = 1,
                                                   additional_buffer_factor: float = 1.5) -> None:
    """The ZeRO-1/2 option table for a model of ``total_params``."""
    print(f"Estimated memory needed for params, optim states and gradients for a:\n"
          f"- hardware setup => {num_chips_per_host} chips per host, {num_hosts} hosts\n"
          f"- model => {total_params / 1e6:.0f}M params")
    print("  per chip |  per host | options")
    for offload in (True, False):
        host, chip = estimate_zero2_model_states_mem_needs(
            total_params, num_chips_per_host, num_hosts, cpu_offload=offload,
            additional_buffer_factor=additional_buffer_factor)
        print(f"{_fmt(chip)} | {_fmt(host)} | offload_optimizer={offload}")


def estimate_zero3_model_states_mem_needs_all_live(model_or_params, num_chips_per_host: int = 4,
                                                   num_hosts: int = 1,
                                                   additional_buffer_factor: float = 1.5) -> None:
    """The ZeRO-3 option table for a model or parameter tree."""
    tree = _resolve_tree(model_or_params)
    estimate_zero3_model_states_mem_needs_all_cold(
        _params_of(tree), _largest_layer_of(tree), num_chips_per_host=num_chips_per_host,
        num_hosts=num_hosts, additional_buffer_factor=additional_buffer_factor)


def estimate_zero3_model_states_mem_needs_all_cold(total_params: int, largest_layer_params: int,
                                                   num_chips_per_host: int = 4,
                                                   num_hosts: int = 1,
                                                   additional_buffer_factor: float = 1.5) -> None:
    """The ZeRO-3 option table for a model of ``total_params``."""
    print(f"Estimated memory needed for params, optim states and gradients for a:\n"
          f"- hardware setup => {num_chips_per_host} chips per host, {num_hosts} hosts\n"
          f"- model => {total_params / 1e6:.0f}M params, largest layer "
          f"{largest_layer_params / 1e6:.0f}M params")
    print("  per chip |  per host | options")
    for offload, offload_p in ((True, True), (True, False), (False, False)):
        host, chip, _ = estimate_zero3_model_states_mem_needs(
            total_params, largest_layer_params, num_chips_per_host, num_hosts,
            cpu_offload=offload, cpu_offload_params=offload_p,
            additional_buffer_factor=additional_buffer_factor)
        print(f"{_fmt(chip)} | {_fmt(host)} | offload_optimizer={offload}, "
              f"offload_param={offload_p}")


def compiled_memory_analysis(engine, batch):
    raise unported("compiled_memory_analysis (a compiled step's buffer sizes)", "A14")
