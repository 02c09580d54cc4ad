"""Numeric step kernels (reference layer 2 equivalents, GPU kernels through Pallas/Triton)."""

from online_convex_optimization.ops.hinge import (
    normalized_hinge,
    hinge_subgradient,
)
from online_convex_optimization.ops.actions import (
    ftl_action,
    ftrl_action,
    project_l2_ball,
    project_l1_ball,
    project_linf_ball,
)
from online_convex_optimization.ops.pallas_game import (
    eta_sweep_packed,
    kernel_envelope,
    pack_per_seq,
    pack_sequences,
    pack_time_major,
    play_packed_stream,
    play_packed_stream_many,
    regrets_fused,
    simulate_linear_auto,
    stream_result,
    unpack_result,
    use_kernels,
    zero_stream_carry,
)
from online_convex_optimization.ops.pallas_smart import (
    simulate_smart_pallas,
    smart_regrets_packed,
    smart_sweep_packed,
)

__all__ = [
    "normalized_hinge",
    "hinge_subgradient",
    "ftl_action",
    "ftrl_action",
    "project_l2_ball",
    "project_l1_ball",
    "project_linf_ball",
    "eta_sweep_packed",
    "pack_per_seq",
    "kernel_envelope",
    "pack_sequences",
    "regrets_fused",
    "simulate_linear_auto",
    "use_kernels",
    "unpack_result",
    "simulate_smart_pallas",
    "smart_regrets_packed",
    "smart_sweep_packed",
    "pack_time_major",
    "play_packed_stream",
    "play_packed_stream_many",
    "stream_result",
    "zero_stream_carry",
]
