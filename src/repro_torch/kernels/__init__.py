"""Hand-written CUDA kernels for the simulator's hot spots (Hopper,
``sm_90a``; sources in ``repro_torch/csrc``, built by ``_build.py``).

Kernels (each: a wrapper module + a plain PyTorch version in ``ref.py``;
``ops.py`` dispatches on the tensors' device):
  powertcp_step        K1, Algorithm 1 fused over flows
  theta_powertcp_step  K2, Algorithm 2 fused (RTT + RTT-gradient only)
  powertcp_observe_step, theta_powertcp_observe_step
                       K1/K2 in the engines' form: each reads its
                       telemetry from the rings and returns the finished
                       window (plain versions in ``core/backends.py``)
  queue_arrivals       K3, dense fluid-queue update, plus the in-order
                       sparse helpers of the reference backend
                       (build_csr_gather / csr_gather_arrivals /
                       apply_loss /
                       ordered_scatter_add / integrate_arrivals /
                       queue_arrivals_sparse)
  fused_tick_block     K4, K whole ticks of the megakernel slot engine
                       in one launch (``core/megakernel.py``)
  flash_attention      K5, blockwise online-softmax attention (causal,
                       sliding window, GQA) for the LM stack
  rmsnorm              K6, RMSNorm with float32 statistics

The simulator selects K1-K4 through the law-backend registry
(``core.backends`` registers ``"fused"``, and K1/K2's observe form as the
fused laws' observe-and-update routine) and the megakernel; the LM
stack (``repro_torch.models``) calls K5 and K6 through ``ops``.
"""
from . import ops, ref
from ._build import LAUNCHES, build, reset_launches
from .flash_attention import flash_attention
from .fused_tick import DEFAULT_BLOCK, fused_tick_block
from .powertcp_step import (powertcp_observe_step, powertcp_step,
                            theta_powertcp_observe_step, theta_powertcp_step)
from .queue_arrivals import (apply_loss, build_csr_gather,
                             build_csr_gather_padded, csr_gather_arrivals,
                             integrate_arrivals, ordered_scatter_add,
                             queue_arrivals, queue_arrivals_sparse,
                             update_incidence)
from .rmsnorm import rmsnorm

__all__ = ["ops", "ref", "LAUNCHES", "build", "reset_launches",
           "powertcp_step", "theta_powertcp_step", "powertcp_observe_step",
           "theta_powertcp_observe_step", "apply_loss", "build_csr_gather",
           "build_csr_gather_padded",
           "csr_gather_arrivals", "ordered_scatter_add", "queue_arrivals",
           "update_incidence", "integrate_arrivals", "queue_arrivals_sparse",
           "DEFAULT_BLOCK", "fused_tick_block", "flash_attention",
           "rmsnorm"]
