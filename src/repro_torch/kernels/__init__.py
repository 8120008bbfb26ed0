"""Hand-written CUDA kernels for the simulator's hot spots (Hopper,
``sm_90a``; sources in ``repro_torch/csrc``, built by ``_build.py``).

Kernels (each: a wrapper module + a plain PyTorch version in ``ref.py``;
``ops.py`` dispatches on the tensors' device):
  powertcp_step        K1, Algorithm 1 fused over flows
  theta_powertcp_step  K2, Algorithm 2 fused (RTT + RTT-gradient only)
  queue_arrivals       K3, dense fluid-queue update, plus the in-order
                       sparse helpers of the reference backend
                       (build_csr_gather / csr_gather_arrivals /
                       ordered_scatter_add)

The simulator selects them through the law-backend registry
(``core.backends`` registers ``"fused"``).
"""
from . import ops, ref
from ._build import LAUNCHES, build, reset_launches
from .powertcp_step import powertcp_step, theta_powertcp_step
from .queue_arrivals import (build_csr_gather, csr_gather_arrivals,
                             ordered_scatter_add, queue_arrivals,
                             update_incidence)

__all__ = ["ops", "ref", "LAUNCHES", "build", "reset_launches",
           "powertcp_step", "theta_powertcp_step", "build_csr_gather",
           "csr_gather_arrivals", "ordered_scatter_add", "queue_arrivals",
           "update_incidence"]
