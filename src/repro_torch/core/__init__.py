"""PowerTCP core on PyTorch: control laws, power computation, fluid-model
simulator (the main-path subset of ``repro.core``)."""
from .types import (Flows, FlowSchedule, PathObs, Record, SimConfig,
                    SimState, SlotState, Topology, GBPS, KB, MB, MTU, US,
                    from_numpy, pad_hops, resolve_device)
from .laws import (LAWS, LAW_BACKENDS, Law, LawConfig, get_law,
                   law_backends, norm_power_int, norm_power_theta,
                   register_backend, register_law)
from .fluid import (FluidSim, SlotSim, audit_carry_dtypes, build_incidence,
                    default_law_config, init_slot_state, init_state,
                    simulate, simulate_slots, slot_step, step)
from . import backends  # noqa: F401  (registers the fused kernel backends)
from .network import (LeafSpine, make_flows_single, make_schedule,
                      schedule_as_flows, single_bottleneck)
from .fabric import (CompiledPaths, Fabric, FabricBuilder, FabricRoutes,
                     compile_routes, ecmp_hash, leaf_spine_fabric,
                     single_bottleneck_fabric)
from .workload import (WEBSEARCH_CDF, peak_concurrency, poisson_websearch,
                       poisson_websearch_schedule, suggest_slots,
                       websearch_mean, websearch_sample)

__all__ = [
    "Flows", "FlowSchedule", "PathObs", "Record", "SimConfig", "SimState",
    "SlotState", "Topology", "GBPS", "KB", "MB", "MTU", "US", "from_numpy",
    "pad_hops", "resolve_device",
    "LAWS", "LAW_BACKENDS", "Law", "LawConfig", "get_law", "law_backends",
    "norm_power_int", "norm_power_theta", "register_backend",
    "register_law",
    "FluidSim", "SlotSim", "audit_carry_dtypes", "build_incidence",
    "default_law_config", "init_slot_state", "init_state", "simulate",
    "simulate_slots", "slot_step", "step",
    "LeafSpine", "make_flows_single", "make_schedule", "schedule_as_flows",
    "single_bottleneck",
    "CompiledPaths", "Fabric", "FabricBuilder", "FabricRoutes",
    "compile_routes", "ecmp_hash", "leaf_spine_fabric",
    "single_bottleneck_fabric",
    "WEBSEARCH_CDF", "peak_concurrency", "poisson_websearch",
    "poisson_websearch_schedule", "suggest_slots", "websearch_mean",
    "websearch_sample",
]
