"""PowerTCP core on PyTorch: control laws, power computation, fluid-model
simulator, per-link impairments (the ported subset of ``repro.core``)."""
from .types import (Flows, FlowSchedule, PathObs, Record, SimConfig,
                    SimState, SlotState, Topology, GBPS, KB, MB, MTU, US,
                    batch_of_one, from_numpy, pad_hops, resolve_device,
                    scenario)
from .laws import (LAWS, LAW_BACKENDS, OBSERVE_STEPS, Law, LawConfig,
                   get_law, law_backends, norm_power_int, norm_power_theta,
                   observe_step, register_backend, register_law,
                   register_observe_step)
from .fluid import (FluidSim, LawTick, SlotSim, UnsupportedFeature,
                    audit_carry_dtypes,
                    build_incidence, default_law_config, init_slot_state,
                    init_state, make_slot_sim, pad_flows, pad_schedule,
                    simulate, simulate_batch, simulate_slots,
                    simulate_slots_batch, slot_step, stack_flow_schedules,
                    stack_flows, stack_law_configs, step)
from . import backends  # noqa: F401  (registers the fused kernel backends)
from .feedback import (FEEDBACK_LAWS, BackpressureState, FNCCState,
                       PCCState, PulserState)
from .impair import (ImpairmentParams, LinkProcess, fabric_impairments,
                     impair_vectors, link_bw_at, link_jitter_at, link_loss_at,
                     netem, no_impairment, schedule_impairment,
                     stack_impairments)
from .megakernel import MegaCarry, PendingFCT, make_tick, simulate_slots_mega
from .rdcn import (CircuitSchedule, ScheduleParams, circuit_bw_at,
                   circuit_up, circuit_utilization, make_retcp_law,
                   queuing_latency_percentile, stack_schedules, voq_topology)
from .network import (LeafSpine, make_flows_single, make_schedule,
                      schedule_as_flows, single_bottleneck)
from .fabric import (CompiledPaths, Fabric, FabricBuilder, FabricRoutes,
                     compile_routes, ecmp_hash, fat_tree, leaf_spine_fabric,
                     single_bottleneck_fabric)
from .workload import (WEBSEARCH_CDF, incast_burst, peak_concurrency,
                       poisson_websearch, poisson_websearch_schedule,
                       suggest_slots, websearch_mean, websearch_sample)

__all__ = [
    "Flows", "FlowSchedule", "PathObs", "Record", "SimConfig", "SimState",
    "SlotState", "Topology", "GBPS", "KB", "MB", "MTU", "US",
    "batch_of_one", "from_numpy", "pad_hops", "resolve_device", "scenario",
    "LAWS", "LAW_BACKENDS", "OBSERVE_STEPS", "Law", "LawConfig", "get_law",
    "law_backends", "norm_power_int", "norm_power_theta", "observe_step",
    "register_backend", "register_law", "register_observe_step",
    "FluidSim", "LawTick", "SlotSim", "UnsupportedFeature",
    "audit_carry_dtypes", "build_incidence",
    "default_law_config", "init_slot_state", "init_state",
    "make_slot_sim", "pad_flows", "pad_schedule", "simulate",
    "simulate_batch", "simulate_slots", "simulate_slots_batch", "slot_step",
    "stack_flow_schedules", "stack_flows", "stack_law_configs", "step",
    "FEEDBACK_LAWS", "BackpressureState", "FNCCState", "PCCState",
    "PulserState",
    "ImpairmentParams", "LinkProcess", "fabric_impairments",
    "impair_vectors", "link_bw_at", "link_jitter_at", "link_loss_at",
    "netem", "no_impairment", "schedule_impairment", "stack_impairments",
    "MegaCarry", "PendingFCT", "make_tick", "simulate_slots_mega",
    "CircuitSchedule", "ScheduleParams", "circuit_bw_at", "circuit_up",
    "circuit_utilization", "make_retcp_law", "queuing_latency_percentile",
    "stack_schedules", "voq_topology",
    "LeafSpine", "make_flows_single", "make_schedule", "schedule_as_flows",
    "single_bottleneck",
    "CompiledPaths", "Fabric", "FabricBuilder", "FabricRoutes",
    "compile_routes", "ecmp_hash", "fat_tree", "leaf_spine_fabric",
    "single_bottleneck_fabric",
    "WEBSEARCH_CDF", "incast_burst", "peak_concurrency", "poisson_websearch",
    "poisson_websearch_schedule", "suggest_slots", "websearch_mean",
    "websearch_sample",
]
