"""PowerTCP core on PyTorch: control laws, power computation, fluid-model
simulator, per-link impairments, chunk-streamed runs with checkpoints,
guards and injected faults, sweeps, the sharded single-scenario engine,
the traffic generators with the HOMA allocator, and the ODE analysis
(the ported subset of ``repro.core``)."""
from .types import (CheckpointSpec, Flows, FlowSchedule, PathObs, Record,
                    SimConfig,
                    SimState, SlotState, Topology, GBPS, KB, MB, MTU, US,
                    batch_of_one, from_numpy, pad_hops, resolve_device,
                    scenario)
from .laws import (LAWS, LAW_BACKENDS, OBSERVE_STEPS, Law, LawConfig,
                   get_law, law_backends, norm_power_int, norm_power_theta,
                   observe_step, register_backend, register_law,
                   register_observe_step)
from .faults import (FaultSpec, InjectedCrash, TransientFault,
                     UnsupportedFeature, crash_at_chunk, crash_at_tick,
                     is_transient, poison_law)
from .guard import (DivergenceError, check_divergence, finite_flags,
                    first_divergent_field)
from .fluid import (FluidSim, LawTick, SlotSim, audit_carry_dtypes,
                    build_incidence, default_law_config, init_slot_state,
                    init_state, make_slot_sim, pad_flows, pad_schedule,
                    resolve_devices, resume_slots, simulate,
                    simulate_batch, simulate_slots,
                    simulate_slots_batch, slot_step, stack_flow_schedules,
                    stack_flows, stack_law_configs, step)
from .ckpt import (checkpoint_ticks, latest_checkpoint, load_checkpoint,
                   read_meta, save_checkpoint)
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
from .workload import (WEBSEARCH_CDF, all_to_all_flows, homa_alloc_fn,
                       incast_burst, incast_flows, peak_concurrency,
                       permutation_traffic, poisson_websearch,
                       poisson_websearch_schedule, suggest_slots,
                       synthetic_incast_workload, websearch_mean,
                       websearch_sample)
from .shardcomm import ShardGroup
from .shardslots import (ShardInfo, comm_census, shard_geometry,
                         simulate_slots_sharded)
from .sweep import (FALLBACK_CHAIN, PointFailure, SweepPoint, SweepResult,
                    SweepSpec, expand, run_sweep)
from . import analysis

__all__ = [
    "CheckpointSpec", "Flows", "FlowSchedule", "PathObs", "Record", "SimConfig", "SimState",
    "SlotState", "Topology", "GBPS", "KB", "MB", "MTU", "US",
    "batch_of_one", "from_numpy", "pad_hops", "resolve_device", "scenario",
    "LAWS", "LAW_BACKENDS", "OBSERVE_STEPS", "Law", "LawConfig", "get_law",
    "law_backends", "norm_power_int", "norm_power_theta", "observe_step",
    "register_backend", "register_law", "register_observe_step",
    "FaultSpec", "InjectedCrash", "TransientFault", "UnsupportedFeature",
    "crash_at_chunk", "crash_at_tick", "is_transient", "poison_law",
    "DivergenceError", "check_divergence", "finite_flags",
    "first_divergent_field",
    "FluidSim", "LawTick", "SlotSim", "audit_carry_dtypes",
    "build_incidence", "resolve_devices", "resume_slots",
    "checkpoint_ticks", "latest_checkpoint", "load_checkpoint", "read_meta",
    "save_checkpoint",
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
    "WEBSEARCH_CDF", "all_to_all_flows", "homa_alloc_fn", "incast_burst",
    "incast_flows", "peak_concurrency", "permutation_traffic",
    "poisson_websearch", "poisson_websearch_schedule", "suggest_slots",
    "synthetic_incast_workload", "websearch_mean", "websearch_sample",
    "ShardGroup", "ShardInfo", "comm_census", "shard_geometry",
    "simulate_slots_sharded",
    "FALLBACK_CHAIN", "PointFailure", "SweepPoint", "SweepResult",
    "SweepSpec", "expand", "run_sweep", "analysis",
]
