#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout, on a machine with a CUDA GPU and the
CUDA toolkit (``nvcc``). Phases, each of which fails the script (non-zero
exit, traceback) if anything in it is wrong:

1. probe: the card's name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (K1/K2, K3, K4,
   K5, K6), one nvcc per source, all at once;
3. kernels: K1 ``powertcp_step`` and K2 ``theta_powertcp_step`` against
   their plain PyTorch versions bit for bit, K3 ``queue_arrivals`` at
   rtol 1e-5 / atol 1e-3 bytes, at the main path's shapes, ragged ones
   and the edges of K3's row chunks and column tiles; K3 also bit for
   bit against its own sum order spelled in torch and against itself
   run twice (its elected combine); each also at the batched engines'
   shapes (B = 2 scenarios of S = 128 slots and of F = 2 436 padded
   flows, and a ragged B = 3), one launch for the batch, each scenario
   bit for bit a launch of its own; then each timed (CUDA graph replays
   of many launches, median of rounds) beside its plain version (K3's,
   which reads its columns' depths back to the host, eagerly between
   CUDA events) and, for
   K3, ``torch.einsum`` (the library yardstick, used nowhere in the
   port), K1 and K3 also at the batched shapes. Then K1/K2 in the
   engines' form, ``powertcp_observe_step`` and
   ``theta_powertcp_observe_step`` (each reads its telemetry from the
   rings and returns the finished window, in place of the ~50 eager ops
   around the law): each law's observe-and-update routine on CUDA
   tensors against its plain version (``core/backends.py``) bit for bit
   in every output, at S = 384, P = 2 406, B = 2 x 128 and ragged shapes,
   fixed-period and RTT-paced; timed at S, P and B beside the plain
   version and the launch floor (an empty kernel through the same
   interface, timed the same way), with a bound counted from the data
   (``observe_cost``);
4. K4 ``fused_tick_block`` (the megakernel, 64 ticks per launch; PowerTCP
   and theta-PowerTCP here, every law in phase 6c) against
   its plain version from the same initial carry, every carry leaf and
   record field bit for bit (K4 adds the records' per-tick sums in
   XLA:CPU's order, as the plain tick does): the 12-flow anchor
   of ``tests/test_megakernel.py`` with K in {1, 7, 64} and S = 1 (their
   first ``K4_ANCHOR_TICKS``, 2 000 of 4 000 ticks), the
   gather table at its suggested width, and the anchor (PowerTCP) and
   the first 1 000 ticks of the paper scenario (both laws) with the
   table narrowed until it overflows (phase 6c holds every law at paper
   scale at the suggested width, with slots recycled at its middle
   launch; the plain tick then walks the hop list; K4's contributor
   lists are never truncated, and it writes the table and its flag as
   the plain tick does); K4's grid form (one block per scenario) on the
   first 1 000 ticks of phase 6b's two seeds, both laws, ``gate`` True
   and False, against each scenario's plain block; then timed over the
   whole 40 000-tick paper
   run, every launch (CUDA events between back-to-back launches), with a
   bound counted from each launch's data, the plain block run from the
   same carry at five launches of that run, timed and held bit for bit,
   and a pass of one tick per launch that counts the admit ticks;
5. goldens: the ``powertcp`` and ``theta_powertcp`` legs of
   ``tests/golden/golden_laws.json`` through the port's ``simulate`` on
   the card, both backends, at ``tests/test_golden_traces.py``'s
   tolerances;
6. main path: PowerTCP on the 256-host paper fabric (seed 1, 60% load,
   30 ms of web-search arrivals + 10 ms drain, 40 000 ticks of 1 us):
   (a) ``simulate_slots`` fused, 384 slots; (b) ``simulate_slots``
   reference; (c) ``simulate`` (padded) fused; (d) theta-PowerTCP,
   ``simulate_slots`` fused; (e) ``simulate_slots`` megakernel; (f)
   theta-PowerTCP, ``simulate_slots`` megakernel (each a batch of one
   through the batched engines of phase 6b). The eager runs (a)-(d) are
   cut to their first ``EAGER_TICKS`` (2 000) ticks, the widths
   unchanged, so that the script stays inside its time limit (phase 6b
   cuts its eager runs alike); (e) and (f) run the whole 40 000. Each run starts with the kernel launch counts at
   zero; the fused runs must launch their law's observe kernel and K3
   once per tick (K1/K2's TPU form never),
   the megakernel runs K4 once per 64 ticks (625 times) and nothing
   else, the reference run none. Each is held to the JAX reference's
   per-flow FCTs of the whole run
   (``tests/golden/torch_port_paper_seed1.json``): the same completion
   set (for a cut run, the flows the reference completes before the
   cut, each flow's completion tick recovered from its FCT; the fused
   runs, whose FCTs differ from the reference's in the last bits, leave
   out the flows that complete within 8 ticks of the cut), and a
   short-flow (< 10 kB) p99.9 FCT within 1e-3 over the flows both
   complete.
6b. smoke_slots: ``benchmarks/run.py::smoke_slots`` on the port's batched
   entry points: seeds 1 and 2 of the same scenario as one batch, (1)
   ``simulate_batch`` reference (padded) over the first ``EAGER_TICKS``
   ticks (cut for time, as (3) and (6) are), every FCT of the flows done
   by then bit for bit ``repro``'s; (2) the slot pool sized as
   ``smoke_slots`` sizes it from the padded run's whole-run FCTs
   (``repro``'s, which (1) matches as far as it runs) through the port's
   ``peak_concurrency``, equal to ``repro``'s; (3)
   ``simulate_slots_batch`` reference over the first ``EAGER_TICKS``
   ticks, held to ``repro``'s FCTs on the flows it completes by then and
   bit for bit to (4) there; (4) megakernel, ``sequential=True`` (K4 one block per
   launch, 1 250 launches); (5) megakernel, ``sequential=False`` (K4 a
   grid of two blocks, 625 launches), bit for bit (4) in every FCT, and
   again with ``gate=False``, bit for bit (5); (6) ``simulate_slots_batch``
   fused (one K1 observe-kernel and one K3 launch per tick for both
   seeds) over the first ``EAGER_TICKS`` ticks, held to the flows
   ``repro`` completes by then (the flows within 8 ticks of the cut left
   out, as phase 6's fused runs); (7) the
   single-bottleneck bit-match anchors ``fct_slot_exact_bitmatch`` and
   ``fct_mega_exact_bitmatch``. Launch counts zeroed before and checked
   after each run. ``smoke_ok``'s slot and megakernel gates over the
   eager runs' cut (completed sets match, p99.9 rel err < 1e-3 slot vs
   padded and mega vs slot; both
   anchors), and every run held to ``repro``'s FCTs for both seeds
   (``tests/golden/torch_port_smoke_slots.json``: the same completion
   set, short-flow p99.9 within 1e-3). Prints ``smoke_slots``'s
   ``fct_slot_*``/``fct_mega_*`` fields with the card's wall seconds and
   name and power limit, and K4's grid launches timed and bounded;
6c. fig6: ``benchmarks/fig6_fct.py::run_paper_scale`` on the port, full
   width and depth: the 256-host fabric, web-search at 60% load, 90 ms of
   arrivals + 40 ms drain (130 000 ticks of 1 us, seed 1, 7 126 flows),
   the pool from ``suggest_slots`` (448 slots). First DCQCN's ``powf`` in
   K4's build against ``torch.pow`` over DCQCN's inputs (the same bits,
   or the phase fails); then each of K4's 13 laws (``powertcp``,
   ``theta_powertcp``, ``hpcc``, ``swift``, ``gradient_mimd``, ``timely``,
   ``dcqcn``, ``reno``, ``retcp`` with Fig. 8's slot-0 circuit
   schedule and a 600 us prebuffer over the fabric's static rates, and
   the feedback-channel laws ``fncc``, ``pulser``, ``backpressure`` and
   ``pcc``) held
   bit for bit to the plain megakernel tick
   over the first 2 launches and to the eager reference slot engine
   (``simulate_slots_batch``, ``backend="reference"``) over the first
   ``FIG6_EAGER_TICKS`` (250) ticks (the final carry and the FCTs),
   and timed over the whole
   run (every launch, CUDA events; the bound of every 4th launch counted
   from its data; the plain block at the middle launch, host clock, held
   bit for bit). Then the five laws of ``run_paper_scale``
   (``powertcp``, ``theta_powertcp``, ``hpcc``, ``timely``, ``dcqcn``)
   through ``simulate_slots_batch(..., backend="megakernel")``, the
   launch counts zeroed before and checked after each (2 032 K4 launches
   and nothing else), each held to ``repro``'s FCTs
   (``tests/golden/torch_port_fig6_paper.json``: the same completion set,
   short-flow p99.9 within 1e-3); prints the short, medium and long p99.9
   and ``claims_hold`` (the four orderings of ``run_paper_scale``), which
   must equal ``repro``'s; then the four feedback-channel laws through the
   same entry point (2 032 K4 launches each), each held to ``repro``'s
   FCTs of the same run (``tests/golden/torch_port_feedback.json``'s
   ``paper``: the same completion set, short-flow p99.9 within 1e-3);
6d. fig8: ``benchmarks/fig8_rdcn.py::run(quick=False)`` on the port, the
   RDCN case study (claim C5) at full size: 8 flows at 25G into one VOQ
   whose rate follows an optical-circuit schedule (100G for 225 us of
   each 5 880 us week, 25G otherwise), 4 weeks (23 520 ticks of 1 us),
   the schedules of slots 0 and 6; each law group of ``rdcn_specs``
   (``powertcp``, ``theta_powertcp``, ``hpcc`` over both schedules,
   ``retcp`` over prebuffers 1 800 and 600 us x both schedules) one
   ``simulate_slots_batch(backend="megakernel", bw_fn=circuit_bw_at,
   bw_params=stack_schedules(...))`` of 8 slots (368 K4 launches, nothing
   else; K4 evaluates each scenario's schedule in its body every tick).
   (i) K4's schedule evaluation against ``circuit_bw_at`` and reTCP's
   ``circuit_up`` on the card over every tick, both schedules and
   prebuffers: bit for bit; (ii) per point the circuit utilization, p99
   queuing latency and mean queue within rtol 1e-5 of ``repro``'s
   (``tests/golden/torch_port_fig8.json``) and ``claims_hold`` equal to
   its; one ``{"fig8": {...}}`` line with ``fig8_rdcn``'s row names;
   (iii) each group's K4, ``gate`` True and False, bit for bit the plain
   tick over 3 launches and the eager padded reference
   (``simulate_batch``, the same ``bw_params``) over the first 2 000
   ticks (both schedules' first edges); (iv) the fused backend (K1/K2's
   observe form and K3, a bandwidth row per scenario) for the PowerTCP
   laws over the first week, one observe and one K3 launch a tick, held
   to the reference's first-week utilization within 5e-3
   (``smoke_rdcn``'s gate) and p99 within rtol 1e-3; (v) K4 timed over
   each group's whole run (every launch, CUDA events; the bound of every
   4th launch from ``k4_cost``);
6e. feedback: ``benchmarks/feedback_fct.py::run(quick=False)`` on the port,
   the four feedback-channel laws against the receiver-echo baselines on
   the k = 4 fat-tree (16 hosts, 80 queues, 5-hop inter-pod ECMP paths):
   the web-search leg (``fabric_fct.anchor_scenario(load=0.25,
   duration=0.004)``: seed 3, 37 flows, 8 000 ticks, the pool from
   ``suggest_slots``) and the incast leg (``incast_scenario``: three
   bursts of fan-in 8 x 200 kB, 2 ms apart, 24 flows, 9 000 ticks, a slot
   per flow). (i) Each of ``fncc``, ``pulser``, ``backpressure`` and
   ``pcc`` with both legs as one batch (a slot per flow of the larger
   leg): K4 with ``gate`` True and False bit for bit the plain tick and
   the eager reference slot engine over the first 800 ticks (the
   carry, the pause and sender-count rings included); (ii) the seven laws
   of ``run`` (the four, ``powertcp``, ``hpcc``, ``timely``) over each
   leg's whole run through ``simulate_slots_batch(backend="megakernel",
   expected_flows=8.0)`` (125 and 141 K4 launches and nothing else), each
   with ``repro``'s completion set and every FCT within rtol 1e-5 of
   ``repro``'s (``tests/golden/torch_port_feedback.json``), and ``run``'s
   verdict (every run's mean FCT defined) equal to ``repro``'s; one
   ``{"feedback": {...}}`` line; (iii) each feedback law's K4 timed over
   each leg's whole run (every launch, CUDA events; the bound of every
   4th launch from ``k4_cost``; the plain block at the middle launch);
6f. impair: per-link impairments (``core/impair.py``; K4 evaluates each
   queued link's capacity, loss and jitter processes in its body every
   tick; phase 4 holds that evaluation alone, ``fused_tick.impair``, bit
   for bit against ``core/impair.py`` over 8 000 ticks of this phase's
   regimes and one of every kind). All on K4 through the public entry
   points: (1) the ``"impair"`` leg of ``tests/golden/golden_laws.json``
   for all 13 laws (the single bottleneck under its mixed regime, the
   slot engine with a slot per flow) at the golden tolerances, each
   unlike its clean leg; (2) ``benchmarks/impair_fct.py::smoke_impair``'s
   anchor (the k = 4 fat tree, web-search at load 0.25, seed 3, 4 ms + 4
   ms of drain: 8 000 ticks, 37 flows, a slot each) under
   ``anchor_impairments``' mixed regime (ToR -> host links oscillating
   down to 2.5 GB/s over 200 us, every other link ``netem(loss=0.01,
   jitter=1e-6)``) for ``powertcp``, ``hpcc`` and ``timely``: K4 bit for
   bit the plain tick over the first 800 ticks (gate True; powertcp
   also False), then the whole run with ``repro``'s completion set and
   every FCT within rtol 1e-5 (``tests/golden/torch_port_impair.json``);
   (3) the four regimes (mixed, oscillate, lossy, clean) stacked as one
   ``simulate_slots_batch(impair_params=...)`` of powertcp (one K4 launch
   of 4 blocks per 64 ticks), each scenario within rtol 1e-5 of
   ``repro``'s, the clean one bit for bit the unimpaired K4 run; (4) the
   impaired pass of ``fabric_fct._fabric16_anchor_bitmatch`` on the
   paper's 256-host leaf-spine (web-search at load 0.3 over 1.2 ms, seed
   11, 3 000 ticks, 56 slots for 52 flows, the mixed regime) for
   ``powertcp``, ``backpressure`` and ``pulser``, against ``repro``'s
   FCTs; (5) the eager padded and slot reference engines over the first
   800 ticks of (2), every record field and FCT bit for bit K4's; (6)
   K4 timed launch by launch over each run of (2)-(4) (CUDA events; the
   bound of every 4th launch from ``k4_cost``, the regime's read
   included), printed with the card's name and power limit;
6g. fault: chunk-streamed K4, checkpoint/resume and a K4 sweep
   (``benchmarks/fault_fct.py``, ``impair_fct.run``). K4 runs every
   segment of a chunk-streamed megakernel run, reading its admissions
   from the segment's window of the schedule (each run's K4 launches
   must be one per 64 ticks of every segment, and nothing else): (a)
   ``crash_resume_paper_scale`` at full size (the paper fabric, seed 1,
   load 0.6, 8 ms of arrivals: 643 flows in 256 slots over 16 000 ticks)
   with ``chunk=2048`` bit for bit the unchunked K4 run in every
   ``fault_fct._bitmatch`` field; snapshots every 6 000 ticks (keep 2),
   a crash injected at 9 000, ``resume_slots`` from 6 000 bit for bit
   the uninterrupted run with its record from tick 0; the completion set
   ``repro``'s and every FCT within rtol 1e-5 of
   ``tests/golden/torch_port_fault.json``; (b) ``chunk=256`` (C = S <
   N) bit for bit the unchunked run, and again with ``guard=True``; the
   three runs timed without records (wall, and K4's device time from
   ``torch.profiler``, per tick; segments and launches); (c) run (e)'s
   scenario with ``chunk=512``: FCTs and final carry bit for bit run
   (e)'s of phase 6; (d) K4 on a window (``win_off > 0``, C < N; the
   window of (b) from its first boundary, 2 000 ticks) for powertcp and
   fncc, gate True and False, bit for bit the plain block; (e)
   ``impair_fct.run(quick=False)``'s grid (powertcp, hpcc, timely x the
   four regimes) through ``run_sweep(backend="megakernel",
   fault_tolerant=True)``: no fallback, no failure, every point
   completes, and the points 6f ran bit for bit 6f's K4 FCTs; (f)
   ``guard_divergence`` on the reference backend: ``repro``'s law, tick
   and field, and NaN carried through unguarded;
6h. shard: the sharded slot engine (``core/shardslots.py``, each rank a
   slot block and a queue block, the ranks meeting in
   ``torch.distributed`` collectives; no kernel of its own), every run
   bit for bit K4's: (1) at world 1 over NCCL (a one-rank group from a
   ``HashStore``) on 6f's impaired pass of the paper leaf-spine (52
   flows, 56 slots), its first ``SHARD_PAPER_TICKS`` (500) of 3 000
   ticks: powertcp clean, and powertcp, backpressure and pulser under
   the mixed regime, each against K4's run of the same ticks (every
   trajectory leaf of the final state, every record field), the impaired
   ones' finished flows also against 6f's whole K4 runs' FCTs; (2) the
   full-width headline, ``fabric_fct.smoke_fabric16``'s scenario (the
   k = 16 fat tree, 1 024 hosts and 5 120 queues, web-search at load 0.6
   plus 64 rotating incasts over 85 ms: 109 186 flows; 1 024 slots,
   chunk 2 048, the degraded-spine regime) over its first
   ``SHARD16_TICKS`` (1 000) of 10 000 ticks at world 1, against K4's
   chunked run of the same ticks, with the wall per tick, the
   collectives per tick, ``comm_census``'s bytes, K4's device time and
   its bound from the shapes (``k4_cost`` with an empty pool), and
   the sharded tick's device time and busy share over its first
   ``SHARD16_PROFILE_TICKS`` (50) ticks (``torch.profiler``); (3) two
   gloo ranks
   on the one card (``shardcomm.spawn``; gloo's collectives staged
   through the host; spawned once, ``gloo_ranks``, they then run 6i.4's
   outer sync): (1)'s impaired powertcp pass over its first
   ``SHARD_SPAWN_TICKS`` (250) ticks, bit for bit K4 and (1)'s first
   250 ticks, and ``impair_fct.run``'s grid
   as a K4 sweep split over the two ranks (``run_sweep(devices=2)``),
   every point bit for bit 6g's unsharded sweep, with no fallback and no
   failure;
6i. incast: Fig. 4, HOMA, the other generators and the outer sync
   (``tests/golden/torch_port_fig4.json`` and
   ``torch_port_generators.json``, made by ``repro`` on the CPU): (1)
   ``fig4_incast.run``'s setup (the 64-host leaf-spine, ``incast_flows``
   at fan-in 10 and 63 of 500 kB with the long-lived flow, 8 000 ticks,
   ``update_period`` 2 us, ``hist`` 512, ``expected_flows`` 16), both
   incasts as one batch of a slot per flow on K4 (a grid of two blocks,
   125 launches and nothing else) for ``powertcp``, ``theta_powertcp``,
   ``hpcc``, ``timely`` and ``dcqcn``: K4 bit for bit the plain tick over
   the first 1 200 ticks (powertcp) or 3 launches (the others); every
   FCT, the victim queue's depth and throughput traces within rtol 1e-5
   of ``repro``'s padded ``simulate_batch``, ``_metrics``' four values
   (the drain time within a tick) and ``claims_hold`` equal to its; K4's
   device time (``torch.profiler``); (2) HOMA (``homa_alloc_fn`` over
   ``reno``, overcommit 1, as ``common.run_law`` runs it) on the padded
   reference engine: Fig. 4's 10:1 incast (padded to 64 flows), its first
   2 000 of 8 000 ticks, and Fig. 6's web-search leg (the 64-host
   leaf-spine, load 0.6, seed 1, 604 flows), its first 1 000 of 70 000
   ticks, each held to ``repro``'s FCTs and queue traces of the same
   ticks; the wall per tick, the tick's device time and busy share over
   its first ``HOMA_PROFILE_TICKS`` (50) ticks and the allocator's device
   time alone over as many calls (``torch.profiler``); (3) the paper-scale generators on K4 (powertcp,
   the pool from ``suggest_slots``): ``permutation_traffic`` at load 0.6
   over 12 ms and ``synthetic_incast_workload`` at 20 000 requests/s of
   1 MB over 12 ms on the 256-host fabric (seed 1, 25 000 ticks), and
   ``all_to_all_flows`` on the k = 4 fat tree (240 flows of 100 kB,
   starts over 100 us, 4 000 ticks): ``repro``'s completion set, every
   FCT within rtol 1e-5, the all-flow p99.9 within 1e-3, and the
   short-flow (under 10 kB) p99.9 within 1e-3 on the permutation leg (the
   other two legs have no flow under 10 kB: 62.5 kB responses, 100 kB);
   K4's wall and device time per tick; (4) ``commsched``'s outer sync of
   one qwen3-14b decoder layer at full width (330 311 936 float32
   parameters in 11 leaves, window 2) at world 1 over NCCL and over two
   gloo ranks on the one card (6h.3's, host-staged gathers): every leaf of the new anchor, error feedback and momentum
   bit for bit the one-process spelling
   (``test_torch_support.outer_sync_spelled``), at most 2 gathers in
   flight; wall seconds a sync and the bytes gathered;

7. LM kernels: K5 ``flash_attention`` and K6 ``rmsnorm`` against their
   plain PyTorch versions at every shape the serve runs of phase 8 and 8b
   give them, derived from each architecture's config (qwen3-14b and
   ``SERVE_ARCHS``; inputs drawn on the card from a seed): K5 at the
   prefill, q [4,H,512,D] over k/v [4,KV,512,D], and the decode, q
   [4,H,1,D] over the first 513 and 543 positions of a [4,544,KV,D]
   cache, read in place (H/KV/D 40/8/128, 16/16/256, 32/32/80, 128/8/128,
   32/4/128, 24/8/64); K6 at each RMSNorm's rows (``norm_rows``: the
   layer norms' [2048, d_model] and [4, d_model], the qk-norms' q and k
   rows of head_dim, for prefill and decode; d_model 5 120, 3 072,
   16 384, 2 048, 1 536; none for stablelm's layernorm), the scale in the
   config's parameter dtype; K5 at 2e-2 and bit for bit against a second
   run, K6 within one bfloat16 ulp, float32 within rtol 1e-5, both bit
   for bit its order spelled in torch and a second run; K5 also at the
   edges of its query tiles, key tiles and decode splits
   (``test_torch_support.FLASH_EDGE_SHAPES``: T and S of 63-129, a window
   across a tile, decode at S = 1, below one split and with a partial
   one, T = 2..4 over a GQA group of 5, D = 16 and 256), and at 8c's
   local attention (recurrentgemma-2b, 10 heads over 1, D = 256): the
   prefill q [2,10,4096,256] over k/v [2,1,4096,256] with its window of
   2 048 (T past the window, so whole key tiles are skipped) and the ring
   decode q [2,10,1,256] over the 2 048 slots of its ring read in place;
   K6 also at 8c's rows ([8192, 2560] and [2, 2560], [4000, 768] and
   [4, 768]); K5 at 8d's shapes (``encdec_flash_shapes``): phi3-vision's
   causal prefill q [4,32,1024,96] and last decode step q [4,32,1,96]
   over 1 039 positions, whisper's unmasked encoder q = k/v
   [4,20,1500,64], cross prefill q [4,20,256,64] and cross decode q
   [4,20,1,64] over its 1 500 frames (the decode's read in place from a
   [4,1500,20,64] cache), each bit for bit a second run; K6 at
   phi3-vision's rows ([4096, 3072], [4, 3072]); then each timed
   beside its plain version and one PyTorch call for the same function
   (``F.scaled_dot_product_attention`` with ``enable_gqa``,
   ``F.rms_norm``; the library yardstick, used nowhere in the port;
   ``F.rms_norm`` takes the scale in bf16, as its fused path needs, and
   is also timed with the same float32 scale K6 reads): K5 at qwen3-14b's
   prefill and last decode shapes, and at every other architecture's
   under ``arch_shapes`` (fewer replays), 8c's two local shapes under
   ``window_shapes`` (SDPA with the same mask as a boolean
   ``attn_mask``; the bound counts only the pairs inside the window), 8d's
   under ``encdec_shapes`` (the bound counts all T·S pairs where
   unmasked), K6 at qwen3-14b's rows;
8. serve: qwen3-14b at full width (40 layers, d_model 5120, float32
   params drawn on the card from a ``torch.Generator`` seeded 0) through
   ``repro_torch.serve.decode_loop``: 4 prompts of 512 tokens from a seed,
   32 greedy tokens each (one prefill and 31 decode steps), cache of 544
   positions. The launch counts are zeroed just before and read just
   after: K5 once per layer per forward (1 280), K6 four times per layer
   plus the final norm per forward (5 152), no other kernel. Every
   logit finite, every token below the vocabulary. Prints the prefill
   time, ms per decode step, tokens/s and the peak device memory. The
   memory is freed before and after, so that the ~60 GB of params never
   meet another phase's tensors. (8b) The same for each of the other
   architectures (``SERVE_ARCHS``), at full width with random weights
   drawn on the card: gemma-7b (28 layers, float32, GeGLU, tied and
   scaled embeddings, head dim 256), stablelm-3b (32 layers, float32,
   layernorm, head dim 80), llama3-405b (bfloat16 as its config says,
   cut to 4 of 126 layers), qwen3-moe-30b-a3b (float32, 128 experts
   top-8, cut to 8 of 48) and granite-moe-3b-a800m (32 layers, float32,
   40 experts top-8, tied, its vocab padded 49 155 -> 49 408), one after
   another, each freed before the next, the serve run's prompts and
   ``SERVE_ARCH_STEPS`` (16) greedy tokens: every logit finite, every token
   below the true vocabulary, the launches zeroed before and read after,
   K5 once a layer a forward and K6 as ``serve_expected_launches``
   derives (none for stablelm's layernorm, two more a layer for the
   qk-norm); the prefill s, ms a decode step, tokens/s and peak GB, the
   card's name and power limit beside them. (8c) The same for the
   recurrent and state-space architectures (``RECURRENT_SERVE``), all
   their layers, float32, 16 greedy tokens: recurrentgemma-2b (26
   layers, 18 RG-LRU and 8 local, 2.67 B params; 2 prompts of 4 096,
   past its window of 2 048, so the ring wraps in the prefill; K5 once a
   local layer a forward, K6 twice a layer plus ``ln_f``) and mamba2-130m
   (24 ``"ssm"`` layers; 4 prompts of 1 000 over four SSD chunks, the last
   padded; no K5, K6 once a layer (ln1) plus ``ln_f``, its gated norm
   plain torch). (8d) The same for the encoder-decoder and
   vision-language architectures (``ENCDEC_SERVE``), all their layers,
   float32, 16 greedy tokens, their frontends' embeddings drawn on the
   card from a seed (``frontend_extras``) and handed to ``decode_loop``
   as ``extras``: whisper-large-v3 (32 encoder + 32 decoder layers, 1.58 B
   params; 4 prompts of 256 over ``enc_feats`` [4, 1500, 1280]; K5 once a
   layer in the encoder, once in the prefill, and twice a decoder layer a
   forward (self and cross), no K6: layernorm) and phi3-vision-4.2b (32
   layers, 3.82 B params; 4 prompts of 1 024 whose first 576 positions
   take ``img_embeds`` [4, 576, 3072]; K5 once a layer a forward, K6
   twice a layer plus ``ln_f``).
9. train: the one-card trainer (``repro_torch.train``). (9a) K5's and
   K6's backward kernels (``flash_attention_bwd``: dq, then dk/dv;
   ``rmsnorm_bwd``: row chunks, then their dscale partials in chunk
   order) against their plain versions at the training shapes of
   ``BWD_ARCHS`` (``train_kernel_shapes``, from each config and
   ``train_preset``'s microbatch: K5 bwd q [1,H,1024,D] over k/v
   [1,KV,1024,D], causal, bf16, o and the LSE from K5's forward, for
   qwen3-14b (40/8/128), gemma-7b (16/16/256), qwen3-moe (32/4/128) and
   stablelm-3b's head dim 80 (32/32/80); K6 bwd at each RMSNorm's rows,
   [1024, d_model] and the qk-norms' [1024·H, 128] and [1024·KV, 128],
   bf16 and float32) and at ``FLASH_BWD_EDGE`` (a float32 case and the
   REDUCED models' head dim 16), within 2e-2 (bf16) / 2e-5 (float32) of
   the largest gradient and bit for bit against a second launch; K5 bwd
   with a sliding window at 9e's recurrentgemma-2b microbatch
   (``window_bwd_shape``: q [1,10,4096,256] over k/v [1,1,4096,256],
   window 2 048) and at ``test_torch_support.FLASH_BWD_WINDOW_SHAPES``
   (T = S of 63-129, windows of 1, 17 and T - 1, D = 16 and 256, two in
   float32), held the same way (``sup.bwd_errs``: a gradient that a
   window of one makes zero is held to the scale of the others); each
   timed (CUDA-graph replays) beside its plain version and autograd of
   the PyTorch call (``F.scaled_dot_product_attention(is_causal=True,
   enable_gqa=True)``, ``F.rms_norm``: the backward alone, its kernels'
   device time from ``torch.profiler``), with its bound: K5 bwd at each
   architecture's shape (qwen3-14b's the row, the others under
   ``arch_shapes``, recurrentgemma's windowed one under ``window_*``,
   beside SDPA's backward with the same mask, timed between CUDA
   events), K6 bwd at qwen3-14b's. K5 bwd also at 9f's shapes
   (``encdec_bwd_shapes``, under ``encdec_shapes``: phi3-vision's q
   [1,32,1024,96] causal, whisper's encoder [1,20,1500,64] and its
   cross-attention q [1,20,448,64] over [1,20,1500,64] unmasked) and at
   head dim 96's edges (``test_torch_support.FLASH_BWD_D96_SHAPES``: T
   and S of 63-129, causal and unmasked, T < S and T > S, GQA, two in
   float32), held and timed the same way. (9b) qwen3-14b at full width (d_model 5 120, 40 / 8 heads,
   head_dim 128, d_ff 17 408, vocab 151 936), depth cut to
   ``TRAIN_LAYERS`` (4) of 40 layers, float32 params drawn on the card
   from ``tcfg.seed``, ``train_preset("qwen3_14b")`` (8 microbatches,
   remat ``"full"``) over ``DataConfig(batch=8, seq=1024)``, 5 steps
   through ``train_driver``: every loss finite, the parameters moved,
   each step's launches exactly those ``train_expected_launches``
   derives (K5 and K6 twice a block per microbatch, their backward
   kernels once, ``ln_f`` once), peak memory under ``TRAIN_PEAK_GB``;
   prints the wall per step, tokens/s, model TFLOP/s and peak GB. (9c)
   the REDUCED qwen3-14b (bf16 compute) under
   ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
   set before the first cuBLAS call): a run that crashes after step 3,
   resumed from its checkpoint, bit for bit the uninterrupted run in
   its losses and every parameter; then float32 compute from
   ``numpy_params`` for 10 steps, the losses within
   ``sup.TRAIN_LOSS_BAR`` of ``tests/golden/torch_port_train.json``
   (``repro`` on the CPU). The REDUCED qwen3-moe's, recurrentgemma's and
   whisper's crash/resume too, bit for bit in their losses, parameters
   and moments: the MoE combine, the token gather's backward, K5's
   windowed and unmasked backward, the encoder's gradients and the RG-LRU
   scan add in a fixed order. Each crash/resume runs ``RESUME_STEPS`` (6)
   steps, checkpoints every 2, the crash after step 3. (9d) gemma-7b and
   qwen3-moe-30b-a3b at full width, each cut to ``TRAIN_ARCH_LAYERS`` (2)
   layers, float32, ``train_preset`` over the same data, 3 steps through
   ``train_driver``, held as 9b is (losses finite, parameters moved,
   launches as derived, peak under ``TRAIN_PEAK_GB``): K5 bwd at D = 256,
   GeGLU and the tied, scaled embedding's gradient; the MoE's backward.
   (9e) recurrentgemma-2b at full width cut to one pattern group (13 of
   26 layers, 1.66 B params) on sequences of 4 096 (K5's windowed
   backward at the model's shapes), and mamba2-130m cut to 6 of 24
   layers on sequences of 1 024 (four SSD chunks, the chunk recurrence
   between them), float32, ``train_preset`` (8 microbatches, remat
   ``"full"``) over batches of 8, 3 steps, held as 9d is. (9f)
   whisper-large-v3 whole (32 encoder and 32 decoder layers) on 8
   sequences of 448 tokens over 8 × 1 500 frames, and phi3-vision-4.2b
   at full width cut to 8 of 32 layers on 8 × 1 024 (the first 576 of
   each image positions), float32, ``train_preset``, 3 steps, held as 9d
   is: K5 bwd unmasked through the encoder and the cross-attention, at
   head dim 96 through phi3-vision.
   9b, 9d, 9e and 9f probe ``ln_f``, the embedding (and its learned
   positions), an encoder's positions and its first block's ``wq``, and
   in the first block of each kind ``wq`` (attention; and ``xattn``'s
   ``wq`` and ``lnx`` in a ``"dec"`` block), ``w_a``, ``lam`` and ``conv_w``
   (RG-LRU), ``in_proj``, ``a_log``, ``dt_bias`` and ``conv_w`` (SSD) and
   the MLP's leaves (the router and the experts' ``wg``, ``wu``, ``wd``
   for a MoE; ``wu`` otherwise): each moved, and each one's first moment
   is nonzero after the run (a gradient reached it; for a MoE in every
   expert's slice and every router column).
   Model TFLOP/s count 6 N tokens with N the parameters a token runs
   through (k of E experts; not the learned position tables), 6 N_enc
   frames for an encoder, plus 12·D·H a query-key pair (inside the
   window for a local layer, all T·S where unmasked: the encoder's and
   the cross-attention's); the SSD's chunk products are not counted.

``--profile`` adds a phase after 6b: each main-path and 6b run under
``torch.profiler`` (the first 200 ticks of the eager runs, the whole
40 000 ticks of the megakernel runs), with the device time and device
launches per tick, the device-busy share and the kernels that take the
most device time; phases 8, 8c and 8d run each serve run a second time
under ``torch.profiler``, with its device time, device launches and
K5's and K6's share of its device time; and 9b, 9e and 9f run one more
train step under it, with the shares of K5, K5 bwd, K6, K6 bwd, the
casts and cuBLAS.

The redesigned kernels (``src/repro_torch/csrc``): K3 is a split
reduction over 64-row chunks of the incidence on a grid of 64-column
tiles, whose last block per tile (elected by a counter) adds the chunks'
partials in chunk order and integrates the queues; K5 runs bf16 on the
tensor cores (``mma.sync``, P split into bf16 halves), prefill in
64-row query tiles over ``cp.async`` double-buffered key tiles, decode
split over 64-key ranges with one block per (b, kv head, split) serving
the whole GQA group and the last block merging the splits in order. Both
keep one launch per call and sum in a fixed order. K6 holds each row in
registers as 16-byte vectors, a block of 128 threads per wide row and 16
lanes per 128-wide row, with a fixed-order butterfly and warp-order sum
(phase 7 also holds it bit for bit against that order spelled in torch,
in bfloat16 and float32, and against a second run, and prints its time
beside ``F.rms_norm`` at each serve shape). K4 stages its carry, the
topology it indexes and its temporaries in shared memory for the launch,
with each queue's full contributor list (a CSR rebuilt by a block-wide
stable counting sort on admit ticks) in place of the truncated gather
table and its overflow walk; ``k4_timing`` splits its launch times by
the table's overflow flag and by the launch's admit ticks (counted by a
third pass of one tick per launch). K4 runs one block per scenario: a
batch is one launch of B blocks that share nothing.

It prints one ``{"kernels": [...]}`` line (K1-K6, K1/K2 in both forms,
and K5's and K6's backward kernels with 9b's launches of one step;
K5's and K6's rows carry 8b's and 8c's launches by architecture, and the
LM kernels' rows 9d's and 9e's launches of a step, K5 bwd's row its
windowed launches of a 9e step under ``window_launches_per_step``;
the TPU form's main-path launches are 0; K4's entry carries each of its
13 laws' phase-6c times under ``laws``, each Fig. 8 group's under
``fig8``, each feedback law's on each fat-tree leg under
``feedback``, each impaired run's of phase 6f under ``impair``,
phase 6g's chunked runs under ``chunk``, phase 6h's sharded runs,
with the K4 runs they are held to, under ``shard``, and phase 6i's K4
runs under ``incast``),
the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``. It exits non-zero, printing
no result, when CUDA is not available or the checkout's sources are
missing.
"""
import base64
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, float32 outside the
# tensor cores, dense bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12

OBSERVE_KERNELS = ("powertcp_observe_step", "theta_powertcp_observe_step")
SIM_KERNELS = ("powertcp_step", "theta_powertcp_step") + OBSERVE_KERNELS + (
    "queue_arrivals", "fused_tick_block")
LM_KERNELS = ("flash_attention", "rmsnorm")
# the trainer's backward kernels (phase 9)
TRAIN_KERNELS = ("flash_attention_bwd", "rmsnorm_bwd")
KERNELS = SIM_KERNELS + LM_KERNELS + TRAIN_KERNELS
# the kernels the main path runs (K1/K2's TPU form stays in the kernels
# line, held and timed in phase 3, with its main-path launches: 0)
PATH_KERNELS = OBSERVE_KERNELS + ("queue_arrivals", "fused_tick_block") \
    + LM_KERNELS + TRAIN_KERNELS
REPLACES = {
    "powertcp_step": "src/repro/kernels/powertcp_step.py:51",
    "theta_powertcp_step": "src/repro/kernels/powertcp_step.py:101",
    "powertcp_observe_step": "src/repro/kernels/powertcp_step.py:51",
    "theta_powertcp_observe_step": "src/repro/kernels/powertcp_step.py:101",
    "queue_arrivals": "src/repro/kernels/queue_arrivals.py:312",
    "fused_tick_block": "src/repro/kernels/fused_tick.py:74",
    "flash_attention": "src/repro/kernels/flash_attention.py:98",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:26",
    # no Pallas backward: the gradient jax.grad takes through these
    "flash_attention_bwd": "src/repro/models/layers.py:200 (jax.grad "
                           "through _sdpa)",
    "rmsnorm_bwd": "src/repro/models/layers.py:124 (jax.grad through "
                   "norm_apply)",
}
SOURCES = {
    "powertcp_step": "src/repro_torch/csrc/powertcp_step.cu",
    "theta_powertcp_step": "src/repro_torch/csrc/powertcp_step.cu",
    "powertcp_observe_step": "src/repro_torch/csrc/powertcp_step.cu",
    "theta_powertcp_observe_step": "src/repro_torch/csrc/powertcp_step.cu",
    "queue_arrivals": "src/repro_torch/csrc/queue_arrivals.cu",
    "fused_tick_block": "src/repro_torch/csrc/fused_tick.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "rmsnorm": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention_bwd": "src/repro_torch/csrc/flash_attention.cu",
    "rmsnorm_bwd": "src/repro_torch/csrc/rmsnorm.cu",
}


def log(*args):
    print(*args, flush=True)


def mark(msg):
    """A ``[time]`` line, on stderr as well, where the end of a stopped
    run's output shows how far it got."""
    log(msg)
    print(msg, file=sys.stderr, flush=True)


# seconds after which the script stops itself (its limit is 1 200 s, the
# build included): every thread's stack on stderr, the ranks it spawned
# killed, exit code 1
DEADLINE_S = 1170


def arm_deadline():
    """Stop the script at ``DEADLINE_S`` (see there); a daemon timer."""
    import faulthandler
    import multiprocessing
    import threading

    def stop():
        print(f"[deadline] still running after {DEADLINE_S} s: stopping",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        for p in multiprocessing.active_children():
            p.kill()
        os._exit(1)
    timer = threading.Timer(DEADLINE_S, stop)
    timer.daemon = True
    timer.start()


# -------------------------------------------------------------------------
# timing and bounds
# -------------------------------------------------------------------------

def graph_ms(torch, fn, reps=100, rounds=7):
    """Device time of one ``fn()`` call: ``reps`` calls captured in one
    CUDA graph, replayed ``rounds`` times between CUDA events; the median
    round over ``reps``. The graph takes the host's launch cost out."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def eager_ms(torch, fn, reps=20, rounds=3):
    """Time of one ``fn()`` call where ``fn`` reads values back to the host
    (no CUDA graph can hold it): ``reps`` calls between CUDA events after
    a warm-up, the median round over ``reps``; host time included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def bound_ms(nbytes, flops, peak_ops=PEAK_F32_S):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def law_cost(F, H):
    """Bytes each input read once + each output written once, and flops,
    of one K1 call: per hop 4 float inputs + 1 mask byte and ~9 flops;
    per flow 6 float inputs + 1 mask byte, 2 float outputs, ~15 flops."""
    return F * H * (4 * 4 + 1) + F * (6 * 4 + 1 + 2 * 4), F * (9 * H + 15)


def theta_cost(F):
    """K2: 8 float inputs + 1 mask byte, 3 float outputs, ~18 flops."""
    return F * (8 * 4 + 1 + 3 * 4), F * 18


def observe_cost(inp, law):
    """One observe-kernel call on ``test_torch_support.observe_inputs``'
    data, counted from that data: every row reads its window, NIC rate,
    base RTT, RTT now, smoothed power, update times (7 floats; Algorithm 2
    also its previous RTT), its active flag and on the padded engine its
    ``started`` flag, and writes four floats (Algorithm 2 five); only a
    row that updates reads its path, hop delays and RTT in steps, its law
    config (tau, beta), w_old and on the slot engine ``slot_flow`` and
    ``admit_t``, and per real hop its observation (q; Algorithm 1 also q
    one tick earlier and the queue's rate out) and the queue's service
    rate. Flops: ~5 a row (the clamp), and per updating row ~30 plus 2
    (Algorithm 2) or 12 (Algorithm 1) per real hop."""
    active, nu = inp["active"], inp["next_update"]
    upd = active & (np.float32(inp["t_sec"]) >= nu)
    rows, n_upd = active.size, int(upd.sum())
    hops = int((inp["path"][upd] < inp["Q"]).sum())
    H = inp["path"].shape[-1]
    a1, slot = law == "powertcp", inp["engine"] == "slot"
    per_row = 4 * (7 + 4 + 2 * (not a1)) + 1 + (not slot)
    per_upd = 4 * (2 * H + 1 + 2 + 1 + 2 * slot)
    per_hop = 4 * ((3 if a1 else 1) + 1)
    nbytes = rows * per_row + n_upd * per_upd + hops * per_hop
    flops = 5 * rows + 30 * n_upd + (12 if a1 else 2) * hops
    return nbytes, flops


def queue_cost(H, F, Q):
    """K3: lam [H,F] + incidence [H,F,Q] + q/out/caps [Q] read, arr and
    q_new [Q] written; 2 flops per incidence entry + 5 per queue."""
    return 4 * (H * F + H * F * Q + 3 * Q + 2 * Q), 2 * H * F * Q + 5 * Q


def visible_pairs(T, S, window=0, causal=True):
    """The query-key pairs attention computes: unmasked, all T·S; causal,
    the queries at the last T of S positions, query t sees keys (t + S -
    T - window, t + S - T], all of them before it where ``window`` is
    0."""
    if not causal:
        return T * S
    return sum(min(S, t + S - T + 1)
               - (max(0, t + S - T - window + 1) if window > 0 else 0)
               for t in range(T))


def flash_cost(B, H, KV, T, S, D, itemsize=2, window=0, causal=True):
    """K5, causal with the queries at the last T of S positions, or
    unmasked: q, k, v read once and the output written once (with a
    window, only the keys some query sees); 4·D flops (two products,
    each a multiply and an add) per visible query-key pair
    (``visible_pairs``)."""
    read = min(S, T + window - 1) if causal and window > 0 else S
    return (2 * B * H * T * D + 2 * B * KV * read * D) * itemsize, \
        4 * B * H * D * visible_pairs(T, S, window, causal)


def rmsnorm_cost(N, D, itemsize=2):
    """K6: x read and y written once, the float32 scale read once; per
    element a square-add, a multiply by the inverse root and one by the
    scale (4 flops)."""
    return 2 * N * D * itemsize + 4 * D, 4 * N * D


# -------------------------------------------------------------------------
# phases
# -------------------------------------------------------------------------

def phase_probe(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {ROOT}")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(f"[probe] nvidia-smi: {smi}")
    return name, smi


def phase_build(kernels):
    t0 = time.time()
    logs = kernels.build()
    secs = time.time() - t0
    for name, out in logs.items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] built {sorted(logs) or 'nothing (cached)'} in "
        f"{secs:.2f} s")
    return secs


def phase_kernels(torch, sup, dev):
    """Each kernel against its plain version, then timed. Returns
    {name: row} for the kernels line (at the slot engine's shapes, S=384)
    plus the padded engine's rows under ``name + '@padded'``."""
    from repro_torch.kernels import (powertcp_step, queue_arrivals, ref,
                                     theta_powertcp_step)

    def on(kw):
        return {k: torch.as_tensor(v, device=dev) for k, v in kw.items()}

    def maxerr(got, want):
        return max(float(torch.max(torch.abs(g - w))) if g.numel() else 0.0
                   for g, w in zip(got, want))

    errs = {"powertcp_step": 0.0, "theta_powertcp_step": 0.0,
            "queue_arrivals": 0.0}
    for F, H in ((2406, 3), (384, 3), (1, 1), (257, 5), (1, 5), (257, 1)):
        kw = on(sup.law_inputs(F, H, seed=F + H))
        got = powertcp_step(**kw, gamma=0.9, w_min=1000.0)
        want = ref.powertcp_step_ref(**kw, gamma=0.9, w_min=1000.0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        errs["powertcp_step"] = max(errs["powertcp_step"], maxerr(got, want))
        log(f"[kernels] powertcp_step F={F} H={H}: bitwise equal")
    for F in (2406, 384, 1, 257):
        kw = on(sup.theta_inputs(F, seed=F))
        got = theta_powertcp_step(**kw, gamma=0.9, w_min=1000.0)
        want = ref.theta_powertcp_step_ref(**kw, gamma=0.9, w_min=1000.0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        errs["theta_powertcp_step"] = max(errs["theta_powertcp_step"],
                                          maxerr(got, want))
        log(f"[kernels] theta_powertcp_step F={F}: bitwise equal")
    for H, F, Q in [(3, 2406, 289), (3, 384, 289), (1, 1, 2), (5, 257, 129),
                    (1, 257, 2), (5, 1, 129)] + sup.QUEUE_EDGE_SHAPES:
        kw = on(sup.queue_inputs(H, F, Q, seed=H + F + Q))
        got = queue_arrivals(**kw, dt=sup.QUEUE_DT)
        want = ref.queue_arrivals_ref(**kw, dt=sup.QUEUE_DT)
        again = queue_arrivals(**kw, dt=sup.QUEUE_DT)
        spelled = sup.queue_arrivals_in_k3_order(**kw, dt=sup.QUEUE_DT)
        torch.cuda.synchronize()
        for g, w, a, o in zip(got, want, again, spelled):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
            torch.testing.assert_close(a, g, rtol=0, atol=0)
            torch.testing.assert_close(g, o, rtol=0, atol=0)
        e = maxerr(got, want)
        errs["queue_arrivals"] = max(errs["queue_arrivals"], e)
        log(f"[kernels] queue_arrivals H={H} F={F} Q={Q}: max abs err "
            f"{e!r} (rtol 1e-5, atol 1e-3); bitwise equal to its order "
            f"spelled in torch and to a second run")

    # the batched engines' shapes: B scenarios' rows in one launch (K1/K2
    # flatten them, K3 runs one grid plane per scenario), each scenario
    # bit for bit what a launch of its own gives
    for B, F, H, Q in ((2, 128, 3, 289), (2, 2436, 3, 289),
                       (3, 257, 5, 129)):
        parts = [on(sup.law_inputs(F, H, seed=F + H + b)) for b in range(B)]
        kw = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        got = powertcp_step(**kw, gamma=0.9, w_min=1000.0)
        want = ref.powertcp_step_ref(**kw, gamma=0.9, w_min=1000.0)
        alone = [powertcp_step(**p, gamma=0.9, w_min=1000.0) for p in parts]
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(
                g, torch.stack([a[i] for a in alone]), rtol=0, atol=0,
                equal_nan=True)
        errs["powertcp_step"] = max(errs["powertcp_step"], maxerr(got, want))
        parts = [on(sup.theta_inputs(F, seed=F + b)) for b in range(B)]
        kw = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        got = theta_powertcp_step(**kw, gamma=0.9, w_min=1000.0)
        want = ref.theta_powertcp_step_ref(**kw, gamma=0.9, w_min=1000.0)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        parts = [on(sup.queue_inputs(H, F, Q, seed=H + F + Q + b))
                 for b in range(B)]
        kw = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        if B == 2:      # the engines' form: service rates shared
            kw["out_rate"] = parts[0]["out_rate"]
        got = queue_arrivals(**kw, dt=sup.QUEUE_DT)
        want = ref.queue_arrivals_ref(**kw, dt=sup.QUEUE_DT)
        again = queue_arrivals(**kw, dt=sup.QUEUE_DT)
        torch.cuda.synchronize()
        for b in range(B):
            one = dict(parts[b], out_rate=kw["out_rate"] if B == 2
                       else parts[b]["out_rate"])
            alone = queue_arrivals(**one, dt=sup.QUEUE_DT)
            spelled = sup.queue_arrivals_in_k3_order(**one, dt=sup.QUEUE_DT)
            for g, a, o in zip(got, alone, spelled):
                torch.testing.assert_close(g[b], a, rtol=0, atol=0)
                torch.testing.assert_close(g[b], o, rtol=0, atol=0)
        for g, w, a in zip(got, want, again):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
            torch.testing.assert_close(a, g, rtol=0, atol=0)
        e = maxerr(got, want)
        errs["queue_arrivals"] = max(errs["queue_arrivals"], e)
        log(f"[kernels] batch B={B} F={F} H={H} Q={Q}: powertcp_step and "
            f"theta_powertcp_step bitwise equal to their plain versions and "
            f"to one launch per scenario; queue_arrivals max abs err {e!r} "
            f"(rtol 1e-5, atol 1e-3), each scenario bitwise equal to its own "
            f"launch and its order spelled in torch")

    rows = {}
    for tag, F in (("", 384), ("@padded", 2406)):
        H, Q = 3, 289
        kw = on(sup.law_inputs(F, H, seed=1))
        nbytes, flops = law_cost(F, H)
        b, by = bound_ms(nbytes, flops)
        rows["powertcp_step" + tag] = dict(
            shape=f"F={F} H={H}",
            ms=graph_ms(torch, lambda: powertcp_step(**kw)),
            plain_ms=graph_ms(torch, lambda: ref.powertcp_step_ref(**kw)),
            bound_ms=b, bound_by=by, library_ms=None)
        kw = on(sup.theta_inputs(F, seed=1))
        nbytes, flops = theta_cost(F)
        b, by = bound_ms(nbytes, flops)
        rows["theta_powertcp_step" + tag] = dict(
            shape=f"F={F}",
            ms=graph_ms(torch, lambda: theta_powertcp_step(**kw)),
            plain_ms=graph_ms(torch,
                              lambda: ref.theta_powertcp_step_ref(**kw)),
            bound_ms=b, bound_by=by, library_ms=None)
        kw = on(sup.queue_inputs(H, F, Q, seed=1))
        nbytes, flops = queue_cost(H, F, Q)
        b, by = bound_ms(nbytes, flops)
        lam, oh = kw["lam_del"], kw["onehot"]
        rows["queue_arrivals" + tag] = dict(
            shape=f"H={H} F={F} Q+1={Q}",
            ms=graph_ms(torch,
                        lambda: queue_arrivals(**kw, dt=sup.QUEUE_DT)),
            plain_ms=eager_ms(torch, lambda: ref.queue_arrivals_ref(
                **kw, dt=sup.QUEUE_DT)),
            bound_ms=b, bound_by=by,
            library_ms=graph_ms(torch,
                                lambda: torch.einsum("hf,hfq->q", lam, oh)))
    # the batched fused slot run's shapes (phase 6b: B = 2, S = 128), and K3
    # at the batched padded engine's (B = 2, F = 2 436)
    for tag, B, F in (("@batch", 2, 128), ("@batch_padded", 2, 2436)):
        H, Q = 3, 289
        parts = [on(sup.law_inputs(F, H, seed=1 + b)) for b in range(B)]
        kw = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        nbytes, flops = law_cost(B * F, H)
        b, by = bound_ms(nbytes, flops)
        rows["powertcp_step" + tag] = dict(
            shape=f"B={B} F={F} H={H}",
            ms=graph_ms(torch, lambda: powertcp_step(**kw)),
            plain_ms=graph_ms(torch, lambda: ref.powertcp_step_ref(**kw)),
            bound_ms=b, bound_by=by, library_ms=None)
        parts = [on(sup.queue_inputs(H, F, Q, seed=1 + b)) for b in range(B)]
        kq = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        kq["out_rate"] = parts[0]["out_rate"]
        nbytes, flops = queue_cost(H, F, Q)
        b, by = bound_ms(B * nbytes, B * flops)
        lam, oh = kq["lam_del"], kq["onehot"]
        rows["queue_arrivals" + tag] = dict(
            shape=f"B={B} H={H} F={F} Q+1={Q}",
            ms=graph_ms(torch,
                        lambda: queue_arrivals(**kq, dt=sup.QUEUE_DT)),
            plain_ms=eager_ms(torch, lambda: ref.queue_arrivals_ref(
                **kq, dt=sup.QUEUE_DT), reps=5),
            bound_ms=b, bound_by=by,
            library_ms=graph_ms(torch, lambda: torch.einsum(
                "bhf,bhfq->bq", lam, oh)))
    for name, row in rows.items():
        row["max_abs_err"] = errs[name.split("@")[0]]
        log(f"[kernels] time {name} ({row['shape']}): ms {row['ms']!r} "
            f"plain_ms {row['plain_ms']!r} bound_ms {row['bound_ms']!r} "
            f"({row['bound_by']}) library_ms {row['library_ms']!r}")
    return rows


# K1/K2's observe form: (tag, engine, B, F, H, N) — S = 384 slots over the
# paper's 2 406 flows, P = 2 406 padded flows, B = phase 6b's 2 x 128
# slots over 2 436 flows; then ragged shapes (checked, not timed)
OBSERVE_SHAPES = (("", "slot", 1, 384, 3, 2406),
                  ("@padded", "padded", 1, 2406, 3, None),
                  ("@batch", "slot", 2, 128, 3, 2436),
                  (None, "padded", 2, 257, 5, None),
                  (None, "slot", 3, 100, 1, 500))


def phase_observe(torch, tc, sup, dev):
    """K1/K2's observe form: each law's routine (the kernel on these CUDA
    tensors) against its plain version on the same tensors, bit for bit
    in every output, at ``OBSERVE_SHAPES``, fixed-period and RTT-paced;
    then timed at the S, P and B shapes beside the plain version, with the
    launch floor: an empty kernel launched through the same interface and
    timed the same way. Returns {name: row} as ``phase_kernels``."""
    from repro_torch.core import backends
    from repro_torch.kernels.powertcp_step import launch_floor
    floor = graph_ms(torch, lambda: launch_floor(dev))
    log(f"[observe] launch floor (an empty kernel, same interface, CUDA "
        f"graph replay): {floor!r} ms")
    rows = {}
    for law in ("powertcp", "theta_powertcp"):
        name = law + "_observe_step"
        plain = (backends.powertcp_observe_step_plain if law == "powertcp"
                 else backends.theta_powertcp_observe_step_plain)
        err = 0.0
        for tag, engine, B, F, H, N in OBSERVE_SHAPES:
            for period in (2e-6, 0.0):
                inp = sup.observe_inputs(engine, B, F, H=H, N=N,
                                         update_period=period, seed=F + H)
                law_b, static, cfg, x = sup.observe_tick(tc, inp, law, dev)
                routine = tc.observe_step(law_b)

                def run():
                    return routine(law_b, static, cfg, x)

                def run_plain():
                    return plain(law_b, static, cfg, x)
                got, want = run(), run_plain()
                torch.cuda.synchronize()
                got = tuple(got[0]) + tuple(got[1:])
                want = tuple(want[0]) + tuple(want[1:])
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=0, atol=0,
                                               equal_nan=True)
                    d = torch.abs(g - w)
                    d = d[torch.isfinite(d)]   # inf - inf: equal infinities
                    err = max(err, float(d.max()) if d.numel() else 0.0)
                log(f"[observe] {name} {engine} B={B} F={F} H={H} "
                    f"update_period={period}: bitwise equal to its plain "
                    f"version")
                if tag is None or period == 0.0:
                    continue
                b, by = bound_ms(*observe_cost(inp, law))
                rows[name + tag] = dict(
                    shape=f"{engine} B={B} F={F} H={H}",
                    ms=graph_ms(torch, run), plain_ms=graph_ms(torch,
                                                               run_plain),
                    bound_ms=b, bound_by=by, library_ms=None,
                    floor_ms=floor)
        for key, row in rows.items():
            if key.startswith(name):
                row["max_abs_err"] = err
                log(f"[kernels] time {key} ({row['shape']}): ms "
                    f"{row['ms']!r} plain_ms {row['plain_ms']!r} bound_ms "
                    f"{row['bound_ms']!r} ({row['bound_by']}) floor_ms "
                    f"{floor!r} library_ms None")
    return rows


def phase_goldens(tc, sup, dev):
    """The golden scenario (``tools/gen_golden.py``'s constants) through
    the port on the card, both backends, at the golden tolerances."""
    data = sup.golden()
    for law in ("powertcp", "theta_powertcp"):
        for backend in ("reference", "fused"):
            topo, flows, lcfg, cfg = sup.golden_scenario(tc, device=dev)
            got = sup.pack(*tc.simulate(topo, flows, law, lcfg, cfg,
                                        backend=backend, device=dev))
            sup.check_golden(law, got, data[law], leg=f"[{backend}]")
            log(f"[goldens] {law} {backend}: within the golden tolerances")


def paper_scenario(tc, sup, dev, ref):
    fab = tc.LeafSpine(**ref["fabric"])
    flows = tc.poisson_websearch(fab, ref["load"], ref["duration_s"],
                                 ref["dt_s"], seed=ref["seed"], device=dev)
    sched = tc.make_schedule(flows)
    n = int(sched.start.shape[0])
    if n != ref["n_flows"] or sup.schedule_checksum(
            sched.size.cpu().numpy(), sched.start.cpu().numpy()) \
            != ref["schedule_sha256"]:
        raise AssertionError("the port's paper schedule differs from the "
                             "reference's")
    return fab.topology(device=dev), sched


def smoke_scenario(tc, sup, dev, ref):
    """(topo, [flows], [schedule]) of phase 6b's sweep, each schedule held
    to the reference's flow count and checksum."""
    fab = tc.LeafSpine(**ref["fabric"])
    flows, scheds = [], []
    for sc in ref["scenarios"]:
        f = tc.poisson_websearch(fab, ref["load"], ref["duration_s"],
                                 ref["dt_s"], seed=sc["seed"], device=dev)
        sched = tc.make_schedule(f)
        if int(sched.start.shape[0]) != sc["n_flows"] or \
                sup.schedule_checksum(sched.size.cpu().numpy(),
                                      sched.start.cpu().numpy()) \
                != sc["schedule_sha256"]:
            raise AssertionError(f"the port's schedule of seed {sc['seed']} "
                                 f"differs from the reference's")
        flows.append(f)
        scheds.append(sched)
    return fab.topology(device=dev), flows, scheds


# ticks of the eager main-path runs (a)-(d) and of 6b.1, 6b.3 and 6b.6:
# the first 2 000 of the 40 000-tick paper run, to keep the script inside
# its time limit (3 000 until the trainer's phase 9 was added)
EAGER_TICKS = 2_000
MAIN_RUNS = (("a", "slot", "powertcp", "fused"),
             ("b", "slot", "powertcp", "reference"),
             ("c", "padded", "powertcp", "fused"),
             ("d", "slot", "theta_powertcp", "fused"),
             ("e", "slot", "powertcp", "megakernel"),
             ("f", "slot", "theta_powertcp", "megakernel"))


def expected_launches(law, backend, steps):
    """Launches each kernel must count in one main-path run: the fused
    backend one observe kernel (K1/K2's engine form) and one K3 per tick
    and no K1/K2 in the TPU kernels' form, the megakernel one K4 per
    block of 64 ticks (and one for a remainder), the reference none."""
    from repro_torch.kernels import DEFAULT_BLOCK
    if backend == "fused":
        return {law + "_observe_step": steps, "queue_arrivals": steps}
    if backend == "megakernel":
        return {"fused_tick_block": -(-steps // DEFAULT_BLOCK)}
    return {}


# -------------------------------------------------------------------------
# K4: the megakernel against its plain version
# -------------------------------------------------------------------------

def k4_pool(carry, fluid, bw, law, dt):
    """What one K4 launch must read of its rings, counted from the pool in
    ``carry`` (one scenario's, ``types.scenario`` of the batch's) at a
    launch's edge: per slot holding a flow, the rows of
    ``hist_lam`` back to its longest hop delay tf and of ``hist_w`` back
    to its window delay wd (from the delayed queue observation, as the
    tick computes it); per queue, the rows of the packed ``hist_q`` back
    to the longest feedback delay tb of a hop on it (the hop clock's tf
    for congestion-point feedback), as many columns as the law reads
    (``fused_tick.TELEMETRY``: PowerTCP 3, HPCC, FNCC, pulser and
    backpressure 2, the others 1). Also the admission cursor, the FCTs
    written so far, the gather table's live entries, the slots in use and
    the overflow flag."""
    import torch
    from repro_torch.core.fluid import feedback_delay
    from repro_torch.core.laws import LAWS
    from repro_torch.kernels.fused_tick import TELEMETRY
    st = carry.state
    N = int(st.fct.shape[0]) - 1
    Q = int(bw.shape[0]) - 1
    D = int(st.hist_lam.shape[0])
    occ = st.slot_flow < N
    valid = st.path < Q
    live = valid & occ[:, None]
    tb = feedback_delay(LAWS[law], st.tf_steps, st.rtt_steps, D)
    q_back = torch.zeros(Q + 1, dtype=torch.int32, device=tb.device)
    q_back.scatter_reduce_(0, st.path.flatten().long(),
                           torch.where(live, tb, 0).flatten(), "amax")
    oh = torch.remainder(int(st.t) % D - tb, D)
    theta = st.tau + fluid._hop_sum(torch.where(
        valid, st.hist_q[oh, st.path] / bw[st.path], 0.0))
    wd = torch.clamp(torch.round(theta / dt).to(torch.int32), 1, D - 2)
    return dict(
        lam=int(torch.where(live, st.tf_steps, 0).amax(1).sum()),
        q=int(q_back[:Q].sum()) * TELEMETRY.get(law, 1),
        w=int(torch.where(occ, wd, 0).sum()),
        inv=int(valid.sum()) + Q + 1,
        cursor=int(st.cursor), fct=int(torch.isfinite(st.fct[:N]).sum()),
        live=int(occ.sum()), ovf=bool(carry.ovf))


# K4's flops by law, counted from csrc/fused_tick.cu: per slot-hop, the
# law's telemetry (PowerTCP's normalized power; HPCC's and FNCC's
# utilization; the ECN marking; pulser's count, fair rate and its min;
# backpressure's pause max); per slot, the law's update beyond PowerTCP's,
# which the base ~34 a slot includes (DCQCN's powf taken as ~20; reTCP's
# floor of its base window and circuit multiplier 2; PCC's five probes,
# 7 each, and its excess, penalty and clip)
K4_HOP_FLOPS = {"powertcp": 8, "hpcc": 6, "dcqcn": 6, "reno": 6,
                "retcp": 6, "fncc": 6, "pulser": 4, "backpressure": 1}
K4_SLOT_FLOPS = {"powertcp": 0, "theta_powertcp": 5, "hpcc": 6,
                 "swift": 0, "gradient_mimd": 2, "timely": 14,
                 "dcqcn": 36, "reno": 0, "retcp": 2, "fncc": 2,
                 "pulser": 4, "backpressure": 3, "pcc": 43}


def k4_cost(S, H, Q1, K, nsw, swdeg, law, pre, post, impair=False):
    """Bytes and flops of one K-tick launch of K4, counted from
    ``csrc/fused_tick.cu`` and this launch's data (``k4_pool`` at its
    first and last tick; the larger count of the two where the pool
    decides). Bytes, each read once or written once: the slot vectors and
    queue vectors read and written; K rows of each ring written; the ring
    elements from before the launch that its reads reach; the gather
    table's live entries read (and written when the cursor moved); the
    FCTs flushed; the topology, the due table and the schedule rows of
    the admitted flows read. Rows a launch writes and then reads are its
    own and cost nothing more. The slot vectors are the carry's 16 and
    the law's state (``fused_tick.LAW_STATE``), read and written, and its
    per-slot config (``LAW_CONFIG``), read; a ring row is as wide as the
    law's channels (``fused_tick.ring_channels``), and backpressure's
    pause state is read and written. Flops per tick: per slot-hop
    ~6 for theta_now and theta_obs, plus the law's per-hop telemetry
    (``K4_HOP_FLOPS``); per slot ~34 (rate, PowerTCP's update, clamp,
    progress) plus the rest of the law's update (``K4_SLOT_FLOPS``); per
    valid hop one arrival add; per
    queue ~10 (caps, integration, gradient); per switch its fold. Under an
    impairment regime (``impair``) the launch also reads the regime's 10
    rows of Q words, and each tick spends ~20 float ops per queue on its
    processes (the epoch's and the wave's divisions, the remainder, the
    four kinds' rates, the loss and the jitter; the integer hash is not
    counted) and 2 per slot-hop (the survival product and the jitter)."""
    from repro_torch.kernels.fused_tick import (LAW_CONFIG, LAW_STATE,
                                                PAUSE_LAWS, ring_channels)
    admitted = post["cursor"] - pre["cursor"]
    inv = max(pre["inv"], post["inv"])
    words = (2 * S * (2 * H + 16 + len(LAW_STATE[law]))
             + S * len(LAW_CONFIG[law])
             + (6 if law in PAUSE_LAWS else 4) * Q1
             + K * (2 * S + ring_channels(law) * Q1)
             + sum(max(pre[k], post[k]) for k in ("lam", "q", "w"))
             + inv * (2 if admitted else 1) + post["fct"] - pre["fct"]
             + 3 * Q1 + nsw * (swdeg + 1) + K + admitted * (2 * H + 10)
             + (10 * (Q1 - 1) if impair else 0))
    per_tick = S * H * (6 + K4_HOP_FLOPS.get(law, 0) + 1) \
        + S * (34 + K4_SLOT_FLOPS[law]) + 10 * Q1 + nsw * swdeg \
        + ((Q1 - 1) * 20 + 2 * S * H if impair else 0)
    return 4 * words, K * per_tick


# ticks of phase 4's anchors (their tests run 4 000; every flow starts
# in the first 1 500), cut to keep the script inside its time limit
K4_ANCHOR_TICKS = 2000


def phase_k4(torch, tc, sup, dev, paper_ticks=1000):
    """K4 against its plain version at the anchor shapes, with the gather
    table at its suggested width and narrowed until it overflows, then
    timed over a whole paper run. Returns the kernels-line row of K4."""
    check = sup.k4_against_plain
    topo, sched, cfg = sup.staggered(tc, device=dev)
    cfg = cfg._replace(steps=K4_ANCHOR_TICKS)
    err = 0.0
    c0 = time.perf_counter()

    def secs():
        nonlocal c0
        c, c0 = time.perf_counter() - c0, time.perf_counter()
        return f"{c:.1f} s"
    # recycled slots (S < N) at the suggested width are held by this
    # phase's timing pass (the plain block at five launches of the paper
    # run, S = 384 < N) and phase 6c (each law's middle launch); theta's
    # overflowed table by its paper check below
    for law, slots, blocks, maxdeg in (
            ("powertcp", 16, (1, 7, 64), None),
            ("powertcp", 16, (1, 64), 2)):      # the table overflows
        e, n_ovf, _ = check(tc, topo, sched, cfg, law, slots, blocks,
                            maxdeg=maxdeg)
        err = max(err, e)
        log(f"[k4] {law}: anchor 12 flows x {K4_ANCHOR_TICKS} ticks, "
            f"S={slots}, K in "
            f"{blocks}, table width {maxdeg or 'suggested'} (overflowed on "
            f"{n_ovf} ticks): bitwise equal ({secs()})")
    stopo, ssched, scfg = sup.single_slot(tc, device=dev)
    e, _, _ = check(tc, stopo, ssched, scfg._replace(steps=K4_ANCHOR_TICKS),
                    "powertcp", 1, (64,))
    err = max(err, e)
    log(f"[k4] S=1, 3 flows x {K4_ANCHOR_TICKS} ticks: bitwise equal "
        f"({secs()})")

    with open(sup.PAPER_REF) as f:
        ref = json.load(f)
    ptopo, psched = paper_scenario(tc, sup, dev, ref)
    pcfg = tc.SimConfig(dt=ref["dt_s"], steps=paper_ticks, hist=ref["hist"],
                        update_period=ref["update_period_s"])
    # at the suggested width phase 6c holds every law at paper scale (K4
    # against the plain tick, and the reference slot engine over its
    # first FIG6_EAGER_TICKS ticks); the narrowed table's overflow is held
    # only here
    for law, maxdeg in (("powertcp", 4), ("theta_powertcp", 4)):
        e, n_ovf, deg = check(tc, ptopo, psched, pcfg, law, ref["slots"],
                              (64,), expected_flows=ref["expected_flows"],
                              maxdeg=maxdeg)
        err = max(err, e)
        log(f"[k4] {law}: paper scenario, first {paper_ticks} ticks, "
            f"S={ref['slots']}, table width {maxdeg or 'suggested'} "
            f"(overflowed on {n_ovf} ticks, busiest queue {deg} "
            f"contributors): bitwise equal ({secs()})")
    # the grid form: both seeds of phase 6b's sweep in one launch of two
    # blocks, against each scenario's plain block, with and without gate
    with open(sup.SMOKE_REF) as f:
        sref = json.load(f)
    stopo, _, sscheds = smoke_scenario(tc, sup, dev, sref)
    sb = tc.stack_flow_schedules(sscheds, stopo.num_queues)
    scfg = tc.SimConfig(dt=sref["dt_s"], steps=paper_ticks,
                        hist=sref["hist"],
                        update_period=sref["update_period_s"])
    for law in ("powertcp", "theta_powertcp"):
        e = sup.k4_grid_against_plain(
            tc, stopo, sb, scfg, law, sref["slots"], (64,),
            k4_gates=(True, False), expected_flows=sref["expected_flows"])
        err = max(err, e)
        log(f"[k4] {law}: grid of 2 blocks (seeds "
            f"{[x['seed'] for x in sref['scenarios']]}), first "
            f"{paper_ticks} ticks, S={sref['slots']}, gate True and False: "
            f"bitwise equal to each scenario's plain block ({secs()})")
    held = impair_probe(torch, tc, sup, dev)
    log(f"[k4] impairment evaluation probes: {secs()}")
    row = k4_timing(torch, tc, sup, dev, ref, ptopo, psched)
    log(f"[k4] timing over the paper run (three passes): {secs()}")
    row["max_abs_err"] = err
    row["impair_values_held"] = held
    return row


def k4_timing(torch, tc, sup, dev, ref, topo, sched, law="powertcp"):
    """K4 over the whole 40 000-tick paper run, launch by launch, three
    times from the same initial carry. Pass 1 times every launch: the
    launches go back to back with a CUDA event after each, the queue kept
    ahead of the host, so each interval is one launch's device time. Pass
    2 counts each launch's data for its bound (``k4_pool``, read between
    launches), and at five launches spread over the run also runs the
    plain block from the same carry, timed by the host clock and held
    bit for bit against K4's. Pass 3 runs one tick per launch and logs
    the admission cursor on the card after each tick, which gives each
    64-tick launch's admit ticks (the ticks that rebuild the contributor
    lists). The three passes must end on the same carry. The kernels line
    takes the mean launch time and the mean bound over the run; the log
    splits the launch times by the gather table's overflow flag and by
    admit ticks."""
    from repro_torch.core import fluid, megakernel as mk
    from repro_torch.kernels import ops, ref as kref
    cfg = tc.SimConfig(dt=ref["dt_s"], steps=ref["steps"], hist=ref["hist"],
                       update_period=ref["update_period_s"])
    sim = fluid.make_slot_sim(topo, tc.batch_of_one(sched), law,
                              ref["slots"], cfg=cfg, backend="megakernel",
                              device=dev,
                              expected_flows=ref["expected_flows"])
    tick = mk.make_tick(sim)
    carry0 = tick.init_carry(fluid.init_slot_state(sim))
    due = torch.as_tensor(mk._due_table(sim.sched, cfg.steps, cfg.dt),
                          device=dev)
    K = mk.DEFAULT_BLOCK
    n = cfg.steps // K
    blocks = [due[:, i * K:(i + 1) * K] for i in range(n)]

    carry = sup.tree_clone(carry0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for i in range(n):
        carry, _ = ops.fused_tick_block(tick, carry, blocks[i], record=False)
        ev[i + 1].record()
    ev[n].synchronize()
    ms = np.array([ev[i].elapsed_time(ev[i + 1]) for i in range(n)])
    end1 = carry

    static = sim.static
    S, H = (int(x) for x in carry0.state.path.shape[-2:])
    Q1 = int(static.bw.shape[0])
    nsw, swdeg = ((0, 0) if static.sw_table is None
                  else tuple(static.sw_table.shape))
    carry = sup.tree_clone(carry0)
    pre = k4_pool(tc.scenario(carry, 0), fluid, static.bw, law, cfg.dt)
    samples = set(int(x) for x in np.linspace(0, n - 1, 7)[1:-1])
    bounds, pools, plain = [], [pre], []
    for i in range(n):
        if i in samples:
            pc = sup.tree_clone(carry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pc, _ = kref.fused_tick_block_ref(tick, pc, blocks[i],
                                              record=False)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
        carry, _ = ops.fused_tick_block(tick, carry, blocks[i], record=False)
        if i in samples:
            for (name, g), (_, w) in zip(sup.tree_leaves(carry),
                                         sup.tree_leaves(pc)):
                torch.testing.assert_close(
                    g, w, rtol=0, atol=0, equal_nan=True,
                    msg=lambda m, nm=name: f"K4 launch {i} {nm}: {m}")
        post = k4_pool(tc.scenario(carry, 0), fluid, static.bw, law, cfg.dt)
        nbytes, flops = k4_cost(S, H, Q1, K, nsw, swdeg, law, pre, post)
        bounds.append(bound_ms(nbytes, flops))
        pools.append(post)
        pre = post
    end2 = carry
    carry = sup.tree_clone(carry0)
    cursors = torch.empty(n * K, dtype=torch.int32, device=dev)
    for t in range(n * K):
        carry, _ = ops.fused_tick_block(tick, carry, due[:, t:t + 1],
                                        record=False)
        cursors[t] = carry.state.cursor[0]
    for end, what in ((end2, "pass 2"), (carry, "pass 3 (one tick a launch)")):
        for (name, g), (_, w) in zip(sup.tree_leaves(end),
                                     sup.tree_leaves(end1)):
            torch.testing.assert_close(
                g, w, rtol=0, atol=0, equal_nan=True,
                msg=lambda m, nm=name, wh=what: f"K4 {wh} {nm}: {m}")
    cur = np.concatenate([[int(carry0.state.cursor)],
                          cursors.cpu().numpy().astype(np.int64)])
    admit = (np.diff(cur) > 0).reshape(n, K).sum(1)
    log(f"[k4] plain block at launches {sorted(samples)} of the paper run: "
        f"bitwise equal to K4; the three K4 passes end on the same carry")

    bms = np.array([b for b, _ in bounds])
    by = max(set(b for _, b in bounds), key=[b for _, b in bounds].count)
    ovf = np.array([p["ovf"] for p in pools[:-1]])
    live = np.array([p["live"] for p in pools[1:]])
    adm = np.array([b["cursor"] - a["cursor"]
                    for a, b in zip(pools, pools[1:])])
    q10, q50, q90 = (float(x) for x in np.percentile(ms, [10, 50, 90]))
    def mean(sel):
        return float(ms[sel].mean()) if sel.any() else float("nan")

    row = dict(shape=f"S={S} H={H} Q+1={Q1} D={ref['hist']} K={K}",
               ms=float(ms.mean()), plain_ms=float(np.mean(plain)),
               bound_ms=float(bms.mean()), bound_by=by, library_ms=None,
               us_per_tick=float(ms.mean()) / K * 1e3,
               ms_overflowed=mean(ovf), ms_not_overflowed=mean(~ovf),
               admit_ticks=int(admit.sum()))
    log(f"[k4] time fused_tick_block ({row['shape']}, {law}, {n} launches "
        f"over the whole run): mean {row['ms']!r} ms per launch "
        f"({row['us_per_tick']!r} us/tick), median {q50!r}, p10 {q10!r}, "
        f"p90 {q90!r}, max {float(ms.max())!r}; plain_ms {row['plain_ms']!r}"
        f" (mean of {len(plain)}); bound mean {row['bound_ms']!r} ms "
        f"({by}), min {float(bms.min())!r}, max {float(bms.max())!r}")
    log(f"[k4] table width {tick.maxdeg}: overflowed at the start of "
        f"{int(ovf.sum())} of {n} launches; mean ms per launch with it "
        f"{row['ms_overflowed']!r}, without {row['ms_not_overflowed']!r}")
    log(f"[k4] admit ticks (the cursor moved; the contributor lists are "
        f"rebuilt): {row['admit_ticks']} of {n * K} ticks; mean ms per "
        f"launch with none {mean(admit == 0)!r} ({int((admit == 0).sum())} "
        f"launches), 1-4 {mean((admit > 0) & (admit < 5))!r} "
        f"({int(((admit > 0) & (admit < 5)).sum())}), 5 or more "
        f"{mean(admit >= 5)!r} ({int((admit >= 5).sum())})")
    for lo in range(0, n, n // 10 + 1):
        sl = slice(lo, min(lo + n // 10 + 1, n))
        log(f"[k4]   launches {sl.start}-{sl.stop - 1} (ticks "
            f"{sl.start * K}-{sl.stop * K - 1}): mean {float(ms[sl].mean())!r}"
            f" ms, slots in use {float(live[sl].mean()):.1f}, admitted "
            f"{int(adm[sl].sum())} on {int(admit[sl].sum())} ticks, "
            f"overflowed {int(ovf[sl].sum())}, bound "
            f"{float(bms[sl].mean())!r} ms")
    return row


def timed_run(torch, kernels, key, want, fn):
    """``fn()`` with the launch counts zeroed just before and read just
    after; every kernel must count exactly ``want`` ({name: n}, others 0).
    Returns (result, wall seconds, launches)."""
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"run ({key}): {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    return out, wall, launches


def run_main(torch, tc, kernels, dev, ref, topo, sched, key, engine, law,
             backend, steps):
    """One main-path run with the launch counts zeroed just before it and
    read just after. Returns (fct [N] in schedule order, summary)."""
    cfg = tc.SimConfig(dt=ref["dt_s"], steps=steps, hist=ref["hist"],
                       update_period=ref["update_period_s"])

    def run():
        if engine == "slot":
            lcfg = tc.default_law_config(
                sched, expected_flows=ref["expected_flows"])
            return tc.simulate_slots(topo, sched, law, ref["slots"], lcfg,
                                     cfg, record=False, backend=backend,
                                     device=dev)[0]
        flows = tc.schedule_as_flows(sched)
        lcfg = tc.default_law_config(flows,
                                     expected_flows=ref["expected_flows"])
        return tc.simulate(topo, flows, law, lcfg, cfg, record=False,
                           backend=backend, device=dev)[0]

    st, wall, launches = timed_run(torch, kernels, key,
                                   expected_launches(law, backend, steps),
                                   run)
    fct = st.fct.double().cpu().numpy()
    if not np.all(np.isfinite(fct) | np.isnan(fct)):
        raise AssertionError(f"run ({key}): non-finite FCTs")
    return fct, dict(run=key, engine=engine, law=law, backend=backend,
                     steps=steps, wall_s=wall, us_per_tick=wall / steps * 1e6,
                     launches=launches), st


def ref_done_by(ref_fct, start, tau, dt, ticks, margin):
    """Of the reference's whole-run FCTs: the flows it completes within
    the first ``ticks`` ticks, and the flows it completes within
    ``margin`` ticks of that cut. A flow's FCT is ``t*dt + tau/2 - start``
    at its completion tick t, which rounding recovers exactly (the FCTs
    are float32 values of a few ms; a tick is 1 us)."""
    with np.errstate(invalid="ignore"):
        t = np.round((ref_fct + start - tau / 2.0) / dt)
        return (np.isfinite(t) & (t < ticks),
                np.isfinite(t) & (np.abs(t - ticks) <= margin))


def fcts_of(lst):
    """A golden's FCT list as float64, None (a flow not completed) as
    NaN."""
    return np.array([np.nan if x is None else x for x in lst], np.float64)


def compare_fct(key, fct, ref_fct, sizes, ref_done=None, near=None,
                rtol=None, all_p999=False):
    """A run's FCTs against the reference's: the same completion set (the
    reference's ``ref_done`` for a cut run, the flows ``near`` its cut
    left out) and, over the flows both complete, the short-flow p99.9
    within 1e-3 (where the run has short flows: ``short_p999_us`` is
    None where it has none), with ``all_p999`` the all-flow p99.9 too,
    and with ``rtol`` every FCT within it."""
    fct = np.asarray(fct, np.float64)
    done = np.isfinite(fct)
    if ref_done is None:
        ref_done = np.isfinite(ref_fct)
    keep = np.ones_like(done) if near is None else ~near
    if not np.array_equal(done[keep], ref_done[keep]):
        raise AssertionError(f"run ({key}): completion set differs from the "
                             f"reference ({done[keep].sum()} vs "
                             f"{ref_done[keep].sum()})")
    done = done & ref_done & keep
    out = dict(completed=int(done.sum()), n_flows=int(fct.size),
               short_p999_us=None, ref_short_p999_us=None, p999_rel_err=None,
               fct_max_rel_err=(float(np.max(np.abs(fct[done] - ref_fct[done])
                                             / ref_fct[done]))
                                if done.any() else 0.0),
               bitwise=bool(np.array_equal(fct[keep], ref_fct[keep],
                                           equal_nan=True)))
    if rtol is not None and not out["fct_max_rel_err"] <= rtol:
        raise AssertionError(f"run ({key}): FCT rel err "
                             f"{out['fct_max_rel_err']} against the "
                             f"reference's")
    sets = [("short", done & (sizes < 10e3))]
    if all_p999:
        sets.append(("all", done))
    for name, sel in sets:
        if not sel.any():
            continue
        p = float(np.percentile(fct[sel], 99.9))
        pr = float(np.percentile(ref_fct[sel], 99.9))
        rel = abs(p - pr) / max(pr, 1e-12)
        if not rel < 1e-3:
            raise AssertionError(f"run ({key}): {name}-flow p99.9 {p} vs "
                                 f"reference {pr} (rel err {rel})")
        out[f"{name}_p999_us"] = p * 1e6
        out[f"ref_{name}_p999_us"] = pr * 1e6
        out["p999_rel_err" if name == "short" else f"{name}_p999_rel_err"] \
            = rel
    return out


def phase_main(torch, tc, kernels, sup, dev):
    with open(sup.PAPER_REF) as f:
        ref = json.load(f)
    topo, sched = paper_scenario(tc, sup, dev, ref)
    sizes = sched.size.double().cpu().numpy()
    start = sched.start.double().cpu().numpy()
    tau = sched.tau.double().cpu().numpy()
    launches = {k: 0 for k in kernels.LAUNCHES}
    summaries, finals = [], {}
    for key, engine, law, backend in MAIN_RUNS:
        steps = ref["steps"] if backend == "megakernel" else EAGER_TICKS
        fct, summ, finals[key] = run_main(torch, tc, kernels, dev, ref, topo,
                                          sched, key, engine, law, backend,
                                          steps)
        ref_fct = fcts_of(ref["fct_s"][law])
        ref_done, near = ref_done_by(ref_fct, start, tau, ref["dt_s"], steps,
                                     8 if backend == "fused" else 0)
        summ.update(compare_fct(key, fct, ref_fct, sizes, ref_done, near))
        summ["left_out_near_cut"] = int(near.sum())
        for k, n in summ["launches"].items():
            launches[k] += n
        summaries.append(summ)
        log(f"[main] ({key}) {engine} {law} {backend}, {steps} ticks: wall "
            f"{summ['wall_s']:.3f} s, {summ['us_per_tick']:.2f} us/tick, "
            f"completed {summ['completed']}/{summ['n_flows']}, short p99.9 "
            f"{summ['short_p999_us']:.4f} us (reference "
            f"{summ['ref_short_p999_us']:.4f}, rel err "
            f"{summ['p999_rel_err']:.3g}), largest per-flow FCT rel err "
            f"{summ['fct_max_rel_err']!r}, launches {summ['launches']}")
    log("[main] " + json.dumps({"main_path": summaries}))
    return launches, summaries, finals


# -------------------------------------------------------------------------
# phase 6b: benchmarks/run.py::smoke_slots on the port's batched engines
# -------------------------------------------------------------------------

def fct_rows(fct, scheds, order=False):
    """Per scenario, a batch run's FCTs [N] in schedule order (the padded
    engine's rows are in flow order: ``order`` reindexes them)."""
    out = []
    for i, s in enumerate(scheds):
        n = int(s.start.shape[0])
        row = fct[i][:n].double().cpu().numpy()
        out.append(row[s.order.cpu().numpy()] if order else row)
    return out


def p999(fct, short):
    return float(np.percentile(fct[short], 99.9))


def smoke_anchors(torch, tc, dev):
    """``smoke_slots``'s bit-exactness anchors on the card, with its own
    conditions: one 100 Gbps bottleneck, 12 flows of 100-500 kB starting
    in the first ms (numpy seed 0), 3 000 ticks, powertcp, 16 slots.
    ``fct_slot_exact_bitmatch``: the slot engine's queue trace and FCTs
    equal the padded engine's, windows within rtol 5e-7;
    ``fct_mega_exact_bitmatch``: the megakernel's (K4) queue trace, FCTs,
    windows and per-slot rates equal the slot engine's."""
    B = 100 * tc.GBPS
    topo = tc.single_bottleneck(bandwidth=B, buffer=16e6, device=dev)
    rng = np.random.default_rng(0)
    fl = tc.make_flows_single(12, tau=20e-6, nic=B,
                              sizes=rng.uniform(1e5, 5e5, 12),
                              starts=rng.uniform(0.0, 1e-3, 12), sim_dt=1e-6,
                              device=dev)
    sched = tc.make_schedule(fl)
    cfg = tc.SimConfig(dt=1e-6, steps=3000, hist=256)
    flows = tc.schedule_as_flows(sched)
    lcfg = tc.default_law_config(flows, expected_flows=8.0)
    ref_st, ref_rec = tc.simulate(topo, flows, "powertcp", lcfg, cfg,
                                  device=dev)
    slot_st, slot_rec = tc.simulate_slots(topo, sched, "powertcp", 16, lcfg,
                                          cfg, device=dev)
    mega_st, mega_rec = tc.simulate_slots(topo, sched, "powertcp", 16, lcfg,
                                          cfg, backend="megakernel",
                                          device=dev)
    torch.cuda.synchronize()
    exact = bool(torch.equal(slot_rec.q, ref_rec.q)
                 and torch.equal(slot_st.fct.nan_to_num(-1.0),
                                 ref_st.fct.nan_to_num(-1.0))
                 and torch.allclose(slot_st.w[:12], ref_st.w, rtol=5e-7,
                                    atol=0.0))
    mega_exact = bool(torch.equal(mega_rec.q, slot_rec.q)
                      and torch.equal(mega_st.fct.nan_to_num(-1.0),
                                      slot_st.fct.nan_to_num(-1.0))
                      and torch.equal(mega_st.w, slot_st.w)
                      and torch.equal(mega_rec.lam_f, slot_rec.lam_f))
    return exact, mega_exact


def phase_smoke_slots(torch, tc, kernels, sup, dev, smi):
    """Phase 6b: ``benchmarks/run.py::smoke_slots`` on the port's batched
    entry points (see the module docstring). Returns (launches, the runs'
    summaries, the smoke_slots fields, K4's grid timing)."""
    from repro_torch.core import fluid, megakernel as mk
    with open(sup.SMOKE_REF) as f:
        ref = json.load(f)
    topo, flows, scheds = smoke_scenario(tc, sup, dev, ref)
    Q = topo.num_queues
    steps = ref["steps"]
    cfg = tc.SimConfig(dt=ref["dt_s"], steps=steps, hist=ref["hist"],
                       update_period=ref["update_period_s"])
    ef = ref["expected_flows"]
    fb = tc.stack_flows(flows, Q)
    sb = tc.stack_flow_schedules(scheds, Q)
    B = len(scheds)
    sizes = [s.size.double().cpu().numpy() for s in scheds]
    refs = {k: [np.array([np.nan if x is None else x
                          for x in sc["fct_s"][k]]) for sc in ref["scenarios"]]
            for k in ("padded", "slot", "mega")}
    launches = {k: 0 for k in kernels.LAUNCHES}
    summaries, fcts = [], {}

    def record(key, what, golden, st, wall, counts, order=False, ticks=None,
               margin=8, exact=False):
        """A run's summary, its FCTs held to repro's per seed; a run cut to
        its first ``ticks`` ticks against the flows the reference
        completes by then (the fused run's last bits differ: the flows
        within ``margin`` ticks of the cut are left out; 0 for a
        reference run); ``exact``: each FCT bit for bit repro's."""
        rows = fct_rows(st.fct, scheds, order)
        fcts[key] = rows
        n_ticks = steps if ticks is None else ticks
        summ = dict(run=key, what=what, wall_s=wall, ticks=n_ticks,
                    us_per_tick=wall / n_ticks * 1e6,
                    us_per_tick_per_scenario=wall / n_ticks / B * 1e6,
                    launches=counts, scenarios=[])
        for i, (row, want) in enumerate(zip(rows, refs[golden])):
            done = near = None
            if ticks is not None:
                done, near = ref_done_by(
                    want, scheds[i].start.double().cpu().numpy(),
                    scheds[i].tau.double().cpu().numpy(), ref["dt_s"],
                    ticks, margin)
            summ["scenarios"].append(compare_fct(
                f"{key} seed {ref['scenarios'][i]['seed']}", row, want,
                sizes[i], done, near))
            fin = np.isfinite(row)
            if exact and not np.array_equal(row[fin], want[fin]):
                raise AssertionError(f"run ({key}) seed "
                                     f"{ref['scenarios'][i]['seed']}: FCTs "
                                     f"differ from repro's {golden} FCTs")
        for k, n in counts.items():
            launches[k] += n
        summaries.append(summ)
        log(f"[smoke] ({key}) {what}: wall {wall:.3f} s, "
            f"{summ['us_per_tick']:.2f} us/tick "
            f"({summ['us_per_tick_per_scenario']:.2f} per scenario-tick), "
            f"launches {counts}; against repro's {golden} FCTs per seed: "
            + "; ".join(f"completed {c['completed']}/{c['n_flows']}, short "
                        f"p99.9 rel err {c['p999_rel_err']:.3g}, largest "
                        f"per-flow rel err {c['fct_max_rel_err']!r}"
                        for c in summ["scenarios"]))

    # (1) the padded engine, batched (reference backend), over the first
    # EAGER_TICKS ticks (cut with phase 6's eager runs, to keep the script
    # inside its time limit): every FCT of the flows done by the cut bit
    # for bit repro's
    (st_p, _), wall, counts = timed_run(
        torch, kernels, "6b.1", {}, lambda: tc.simulate_batch(
            topo, fb, "powertcp", cfg=cfg._replace(steps=EAGER_TICKS),
            record=False, expected_flows=ef, device=dev))
    record("6b.1", f"simulate_batch reference, first {EAGER_TICKS} ticks",
           "padded", st_p, wall, counts, order=True, ticks=EAGER_TICKS,
           margin=0, exact=True)
    padded_s = wall
    # (2) the pool as smoke_slots sizes it, from the padded engine's
    # whole-run FCTs in its own flow order: repro's, which (1) matches bit
    # for bit as far as it runs (its peak concurrency falls at tick 20 916
    # for seed 2), through the port's peak_concurrency
    flow_rows = []
    for s_i, row in zip(scheds, refs["padded"]):
        flow_row = np.empty_like(row)
        flow_row[s_i.order.cpu().numpy()] = row
        flow_rows.append(flow_row)
    slots = sup.smoke_slots_pool(
        [s.start.cpu().numpy() for s in scheds], flow_rows,
        max(int(s.tf_steps.max()) for s in scheds), tc.peak_concurrency)
    if slots != ref["slots"]:
        raise AssertionError(f"6b.2: pool {slots}, repro's {ref['slots']}")
    log(f"[smoke] (6b.2) pool from the padded FCTs (repro's whole run, "
        f"(1)'s bit for bit over its cut): {slots} slots (repro's: "
        f"{ref['slots']})")
    # (3) the slot engine, batched (reference backend), over the first
    # EAGER_TICKS ticks (cut with phase 6's eager runs, to keep the script
    # inside its time limit): held to repro's slot FCTs on the flows done
    # by the cut, and below bit for bit to K4's whole run (4), whose FCTs
    # stand for the slot engine's in smoke_ok's whole-run gates
    (st_s, _), wall, counts = timed_run(
        torch, kernels, "6b.3", {}, lambda: tc.simulate_slots_batch(
            topo, sb, "powertcp", slots,
            cfg=cfg._replace(steps=EAGER_TICKS), record=False,
            expected_flows=ef, device=dev))
    record("6b.3", f"simulate_slots_batch reference, first {EAGER_TICKS} "
           f"ticks", "slot", st_s, wall, counts, ticks=EAGER_TICKS,
           margin=0)
    slot_s = wall
    # (4)/(5) the megakernel: scenario after scenario (K4 grid 1), then
    # the whole batch per launch (grid 2)
    nblk = -(-steps // mk.DEFAULT_BLOCK)
    mega = {}
    for key, seq in (("6b.4", True), ("6b.5", False)):
        (st_m, _), wall, counts = timed_run(
            torch, kernels, key, {"fused_tick_block": nblk * (B if seq
                                                              else 1)},
            lambda: tc.simulate_slots_batch(
                topo, sb, "powertcp", slots, cfg=cfg, record=False,
                backend="megakernel", expected_flows=ef, sequential=seq,
                device=dev))
        record(key, f"simulate_slots_batch megakernel sequential={seq} "
               f"(K4 grid {1 if seq else B})", "mega", st_m, wall, counts)
        mega[seq] = (st_m, wall)
    if not torch.equal(mega[True][0].fct.nan_to_num(-1.0),
                       mega[False][0].fct.nan_to_num(-1.0)):
        raise AssertionError("K4 grid 2 differs from grid 1 in some FCT")
    # the cut reference slot run (3) against K4's whole run: the flows K4
    # completes by the cut, each FCT bit for bit
    cut_match = []
    for i, (fs_i, fm_i) in enumerate(zip(fcts["6b.3"], fcts["6b.4"])):
        k4_done, _ = ref_done_by(fm_i, scheds[i].start.double().cpu().numpy(),
                                 scheds[i].tau.double().cpu().numpy(),
                                 ref["dt_s"], EAGER_TICKS, 0)
        done = np.isfinite(fs_i)
        cut_match.append(bool(np.array_equal(done, k4_done)))
        if not cut_match[-1] or not np.array_equal(fs_i[done], fm_i[done]):
            raise AssertionError(
                f"6b.3 seed {ref['scenarios'][i]['seed']}: the reference "
                f"slot engine's first {EAGER_TICKS} ticks differ from K4's "
                f"run ({done.sum()} flows done against K4's "
                f"{k4_done.sum()})")
    n_done = ", ".join(str(int(np.isfinite(x).sum())) for x in fcts["6b.3"])
    log(f"[smoke] (6b.3) the reference slot engine's first {EAGER_TICKS} "
        f"ticks bit for bit K4's whole run (4): the same flows done by the "
        f"cut ({n_done} per seed), each FCT equal")
    # the ungated tick on the card: the same bits
    sim = fluid.make_slot_sim(topo, sb, "powertcp", slots, cfg=cfg,
                              backend="megakernel", device=dev,
                              expected_flows=ef)
    ungated, wall_ungated, _ = timed_run(
        torch, kernels, "6b.5 ungated", {"fused_tick_block": nblk},
        lambda: mk.simulate_slots_mega(sim, record=False, gate=False))
    for f in ("fct", "w", "q", "remaining", "hist_q", "hist_lam", "hist_w",
              "slot_flow", "cursor"):
        g = getattr(ungated[0], f)
        w = getattr(mega[False][0], f)
        if f == "fct":
            g = g[..., :w.shape[-1]]
        if not torch.equal(g.nan_to_num(-1.0) if g.is_floating_point()
                           else g, w.nan_to_num(-1.0)
                           if w.is_floating_point() else w):
            raise AssertionError(f"the ungated K4 run differs in {f}")
    log(f"[smoke] (6b.5) K4 with gate=False: bitwise equal to the gated "
        f"grid-{B} run (wall {wall_ungated:.3f} s); grid {B} bitwise equal "
        f"to grid 1 in every FCT")
    # (6) the slot engine, batched, fused: one K1 (observe form) and one K3
    # per tick, over the first EAGER_TICKS ticks (phase 6's fused runs
    # are cut alike; (a) and (d) hold K1/K3 on the paper run)
    (st_f, _), wall, counts = timed_run(
        torch, kernels, "6b.6",
        expected_launches("powertcp", "fused", EAGER_TICKS),
        lambda: tc.simulate_slots_batch(
            topo, sb, "powertcp", slots, cfg=cfg._replace(steps=EAGER_TICKS),
            record=False, backend="fused", expected_flows=ef, device=dev))
    record("6b.6", f"simulate_slots_batch fused, first {EAGER_TICKS} ticks",
           "slot", st_f, wall, counts, ticks=EAGER_TICKS)
    # (7) the single-bottleneck anchors
    exact, mega_exact = smoke_anchors(torch, tc, dev)

    # smoke_ok's fields, computed as smoke_slots computes them, over the
    # eager runs' cut: the padded (1) and slot (3) reference runs, and K4's
    # whole run (4) on the flows done by the cut (K4's whole run is held
    # to repro's above)
    fp, fc, fm = (np.concatenate(fcts[k]) for k in ("6b.1", "6b.3", "6b.4"))
    size = np.concatenate(sizes)
    short = np.isfinite(fp) & np.isfinite(fc) & (size < 10e3)
    pp, pc = p999(fp, short), p999(fc, short)
    cut_short = np.isfinite(fc) & (size < 10e3)
    pm = p999(fm, cut_short)
    mega_s = mega[True][1]
    padded_us = padded_s / EAGER_TICKS * 1e6
    slot_us = slot_s / EAGER_TICKS * 1e6
    fields = {
        "fct_slot_hosts": ref["fabric"]["racks"]
        * ref["fabric"]["hosts_per_rack"],
        "fct_slot_load": ref["load"], "fct_slot_points": B,
        "fct_slot_steps_per_point": steps,
        "fct_slot_flows": int(sum(s.start.shape[0] for s in scheds)),
        "fct_slot_slots": slots,
        "fct_slot_eager_ticks": EAGER_TICKS,
        "fct_slot_padded_s": padded_s, "fct_slot_padded_us_per_tick":
        padded_us, "fct_slot_stream_s": slot_s,
        "fct_slot_stream_us_per_tick": slot_us,
        "fct_slot_speedup": padded_us / slot_us,
        "fct_slot_completed_match": bool(
            (np.isfinite(fp) == np.isfinite(fc)).all()),
        "fct_slot_p999_rel_err": abs(pc - pp) / max(pp, 1e-12),
        "fct_slot_exact_bitmatch": exact,
        "fct_mega_s": mega_s, "fct_mega_points_per_s": B / mega_s,
        "fct_mega_speedup": slot_us / (mega_s / steps * 1e6),
        "fct_mega_mode": "sequential",
        "fct_mega_completed_match": all(cut_match),
        "fct_mega_p999_rel_err": abs(pm - pc) / max(pc, 1e-12),
        "fct_mega_exact_bitmatch": mega_exact,
        "fct_mega_grid_s": mega[False][1],
        "fct_mega_grid_speedup": mega_s / mega[False][1],
        "device": smi,
    }
    ok = (fields["fct_slot_completed_match"]
          and fields["fct_slot_p999_rel_err"] < 1e-3
          and fields["fct_slot_exact_bitmatch"]
          and fields["fct_mega_completed_match"]
          and fields["fct_mega_p999_rel_err"] < 1e-3
          and fields["fct_mega_exact_bitmatch"])
    log("[smoke] " + json.dumps({"smoke_slots": fields}))
    if not ok:
        raise AssertionError(f"smoke_slots gates failed: {fields}")
    grid = k4_grid_timing(torch, fluid, mk, sim, cfg, nblk, B)
    return launches, summaries, fields, grid


def k4_grid_timing(torch, fluid, mk, sim, cfg, nblk, B, bw_fn=None,
                   bw_params=None, tag="smoke", bound_every=1):
    """K4 over a whole run (phase 6b's, or a Fig. 8 group's with its
    schedules ``bw_fn``/``bw_params``), every launch, as one grid of B
    blocks and as B launches of one block (the first scenario), CUDA
    events between back-to-back launches; then the bound of each grid
    launch (of every ``bound_every``-th), the sum over its scenarios of
    ``k4_cost`` from each scenario's pool at the launch's edges
    (``k4_pool``)."""
    from repro_torch.core.types import scenario
    from repro_torch.kernels import ops
    T, K = int(cfg.steps), mk.DEFAULT_BLOCK
    law = sim.law.name
    grid = mk.make_tick(sim, bw_fn=bw_fn, bw_params=bw_params)
    carry0 = grid.init_carry(fluid.init_slot_state(sim))
    due = torch.as_tensor(mk._due_table(sim.sched, T, cfg.dt),
                          device=carry0.state.w.device)
    first = fluid.scenarios(sim, 0, 1)
    one = mk.make_tick(first, maxdeg=grid.maxdeg, bw_fn=bw_fn,
                       bw_params=fluid.part_of(bw_params, 0, 1))

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple):
            return type(x)(*[clone(v) for v in x])
        return x

    def run(tick, carry, d):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(nblk + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        ev[0].record()
        for i in range(nblk):
            carry, _ = ops.fused_tick_block(tick, carry,
                                            d[..., i * K:(i + 1) * K],
                                            record=False)
            ev[i + 1].record()
        ev[nblk].synchronize()
        return np.array([ev[i].elapsed_time(ev[i + 1]) for i in range(nblk)])

    ms_grid = run(grid, clone(carry0), due)
    ms_one = run(one, one.init_carry(fluid.init_slot_state(first)), due[:1])
    static = sim.static
    S, H = (int(x) for x in carry0.state.path.shape[-2:])
    Q1 = int(static.bw.shape[0])
    nsw, swdeg = ((0, 0) if static.sw_table is None
                  else tuple(static.sw_table.shape))
    carry = clone(carry0)
    pre, bounds = None, []
    for i in range(nblk):
        if pre is None and i % bound_every == 0:
            pre = [k4_pool(scenario(carry, b), fluid, static.bw, law, cfg.dt)
                   for b in range(B)]
        carry, _ = ops.fused_tick_block(grid, carry, due[:, i * K:(i + 1) * K],
                                        record=False)
        if pre is None:
            continue
        post = [k4_pool(scenario(carry, b), fluid, static.bw, law, cfg.dt)
                for b in range(B)]
        nbytes = flops = 0
        for a, z in zip(pre, post):
            nb_, fl_ = k4_cost(S, H, Q1, min(K, T - i * K), nsw, swdeg, law,
                               a, z)
            nbytes += nb_
            flops += fl_
        bounds.append(bound_ms(nbytes, flops))
        pre = post if bound_every == 1 else None
    bms = np.array([b for b, _ in bounds])
    by = max(set(b for _, b in bounds), key=[b for _, b in bounds].count)
    row = dict(grid_shape=f"B={B} S={S} H={H} Q+1={Q1} K={K}",
               grid_launches=nblk, grid_ms=float(ms_grid.mean()),
               grid_us_per_tick=float(ms_grid.mean()) / K * 1e3,
               grid_bound_ms=float(bms.mean()), grid_bound_by=by,
               grid1_ms=float(ms_one.mean()))
    log(f"[{tag}] time fused_tick_block grid ({row['grid_shape']}, {law}, "
        f"{nblk} launches over the whole run): mean {row['grid_ms']!r} ms "
        f"per launch ({row['grid_us_per_tick']!r} us per tick of the "
        f"batch), one block (seed 1 alone) {row['grid1_ms']!r} ms; bound "
        f"mean {row['grid_bound_ms']!r} ms ({by})")
    return row


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, attr, None)
        if val is not None:
            return float(val)
    return 0.0


# -------------------------------------------------------------------------
# phase 6c: benchmarks/fig6_fct.py::run_paper_scale's five laws on K4
# -------------------------------------------------------------------------

# ticks of phase 6c's checks against the eager reference slot engine (cut
# with phase 6's eager runs to keep the script inside its time limit)
FIG6_EAGER_TICKS = 250
# launches of the paper run over which K4 is held to its plain tick
FIG6_PLAIN_LAUNCHES = 2
# every how many launches phase 6c's timing pass counts a launch's bound
FIG6_BOUND_EVERY = 4


def powf_probe(torch, dev):
    """DCQCN's ``powf`` in K4's build against ``torch.pow`` on the card,
    over DCQCN's inputs (1 - p in [0.8, 1] and in [0, 1], packets 1-2 000;
    the edges 0 and 1): the number of results that differ and the largest
    difference in ulps."""
    from repro_torch.kernels import fused_tick as ft
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 1 << 21
    x = torch.cat([torch.rand(n, generator=g) * 0.2 + 0.8,
                   torch.rand(n, generator=g), torch.zeros(16),
                   torch.ones(16)]).to(dev)
    y = torch.cat([1.0 + torch.rand(n, generator=g) * 1999.0,
                   1.0 + torch.rand(n, generator=g) * 49.0,
                   torch.linspace(1, 2000, 16),
                   torch.linspace(1, 2000, 16)]).to(dev)
    a, b = ft.powf(x, y), torch.pow(x, y)
    ulp = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return int((a != b).sum()), int(ulp.max()), int(a.numel())


def fig6_law_cfg(tc, sup, sched, law, dev):
    """Phase 6c's config for ``law``: the paper default (None), and for
    reTCP that with Fig. 8's slot-0 circuit schedule and a 600 us
    prebuffer (the fabric's rates stay the topology's)."""
    if law != "retcp":
        return None
    return tc.default_law_config(
        sched, expected_flows=sup.PAPER_EXPECTED_FLOWS,
        sched=tc.CircuitSchedule().params(dev), retcp_prebuffer=600e-6)


def k4_law_timing(torch, tc, sup, dev, topo, sched, cfg, slots, law,
                  law_cfg=None, impair=None):
    """K4 over the whole run of ``cfg`` for ``law``: every launch timed
    (CUDA events between back-to-back launches), then a second pass from
    the same carry that counts the bound (``k4_cost``, summed over the
    scenarios of a batch) of every ``FIG6_BOUND_EVERY``-th launch from its
    data and, at the middle launch, runs the plain block from the same
    carry (timed by the host clock, held bit for bit to K4's launch);
    both passes must end on the same carry. ``sched`` is one schedule or
    a batch ([B, N] leaves, one K4 block each); ``law_cfg`` (one
    scenario's) replaces the default config; ``impair`` is the run's
    impairment regime. Returns the row of the law."""
    from repro_torch.core import fluid, megakernel as mk
    from repro_torch.kernels import ops, ref as kref
    batch = sched if sched.start.dim() == 2 else tc.batch_of_one(sched)
    sim = fluid.make_slot_sim(
        topo, batch, law, slots,
        None if law_cfg is None else tc.batch_of_one(law_cfg), cfg=cfg,
        backend="megakernel", device=dev,
        expected_flows=sup.PAPER_EXPECTED_FLOWS, impair=impair)
    B = int(batch.start.shape[0])
    tick = mk.make_tick(sim)
    carry0 = tick.init_carry(fluid.init_slot_state(sim))
    T, K = int(cfg.steps), mk.DEFAULT_BLOCK
    due = torch.as_tensor(mk._due_table(sim.sched, T, cfg.dt), device=dev)
    n = -(-T // K)
    blocks = [due[:, i * K:(i + 1) * K] for i in range(n)]
    carry = sup.tree_clone(carry0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for i in range(n):
        carry, _ = ops.fused_tick_block(tick, carry, blocks[i], record=False)
        ev[i + 1].record()
    ev[n].synchronize()
    ms = np.array([ev[i].elapsed_time(ev[i + 1]) for i in range(n)])
    end1 = carry
    static = sim.static
    S, H = (int(x) for x in carry0.state.path.shape[-2:])
    Q1 = int(static.bw.shape[0])
    nsw, swdeg = ((0, 0) if static.sw_table is None
                  else tuple(static.sw_table.shape))
    carry = sup.tree_clone(carry0)
    bounds = []

    def pools(c):
        return [k4_pool(tc.scenario(c, b), fluid, static.bw, law, cfg.dt)
                for b in range(B)]
    for i in range(n):
        pre = pools(carry) if i % FIG6_BOUND_EVERY == 0 else None
        if i == n // 2:
            pc = sup.tree_clone(carry)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pc, _ = kref.fused_tick_block_ref(tick, pc, blocks[i],
                                              record=False)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        carry, _ = ops.fused_tick_block(tick, carry, blocks[i], record=False)
        if i == n // 2:
            for (name, g), (_, w) in zip(sup.tree_leaves(carry),
                                         sup.tree_leaves(pc)):
                torch.testing.assert_close(
                    g, w, rtol=0, atol=0, equal_nan=True,
                    msg=lambda m, nm=name: f"K4 {law} launch {i} {nm}: {m}")
        if pre is not None:
            cost = [k4_cost(S, H, Q1, blocks[i].shape[-1], nsw, swdeg, law,
                            a, b, impair is not None)
                    for a, b in zip(pre, pools(carry))]
            bounds.append(bound_ms(sum(x for x, _ in cost),
                                   sum(y for _, y in cost)))
    for (name, g), (_, w) in zip(sup.tree_leaves(carry),
                                 sup.tree_leaves(end1)):
        torch.testing.assert_close(
            g, w, rtol=0, atol=0, equal_nan=True,
            msg=lambda m, nm=name: f"K4 {law} timing pass 2 {nm}: {m}")
    bms = np.array([b for b, _ in bounds])
    by = max(set(b for _, b in bounds), key=[b for _, b in bounds].count)
    return dict(shape=(f"B={B} " if B > 1 else "")
                + f"S={S} H={H} Q+1={Q1} D={cfg.hist} K={K}",
                launches=n, ms=float(ms.mean()),
                us_per_tick=float(ms.sum()) / T * 1e3,
                ms_p50=float(np.median(ms)), plain_ms=plain_ms,
                bound_ms=float(bms.mean()), bound_by=by)


def phase_fig6(torch, tc, kernels, sup, dev, smi):
    """Phase 6c: ``benchmarks/fig6_fct.py::run_paper_scale`` on K4 (see the
    module docstring). Returns (launches, the K4 rows of the nine laws,
    the runs' summaries)."""
    from repro_torch.kernels import fused_tick as ft
    with open(sup.FIG6_REF) as f:
        ref = json.load(f)
    topo, sched, cfg, slots = sup.fig6_scenario(tc, device=dev)
    n = int(sched.start.shape[0])
    if n != ref["n_flows"] or slots != ref["slots"] or \
            sup.schedule_checksum(sched.size.cpu().numpy(),
                                  sched.start.cpu().numpy()) \
            != ref["schedule_sha256"]:
        raise AssertionError("the port's fig6 schedule or pool differs from "
                             "the reference's")
    sizes = sched.size.double().cpu().numpy()
    nd, ulp, total = powf_probe(torch, dev)
    log(f"[fig6] powf in K4's build against torch.pow: {nd} of {total} "
        f"results differ, largest difference {ulp} ulp")
    if nd:
        raise AssertionError("K4's powf differs from torch.pow; DCQCN's K4 "
                             "run would not be held bit for bit")
    # each law in K4: against the plain tick over the first launches, and
    # against the eager reference slot engine over the first ticks
    plain_cfg = cfg._replace(steps=FIG6_PLAIN_LAUNCHES * 64)
    eager_cfg = cfg._replace(steps=FIG6_EAGER_TICKS)
    rows, err = {}, 0.0
    for law in ft.LAW_NAMES:
        t0 = time.perf_counter()
        lcfg = fig6_law_cfg(tc, sup, sched, law, dev)
        e, _, _ = sup.k4_against_plain(tc, topo, sched, plain_cfg, law,
                                       slots, (64,), law_cfg=lcfg)
        err = max(err, e)
        done = sup.k4_against_reference(tc, topo, sched, eager_cfg, law,
                                        slots, law_cfg=lcfg)
        log(f"[fig6] {law}: K4 bitwise equal to the plain tick over "
            f"{FIG6_PLAIN_LAUNCHES} launches and to the reference slot "
            f"engine over {FIG6_EAGER_TICKS} ticks ({done} flows done) "
            f"({time.perf_counter() - t0:.1f} s)")
        rows[law] = k4_law_timing(torch, tc, sup, dev, topo, sched, cfg,
                                  slots, law, lcfg)
        log(f"[fig6] time K4 {law} ({rows[law]['shape']}, "
            f"{rows[law]['launches']} launches, the whole "
            f"{cfg.steps}-tick run): mean {rows[law]['ms']!r} ms per launch "
            f"({rows[law]['us_per_tick']!r} us per tick), median "
            f"{rows[law]['ms_p50']!r}; plain block at the middle launch "
            f"{rows[law]['plain_ms']!r} ms (bitwise equal); bound mean "
            f"{rows[law]['bound_ms']!r} ms ({rows[law]['bound_by']}); {smi}")
    # the five laws of run_paper_scale through the entry point
    launches = {k: 0 for k in kernels.LAUNCHES}
    want = expected_launches("powertcp", "megakernel", cfg.steps)
    stats, summaries = {}, []
    sb = tc.stack_flow_schedules([sched], topo.num_queues)
    for law in sup.FIG6_LAWS:
        (st, _), wall, counts = timed_run(
            torch, kernels, f"6c {law}", want,
            lambda law=law: tc.simulate_slots_batch(
                topo, sb, law, slots, cfg=cfg, record=False,
                backend="megakernel",
                expected_flows=sup.PAPER_EXPECTED_FLOWS, device=dev))
        for k, c in counts.items():
            launches[k] += c
        fct = st.fct[0, :n].double().cpu().numpy()
        ref_fct = fcts_of(ref["fct_s"][law])
        summ = compare_fct(f"6c {law}", fct, ref_fct, sizes)
        stats[law] = sup.fig6_stats(fct.astype(np.float32), sizes)
        summ.update(run=f"6c {law}", law=law, wall_s=wall,
                    us_per_tick=wall / cfg.steps * 1e6, launches=counts,
                    **{k: stats[law][k] for k in ("short_p999_us",
                                                 "med_p999_us",
                                                 "long_p999_us")})
        summaries.append(summ)
        log(f"[fig6] {law} megakernel, {cfg.steps} ticks, {slots} slots: "
            f"wall {wall:.3f} s ({summ['us_per_tick']:.3f} us/tick), "
            f"completed {summ['completed']}/{n} (the reference's set), "
            f"p99.9 short {stats[law]['short_p999_us']!r} us (reference "
            f"{ref['stats'][law]['short_p999_us']!r}, rel err "
            f"{summ['p999_rel_err']:.3g}), medium "
            f"{stats[law]['med_p999_us']!r}, long "
            f"{stats[law]['long_p999_us']!r}; launches {counts}")
    # the four feedback laws through the entry point, against repro's
    # FCTs of the same run
    with open(sup.FEEDBACK_REF) as f:
        fref = json.load(f)["paper"]
    if fref["n_flows"] != n or fref["slots"] != slots or \
            fref["schedule_sha256"] != ref["schedule_sha256"]:
        raise AssertionError("the feedback reference's paper run differs "
                             "from the port's fig6 schedule or pool")
    for law in sup.FEEDBACK_LAWS:
        (st, _), wall, counts = timed_run(
            torch, kernels, f"6c {law}", want,
            lambda law=law: tc.simulate_slots_batch(
                topo, sb, law, slots, cfg=cfg, record=False,
                backend="megakernel",
                expected_flows=sup.PAPER_EXPECTED_FLOWS, device=dev))
        for k, c in counts.items():
            launches[k] += c
        fct = st.fct[0, :n].double().cpu().numpy()
        ref_fct = fcts_of(fref["fct_s"][law])
        summ = compare_fct(f"6c {law}", fct, ref_fct, sizes)
        fst = sup.fig6_stats(fct.astype(np.float32), sizes)
        summ.update(run=f"6c {law}", law=law, wall_s=wall,
                    us_per_tick=wall / cfg.steps * 1e6, launches=counts,
                    **{k: fst[k] for k in ("short_p999_us", "med_p999_us",
                                           "long_p999_us")})
        summaries.append(summ)
        log(f"[fig6] {law} megakernel, {cfg.steps} ticks, {slots} slots: "
            f"wall {wall:.3f} s ({summ['us_per_tick']:.3f} us/tick), "
            f"completed {summ['completed']}/{n} (the reference's set), "
            f"p99.9 short {fst['short_p999_us']!r} us (reference "
            f"{fref['stats'][law]['short_p999_us']!r}, rel err "
            f"{summ['p999_rel_err']:.3g}), medium {fst['med_p999_us']!r}, "
            f"long {fst['long_p999_us']!r}; launches {counts}")
    claims = sup.fig6_claims(stats)
    log(f"[fig6] claims_hold {claims} (reference {ref['claims_hold']})")
    if claims != ref["claims_hold"]:
        raise AssertionError("fig6 claims_hold differs from the reference's")
    log("[fig6] " + json.dumps({"fig6_paper": {
        "claims_hold": claims, "runs": summaries}}))
    for row in rows.values():
        row["max_abs_err"] = err
    return launches, rows, summaries


# -------------------------------------------------------------------------
# phase 6d: benchmarks/fig8_rdcn.py::run (Fig. 8, the RDCN case study)
# on K4
# -------------------------------------------------------------------------

# ticks over which each law group's K4 run is held to the eager padded
# reference (both schedules' first edges: slot 0 at ticks 225 and 245,
# slot 6 at 1 470 and 1 695), and launches over which K4 is held to its
# plain tick
FIG8_EAGER_TICKS = 2000
FIG8_PLAIN_LAUNCHES = 3
# the fused runs over the first week: the PowerTCP laws, held to the
# reference's first-week metrics at smoke_rdcn's utilization gate and a
# p99 tolerance
FIG8_FUSED_LAWS = ("powertcp", "theta_powertcp")
FIG8_FUSED_UTIL_ABS = 5e-3
FIG8_FUSED_P99_RTOL = 1e-3
FIG8_RTOL = 1e-5


def fig8_schedule_probe(torch, tc, dev, ref, scheds):
    """(i) K4's schedule evaluation (``fused_tick.schedule``, compiled with
    K4's flags) over every tick of the run, for each schedule and
    prebuffer: the VOQ's rate bit for bit ``circuit_bw_at``'s on the card
    and reTCP's scaling flag ``circuit_up(t + prebuffer) | circuit_up(t)``.
    Returns the number of up ticks of each schedule."""
    from repro_torch.core import rdcn
    from repro_torch.kernels import fused_tick as ft
    T, dt = ref["steps"], ref["dt_s"]
    t = torch.arange(T, dtype=torch.int32, device=dev).to(
        torch.float32) * np.float32(dt)
    ups = []
    for sc in scheds:
        p = sc.params(dev)
        want_bw = tc.circuit_bw_at(t, p)[:, 0]
        row = torch.stack(list(p))[None].contiguous()
        for pb in ref["prebuffers_s"]:
            bw, on = ft.schedule(row, 0, T, dt, torch.full(
                (1,), pb, dtype=torch.float32, device=dev))
            want_on = (tc.circuit_up(rdcn._plus_prebuffer(t, pb), p)
                       | tc.circuit_up(t, p))
            if not torch.equal(bw[0], want_bw) or \
                    not torch.equal(on[0].bool(), want_on):
                raise AssertionError(f"K4's schedule (slot {sc.slot}, "
                                     f"prebuffer {pb}) differs from "
                                     f"circuit_bw_at on the card")
        ups.append(int((want_bw == p.circuit_bw).sum()))
    return ups


def fig8_records_equal(got, want, what):
    """Two runs' records (a batch's), every field bit for bit (K4 adds the
    per-tick sums ``w_sum`` and ``lam`` in the plain tick's order).
    Returns the largest absolute difference in those sums (0.0)."""
    import torch
    err = 0.0
    for f in want._fields:
        g = getattr(got, f)
        w = getattr(want, f).to(device=g.device, dtype=g.dtype)
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m, n=f: f"{what} rec.{n}: {m}")
        if f in ("w_sum", "lam") and g.numel():
            err = max(err, float(torch.nan_to_num(
                (g.double() - w.double()).abs().max())))
    return err


def phase_fig8(torch, tc, kernels, sup, dev, smi):
    """Phase 6d: ``benchmarks/fig8_rdcn.py::run`` (quick=False) on K4 (see
    the module docstring). Returns (launches, K4's rows by law group,
    the error in the record sums)."""
    from repro_torch.core import fluid, megakernel as mk
    from repro_torch.core.types import scenario
    with open(sup.FIG8_REF) as f:
        ref = json.load(f)
    topo, flows, cfg, scheds = sup.fig8_scenario(tc, device=dev)
    if cfg.steps != ref["steps"] or cfg.hist != ref["hist"]:
        raise AssertionError("the port's Fig. 8 scenario differs from the "
                             "reference's")
    T, Q, week = cfg.steps, topo.num_queues, ref["week_ticks"]
    by_slot = {sc.slot: sc for sc in scheds}
    want = {(p["name"], p["slot"]): p for p in ref["points"]}
    t0 = time.perf_counter()
    ups = fig8_schedule_probe(torch, tc, dev, ref, scheds)
    log(f"[fig8] K4's schedule, {T} ticks, slots {list(by_slot)} x "
        f"prebuffers {ref['prebuffers_s']}: bitwise circuit_bw_at and "
        f"circuit_up on the card ({ups} up ticks)")
    src = tc.make_schedule(flows)
    slots = int(flows.tau.shape[0])
    launches = {k: 0 for k in kernels.LAUNCHES}
    rows, metrics, err = {}, {}, 0.0
    for law, pbs in sup.FIG8_GROUPS:
        pts, lcfg, bwp = sup.fig8_group(tc, law, pbs, src, scheds,
                                        device=dev)
        B = len(pts)
        sb = tc.stack_flow_schedules([src] * B, Q)
        bw = dict(bw_fn=tc.circuit_bw_at, bw_params=bwp)
        # (iii) K4 against its plain tick and the eager padded reference
        g0 = time.perf_counter()
        for gate in (True, False):
            err = max(err, sup.k4_grid_against_plain(
                tc, topo, sb, cfg._replace(steps=FIG8_PLAIN_LAUNCHES * 64),
                law, slots, (64,), gate=gate, law_cfg=lcfg, **bw))
        ecfg = cfg._replace(steps=FIG8_EAGER_TICKS)
        _, plcfg, _ = sup.fig8_group(tc, law, pbs, flows, scheds,
                                     device=dev)
        _, prec = tc.simulate_batch(topo, tc.stack_flows([flows] * B, Q),
                                    law, plcfg, ecfg, device=dev, **bw)
        for gate in (True, False):
            sim = fluid.make_slot_sim(topo, sb, law, slots, lcfg, ecfg,
                                      "megakernel", dev)
            _, krec = mk.simulate_slots_mega(sim, gate=gate, **bw)
            err = max(err, fig8_records_equal(
                krec, prec, f"6d {law} K4 gate={gate} against the padded "
                f"reference"))
        log(f"[fig8] {law}: K4 (B={B}, gate True and False) bitwise equal "
            f"to the plain tick over {FIG8_PLAIN_LAUNCHES} launches and to "
            f"the eager padded reference (simulate_batch) over "
            f"{FIG8_EAGER_TICKS} ticks ({time.perf_counter() - g0:.1f} s)")
        # (ii) the grid on K4, through the entry point
        (st, rec), wall, counts = timed_run(
            torch, kernels, f"6d {law}",
            {"fused_tick_block": -(-T // mk.DEFAULT_BLOCK)},
            lambda: tc.simulate_slots_batch(
                topo, sb, law, slots, lcfg, cfg, backend="megakernel",
                device=dev, **bw))
        for k, c in counts.items():
            launches[k] += c
        for b, (name, slot) in enumerate(pts):
            m = sup.fig8_metrics(tc, scenario(rec, b), by_slot[slot])
            w = want[(name, slot)]
            for k in ("util", "p99_s", "mean_q"):
                if not np.isclose(m[k], w[k], rtol=FIG8_RTOL, atol=0):
                    raise AssertionError(
                        f"6d {name} slot {slot}: {k} {m[k]!r} against the "
                        f"reference's {w[k]!r}")
            metrics[(name, slot)] = m
        # (v) K4's time at Fig. 8's shape
        row = k4_grid_timing(torch, fluid, mk, fluid.make_slot_sim(
            topo, sb, law, slots, lcfg, cfg, "megakernel", dev), cfg,
            -(-T // mk.DEFAULT_BLOCK), B, tag="fig8",
            bound_every=FIG6_BOUND_EVERY, **bw)
        row.update(wall_s=wall, wall_us_per_tick=wall / T * 1e6,
                   points=[f"{n}@{s}" for n, s in pts])
        rows[law] = row
        log(f"[fig8] {law} megakernel, {T} ticks, B={B}: wall {wall:.3f} s "
            f"({row['wall_us_per_tick']!r} us per tick of the batch); "
            + "; ".join(f"{n} slot {s}: util {metrics[(n, s)]['util']!r} "
                        f"p99 {metrics[(n, s)]['p99_s'] * 1e6!r} us"
                        for n, s in pts) + f"; launches {counts}; {smi}")
    # (iv) the fused backend over the first week
    fused_dev = {}
    for law in FIG8_FUSED_LAWS:
        pts, plcfg, bwp = sup.fig8_group(tc, law, (None,), flows, scheds,
                                         device=dev)
        wcfg = cfg._replace(steps=week)
        (_, rec), wall, counts = timed_run(
            torch, kernels, f"6d {law} fused",
            expected_launches(law, "fused", week),
            lambda: tc.simulate_batch(
                topo, tc.stack_flows([flows] * len(pts), Q), law,
                plcfg._replace(gamma=0.9), wcfg, bw_fn=tc.circuit_bw_at,
                bw_params=bwp, backend="fused", device=dev))
        for k, c in counts.items():
            launches[k] += c
        for b, (name, slot) in enumerate(pts):
            m = sup.fig8_metrics(tc, scenario(rec, b), by_slot[slot])
            w = want[(name, slot)]
            du = abs(m["util"] - w["week1_util"])
            dp = abs(m["p99_s"] - w["week1_p99_s"]) / w["week1_p99_s"]
            fused_dev[f"{name}@{slot}"] = dict(util_abs_err=du,
                                               p99_rel_err=dp)
            if du >= FIG8_FUSED_UTIL_ABS or dp >= FIG8_FUSED_P99_RTOL:
                raise AssertionError(
                    f"6d {name} fused slot {slot}: util {m['util']!r} p99 "
                    f"{m['p99_s']!r} against the reference's first week "
                    f"{w['week1_util']!r} / {w['week1_p99_s']!r}")
        log(f"[fig8] {law} fused, first week ({week} ticks, B=2): wall "
            f"{wall:.3f} s; " + "; ".join(
                f"{k}: |d util| {v['util_abs_err']!r}, p99 rel err "
                f"{v['p99_rel_err']!r}" for k, v in fused_dev.items()
                if k.startswith(law + "@")) + f"; launches {counts}")
    out = {}
    for (name, slot), m in metrics.items():
        if slot == 0:
            out[name] = m
    claims = sup.fig8_claims(out)
    log(f"[fig8] claims_hold {claims} (reference {ref['claims_hold']})")
    if claims != ref["claims_hold"]:
        raise AssertionError("fig8 claims_hold differs from the reference's")
    log("[fig8] " + json.dumps({"fig8": {
        "claims_hold": claims,
        "rows": [{"law": n, "circuit_util": m["util"],
                  "p99_qlat_us": m["p99_s"] * 1e6,
                  "mean_q_KB": m["mean_q"] / 1e3} for n, m in out.items()],
        "util_slotmean": {n: float(np.mean([metrics[(n, s)]["util"]
                                            for s in by_slot]))
                          for n in out},
        "fused_first_week": fused_dev}}))
    log(f"[fig8] phase 6d: {time.perf_counter() - t0:.1f} s")
    return launches, rows, err


# -------------------------------------------------------------------------
# phase 6e: benchmarks/feedback_fct.py::run (the feedback-channel laws on
# the k = 4 fat-tree) on K4
# -------------------------------------------------------------------------

# ticks over which each feedback law's K4 run is held to the plain tick
# and the eager reference slot engine (1 200 until the LM phases 8b and 9d were added)
FEEDBACK_CHECK_TICKS = 800
# a run's FCTs against repro's
FEEDBACK_RTOL = 1e-5


def phase_feedback(torch, tc, kernels, sup, dev, smi):
    """Phase 6e: ``benchmarks/feedback_fct.py::run`` (quick=False) on K4
    (see the module docstring). Returns (launches, K4's rows by law and
    leg, the error in the record sums)."""
    with open(sup.FEEDBACK_REF) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    legs = {}
    for leg in sup.FEEDBACK_LEGS:
        topo, sched, cfg, slots, bqs = sup.feedback_scenario(tc, leg,
                                                             device=dev)
        w = ref["legs"][leg]
        got = (int(sched.start.shape[0]), slots, cfg.steps, list(bqs),
               sup.schedule_checksum(sched.size.cpu().numpy(),
                                     sched.start.cpu().numpy()))
        if got != (w["n_flows"], w["slots"], w["steps"], w["victim_queues"],
                   w["schedule_sha256"]):
            raise AssertionError(f"6e {leg}: the port's scenario {got[:4]} "
                                 f"differs from the reference's")
        legs[leg] = (topo, sched, cfg, slots)
    topo = legs["ws"][0]
    # (i) each feedback law's K4 on the fat tree, both legs as one batch
    # (a slot per flow of the larger leg), gate True and False, against
    # the plain tick and the eager reference slot engine
    sb = tc.stack_flow_schedules([legs[g][1] for g in sup.FEEDBACK_LEGS],
                                 topo.num_queues)
    S = max(legs[g][3] for g in sup.FEEDBACK_LEGS)
    ccfg = legs["ws"][2]._replace(steps=FEEDBACK_CHECK_TICKS)
    err = 0.0
    for law in sup.FEEDBACK_LAWS:
        c0 = time.perf_counter()
        err = max(err, sup.k4_grid_against_plain(
            tc, topo, sb, ccfg, law, S, (64,), k4_gates=(True, False),
            expected_flows=sup.FEEDBACK_EXPECTED_FLOWS))
        done = sup.k4_batch_against_reference(
            tc, topo, sb, ccfg, law, S,
            expected_flows=sup.FEEDBACK_EXPECTED_FLOWS, gates=(True, False))
        log(f"[feedback] {law}: K4 (both legs, B=2, S={S}, H=5, gate True "
            f"and False) bitwise equal to the plain tick and to the eager "
            f"reference slot engine over {FEEDBACK_CHECK_TICKS} ticks "
            f"({done} flows done) ({time.perf_counter() - c0:.1f} s)")
    # (ii) the seven laws of run through the entry point, each leg whole
    launches = {k: 0 for k in kernels.LAUNCHES}
    stats, runs = [], []
    for leg, (topo, sched, cfg, slots) in legs.items():
        n = int(sched.start.shape[0])
        sizes = sched.size.double().cpu().numpy()
        sbl = tc.stack_flow_schedules([sched], topo.num_queues)
        for law in sup.FEEDBACK_LAWS + sup.FEEDBACK_BASELINES:
            (st, _), wall, counts = timed_run(
                torch, kernels, f"6e {leg} {law}",
                expected_launches(law, "megakernel", cfg.steps),
                lambda law=law: tc.simulate_slots_batch(
                    topo, sbl, law, slots, cfg=cfg, record=False,
                    backend="megakernel",
                    expected_flows=sup.FEEDBACK_EXPECTED_FLOWS, device=dev))
            for k, c in counts.items():
                launches[k] += c
            fct = st.fct[0, :n].double().cpu().numpy()
            want = ref["legs"][leg]["runs"][law]
            ref_fct = fcts_of(want["fct_s"])
            done = np.isfinite(fct)
            if not np.array_equal(done, np.isfinite(ref_fct)):
                raise AssertionError(f"6e {leg} {law}: completion set "
                                     f"differs from the reference's")
            rel = float(np.max(np.abs(fct[done] - ref_fct[done])
                               / ref_fct[done])) if done.any() else 0.0
            if not rel <= FEEDBACK_RTOL:
                raise AssertionError(f"6e {leg} {law}: FCT rel err {rel} "
                                     f"against the reference's")
            st_us = sup.feedback_fct_us(fct.astype(np.float32), sizes)
            stats.append(st_us)
            runs.append(dict(leg=leg, law=law, wall_s=wall,
                             us_per_tick=wall / cfg.steps * 1e6,
                             fct_max_rel_err=rel, launches=counts, **st_us))
            log(f"[feedback] {leg} {law} megakernel, {cfg.steps} ticks, "
                f"{slots} slots: wall {wall:.3f} s, completed "
                f"{st_us['completed']}/{n} (the reference's set), largest "
                f"FCT rel err {rel!r}, mean FCT {st_us['all_mean']!r} us "
                f"(reference {want['stats']['all_mean']!r}), p99.9 "
                f"{st_us['all_p']!r} us; launches {counts}")
    verdict = sup.feedback_verdict(stats)
    log(f"[feedback] run's verdict {verdict} (reference {ref['verdict']})")
    if verdict != ref["verdict"]:
        raise AssertionError("feedback_fct.run's verdict differs from the "
                             "reference's")
    log("[feedback] " + json.dumps({"feedback": {"verdict": verdict,
                                                 "runs": runs}}))
    # (iii) each feedback law's K4 timed over each leg's whole run
    rows = {}
    for leg, (topo, sched, cfg, slots) in legs.items():
        for law in sup.FEEDBACK_LAWS:
            row = k4_law_timing(torch, tc, sup, dev, topo, sched, cfg,
                                slots, law)
            row["max_abs_err"] = err
            rows[f"{law}@{leg}"] = row
            log(f"[feedback] time K4 {law} {leg} ({row['shape']}, "
                f"{row['launches']} launches, the whole {cfg.steps}-tick "
                f"run): mean {row['ms']!r} ms per launch "
                f"({row['us_per_tick']!r} us per tick), median "
                f"{row['ms_p50']!r}; plain block at the middle launch "
                f"{row['plain_ms']!r} ms (bitwise equal); bound mean "
                f"{row['bound_ms']!r} ms ({row['bound_by']}); {smi}")
    log(f"[feedback] phase 6e: {time.perf_counter() - t0:.1f} s")
    return launches, rows, err


# -------------------------------------------------------------------------
# phase 6f: per-link impairments (benchmarks/impair_fct.py) on K4
# -------------------------------------------------------------------------

# ticks over which the impaired K4 runs are held to the plain tick and
# the eager reference engines (1 200 until the LM phases 8b and 9d were added)
IMPAIR_CHECK_TICKS = 800
# a run's FCTs against repro's
IMPAIR_RTOL = 1e-5


def impair_probe(torch, tc, sup, dev, T=8000):
    """K4's evaluation of a regime alone (``fused_tick.impair``, compiled
    with K4's flags) against ``core/impair.py`` on the card, bit for bit
    over ticks 0 .. T - 1: phase 6f's four regimes of the fat tree as one
    stacked [4, 10, Q] regime, the paper fabric's, and one of every
    process and loss kind (zero periods, phases before t = 0, seeds above
    2^31). Returns the number of (tick, queue) values held."""
    from repro_torch.core import impair as ti, megakernel as mk
    from repro_torch.kernels import fused_tick as ft
    rows, bw = sup.impair_kind_rows()
    every = ti._params_from_procs([ti.LinkProcess(**r) for r in rows], bw,
                                  device=dev)
    ft4 = tc.fat_tree(4)
    four = tc.stack_impairments(list(sup.impair_regimes(
        tc, ft4, device=dev).values()))
    paper = sup.impair_paper_scenario(tc, device=dev)[-1]
    held = 0
    for name, reg in (("the fat tree's four regimes", four),
                      ("the paper fabric's", paper), ("every kind", every)):
        Q = int(reg.kind.shape[-1])
        lead = tuple(reg.kind.shape[:-1])
        B = lead[0] if lead else 1
        imp = mk._k4_impair(reg, B, Q, dev)
        gb, gk, gj = ft.impair(imp, 0, T, 1e-6)
        t = (torch.arange(T, device=dev).to(torch.float32) * 1e-6)[:, None]
        for b in range(B):
            p = ti.ImpairmentParams(*[x[b] for x in reg]) if lead else reg
            keep, jit = ti.impair_vectors(t, p)
            for g, w, what in ((gb[b], ti.link_bw_at(t, p), "rate"),
                               (gk[b], keep[..., :Q], "survival fraction"),
                               (gj[b], jit[..., :Q], "jitter")):
                if not torch.equal(g, w):
                    bad = int((g != w).sum())
                    raise AssertionError(f"K4's impairment evaluation "
                                         f"({name}, {what}) differs from "
                                         f"core/impair.py at {bad} values")
            held += T * Q
        log(f"[k4] impairment evaluation ({name}, {B} x {Q} queues, ticks "
            f"0-{T - 1}): rate, survival fraction and jitter bitwise equal "
            f"to core/impair.py")
    return held


def impair_fcts(key, fct, want, rtol=IMPAIR_RTOL):
    """A run's FCTs (schedule order) against ``repro``'s: the same
    completion set and every FCT within ``rtol``. Returns the largest
    relative error."""
    ref_fct = fcts_of(want)
    done = np.isfinite(fct)
    if not np.array_equal(done, np.isfinite(ref_fct)):
        raise AssertionError(f"6f {key}: completion set differs from the "
                             f"reference's")
    rel = float(np.max(np.abs(fct[done] - ref_fct[done]) / ref_fct[done])) \
        if done.any() else 0.0
    if not rel <= rtol:
        raise AssertionError(f"6f {key}: FCT rel err {rel} against the "
                             f"reference's")
    return rel


def golden_in_flow_order(sup, sched, st, rec):
    """A slot run (S >= N) of the golden scenario in the golden file's
    layout (``sup.pack``): its FCTs and final windows taken back to flow
    order."""
    import torch
    order = sched.order.long()
    fct = torch.empty_like(st.fct)
    fct[order] = st.fct
    w = torch.empty_like(st.w[:order.shape[0]])
    w[order] = st.w[:order.shape[0]]
    return sup.pack(st._replace(fct=fct, w=w), rec)


def phase_impair(torch, tc, kernels, sup, dev, smi):
    """Phase 6f: per-link impairments on K4 (see the module docstring).
    Returns (launches, K4's rows by run, K4's FCTs by (law, regime) of
    the anchor, K4's FCTs by law of the paper fabric's impaired pass)."""
    with open(sup.IMPAIR_REF) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    launches = {k: 0 for k in kernels.LAUNCHES}

    def count(c):
        for k, n in c.items():
            launches[k] += n

    # (1) the golden "impair" legs, 13 laws, the slot engine on K4
    golden = sup.golden()
    for law in sorted(golden):
        topo, flows, lcfg, cfg = sup.golden_scenario(tc, device=dev)
        if law == "retcp":
            lcfg = lcfg._replace(sched=tc.CircuitSchedule(
                day=50e-6, night=10e-6, matchings=2).params(dev))
        reg = sup.golden_impair_regime(tc, topo, device=dev)
        sched = tc.make_schedule(flows)
        n = int(sched.start.shape[0])
        (st, rec), _, c = timed_run(
            torch, kernels, f"6f golden {law}",
            expected_launches(law, "megakernel", cfg.steps),
            lambda: tc.simulate_slots(topo, sched, law, n, lcfg, cfg,
                                      backend="megakernel", impair=reg,
                                      device=dev))
        count(c)
        got = golden_in_flow_order(sup, sched, st, rec)
        sup.check_golden(law, got, golden[law]["impair"], leg="[impair]")
        if got["q"] == golden[law]["q"]:
            raise AssertionError(f"6f golden {law}: the regime was a no-op")
    log(f"[impair] the golden traces' impaired leg, 13 laws, slot engine "
        f"on K4: within the golden tolerances, each unlike its clean leg")

    # (2) smoke_impair's anchor under the mixed regime
    topo, sched, cfg, S, regimes = sup.impair_anchor_scenario(tc,
                                                              device=dev)
    meta = ref["anchor"]["scenario"]
    got = dict(n_flows=int(sched.start.shape[0]), slots=S, steps=cfg.steps,
               schedule_sha256=sup.schedule_checksum(
                   sched.size.cpu().numpy(), sched.start.cpu().numpy()))
    if got != meta:
        raise AssertionError(f"6f: the port's anchor {got} differs from the "
                             f"reference's {meta}")
    sb = tc.stack_flow_schedules([sched], topo.num_queues)
    mixed = tc.stack_impairments([regimes["mixed"]])
    ccfg = cfg._replace(steps=IMPAIR_CHECK_TICKS)
    ef = sup.IMPAIR_EXPECTED_FLOWS
    for law in sup.IMPAIR_LAWS:
        c0 = time.perf_counter()
        gates = (True, False) if law == "powertcp" else (True,)
        sup.k4_grid_against_plain(tc, topo, sb, ccfg, law, S, (64,),
                                  k4_gates=gates, expected_flows=ef,
                                  impair=mixed)
        log(f"[impair] {law}: K4 (mixed regime, S={S}, H=5, gate "
            f"{' and '.join(map(str, gates))}) bitwise equal to the plain "
            f"tick over {IMPAIR_CHECK_TICKS} ticks "
            f"({time.perf_counter() - c0:.1f} s)")
    runs, rows, k4_fct = [], {}, {}
    n = meta["n_flows"]
    for law in sup.IMPAIR_LAWS:
        (st, _), wall, c = timed_run(
            torch, kernels, f"6f anchor {law}",
            expected_launches(law, "megakernel", cfg.steps),
            lambda law=law: tc.simulate_slots_batch(
                topo, sb, law, S, cfg=cfg, record=False,
                backend="megakernel", expected_flows=ef,
                impair_params=mixed, device=dev))
        count(c)
        k4_fct[(law, "mixed")] = st.fct[0, :n].clone()
        fct = st.fct[0, :n].double().cpu().numpy()
        rel = impair_fcts(f"anchor {law}", fct, ref["anchor"]["fct_s"][law])
        runs.append(dict(run="anchor", law=law, wall_s=wall,
                         fct_max_rel_err=rel, launches=c,
                         completed=int(np.isfinite(fct).sum())))
        log(f"[impair] anchor {law} megakernel (mixed), {cfg.steps} ticks, "
            f"{S} slots: wall {wall:.3f} s, completed "
            f"{runs[-1]['completed']}/{n} (the reference's set), largest "
            f"FCT rel err {rel!r}; launches {c}")
        row = k4_law_timing(torch, tc, sup, dev, topo, sched, cfg, S, law,
                            impair=regimes["mixed"])
        rows[f"{law}@anchor"] = row
        log(f"[impair] time K4 {law} anchor mixed ({row['shape']}, "
            f"{row['launches']} launches): mean {row['ms']!r} ms per launch "
            f"({row['us_per_tick']!r} us per tick), median "
            f"{row['ms_p50']!r}; plain block at the middle launch "
            f"{row['plain_ms']!r} ms (bitwise equal); bound mean "
            f"{row['bound_ms']!r} ms ({row['bound_by']}); {smi}")

    # (3) the four regimes as one batch: one K4 grid launch of 4 blocks
    names = list(sup.IMPAIR_REGIMES)
    s4 = tc.stack_flow_schedules([sched] * len(names), topo.num_queues)
    r4 = tc.stack_impairments([regimes[r] for r in names])
    (st4, rec4), wall, c = timed_run(
        torch, kernels, "6f regimes",
        expected_launches("powertcp", "megakernel", cfg.steps),
        lambda: tc.simulate_slots_batch(
            topo, s4, "powertcp", S, cfg=cfg, backend="megakernel",
            expected_flows=ef, impair_params=r4, device=dev))
    count(c)
    means = {}
    for b, r in enumerate(names):
        k4_fct[("powertcp", r)] = st4.fct[b, :n].clone()
        fct = st4.fct[b, :n].double().cpu().numpy()
        rel = impair_fcts(f"regime {r}", fct,
                          ref["regimes"]["fct_s"][r])
        means[r] = float(np.mean(fct[np.isfinite(fct)]) * 1e6)
        runs.append(dict(run="regimes", regime=r, law="powertcp",
                         fct_max_rel_err=rel,
                         fct_impair_mean_us=means[r]))
    (stc, recc), _, c = timed_run(
        torch, kernels, "6f clean",
        expected_launches("powertcp", "megakernel", cfg.steps),
        lambda: tc.simulate_slots_batch(
            topo, sb, "powertcp", S, cfg=cfg, backend="megakernel",
            expected_flows=ef, device=dev))
    count(c)
    b = names.index("clean")
    torch.testing.assert_close(st4.fct[b], stc.fct[0], rtol=0, atol=0,
                               equal_nan=True)
    fig8_records_equal(type(rec4)(*[x[b:b + 1] for x in rec4]), recc,
                       "6f clean regime against the unimpaired K4 run")
    log(f"[impair] the four regimes as one batch (powertcp, one K4 launch "
        f"of {len(names)} blocks per 64 ticks, {c['fused_tick_block']} "
        f"launches): each within rtol {IMPAIR_RTOL} of the reference; mean "
        f"FCT (us) {means}; the clean scenario bitwise the unimpaired K4 "
        f"run (every record and FCT); wall {wall:.3f} s")
    row = k4_law_timing(torch, tc, sup, dev, topo, s4, cfg, S, "powertcp",
                        impair=r4)
    rows["powertcp@regimes"] = row
    log(f"[impair] time K4 powertcp, the four regimes ({row['shape']}, B=4, "
        f"{row['launches']} launches): mean {row['ms']!r} ms per launch "
        f"({row['us_per_tick']!r} us per tick); bound mean "
        f"{row['bound_ms']!r} ms; {smi}")

    # (4) the paper's 256-host fabric, impaired
    ptopo, psched, pcfg, pS, preg = sup.impair_paper_scenario(tc,
                                                              device=dev)
    pmeta = ref["paper"]["scenario"]
    got = dict(n_flows=int(psched.start.shape[0]), slots=pS,
               steps=pcfg.steps, schedule_sha256=sup.schedule_checksum(
                   psched.size.cpu().numpy(), psched.start.cpu().numpy()))
    if got != pmeta:
        raise AssertionError(f"6f: the port's paper scenario {got} differs "
                             f"from the reference's {pmeta}")
    psb = tc.stack_flow_schedules([psched], ptopo.num_queues)
    pn = pmeta["n_flows"]
    paper_fct = {}
    for law in sup.IMPAIR_PAPER_LAWS:
        (st, _), wall, c = timed_run(
            torch, kernels, f"6f paper {law}",
            expected_launches(law, "megakernel", pcfg.steps),
            lambda law=law: tc.simulate_slots_batch(
                ptopo, psb, law, pS, cfg=pcfg, record=False,
                backend="megakernel", expected_flows=ef,
                impair_params=preg, device=dev))
        count(c)
        paper_fct[law] = st.fct[0, :pn].clone()
        fct = st.fct[0, :pn].double().cpu().numpy()
        rel = impair_fcts(f"paper {law}", fct, ref["paper"]["fct_s"][law])
        runs.append(dict(run="paper", law=law, wall_s=wall,
                         fct_max_rel_err=rel, launches=c,
                         completed=int(np.isfinite(fct).sum())))
        row = k4_law_timing(torch, tc, sup, dev, ptopo, psched, pcfg, pS,
                            law, impair=preg)
        rows[f"{law}@paper"] = row
        log(f"[impair] paper fabric {law} megakernel (mixed), "
            f"{pcfg.steps} ticks, {pS} slots: completed "
            f"{runs[-1]['completed']}/{pn} (the reference's set), largest "
            f"FCT rel err {rel!r}; K4 ({row['shape']}) mean {row['ms']!r} "
            f"ms per launch ({row['us_per_tick']!r} us per tick), bound "
            f"{row['bound_ms']!r} ms; {smi}")

    # (5) one impaired run of each eager engine against K4
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=ef)
    mixed1 = regimes["mixed"]
    (kst, krec), _, c = timed_run(
        torch, kernels, "6f eager check, K4",
        expected_launches("powertcp", "megakernel", ccfg.steps),
        lambda: tc.simulate_slots(topo, sched, "powertcp", S, lcfg, ccfg,
                                  backend="megakernel", impair=mixed1,
                                  device=dev))
    count(c)
    for what, fn in (
            ("slot reference", lambda: tc.simulate_slots(
                topo, sched, "powertcp", S, lcfg, ccfg, impair=mixed1,
                device=dev)),
            ("padded reference", lambda: tc.simulate(
                topo, tc.schedule_as_flows(sched), "powertcp", lcfg, ccfg,
                impair=mixed1, device=dev))):
        (est, erec), wall, _ = timed_run(torch, kernels, f"6f {what}", {},
                                         fn)
        torch.testing.assert_close(kst.fct, est.fct, rtol=0, atol=0,
                                   equal_nan=True,
                                   msg=lambda m, w=what: f"6f {w} fct: {m}")
        fig8_records_equal(krec, erec, f"6f K4 against the {what}")
        log(f"[impair] the eager {what} (mixed, powertcp, first "
            f"{IMPAIR_CHECK_TICKS} ticks, wall {wall:.1f} s): every record "
            f"field and FCT bitwise K4's "
            f"({int(torch.isfinite(kst.fct).sum())} flows done)")
    log("[impair] " + json.dumps({"impair": {"runs": runs}}))
    log("[impair] K4 us per tick: " + json.dumps(
        {k: v["us_per_tick"] for k, v in rows.items()}) + f"; {smi}")
    log(f"[impair] phase 6f: {time.perf_counter() - t0:.1f} s")
    return launches, rows, k4_fct, paper_fct


# -------------------------------------------------------------------------
# phase 6g: chunk-streamed K4, checkpoint/resume and a K4 sweep
# (benchmarks/fault_fct.py, benchmarks/impair_fct.py::run)
# -------------------------------------------------------------------------

# phase 6g's runs: fault_fct's chunk, the clamp floor (= S), run (e)'s
# chunk; K4 against the plain block on a window from the first boundary
# of the chunk-256 run, over FAULT_WINDOW_TICKS ticks
FAULT_CHUNKS = (2048, 256)
FAULT_MAIN_CHUNK = 512
FAULT_WINDOW_FROM = 2048
FAULT_WINDOW_TICKS = 2000
FAULT_WINDOW_LAWS = ("powertcp", "fncc")
FAULT_RTOL = 1e-5
FAULT_TIME_REPS = 3


def chunk_launches():
    """K4 launches a chunk-streamed megakernel run makes: one per 64 ticks
    of each segment (segments are powers of two), one for a shorter
    segment (``fluid.LAST_CHUNKED``, the run's segments)."""
    from repro_torch.core import fluid
    return sum(max(1, L // 64) for L in fluid.LAST_CHUNKED["ticks"])


def chunk_run(torch, kernels, key, fn, crash=None):
    """A chunk-streamed megakernel run with the launch counts zeroed just
    before and read just after: K4 and nothing else, one launch per 64
    ticks of every segment (so every segment ran on K4). ``crash`` is the
    ``InjectedCrash`` class the run must raise. Returns (result or the
    crash, wall seconds, launches, segments)."""
    from repro_torch.core import fluid
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if crash is None:
        out = fn()
    else:
        try:
            fn()
            raise AssertionError(f"run ({key}): the injected crash did "
                                 f"not fire")
        except crash as e:
            out = e
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {"fused_tick_block": chunk_launches()}
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"run ({key}): {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")
    return out, wall, launches, fluid.LAST_CHUNKED["segments"]


def k4_device_us(torch, fn):
    """K4's device time (us) in ``fn()`` from ``torch.profiler``: the sum of
    the self device time of the kernels named ``fused_tick``; None where
    the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "fused_tick" in e.key)
    return us or None


def phase_fault(torch, tc, kernels, sup, dev, smi, main_final, impair_fct):
    """Phase 6g: chunk-streamed K4, checkpoint/resume and a K4 sweep (see
    the module docstring). ``main_final`` is run (e)'s final state (phase
    6), ``impair_fct`` phase 6f's K4 FCTs by (law, regime). Returns
    (launches, K4's rows, the K4 sweep's FCTs by point)."""
    import tempfile
    from repro_torch.core import fluid
    with open(sup.FAULT_REF) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    launches = {k: 0 for k in kernels.LAUNCHES}

    def count(c):
        for k, n in c.items():
            launches[k] += n

    def bitmatch(got, want, what):
        bad = sup.resume_mismatches(got[0], got[1], want[0], want[1])
        if bad:
            raise AssertionError(f"6g {what}: {bad} differ")

    # (a) fault_fct.crash_resume_paper_scale at full size
    topo, sched, cfg, S, every, crash = sup.fault_scenario(tc, device=dev)
    n = int(sched.start.shape[0])
    got = dict(n_flows=n, slots=S, steps=cfg.steps, every=every,
               crash=crash, schedule_sha256=sup.schedule_checksum(
                   sched.size.cpu().numpy(), sched.start.cpu().numpy()))
    if got != ref["scenario"]:
        raise AssertionError(f"6g: the port's scenario {got} differs from "
                             f"the reference's {ref['scenario']}")
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=8.0)

    def run(chunk=None, record=True, **kw):
        return lambda: tc.simulate_slots(
            topo, sched, "powertcp", S, lcfg, cfg, record=record,
            backend="megakernel", chunk=chunk, device=dev, **kw)

    whole, _, c = timed_run(
        torch, kernels, "6g unchunked",
        expected_launches("powertcp", "megakernel", cfg.steps), run())
    count(c)
    chunked, _, c, segs = chunk_run(torch, kernels, "6g chunk 2048",
                                    run(FAULT_CHUNKS[0]))
    count(c)
    bitmatch(chunked, whole, f"chunk {FAULT_CHUNKS[0]} against unchunked")
    fct = whole[0].fct.double().cpu().numpy()
    want = np.array([np.nan if x is None else x for x in ref["fct_s"]])
    if not np.array_equal(np.isfinite(fct), np.isfinite(want)):
        raise AssertionError(f"6g: completion set {int(np.isfinite(fct).sum())}"
                             f" differs from the reference's "
                             f"{int(np.isfinite(want).sum())}")
    done = np.isfinite(want)
    rel = float(np.max(np.abs(fct[done] - want[done]) / want[done]))
    if not rel <= FAULT_RTOL:
        raise AssertionError(f"6g: FCT rel err {rel} against the golden")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as d:
        ck = tc.CheckpointSpec(path=os.path.join(d, "ck"), every=every,
                               keep=2)
        e, _, c, _ = chunk_run(
            torch, kernels, "6g crash",
            run(FAULT_CHUNKS[0], checkpoint=ck,
                faults=tc.crash_at_tick(crash)), crash=tc.InjectedCrash)
        count(c)
        if e.tick != crash:
            raise AssertionError(f"6g: the crash fired at {e.tick}, not "
                                 f"{crash}")
        resume_tick = tc.latest_checkpoint(ck.path)
        if resume_tick != every:
            raise AssertionError(f"6g: the newest snapshot is at "
                                 f"{resume_tick}, not {every}")
        resumed, wall_r, c, _ = chunk_run(
            torch, kernels, "6g resume",
            lambda: tc.resume_slots(topo, sched, "powertcp", S, ck,
                                    law_cfg=lcfg, cfg=cfg,
                                    backend="megakernel",
                                    chunk=FAULT_CHUNKS[0], device=dev))
        count(c)
    bitmatch(resumed, chunked, "resumed against uninterrupted")
    if int(resumed[1].q.shape[0]) != cfg.steps:
        raise AssertionError("6g: the resumed record does not start at 0")
    log(f"[fault] (a) fault_fct's paper scale ({n} flows, {S} slots, "
        f"{cfg.steps} ticks): chunk {FAULT_CHUNKS[0]} ({segs} segments) "
        f"bitwise the unchunked K4 run; crash at {crash}, resumed from "
        f"{resume_tick} (wall {wall_r:.3f} s) bitwise the uninterrupted "
        f"run, its record from tick 0; completion set the reference's "
        f"({int(done.sum())}/{n}), largest FCT rel err {rel!r}")

    # (b) the clamp floor: C = S, narrower than the schedule
    chunked, _, c, segs = chunk_run(torch, kernels, "6g chunk 256",
                                    run(FAULT_CHUNKS[1]))
    count(c)
    offs = list(fluid.LAST_CHUNKED["win_off"])
    bitmatch(chunked, whole, f"chunk {FAULT_CHUNKS[1]} against unchunked")
    guarded, _, c, _ = chunk_run(torch, kernels, "6g chunk 256 guarded",
                                 run(FAULT_CHUNKS[1], guard=True))
    count(c)
    bitmatch(guarded, whole, "guarded chunk 256 against unchunked")
    log(f"[fault] (b) chunk {FAULT_CHUNKS[1]} (C = S = {S} < N = {n}; "
        f"{segs} segments, window offsets {offs[0]}..{offs[-1]}): bitwise "
        f"the unchunked K4 run, and again with guard=True")

    # timing: the three runs without records, wall (the median of
    # FAULT_TIME_REPS runs) and K4's device time
    rows = {}
    for key, chunk in (("unchunked", None),) + tuple(
            (f"chunk {c_}", c_) for c_ in FAULT_CHUNKS):
        fn = run(chunk, record=False)
        walls = []
        for _ in range(FAULT_TIME_REPS):
            if chunk is None:
                _, wall, c = timed_run(
                    torch, kernels, f"6g time {key}",
                    expected_launches("powertcp", "megakernel", cfg.steps),
                    fn)
                segs = 1
            else:
                _, wall, c, segs = chunk_run(torch, kernels,
                                             f"6g time {key}", fn)
            walls.append(wall)
        count(c)
        wall = float(np.median(walls))
        dev_us = k4_device_us(torch, fn)
        rows[key] = dict(
            segments=segs, launches=c["fused_tick_block"],
            wall_us_per_tick=wall / cfg.steps * 1e6,
            device_us_per_tick=(None if dev_us is None
                                else dev_us / cfg.steps))
    base = rows["unchunked"]
    for key, row in rows.items():
        row["wall_over_unchunked"] = (row["wall_us_per_tick"]
                                      / base["wall_us_per_tick"])
        row["device_over_unchunked"] = (
            None if row["device_us_per_tick"] is None
            or base["device_us_per_tick"] is None
            else row["device_us_per_tick"] / base["device_us_per_tick"])
        log(f"[fault] time {key}: {row['segments']} segments, "
            f"{row['launches']} K4 launches, wall "
            f"{row['wall_us_per_tick']!r} us/tick "
            f"({row['wall_over_unchunked']!r} of unchunked), K4 device "
            f"{row['device_us_per_tick']!r} us/tick "
            f"({row['device_over_unchunked']!r}); {smi}")

    # (c) run (e)'s scenario, chunk 512: bitwise run (e) of phase 6
    with open(sup.PAPER_REF) as f:
        pref = json.load(f)
    ptopo, psched = paper_scenario(tc, sup, dev, pref)
    pcfg = tc.SimConfig(dt=pref["dt_s"], steps=pref["steps"],
                        hist=pref["hist"],
                        update_period=pref["update_period_s"])
    plcfg = tc.default_law_config(psched,
                                  expected_flows=pref["expected_flows"])
    (pst, _), wall, c, segs = chunk_run(
        torch, kernels, "6g (e) chunk 512",
        lambda: tc.simulate_slots(ptopo, psched, "powertcp", pref["slots"],
                                  plcfg, pcfg, record=False,
                                  backend="megakernel",
                                  chunk=FAULT_MAIN_CHUNK, device=dev))
    count(c)
    for (name, g), (_, w) in zip(sup.tree_leaves(pst),
                                 sup.tree_leaves(main_final)):
        torch.testing.assert_close(
            g, w, rtol=0, atol=0, equal_nan=True,
            msg=lambda m, nm=name: f"6g (c) against run (e) {nm}: {m}")
    rows[f"(e) chunk {FAULT_MAIN_CHUNK}"] = dict(
        segments=segs, launches=c["fused_tick_block"],
        wall_us_per_tick=wall / pcfg.steps * 1e6)
    log(f"[fault] (c) run (e)'s scenario ({int(psched.start.shape[0])} "
        f"flows, {pref['slots']} slots, {pcfg.steps} ticks), chunk "
        f"{FAULT_MAIN_CHUNK} ({segs} segments, {c['fused_tick_block']} K4 "
        f"launches, wall {wall / pcfg.steps * 1e6:.3f} us/tick): FCTs and "
        f"final carry bitwise run (e)'s")

    # (d) K4 on a window against the plain block
    for law in FAULT_WINDOW_LAWS:
        c0 = time.perf_counter()
        w0, C, N, _ = sup.k4_window_against_plain(
            tc, topo, sched, cfg, law, S, FAULT_CHUNKS[1], FAULT_WINDOW_FROM,
            FAULT_WINDOW_TICKS)
        log(f"[fault] (d) {law}: K4 on the window of {C} rows at {w0} (N = "
            f"{N}), ticks {FAULT_WINDOW_FROM}-"
            f"{FAULT_WINDOW_FROM + FAULT_WINDOW_TICKS - 1}, gate True and "
            f"False: bitwise the plain block "
            f"({time.perf_counter() - c0:.1f} s)")

    # (e) impair_fct.run(quick=False)'s grid through K4
    itopo, isched, icfg, iS, regimes = sup.impair_anchor_scenario(
        tc, device=dev)
    names = list(sup.IMPAIR_REGIMES)
    spec = tc.SweepSpec(laws=list(sup.IMPAIR_LAWS),
                        flows=[tc.schedule_as_flows(isched)],
                        impairments=[regimes[r] for r in names],
                        expected_flows=sup.IMPAIR_EXPECTED_FLOWS,
                        slots=int(tc.suggest_slots(isched, icfg.dt)),
                        backend="megakernel")
    res, wall, c = timed_run(
        torch, kernels, "6g sweep",
        {"fused_tick_block": len(spec.laws) * -(-icfg.steps // 64)},
        lambda: tc.run_sweep(spec, itopo, icfg, record=False,
                             fault_tolerant=True, device=dev))
    count(c)
    if res.fallbacks != () or res.failures != ():
        raise AssertionError(f"6g sweep: fallbacks {res.fallbacks}, "
                             f"failures {res.failures}")
    held, verdict = 0, True
    ni = int(isched.start.shape[0])
    sweep_fct = {}
    for p in res.points:
        got = res.state(p.index).fct[:ni]
        sweep_fct[p.index] = got.clone()
        key = (p.law, names[p.impair_idx])
        if key in impair_fct:
            torch.testing.assert_close(
                got, impair_fct[key], rtol=0, atol=0, equal_nan=True,
                msg=lambda m, k=key: f"6g sweep {k} against 6f: {m}")
            held += 1
        verdict &= bool(torch.isfinite(got).any())
    if held != len(impair_fct) or not verdict:
        raise AssertionError(f"6g sweep: {held} points held to 6f, verdict "
                             f"{verdict}")
    log(f"[fault] (e) impair_fct.run's grid ({len(res.points)} points, "
        f"{len(spec.laws)} K4 grids of {len(names)} blocks, "
        f"{c['fused_tick_block']} launches, wall {wall:.3f} s) through "
        f"run_sweep(fault_tolerant=True): no fallback, no failure; "
        f"{held} points bitwise 6f's K4 runs; every point completes")

    # (f) fault_fct.guard_divergence, reference backend
    gtopo, gsched, gcfg = sup.bottleneck18(tc, hist=512, device=dev)
    bad = tc.poison_law("powertcp", at_t=sup.FAULT_GUARD_AT)
    try:
        tc.simulate_slots(gtopo, gsched, bad, 8, cfg=gcfg, chunk=8,
                          guard=True, device=dev)
        raise AssertionError("6g: the guarded poisoned run did not diverge")
    except tc.DivergenceError as e:
        diag = dict(law=e.law, tick=e.tick, field=e.field)
    if diag != ref["guard"]:
        raise AssertionError(f"6g: diagnosis {diag}, the reference's "
                             f"{ref['guard']}")
    gst, _ = tc.simulate_slots(gtopo, gsched, bad, 8, cfg=gcfg, chunk=8,
                               device=dev)
    field = tc.first_divergent_field(gst)
    if not field:
        raise AssertionError("6g: the unguarded poisoned run carried no NaN")
    log(f"[fault] (f) guard_divergence on the card: DivergenceError "
        f"{diag} (the reference's); unguarded, NaN carried through "
        f"('{field}')")
    log("[fault] " + json.dumps({"fault": rows}))
    log(f"[fault] phase 6g: {time.perf_counter() - t0:.1f} s")
    return launches, rows, sweep_fct


# -------------------------------------------------------------------------
# phase 6h: the sharded slot engine (core/shardslots.py) over
# torch.distributed, held bit for bit against K4
# -------------------------------------------------------------------------

# 6h.1's runs on the paper fabric's impaired pass: (law, impaired), over
# its first SHARD_PAPER_TICKS of 3 000 ticks
SHARD_PAPER_RUNS = (("powertcp", False), ("powertcp", True),
                    ("backpressure", True), ("pulser", True))
SHARD_PAPER_TICKS = 500
# 6h.2: fabric_fct.smoke_fabric16's pool, chunk and tick horizon, of
# which the first SHARD16_TICKS run
SHARD16_SLOTS, SHARD16_CHUNK, SHARD16_STEPS = 1024, 2048, 10_000
SHARD16_TICKS = 1000
# ticks of the sharded fabric16 run profiled for its device time (200
# until phase 9 was added)
SHARD16_PROFILE_TICKS = 50
# 6h.3: the two gloo ranks' run of 6h.1's impaired powertcp pass (500
# ticks until phase 9 was added)
SHARD_SPAWN_TICKS = 250


def fabric16_scenario(tc, dev):
    """``benchmarks/fabric_fct.py::fabric16_scenario`` and
    ``smoke_fabric16``'s run in the port: the k = 16 fat tree (1 024
    hosts, 5 120 queues), web-search at load 0.6 over 85 ms (seed 5) plus
    64 rotating incasts of 16 x 150 kB (seed 6, from 100 us), one
    time-sorted schedule; ``smoke_fabric16``'s degraded spine (every
    AGG <-> CORE link oscillating down to 40 GB/s over 500 us, seed 7;
    every other link 0.2% random loss, seed 13); its config cut to the
    first ``SHARD16_TICKS`` ticks. Returns (fabric, topology, schedule,
    config, law config, regime)."""
    import torch
    ft = tc.fat_tree(16)
    dt, duration = 1e-6, 0.085
    fw = tc.poisson_websearch(ft, 0.6, duration, dt, seed=5, device=dev)
    fi, _ = tc.incast_burst(ft, fan_in=16, req_bytes=1.5e5, n_bursts=64,
                            period=duration / 64, sim_dt=dt, seed=6,
                            start=1e-4, device=dev)
    sched = tc.make_schedule(tc.Flows(*[torch.cat([a, b])
                                        for a, b in zip(fw, fi)]))
    cfg = tc.SimConfig(dt=dt, steps=SHARD16_TICKS, hist=512,
                       update_period=2e-6)
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=8.0)
    agg, core = tc.fabric.AGG, tc.fabric.CORE
    spine = tc.LinkProcess(kind="oscillate", bw_lo=40e9, period=500e-6,
                           seed=7)
    imp = tc.fabric_impairments(
        ft, rules={(agg, core): spine, (core, agg): spine},
        default=tc.netem(loss=0.002, jitter=0.0, seed=13), device=dev)
    return ft, ft.topology(device=dev), sched, cfg, lcfg, imp


# the final-state leaves held between two runs (those of
# ``test_torch_support._same_state``: not the slots' retire bookkeeping,
# since K4 retires a drained slot on the tick it drains and the eager
# engines at the next admission, which changes no trajectory)
SAME_STATE = ("w", "rate_cap", "q", "out_rate", "remaining", "next_update",
              "last_update", "hist_lam", "hist_q", "hist_out", "hist_w",
              "law", "cursor", "fct", "pause", "hist_pause", "hist_inc")


def same_state(torch, sup, got, want, what):
    """Two final slot states, ``SAME_STATE``'s leaves bit for bit (NaN
    equal to NaN; the FCT tables cut to the shorter)."""
    for f in SAME_STATE:
        gl = sup.tree_leaves(getattr(got, f), f)
        wl = sup.tree_leaves(getattr(want, f), f)
        if len(gl) != len(wl):
            raise AssertionError(f"{what} {f}: {len(gl)} leaves against "
                                 f"{len(wl)}")
        for (name, g), (_, w) in zip(gl, wl):
            if f == "fct":
                n = min(g.shape[-1], w.shape[-1])
                g, w = g[..., :n], w[..., :n]
            torch.testing.assert_close(
                g, w.to(g.device), rtol=0, atol=0, equal_nan=True,
                msg=lambda m, n=name: f"{what} {n}: {m}")


def shard_rank(group, ticks, ef):
    """Phase 6h.3 on one of two gloo ranks sharing the card (spawned by
    ``shardcomm.spawn``): 6h.1's impaired powertcp pass over its first
    ``ticks`` ticks through the sharded engine, then ``impair_fct.run``'s
    grid as a K4 sweep split over the ranks (``run_sweep(devices=2)``).
    Returns, on the host, the run's state and record, its statistics,
    wall and launches, and the sweep's per-point FCTs, fallbacks,
    failures, wall and launches."""
    import torch
    import repro_torch.core as tc
    import test_torch_support as sup
    from repro_torch import kernels
    from repro_torch.core.shardslots import LAST_SHARDED
    from repro_torch.core.types import tree_map
    dev = group.device
    topo, sched, cfg, S, imp = sup.impair_paper_scenario(tc, device=dev)
    cfg = cfg._replace(steps=ticks)
    lcfg = tc.default_law_config(tc.schedule_as_flows(sched),
                                 expected_flows=ef)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, rec = tc.simulate_slots_sharded(topo, sched, "powertcp", S, lcfg,
                                        cfg, impair=imp, group=group,
                                        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    def host(tree):
        return tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                        else x, tree)

    run = dict(state=host(st), rec=host(rec), stats=dict(LAST_SHARDED),
               wall_s=wall, launches=dict(kernels.LAUNCHES))
    itopo, isched, icfg, _, regimes = sup.impair_anchor_scenario(tc,
                                                                 device=dev)
    spec = tc.SweepSpec(laws=list(sup.IMPAIR_LAWS),
                        flows=[tc.schedule_as_flows(isched)],
                        impairments=[regimes[r] for r in sup.IMPAIR_REGIMES],
                        expected_flows=ef,
                        slots=int(tc.suggest_slots(isched, icfg.dt)),
                        backend="megakernel")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tc.run_sweep(spec, itopo, icfg, record=False, devices=group.world,
                       fault_tolerant=True, device=dev)
    torch.cuda.synchronize()
    ni = int(isched.start.shape[0])
    sweep = dict(fct={p.index: res.state(p.index).fct[:ni].cpu()
                      for p in res.points},
                 fallbacks=res.fallbacks, failures=res.failures,
                 wall_s=time.perf_counter() - t0,
                 launches=dict(kernels.LAUNCHES),
                 k4_per_rank=len(spec.laws) * -(-icfg.steps // 64))
    return run, sweep


def gloo_ranks(group, shard_args, outer_args):
    """The work of two gloo ranks sharing the card, spawned once for
    phases 6h.3 and 6i.4 (a spawn's start-up is paid once):
    ``shard_rank(group, *shard_args)``, then
    ``test_torch_support.outer_sync_rank(group, *outer_args)``. Returns
    both results."""
    import test_torch_support as sup
    return (shard_rank(group, *shard_args),
            sup.outer_sync_rank(group, *outer_args))


def phase_shard(torch, tc, kernels, sup, dev, smi, paper_fct, sweep_fct):
    """Phase 6h: the sharded slot engine over ``torch.distributed`` (see
    the module docstring). ``paper_fct`` is phase 6f's K4 FCTs of the
    paper fabric's impaired pass by law, ``sweep_fct`` phase 6g's K4
    sweep FCTs by point. Returns (launches, rows, the outer sync's result
    on 6h.3's gloo ranks for 6i.4)."""
    from repro_torch.core import fluid, shardcomm
    from repro_torch.core.shardslots import LAST_SHARDED
    t0 = time.perf_counter()
    launches = {k: 0 for k in kernels.LAUNCHES}
    rows = {}
    ef = sup.IMPAIR_EXPECTED_FLOWS

    def count(c):
        for k, n in c.items():
            launches[k] += n

    def stats_line(wall, ticks):
        st = dict(LAST_SHARDED)
        return dict(wall_s=wall, us_per_tick=wall / ticks * 1e6,
                    collectives_per_tick=st["collectives"] / ticks,
                    rebuilds=st["rebuilds"],
                    overflow_ticks=st["overflow_ticks"],
                    segments=st["segments"], geometry=st["geometry"])

    # (1) world 1 over NCCL, the paper fabric's impaired pass, against K4
    group = shardcomm.one_rank_group(dev)
    if group.backend != "nccl" or group.world != 1:
        raise AssertionError(f"6h.1: expected a one-rank NCCL group, got "
                             f"{group}")
    ptopo, psched, pcfg, pS, preg = sup.impair_paper_scenario(tc,
                                                              device=dev)
    pcfg = pcfg._replace(steps=SHARD_PAPER_TICKS)
    lcfg = tc.default_law_config(tc.schedule_as_flows(psched),
                                 expected_flows=ef)
    ref61 = {}
    for law, impaired in SHARD_PAPER_RUNS:
        imp = preg if impaired else None
        tag = f"{law} {'mixed' if impaired else 'clean'}"
        (kst, krec), _, c = timed_run(
            torch, kernels, f"6h.1 K4 {tag}",
            expected_launches(law, "megakernel", pcfg.steps),
            lambda: tc.simulate_slots(ptopo, psched, law, pS, lcfg, pcfg,
                                      backend="megakernel", impair=imp,
                                      device=dev))
        count(c)
        (sst, srec), wall, _ = timed_run(
            torch, kernels, f"6h.1 sharded {tag}", {},
            lambda: tc.simulate_slots_sharded(ptopo, psched, law, pS, lcfg,
                                              pcfg, impair=imp,
                                              group=group, device=dev))
        row = stats_line(wall, pcfg.steps)
        same_state(torch, sup, sst, kst, f"6h.1 {tag} against K4")
        fig8_records_equal(srec, krec, f"6h.1 {tag} against K4")
        if impaired:
            # the flows done by the cut: 6f's whole-run K4 FCTs
            done = torch.isfinite(sst.fct)
            if not bool(done.any()):
                raise AssertionError(f"6h.1 {tag}: no flow done by tick "
                                     f"{pcfg.steps} to hold to 6f's FCTs")
            torch.testing.assert_close(
                sst.fct[done], paper_fct[law].to(sst.fct.device)[done],
                rtol=0, atol=0, msg=lambda m, t=tag: f"6h.1 {t} against "
                                                     f"6f's K4 FCTs: {m}")
            ref61[law] = (sst, srec)
        rows[f"{law}@paper{'-mixed' if impaired else ''}"] = row
        log(f"[shard] (6h.1) {tag}, world 1 over NCCL ({pS} slots, "
            f"{pcfg.steps} ticks, {row['geometry']['Qb']} queue rows, "
            f"cap {row['geometry']['cap']}, rebuild every "
            f"{row['geometry']['rb_every']}): wall {wall:.3f} s, "
            f"{row['us_per_tick']:.2f} us/tick, "
            f"{row['collectives_per_tick']:.3f} collectives/tick "
            f"({row['rebuilds']} rebuilds, {row['overflow_ticks']} overflow "
            f"ticks); state, FCTs ({int(torch.isfinite(sst.fct).sum())} "
            f"done) and every record field bitwise K4's"
            + ("; those FCTs bitwise 6f's whole K4 run" if impaired
               else "")
            + f"; {smi}")

    mark(f"[time] 6h.1 paper fabric, world 1: "
         f"{time.perf_counter() - t0:.1f} s")

    # (2) the full-width headline: fabric16 at world 1 against chunked K4
    c0 = time.perf_counter()
    ft, topo16, sched16, cfg16, lcfg16, imp16 = fabric16_scenario(tc, dev)
    n16 = int(sched16.start.shape[0])
    H16 = int(sched16.path.shape[-1])
    Q16 = int(topo16.num_queues)
    mi = tc.shard_geometry(sched16, SHARD16_SLOTS, Q16, 1)
    census = tc.comm_census(mi, SHARD16_SLOTS, H16, Q16, record=False)
    build_s = time.perf_counter() - c0
    (kst, _), kwall, c, segs = chunk_run(
        torch, kernels, "6h.2 K4", lambda: tc.simulate_slots(
            topo16, sched16, "powertcp", SHARD16_SLOTS, lcfg16, cfg16,
            record=False, backend="megakernel", chunk=SHARD16_CHUNK,
            impair=imp16, device=dev))
    count(c)
    (sst, _), wall, _ = timed_run(
        torch, kernels, "6h.2 sharded", {},
        lambda: tc.simulate_slots_sharded(
            topo16, sched16, "powertcp", SHARD16_SLOTS, lcfg16, cfg16,
            record=False, chunk=SHARD16_CHUNK, impair=imp16, group=group,
            device=dev))
    row = stats_line(wall, cfg16.steps)
    same_state(torch, sup, sst, kst, "6h.2 fabric16 against K4")
    done = int(torch.isfinite(sst.fct).sum())
    mark(f"[time] 6h.2 fabric16 build, K4 and sharded runs: "
         f"{time.perf_counter() - c0:.1f} s")
    c1 = time.perf_counter()
    # K4's device time (torch.profiler, one more pass), and the sharded
    # tick's device time and launches over its first
    # SHARD16_PROFILE_TICKS ticks
    k4_us = k4_device_us(torch, lambda: tc.simulate_slots(
        topo16, sched16, "powertcp", SHARD16_SLOTS, lcfg16, cfg16,
        record=False, backend="megakernel", chunk=SHARD16_CHUNK,
        impair=imp16, device=dev))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tc.simulate_slots_sharded(
            topo16, sched16, "powertcp", SHARD16_SLOTS, lcfg16,
            cfg16._replace(steps=SHARD16_PROFILE_TICKS), record=False,
            chunk=SHARD16_CHUNK, impair=imp16, group=group, device=dev)
        torch.cuda.synchronize()
    devs = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    prof_us = sum(_self_device_us(e) for e in devs) / SHARD16_PROFILE_TICKS
    row.update(k4_device_us_per_tick=(None if k4_us is None
                                      else k4_us / cfg16.steps),
               device_us_per_tick=prof_us,
               device_launches_per_tick=sum(e.count for e in devs)
               / SHARD16_PROFILE_TICKS,
               busy_share=prof_us / row["us_per_tick"])
    # K4's bound at this shape from its shapes alone (k4_cost with an empty
    # pool: the ring rows, gather entries, admissions and FCTs a launch's
    # data adds are left out, which can only lower the bound)
    from repro_torch.core import fluid
    from repro_torch.kernels.fused_tick import DEFAULT_BLOCK
    sw = fluid._make_static(topo16, cfg16.dt).sw_table
    nsw, swdeg = (0, 0) if sw is None else tuple(sw.shape)
    empty = dict(cursor=0, inv=0, lam=0, q=0, w=0, fct=0)
    k4_b, k4_by = bound_ms(*k4_cost(SHARD16_SLOTS, H16, Q16 + 1,
                                    DEFAULT_BLOCK, nsw, swdeg, "powertcp",
                                    empty, empty, impair=True))
    row.update(k4_bound_ms_per_launch=k4_b, k4_bound_by=k4_by,
               k4_bound_us_per_tick=k4_b / DEFAULT_BLOCK * 1e3)
    row.update(hosts=ft.n_hosts, queues=Q16, flows=n16,
               slots=SHARD16_SLOTS, chunk=SHARD16_CHUNK,
               ticks=cfg16.steps, of_steps=SHARD16_STEPS, completed=done,
               k4_wall_s=kwall, k4_us_per_tick=kwall / cfg16.steps * 1e6,
               k4_launches=c["fused_tick_block"], k4_segments=segs,
               census=census, build_s=build_s)
    rows["powertcp@fabric16"] = row
    mark(f"[time] 6h.2 fabric16 profiled passes: "
         f"{time.perf_counter() - c1:.1f} s")
    log(f"[shard] (6h.2) fabric16: k = 16 fat tree ({ft.n_hosts} hosts, "
        f"{Q16} queues), {n16} flows, {SHARD16_SLOTS} slots, chunk "
        f"{SHARD16_CHUNK}, degraded spine, first {cfg16.steps} of "
        f"{SHARD16_STEPS} ticks (scenario built in {build_s:.1f} s): "
        f"sharded world 1 wall {wall:.3f} s, {row['us_per_tick']:.2f} "
        f"us/tick, {row['collectives_per_tick']:.3f} collectives/tick "
        f"({row['rebuilds']} rebuilds, {row['overflow_ticks']} overflow "
        f"ticks, {row['segments']} segments); K4 chunked wall {kwall:.3f} s "
        f"({row['k4_us_per_tick']:.2f} us/tick, {c['fused_tick_block']} "
        f"launches, {segs} segments; K4 device "
        f"{row['k4_device_us_per_tick']!r} us/tick, bound "
        f"{row['k4_bound_us_per_tick']!r} us/tick ({k4_by}, from the "
        f"shapes: S {SHARD16_SLOTS}, H {H16}, Q+1 {Q16 + 1}, K "
        f"{DEFAULT_BLOCK}, {nsw} switches of {swdeg})); the sharded tick's "
        f"first {SHARD16_PROFILE_TICKS} ticks profiled: device "
        f"{prof_us:.2f} us/tick, {row['device_launches_per_tick']:.1f} "
        f"launches/tick, busy share {row['busy_share']!r}; final state and "
        f"FCTs ({done} done) bitwise K4's; comm_census "
        f"{json.dumps(census)}; {smi}")

    # (3) two gloo ranks on the one card, which also run 6i.4's outer sync
    c0 = time.perf_counter()
    (run, sweep), outer = shardcomm.spawn(
        gloo_ranks, 2, ((SHARD_SPAWN_TICKS, ef),
                        (sup.qwen3_layer_shapes(), OUTER_WINDOW,
                         OUTER_SEEDS)), backend="gloo", device=dev)
    spawn_s = time.perf_counter() - c0
    mark(f"[time] 6h.3 (and 6i.4) two gloo ranks, spawned: {spawn_s:.1f} s")
    st2, rec2 = run["state"], run["rec"]
    ccfg = pcfg._replace(steps=SHARD_SPAWN_TICKS)
    (kst, krec), _, c = timed_run(
        torch, kernels, "6h.3 K4",
        expected_launches("powertcp", "megakernel", ccfg.steps),
        lambda: tc.simulate_slots(ptopo, psched, "powertcp", pS, lcfg, ccfg,
                                  backend="megakernel", impair=preg,
                                  device=dev))
    count(c)
    same_state(torch, sup, st2, kst, "6h.3 two gloo ranks against K4")
    fig8_records_equal(rec2, krec, "6h.3 two gloo ranks against K4")
    one = ref61["powertcp"][1]
    fig8_records_equal(rec2, type(one)(*[x[:SHARD_SPAWN_TICKS]
                                         for x in one]),
                       "6h.3 two gloo ranks against 6h.1's first ticks")
    if run["stats"]["ndev"] != 2 or any(run["launches"].values()):
        raise AssertionError(f"6h.3: {run['stats']}, launches "
                             f"{run['launches']}")
    if sweep["fallbacks"] != () or sweep["failures"] != ():
        raise AssertionError(f"6h.3 sweep: fallbacks {sweep['fallbacks']}, "
                             f"failures {sweep['failures']}")
    if sweep["fct"].keys() != sweep_fct.keys():
        raise AssertionError("6h.3 sweep: its points are not 6g's")
    for i, fct in sweep["fct"].items():
        torch.testing.assert_close(
            fct, sweep_fct[i].cpu(), rtol=0, atol=0, equal_nan=True,
            msg=lambda m, i=i: f"6h.3 sweep point {i} against 6g's: {m}")
    k4 = sweep["launches"]["fused_tick_block"]
    if k4 != sweep["k4_per_rank"] or sum(sweep["launches"].values()) != k4:
        raise AssertionError(f"6h.3 sweep rank 0 launches "
                             f"{sweep['launches']}, expected K4 "
                             f"{sweep['k4_per_rank']}")
    launches["fused_tick_block"] += k4
    st = run["stats"]
    rows["powertcp@paper-mixed-2ranks"] = dict(
        wall_s=run["wall_s"],
        us_per_tick=run["wall_s"] / SHARD_SPAWN_TICKS * 1e6,
        collectives_per_tick=st["collectives"] / SHARD_SPAWN_TICKS,
        rebuilds=st["rebuilds"], overflow_ticks=st["overflow_ticks"],
        geometry=st["geometry"], spawn_s=spawn_s,
        sweep_wall_s=sweep["wall_s"], sweep_k4_launches_rank0=k4)
    r = rows["powertcp@paper-mixed-2ranks"]
    log(f"[shard] (6h.3) two gloo ranks on the card (host-staged "
        f"collectives): powertcp mixed, {SHARD_SPAWN_TICKS} ticks, wall "
        f"{run['wall_s']:.3f} s, {r['us_per_tick']:.2f} us/tick, "
        f"{r['collectives_per_tick']:.3f} collectives/tick "
        f"({st['rebuilds']} rebuilds, {st['overflow_ticks']} overflow "
        f"ticks): state bitwise K4's, every record field bitwise K4's and "
        f"6h.1's first {SHARD_SPAWN_TICKS} ticks; run_sweep(devices=2) over "
        f"impair_fct.run's grid on K4 ({len(sweep['fct'])} points, {k4} K4 "
        f"launches on rank 0, wall {sweep['wall_s']:.3f} s): no fallback, "
        f"no failure, every point bitwise 6g's unsharded K4 sweep; spawn "
        f"and both ranks' work (6i.4's outer sync too) {spawn_s:.1f} s; "
        f"{smi}")
    torch.distributed.destroy_process_group()
    log("[shard] " + json.dumps({"shard": rows}))
    log(f"[shard] phase 6h: {time.perf_counter() - t0:.1f} s")
    return launches, rows, outer


# -------------------------------------------------------------------------
# phase 6i: Fig. 4's incast, HOMA, the paper-scale generators, outer sync
# -------------------------------------------------------------------------

# 6i.1: K4 held to the plain tick over the first FIG4_PLAIN_TICKS ticks
# for powertcp, over its first FIG4_PLAIN_LAUNCHES launches for the other
# four laws; the whole runs held to repro's at FIG4_RTOL
FIG4_PLAIN_TICKS = 1200
FIG4_PLAIN_LAUNCHES = 3
FIG4_RTOL = 1e-5
# 6i.2: the ticks of Fig. 6's HOMA leg run under torch.profiler, and the
# allocator's calls profiled alone (200 until phase 9 was added)
HOMA_PROFILE_TICKS = 50
# 6i.3: the generators' FCTs against repro's
GEN_RTOL = 1e-5
# 6i.4: the outer sync's in-flight bound and the trees' seeds
OUTER_WINDOW = 2
OUTER_SEEDS = (101, 102, 103, 104)


def b64_f32(s):
    return np.frombuffer(base64.b64decode(s), np.float32)


def hold_trace(key, got, want, rtol, atol):
    """A trace within ``atol + rtol * |want|`` of the reference's. Returns
    (the largest error relative to max(|want|, 1), bit for bit)."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    if got.shape != want.shape:
        raise AssertionError(f"{key}: {got.shape} against {want.shape}")
    err = np.abs(got - want)
    if not (err <= atol + rtol * np.abs(want)).all():
        i = int(np.argmax(err - rtol * np.abs(want)))
        raise AssertionError(f"{key}: {got[i]!r} against {want[i]!r} at {i}")
    return (float(np.max(err / np.maximum(np.abs(want), 1.0)))
            if err.size else 0.0, bool(np.array_equal(got, want)))


def fct_checksum(sup, flows):
    return sup.schedule_checksum(flows.size.cpu().numpy(),
                                 flows.start.cpu().numpy())


def phase_incast(torch, tc, kernels, sup, dev, smi, outer_two):
    """Phase 6i (see the module docstring); ``outer_two`` is the outer
    sync's result on 6h.3's two gloo ranks (``gloo_ranks``). Returns
    (launches, rows)."""
    with open(sup.FIG4_REF) as f:
        ref = json.load(f)
    with open(sup.GENERATORS_REF) as f:
        gref = json.load(f)
    t0 = time.perf_counter()
    launches = {k: 0 for k in kernels.LAUNCHES}
    rows = {}

    def count(c):
        for k, n in c.items():
            launches[k] += n

    # (1) Fig. 4: both incasts as one batch on K4, five laws
    c0 = time.perf_counter()
    fab, topo, flows, bq, cfg = sup.fig4_scenario(tc, device=dev)
    sc = ref["scenario"]
    got = [bq, cfg.steps] + [fct_checksum(sup, f) for f in flows]
    want = [sc["bq"], sc["steps"]] + [sc[f"checksum_{fan}"]
                                      for fan in sup.FIG4_FANS]
    if got != want:
        raise AssertionError(f"6i.1: the port's scenario {got[:2]} differs "
                             f"from the reference's {want[:2]}")
    sb = tc.stack_flow_schedules([tc.make_schedule(f) for f in flows],
                                 topo.num_queues)
    S = int(sb.start.shape[-1])
    ef = sup.FIG4_EXPECTED_FLOWS
    err = 0.0
    for law in sup.FIG4_LAWS:
        ticks = (FIG4_PLAIN_TICKS if law == "powertcp"
                 else FIG4_PLAIN_LAUNCHES * 64)
        err = max(err, sup.k4_grid_against_plain(
            tc, topo, sb, cfg._replace(steps=ticks), law, S, (64,),
            expected_flows=ef))
        log(f"[incast] (6i.1) {law}: K4 (B=2, S={S}) bitwise equal to the "
            f"plain tick over the first {ticks} ticks")
    mark(f"[time] 6i.1 K4 against the plain tick: "
         f"{time.perf_counter() - c0:.1f} s")
    c0 = time.perf_counter()
    bdp = sup.fig4_bdp(fab)
    res = {fan: {} for fan in sup.FIG4_FANS}
    for law in sup.FIG4_LAWS:
        (st, rec), wall, c = timed_run(
            torch, kernels, f"6i.1 {law}",
            expected_launches(law, "megakernel", cfg.steps),
            lambda law=law: tc.simulate_slots_batch(
                topo, sb, law, S, cfg=cfg, backend="megakernel",
                expected_flows=ef, device=dev))
        count(c)
        row = dict(wall_s=wall, us_per_tick=wall / cfg.steps * 1e6,
                   launches=c["fused_tick_block"])
        for i, (fan, fl) in enumerate(zip(sup.FIG4_FANS, flows)):
            leg = ref["laws"][law][str(fan)]
            key = f"6i.1 {law} {fan}:1"
            fct = st.fct[i].cpu().numpy()
            q = rec.q[i, :, bq].cpu().numpy()
            th = rec.thru[i, :, bq].cpu().numpy()
            h = compare_fct(key, fct, fcts_of(leg["fct_s"]),
                            sb.size[i].cpu().numpy(), rtol=FIG4_RTOL)
            done, frel, fbit = (h["completed"], h["fct_max_rel_err"],
                                h["bitwise"])
            qrel, qbit = hold_trace(key + " q", q, b64_f32(leg["q"]),
                                    FIG4_RTOL, 0.5)
            trel, tbit = hold_trace(key + " thru", th, b64_f32(leg["thru"]),
                                    FIG4_RTOL, 0.5)
            m = sup.fig4_metrics(fl.size.cpu().numpy(), fct, q,
                                 th / fab.host_bw, cfg.steps, cfg.dt, bdp)
            for k, v in m.items():
                w = leg["metrics"][k]
                # a drain time is whole ticks: one tick of slack
                tol = cfg.dt * 1e6 if k == "drain_us" else \
                    FIG4_RTOL * abs(w) + 1e-9
                if not abs(v - w) <= tol:
                    raise AssertionError(f"{key} {k}: {v!r} against the "
                                         f"reference's {w!r}")
            res[fan][law] = m
            row[f"{fan}to1"] = dict(completed=done, fct_max_rel_err=frel,
                                    q_max_rel_err=qrel,
                                    thru_max_rel_err=trel,
                                    bitwise=fbit and qbit and tbit, **m)
            log(f"[incast] (6i.1) {law} {fan}:1 on K4 ({cfg.steps} ticks): "
                f"{done} responses done (the reference's set), FCT rel err "
                f"{frel!r}, victim queue q / thru rel err {qrel!r} / "
                f"{trel!r} (bitwise {fbit and qbit and tbit}); peak "
                f"{m['peak_q_MB']!r} MB, end {m['end_q_KB']!r} KB, drain "
                f"{m['drain_us']!r} us, dip {m['dip_after']!r}")
        rows[f"{law}@fig4"] = row
        log(f"[incast] (6i.1) {law}: wall {wall:.3f} s for both incasts, "
            f"{row['us_per_tick']:.2f} us/tick, {row['launches']} K4 "
            f"launches; {smi}")
    claims = sup.fig4_claims(res[10], res[63], fab)
    if claims != ref["claims_hold"]:
        raise AssertionError(f"6i.1: claims_hold {claims}, the reference's "
                             f"{ref['claims_hold']}")
    k4_us = k4_device_us(torch, lambda: tc.simulate_slots_batch(
        topo, sb, "powertcp", S, cfg=cfg, record=False,
        backend="megakernel", expected_flows=ef, device=dev))
    rows["powertcp@fig4"]["k4_device_us_per_tick"] = (
        None if k4_us is None else k4_us / cfg.steps)
    log(f"[incast] (6i.1) fig4_incast claims_hold {claims} (the "
        f"reference's); K4 device {rows['powertcp@fig4']['k4_device_us_per_tick']!r} "
        f"us/tick for both incasts (powertcp, torch.profiler); {smi}")
    mark(f"[time] 6i.1 Fig. 4 runs: {time.perf_counter() - c0:.1f} s")

    # (2) HOMA on the padded engine (the reference backend)
    c0 = time.perf_counter()
    hfab, htopo, hflows, hbq, hcfg = sup.fig4_scenario(
        tc, steps=sup.HOMA_FIG4_STEPS, device=dev)
    n = max(int(f.tau.shape[0]) for f in hflows)
    hfl, halloc, hlcfg = sup.homa_run_args(tc, hfab, hflows[0], pad_to=n,
                                           expected_flows=16.0)
    (st, rec), wall, _ = timed_run(
        torch, kernels, "6i.2 HOMA fig4", {},
        lambda: tc.simulate(htopo, hfl, "reno", hlcfg, hcfg,
                            alloc_fn=halloc, device=dev))
    href = ref["homa"]["fig4_10"]
    h = compare_fct("6i.2 fig4 10:1", st.fct.cpu().numpy(),
                    fcts_of(href["fct_s"]), hfl.size.cpu().numpy(),
                    rtol=FIG4_RTOL)
    done, frel, fbit = h["completed"], h["fct_max_rel_err"], h["bitwise"]
    qrel, qbit = hold_trace("6i.2 fig4 10:1 q", rec.q[:, hbq].cpu().numpy(),
                            b64_f32(href["q"]), FIG4_RTOL, 0.5)
    trel, tbit = hold_trace("6i.2 fig4 10:1 thru",
                            rec.thru[:, hbq].cpu().numpy(),
                            b64_f32(href["thru"]), FIG4_RTOL, 0.5)
    rows["homa@fig4"] = dict(wall_s=wall, ticks=hcfg.steps,
                             us_per_tick=wall / hcfg.steps * 1e6,
                             flows=n, completed=done, fct_max_rel_err=frel,
                             q_max_rel_err=qrel,
                             bitwise=fbit and qbit and tbit)
    log(f"[incast] (6i.2) HOMA (reno + receiver grants, overcommit 1) on "
        f"Fig. 4's 10:1 incast, padded reference, {n} flows, first "
        f"{hcfg.steps} of {sup.FIG4_STEPS} ticks: wall {wall:.3f} s, "
        f"{rows['homa@fig4']['us_per_tick']:.2f} us/tick; {done} responses "
        f"done (the reference's set), FCT rel err {frel!r}, victim q / "
        f"thru rel err {qrel!r} / {trel!r} (bitwise "
        f"{fbit and qbit and tbit}); {smi}")
    wfab, wtopo, wflows, wcfg = sup.homa_ws_scenario(tc, device=dev)
    wref = ref["homa"]["ws"]
    if fct_checksum(sup, wflows) != wref["checksum"]:
        raise AssertionError("6i.2: the web-search leg differs from the "
                             "reference's")
    wfl, walloc, wlcfg = sup.homa_run_args(tc, wfab, wflows)
    (st, rec), wall, _ = timed_run(
        torch, kernels, "6i.2 HOMA web-search", {},
        lambda: tc.simulate(wtopo, wfl, "reno", wlcfg, wcfg,
                            alloc_fn=walloc, device=dev))
    h = compare_fct("6i.2 web-search", st.fct.cpu().numpy(),
                    fcts_of(wref["fct_s"]), wfl.size.cpu().numpy(),
                    rtol=FIG4_RTOL)
    done, frel, fbit = h["completed"], h["fct_max_rel_err"], h["bitwise"]
    qrel, qbit = hold_trace("6i.2 web-search q", rec.q.cpu().numpy(),
                            b64_f32(wref["q"]), FIG4_RTOL, 0.5)
    F = int(wfl.tau.shape[0])
    from torch.profiler import ProfilerActivity, profile
    pcfg = wcfg._replace(steps=HOMA_PROFILE_TICKS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tc.simulate(wtopo, wfl, "reno", wlcfg, pcfg, alloc_fn=walloc,
                    record=False, device=dev)
        torch.cuda.synchronize()
    devs = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    tick_us = sum(_self_device_us(e) for e in devs) / HOMA_PROFILE_TICKS
    tick_launches = sum(e.count for e in devs) / HOMA_PROFILE_TICKS
    # the allocator alone, on the run's final state
    t_sec = float(np.float32(wcfg.steps) * np.float32(wcfg.dt))
    active = ((wfl.start <= t_sec) & (st.remaining > 0.0)
              & (t_sec < wfl.stop))
    walloc(st.remaining, active, t_sec, wfl, st.rate_cap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(HOMA_PROFILE_TICKS):
            walloc(st.remaining, active, t_sec, wfl, st.rate_cap)
        torch.cuda.synchronize()
    adevs = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    alloc_us = sum(_self_device_us(e) for e in adevs) / HOMA_PROFILE_TICKS
    rows["homa@ws"] = dict(
        wall_s=wall, ticks=wcfg.steps, flows=F,
        us_per_tick=wall / wcfg.steps * 1e6, completed=done,
        fct_max_rel_err=frel, q_max_rel_err=qrel, bitwise=fbit and qbit,
        device_us_per_tick=tick_us, device_launches_per_tick=tick_launches,
        busy_share=tick_us / (wall / wcfg.steps * 1e6),
        alloc_device_us=alloc_us,
        alloc_launches=sum(e.count for e in adevs) / HOMA_PROFILE_TICKS,
        alloc_device_share=alloc_us / tick_us if tick_us else None)
    r = rows["homa@ws"]
    log(f"[incast] (6i.2) HOMA on Fig. 6's web-search leg (64 hosts, load "
        f"0.6, seed 1, {F} flows), padded reference, first {wcfg.steps} of "
        f"{int((sup.HOMA_WS_DURATION + 0.04) / wcfg.dt)} ticks: wall "
        f"{wall:.3f} s, {r['us_per_tick']:.2f} us/tick; {done} flows done "
        f"(the reference's set), FCT rel err {frel!r}, q rel err {qrel!r} "
        f"(bitwise {fbit and qbit}); first {HOMA_PROFILE_TICKS} ticks "
        f"profiled: device {tick_us:.2f} us/tick, {tick_launches:.1f} "
        f"launches/tick, busy share {r['busy_share']!r}; the allocator "
        f"alone {alloc_us:.2f} us a call ({r['alloc_launches']:.1f} "
        f"launches), {r['alloc_device_share']!r} of the tick's device "
        f"time; {smi}")
    mark(f"[time] 6i.2 HOMA: {time.perf_counter() - c0:.1f} s")

    # (3) the paper-scale generators on K4
    c0 = time.perf_counter()
    for leg in sup.GEN_LEGS:
        b0 = time.perf_counter()
        gtopo, gsched, gcfg, slots = sup.generator_scenario(tc, leg,
                                                            device=dev)
        build_s = time.perf_counter() - b0
        r = gref[leg]
        N = int(gsched.start.shape[0])
        got = (fct_checksum(sup, gsched), slots, gcfg.steps, N)
        if got != (r["checksum"], r["slots"], r["steps"], r["n_flows"]):
            raise AssertionError(f"6i.3 {leg}: the port's scenario "
                                 f"{got[1:]} differs from the reference's")
        lcfg = tc.default_law_config(tc.schedule_as_flows(gsched),
                                     expected_flows=sup.GEN_EXPECTED_FLOWS)

        def run(cfg_=gcfg, gtopo=gtopo, gsched=gsched, slots=slots,
                lcfg=lcfg):
            return tc.simulate_slots(gtopo, gsched, sup.GEN_LAW, slots,
                                     lcfg, cfg_, record=False,
                                     backend="megakernel", device=dev)
        (st, _), wall, c = timed_run(
            torch, kernels, f"6i.3 {leg}",
            expected_launches(sup.GEN_LAW, "megakernel", gcfg.steps), run)
        count(c)
        h = compare_fct(f"6i.3 {leg}", st.fct.cpu().numpy(),
                        fcts_of(r["fct_s"]), gsched.size.cpu().numpy(),
                        rtol=GEN_RTOL, all_p999=True)
        done, frel, fbit = h["completed"], h["fct_max_rel_err"], h["bitwise"]
        k4_us = k4_device_us(torch, run)
        rows[f"{sup.GEN_LAW}@{leg}"] = dict(
            flows=N, slots=slots, ticks=gcfg.steps, wall_s=wall,
            us_per_tick=wall / gcfg.steps * 1e6,
            k4_device_us_per_tick=(None if k4_us is None
                                   else k4_us / gcfg.steps),
            launches=c["fused_tick_block"], completed=done,
            fct_max_rel_err=frel, bitwise=fbit,
            short_p999_us=h["short_p999_us"], all_p999_us=h["all_p999_us"],
            build_s=build_s)
        log(f"[incast] (6i.3) {leg}: {N} flows, {slots} slots, "
            f"{gcfg.steps} ticks on K4 ({c['fused_tick_block']} launches, "
            f"scenario built in {build_s:.1f} s): wall {wall:.3f} s, "
            f"{wall / gcfg.steps * 1e6:.2f} us/tick, K4 device "
            f"{rows[f'{sup.GEN_LAW}@{leg}']['k4_device_us_per_tick']!r} "
            f"us/tick; {done} done (the reference's set), FCT rel err "
            f"{frel!r} (bitwise {fbit}), short p99.9 {h['short_p999_us']!r} "
            f"us (None: no flow under 10 kB), all p99.9 "
            f"{h['all_p999_us']!r} us (each within 1e-3 of the "
            f"reference's); {smi}")
    mark(f"[time] 6i.3 generators: {time.perf_counter() - c0:.1f} s")

    # (4) the outer sync of one qwen3-14b decoder layer
    c0 = time.perf_counter()
    from repro_torch.commsched import make_outer_sync
    from repro_torch.core import shardcomm
    shapes = sup.qwen3_layer_shapes()
    group = shardcomm.one_rank_group(dev)
    if group.backend != "nccl" or group.world != 1:
        raise AssertionError(f"6i.4: expected a one-rank NCCL group, got "
                             f"{group}")
    s = OUTER_SEEDS
    anchor = sup.outer_tree(shapes, s[0], device=dev)
    mom = sup.outer_tree(shapes, s[1], scale=0.01, device=dev)
    local = sup.outer_tree(shapes, s[2], scale=0.1, device=dev)
    efb = sup.outer_tree(shapes, s[3], scale=1e-3, device=dev)
    leaves = sup.sorted_leaves(anchor)
    nparam = sum(int(x.numel()) for x in leaves)
    sync = make_outer_sync(group, window=OUTER_WINDOW)
    walls = []
    for _ in range(2):          # the first call also starts NCCL
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        out = sync(anchor, local, efb, mom)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - w0)
    stats = dict(sync.stats)
    got = sup.sorted_leaves(out[0]) + sup.sorted_leaves(out[1]) + sup.sorted_leaves(out[2])
    del out
    wa, we, wm = sup.outer_sync_spelled(anchor, [local], [efb], mom)
    for i, (g, w) in enumerate(zip(got, wa + we[0] + wm)):
        if not torch.equal(g, w):
            raise AssertionError(f"6i.4 world 1: leaf {i} differs from the "
                                 f"one-process spelling")
    if stats["gathers"] != len(leaves) or \
            stats["max_in_flight"] != OUTER_WINDOW:
        raise AssertionError(f"6i.4 world 1: {stats}")
    del got, wa, we, wm, anchor, mom, local, efb
    torch.distributed.destroy_process_group()
    free_memory(torch)
    rows["outer_sync@world1-nccl"] = dict(
        params=nparam, leaves=len(leaves), window=OUTER_WINDOW,
        wall_s=walls[1], first_wall_s=walls[0], bytes=stats["bytes"],
        max_in_flight=stats["max_in_flight"])
    log(f"[incast] (6i.4) outer sync of one qwen3-14b decoder layer "
        f"({nparam} float32 params, {len(leaves)} leaves, window "
        f"{OUTER_WINDOW}) at world 1 over NCCL: {walls[1]:.3f} s a sync "
        f"(first {walls[0]:.3f} s), {stats['bytes']} bytes gathered, at "
        f"most {stats['max_in_flight']} gathers in flight; every leaf of "
        f"the anchor, error feedback and momentum bitwise the one-process "
        f"spelling; {smi}")
    two = outer_two             # run on 6h.3's two gloo ranks
    if two["bad"] != [0, 0] or two["leaves"] != len(leaves) \
            or two["gathers"] != [len(leaves)] * 2 \
            or two["max_in_flight"] != [OUTER_WINDOW] * 2:
        raise AssertionError(f"6i.4 two gloo ranks: {two}")
    rows["outer_sync@2ranks-gloo"] = dict(
        params=nparam, leaves=len(leaves), window=OUTER_WINDOW,
        wall_s=two["wall_s"], bytes=two["bytes"])
    log(f"[incast] (6i.4) two gloo ranks on the card (host-staged "
        f"gathers; the ranks 6h.3 spawned): {two['wall_s']:.3f} s a sync "
        f"on rank 0, {two['bytes']} bytes gathered a rank, at most "
        f"{OUTER_WINDOW} gathers in flight on each rank; each rank's "
        f"result bitwise the spelling over both pods; {smi}")
    mark(f"[time] 6i.4 outer sync: {time.perf_counter() - c0:.1f} s")
    log("[incast] " + json.dumps({"incast": rows}))
    log(f"[incast] phase 6i: {time.perf_counter() - t0:.1f} s")
    return launches, rows


def phase_profile(torch, tc, sup, dev, summaries, ticks=200):
    """``--profile``: each main-path run under ``torch.profiler`` — the
    first ``ticks`` ticks of the eager runs, the whole run of the
    megakernel runs (it takes about a second). Prints the device time and
    device launches per tick, the device-busy share against that run's
    unprofiled wall time per tick, and the kernels that take the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    with open(sup.PAPER_REF) as f:
        ref = json.load(f)
    topo, sched = paper_scenario(tc, sup, dev, ref)
    for summ in summaries:
        n = summ["steps"] if summ["backend"] == "megakernel" else ticks
        cfg = tc.SimConfig(dt=ref["dt_s"], steps=n, hist=ref["hist"],
                           update_period=ref["update_period_s"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if summ["engine"] == "slot":
                lcfg = tc.default_law_config(
                    sched, expected_flows=ref["expected_flows"])
                tc.simulate_slots(topo, sched, summ["law"], ref["slots"],
                                  lcfg, cfg, record=False,
                                  backend=summ["backend"], device=dev)
            else:
                flows = tc.schedule_as_flows(sched)
                lcfg = tc.default_law_config(
                    flows, expected_flows=ref["expected_flows"])
                tc.simulate(topo, flows, summ["law"], lcfg, cfg,
                            record=False, backend=summ["backend"],
                            device=dev)
            torch.cuda.synchronize()
        profile_summary(torch, prof, n, summ["run"], summ["us_per_tick"])


def profile_summary(torch, prof, n, key, us_per_tick):
    """Device time and launches per tick of a profiled run of ``n`` ticks,
    its busy share against the unprofiled wall time per tick, and the
    kernels that take the most device time."""
    # device-side events only (kernels, copies, fills): a CPU op's entry
    # repeats the device time of the kernels it launched
    avgs = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(_self_device_us(e) for e in avgs) / n
    n_dev = sum(e.count for e in avgs) / n
    if n_dev == 0:
        raise AssertionError(f"run ({key}): the profiler saw no device work")
    log(f"[profile] ({key}) first {n} ticks: device {dev_us:.2f} us/tick, "
        f"busy share {dev_us / us_per_tick!r} of the unprofiled "
        f"{us_per_tick:.2f} us/tick; {n_dev:.2f} device launches/tick, "
        f"{us_per_tick / n_dev:.2f} us of wall time each")
    for e in sorted(avgs, key=_self_device_us, reverse=True)[:8]:
        log(f"[profile] ({key})   {_self_device_us(e) / n:9.3f} us/tick  "
            f"{e.count / n:6.2f} calls/tick  {e.key[:90]}")


def phase_profile_smoke(torch, tc, sup, dev, summaries, ticks=200):
    """``--profile`` for phase 6b: the eager batch runs' first ``ticks``
    ticks, the megakernel runs whole, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with open(sup.SMOKE_REF) as f:
        ref = json.load(f)
    topo, flows, scheds = smoke_scenario(tc, sup, dev, ref)
    Q = topo.num_queues
    fb = tc.stack_flows(flows, Q)
    sb = tc.stack_flow_schedules(scheds, Q)
    slots = ref["slots"]
    runs = {"6b.1": ("padded", "reference", False),
            "6b.3": ("slot", "reference", False),
            "6b.4": ("slot", "megakernel", True),
            "6b.5": ("slot", "megakernel", False),
            "6b.6": ("slot", "fused", False)}
    for summ in summaries:
        engine, backend, seq = runs[summ["run"]]
        n = ref["steps"] if backend == "megakernel" else ticks
        cfg = tc.SimConfig(dt=ref["dt_s"], steps=n, hist=ref["hist"],
                           update_period=ref["update_period_s"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if engine == "padded":
                tc.simulate_batch(topo, fb, "powertcp", cfg=cfg,
                                  record=False, backend=backend,
                                  expected_flows=ref["expected_flows"],
                                  device=dev)
            else:
                tc.simulate_slots_batch(topo, sb, "powertcp", slots,
                                        cfg=cfg, record=False,
                                        backend=backend, sequential=seq,
                                        expected_flows=ref["expected_flows"],
                                        device=dev)
            torch.cuda.synchronize()
        profile_summary(torch, prof, n, summ["run"], summ["us_per_tick"])


# -------------------------------------------------------------------------
# the LM slice: K5, K6 and the qwen3-14b serve run
# -------------------------------------------------------------------------

def free_memory(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# 8b: the other architectures at full width, each depth-cut only where
# its float32 (llama3-405b: bfloat16) parameters would not fit beside the
# others' peak: (arch, layers or None for all)
SERVE_ARCHS = (("gemma_7b", None), ("stablelm_3b", None),
               ("llama3_405b", 4), ("qwen3_moe_30b_a3b", 8),
               ("granite_moe_3b_a800m", None))
# greedy tokens each (the serve run's prompts, half its tokens)
SERVE_ARCH_STEPS = 16


def arch_cfgs(archs):
    """[(arch, full-width config)] for the architecture names ``archs``."""
    from repro_torch import configs
    return [(a, configs.get_config(a)) for a in archs]


def norm_rows(cfg, rows):
    """K6's (N, width) in a forward of ``cfg`` over ``rows`` tokens: the
    layer norms' where the norm is RMSNorm (a layernorm is plain torch),
    q's and k's with the qk-norm."""
    out = {}
    if cfg.norm == "rmsnorm":
        out["ln"] = (rows, cfg.d_model)
    if cfg.qk_norm:
        out["q"] = (rows * cfg.num_heads, cfg.head_dim)
        out["k"] = (rows * cfg.num_kv_heads, cfg.head_dim)
    return out


def card_normal(torch, dev, seed, *shapes):
    """float32 standard normal tensors of ``shapes``, drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(sh, generator=gen, device=dev) for sh in shapes)


def encdec_flash_shapes():
    """{tag: (config, B, T, S, causal)}: K5's shapes in 8d's serve runs
    (``ENCDEC_SERVE``): phi3-vision's prefill over its prompt and its last
    decode step (causal); whisper's encoder over its frames, its decoder's
    cross-attention in the prefill and in a decode step over them
    (unmasked)."""
    from repro_torch import configs
    out = {}
    for arch, batch, prompt in ENCDEC_SERVE:
        cfg = configs.get_config(arch)
        if cfg.enc_layers:
            F = cfg.enc_seq
            out[f"{arch} encoder"] = (cfg, batch, F, F, False)
            out[f"{arch} cross prefill"] = (cfg, batch, prompt, F, False)
            out[f"{arch} cross decode"] = (cfg, batch, 1, F, False)
        else:
            out[f"{arch} prefill"] = (cfg, batch, prompt, prompt, True)
            out[f"{arch} decode"] = (cfg, batch, 1,
                                     prompt + ENCDEC_SERVE_STEPS - 1, True)
    return out


def phase_lm_kernels(torch, sup, dev):
    """K5 and K6 against their plain versions at the shapes the serve runs
    give them (qwen3-14b's in phase 8, each of ``SERVE_ARCHS``' in 8b, all
    derived from their configs), then timed beside the plain version and
    the PyTorch call for the same function. Returns {name: row} for the
    kernels line (K5 at qwen3-14b's prefill shape with its decode shape
    under ``decode_*`` and the other architectures' under ``arch_shapes``;
    K6 at the prefill layer norm's rows with the qk-norm's and the decode
    rows beside)."""
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import flash_attention, ref, rmsnorm
    bf = torch.bfloat16
    B, P, C = sup.SERVE_BATCH, sup.SERVE_PROMPT, sup.SERVE_CACHE
    archs = arch_cfgs(("qwen3_14b",) + tuple(a for a, _ in SERVE_ARCHS))

    def flash_case(T, S, seed, H, KV, D, Bc=B, C=C):
        q, k, v = (a.to(bf) for a in card_normal(
            torch, dev, seed, (Bc, H, T, D), (Bc, KV, S, D), (Bc, KV, S, D)))
        if T == 1:      # the decode reads the cache in place: [B,S,KV,D]
            cache = torch.zeros(Bc, C, KV, D, dtype=bf, device=dev)
            cache[:, :S] = k.permute(0, 2, 1, 3)
            k = v = cache[:, :S].permute(0, 2, 1, 3)
            q = q.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        return q, k, v

    def dims(cfg):
        return dict(H=cfg.num_heads, KV=cfg.num_kv_heads, D=cfg.head_dim)

    err = {"flash_attention": 0.0, "rmsnorm": 0.0}
    cases = {"prefill": (P, P), "decode_first": (1, P + 1),
             "decode": (1, C - 1)}
    for arch, cfg in archs:
        for tag, (T, S) in cases.items():
            q, k, v = flash_case(T, S, seed=T + S, **dims(cfg))
            got = flash_attention(q, k, v, causal=True)
            want = ref.flash_attention_ref(q, k, v, causal=True)
            again = flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                       atol=2e-2)
            torch.testing.assert_close(again, got, rtol=0, atol=0)
            e = float((got.float() - want.float()).abs().max())
            err["flash_attention"] = max(err["flash_attention"], e)
            log(f"[lm] flash_attention {arch} {tag} q {list(q.shape)} k/v "
                f"{list(k.shape)}: max abs err {e!r} (rtol/atol 2e-2); "
                f"bitwise equal to a second run")
    for (Be, He, KVe, T, S, De, causal, window,
         _) in sup.FLASH_EDGE_SHAPES:
        q, k, v = (torch.as_tensor(a, device=dev).to(bf) for a in
                   sup.flash_inputs(Be, He, KVe, T, S, De, seed=T + S))
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        e = float((got.float() - want.float()).abs().max())
        err["flash_attention"] = max(err["flash_attention"], e)
        log(f"[lm] flash_attention edge q {list(q.shape)} k/v "
            f"{list(k.shape)} causal {causal} window {window}: max abs err "
            f"{e!r} (rtol/atol 2e-2)")
    # 8c's local attention (recurrentgemma-2b): the prefill over its
    # window, whole key tiles skipped (T > window), and the ring decode,
    # one query over the ring's slots read in place, no mask
    rg = configs.get_config("recurrentgemma_2b")
    rg_b, rg_p = dict((a, (b, p)) for a, b, p in RECURRENT_SERVE)[
        "recurrentgemma_2b"]
    rg_dims = dims(rg)
    win_cases = {"prefill": (rg_p, rg_p, rg.window),
                 "ring decode": (1, rg.window, 0)}
    for tag, (T, S, w) in win_cases.items():
        q, k, v = flash_case(T, S, seed=T + S, Bc=rg_b, C=rg.window,
                             **rg_dims)
        got = flash_attention(q, k, v, causal=True, window=w)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=w)
        again = flash_attention(q, k, v, causal=True, window=w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(again, got, rtol=0, atol=0)
        e = float((got.float() - want.float()).abs().max())
        err["flash_attention"] = max(err["flash_attention"], e)
        log(f"[lm] flash_attention recurrentgemma_2b {tag} q "
            f"{list(q.shape)} k/v {list(k.shape)} window {w}: max abs err "
            f"{e!r} (rtol/atol 2e-2); bitwise equal to a second run")
    # 8d's attention (``encdec_flash_shapes``): phi3-vision's causal
    # prefill and decode at head dim 96, whisper's unmasked encoder and
    # cross-attention (the decode's cross keys read in place from the
    # cache)
    ed_cases = encdec_flash_shapes()
    for tag, (cfg, Bc, T, S, causal) in ed_cases.items():
        q, k, v = flash_case(T, S, seed=T + S, Bc=Bc, C=S, **dims(cfg))
        got = flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        again = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(again, got, rtol=0, atol=0)
        e = float((got.float() - want.float()).abs().max())
        err["flash_attention"] = max(err["flash_attention"], e)
        log(f"[lm] flash_attention {tag} q {list(q.shape)} k/v "
            f"{list(k.shape)} {'causal' if causal else 'unmasked'}: max abs "
            f"err {e!r} (rtol/atol 2e-2); bitwise equal to a second run")

    def norm_check(arch, cfg, phase, n):
        sdt = getattr(torch, cfg.param_dtype)
        for tag, (N, Dn) in norm_rows(cfg, n).items():
            x, s = card_normal(torch, dev, N + Dn, (N, Dn), (Dn,))
            x32, x, s = x * 3.0, (x * 3.0).to(bf), (1.0 + 0.1 * s).to(sdt)
            got = rmsnorm(x, s, eps=1e-6)
            want = ref.rmsnorm_ref(x, s, eps=1e-6)
            again = rmsnorm(x, s, eps=1e-6)
            spelled = sup.rmsnorm_in_k6_order(x, s, 1e-6)
            got32 = rmsnorm(x32, s, eps=1e-6)
            spelled32 = sup.rmsnorm_in_k6_order(x32, s, 1e-6)
            torch.cuda.synchronize()
            what = f"rmsnorm {arch} {tag} {phase} [{N}, {Dn}]"
            ulps = sup.bf16_ulps(got, want)
            if ulps > 1.0:
                raise AssertionError(f"{what}: {ulps} bfloat16 ulps off")
            torch.testing.assert_close(again, got, rtol=0, atol=0)
            torch.testing.assert_close(got, spelled, rtol=0, atol=0)
            torch.testing.assert_close(
                got32, ref.rmsnorm_ref(x32, s, eps=1e-6), rtol=1e-5,
                atol=1e-6)
            torch.testing.assert_close(got32, spelled32, rtol=0, atol=0)
            e = float((got.float() - want.float()).abs().max())
            err["rmsnorm"] = max(err["rmsnorm"], e)
            log(f"[lm] {what}, scale {cfg.param_dtype}: max abs err "
                f"{e!r}, {ulps!r} bfloat16 ulps (at most 1); float32 "
                f"within rtol 1e-5; both bitwise equal to its order "
                f"spelled in torch, bfloat16 to a second run")

    for arch, cfg in archs:
        for phase, n in (("prefill", B * P), ("decode", B)):
            norm_check(arch, cfg, phase, n)
    for arch, rb, rp in RECURRENT_SERVE + ENCDEC_SERVE:
        for phase, n in (("prefill", rb * rp), ("decode", rb)):
            norm_check(arch, configs.get_config(arch), phase, n)

    def flash_timed(cfg, T, S, **reps):
        q, k, v = flash_case(T, S, seed=1, **dims(cfg))
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        nbytes, flops = flash_cost(B, H, KV, T, S, D)
        b, by = bound_ms(nbytes, flops, PEAK_BF16_S)
        lib = (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)) if T == S else (
            lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True))
        return dict(
            shape=f"q [{B},{H},{T},{D}] k/v [{B},{KV},{S},{D}] bf16",
            ms=graph_ms(torch, lambda: flash_attention(q, k, v), **reps),
            plain_ms=graph_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v), **reps),
            bound_ms=b, bound_by=by, library_ms=graph_ms(torch, lib, **reps))

    k5 = dict(flash_timed(archs[0][1], *cases["prefill"]),
              max_abs_err=err["flash_attention"])
    for key, val in flash_timed(archs[0][1], *cases["decode"]).items():
        k5["decode_" + key] = val
    def window_timed(tag):
        T, S, w = win_cases[tag]
        q, k, v = flash_case(T, S, seed=1, Bc=rg_b, C=rg.window, **rg_dims)
        H, KV, D = rg.num_heads, rg.num_kv_heads, rg.head_dim
        nbytes, flops = flash_cost(rg_b, H, KV, T, S, D, window=w)
        b, by = bound_ms(nbytes, flops, PEAK_BF16_S)
        mask = torch.ones(T, S, dtype=torch.bool, device=dev).tril(S - T)
        if w:
            mask = mask.triu(S - T - w + 1)
        return dict(
            shape=f"q [{rg_b},{H},{T},{D}] k/v [{rg_b},{KV},{S},{D}] bf16, "
                  f"window {w}",
            ms=graph_ms(torch, lambda: flash_attention(q, k, v, window=w)),
            plain_ms=graph_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, window=w), reps=10, rounds=3),
            bound_ms=b, bound_by=by,
            library_ms=graph_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), reps=20,
                rounds=3))

    k5["window_shapes"] = {f"recurrentgemma_2b {tag}": window_timed(tag)
                           for tag in win_cases}

    def encdec_timed(tag):
        cfg, Bc, T, S, causal = ed_cases[tag]
        q, k, v = flash_case(T, S, seed=1, Bc=Bc, C=S, **dims(cfg))
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        nbytes, flops = flash_cost(Bc, H, KV, T, S, D, causal=causal)
        b, by = bound_ms(nbytes, flops, PEAK_BF16_S)
        full = causal and T == S        # else every key is seen
        return dict(
            shape=f"q [{Bc},{H},{T},{D}] k/v [{Bc},{KV},{S},{D}] bf16, "
                  f"{'causal' if causal else 'unmasked'}",
            ms=graph_ms(torch, lambda: flash_attention(q, k, v,
                                                       causal=causal),
                        reps=20, rounds=3),
            plain_ms=graph_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=causal), reps=5, rounds=3),
            bound_ms=b, bound_by=by,
            library_ms=graph_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=full, enable_gqa=True), reps=20,
                rounds=3))

    k5["encdec_shapes"] = {tag: encdec_timed(tag) for tag in ed_cases}
    k5["arch_shapes"] = {}
    for arch, cfg in archs[1:]:
        row = flash_timed(cfg, *cases["prefill"], reps=20, rounds=3)
        for key, val in flash_timed(cfg, *cases["decode"], reps=20,
                                    rounds=3).items():
            row["decode_" + key] = val
        k5["arch_shapes"][arch] = row
    rows, q14 = {}, archs[0][1]
    for tag, (N, Dn) in (("", (B * P, q14.d_model)),
                         ("qk_", (B * P * q14.num_heads, q14.head_dim)),
                         ("decode_", (B, q14.d_model))):
        x, s = (torch.as_tensor(a, device=dev)
                for a in sup.rmsnorm_inputs(N, Dn, seed=1))
        x = x.to(bf)
        sb = s.to(bf)
        nbytes, flops = rmsnorm_cost(N, Dn)
        b, by = bound_ms(nbytes, flops)
        rows[tag] = dict(
            shape=f"x [{N},{Dn}] bf16, scale f32",
            ms=graph_ms(torch, lambda: rmsnorm(x, s)),
            plain_ms=graph_ms(torch, lambda: ref.rmsnorm_ref(x, s)),
            bound_ms=b, bound_by=by,
            library_ms=graph_ms(torch, lambda: F.rms_norm(x, (Dn,), sb,
                                                          1e-6)),
            library_f32_scale_ms=graph_ms(
                torch, lambda: F.rms_norm(x, (Dn,), s, 1e-6), reps=20,
                rounds=3))
    for tag, row in rows.items():
        log(f"[lm] time rmsnorm {row['shape']}: K6 {row['ms'] * 1e3!r} us, "
            f"F.rms_norm {row['library_ms'] * 1e3!r} us with the scale in "
            f"bf16 (K6 / F.rms_norm {row['ms'] / row['library_ms']!r}), "
            f"{row['library_f32_scale_ms'] * 1e3!r} us with the same float32 "
            f"scale; bound {row['bound_ms'] * 1e3!r} us")
    k6 = dict(rows[""], max_abs_err=err["rmsnorm"])
    for pre in ("qk_", "decode_"):
        for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_f32_scale_ms"):
            k6[pre + key] = rows[pre][key]
    out = {"flash_attention": k5, "rmsnorm": k6}
    for name, row in out.items():
        log(f"[lm] time {name}: " + json.dumps(row))
    return out


ATTN_KINDS = ("attn", "moe", "local", "enc", "dec")


def norms_per_layer(cfg, kind="attn"):
    """K6 launches a block of ``kind`` makes in a forward: ln1, ln2 but
    in an ``"ssm"`` block (which has no MLP) and lnx in a ``"dec"`` block,
    where the norm is RMSNorm (a layernorm is plain torch, and so is
    mamba2's gated norm), and q_norm and k_norm with the qk-norm in a
    self-attention (the cross-attention has none)."""
    return ((1 + (kind != "ssm") + (kind == "dec")) * (cfg.norm == "rmsnorm")
            + 2 * bool(cfg.qk_norm) * (kind in ATTN_KINDS))


def layer_launches(cfg):
    """(K5, K6) launches of one forward through the decoder's blocks: K5
    once per self-attention (``ATTN_KINDS``) and once more per
    cross-attention (``"dec"``), K6 ``norms_per_layer`` times per block;
    the final norm not counted."""
    G = cfg.pattern_groups
    return (G * sum((k in ATTN_KINDS) + (k == "dec") for k in cfg.pattern),
            G * sum(norms_per_layer(cfg, k) for k in cfg.pattern))


def encoder_launches(cfg):
    """(K5, K6 in the blocks, K6 of its ``ln_f``) of one pass of an
    encoder-decoder's encoder, which runs once a prefill (or a training
    microbatch), not once a decode step: ``enc_layers`` ``"enc"`` blocks;
    (0, 0, 0) for a decoder-only model."""
    if not cfg.enc_layers:
        return 0, 0, 0
    return (cfg.enc_layers, cfg.enc_layers * norms_per_layer(cfg, "enc"),
            int(cfg.norm == "rmsnorm"))


def serve_expected_launches(cfg, forwards):
    """Per forward: K5 once per attention (self and cross), K6
    ``norms_per_layer`` times per layer plus the final norm where it is
    RMSNorm; once a run, the encoder's (``encoder_launches``); no other
    kernel."""
    attn, norms = layer_launches(cfg)
    ea, en, ef = encoder_launches(cfg)
    return {"flash_attention": attn * forwards + ea,
            "rmsnorm": (norms + (cfg.norm == "rmsnorm")) * forwards + en
            + ef}


def phase_serve(torch, kernels, sup, dev, profile=False):
    """qwen3-14b at full width through ``decode_loop`` (see the module
    docstring). Returns (launches, summary)."""
    from repro_torch import configs
    return serve_model(torch, kernels, sup, dev,
                       configs.get_config("qwen3-14b"), "serve", profile)


def phase_serve_archs(torch, kernels, sup, dev, smi):
    """8b: ``decode_loop`` for each of ``SERVE_ARCHS`` at full width (see
    the module docstring), each model freed before the next loads.
    Returns {arch: (launches, summary)}."""
    import dataclasses
    from repro_torch import configs
    out = {}
    for arch, layers in SERVE_ARCHS:
        cfg = configs.get_config(arch)
        full = cfg.num_layers
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        launches, summ = serve_model(torch, kernels, sup, dev, cfg,
                                     "serve 8b", steps=SERVE_ARCH_STEPS)
        summ.update(layers=cfg.num_layers, of_layers=full)
        log(f"[serve 8b] {cfg.name}: {cfg.num_layers} of {full} layers; "
            f"{smi}")
        out[arch] = (launches, summ)
    return out


# 8c: the recurrent and state-space architectures at full width, all
# their layers, (arch, batch, prompt): recurrentgemma-2b's prompts are
# twice its window of 2 048, so its ring wraps in the prefill; mamba2's
# span four SSD chunks of 256, the last one padded
RECURRENT_SERVE = (("recurrentgemma_2b", 2, 4096), ("mamba2_130m", 4, 1000))
RECURRENT_SERVE_STEPS = 16


def phase_serve_recurrent(torch, kernels, sup, dev, smi, profile=False):
    """8c: ``decode_loop`` for each of ``RECURRENT_SERVE`` at full width
    (see the module docstring), each model freed before the next loads;
    with ``profile``, each run a second time under ``torch.profiler``.
    Returns {arch: (launches, summary)}."""
    from repro_torch import configs
    out = {}
    for arch, batch, prompt in RECURRENT_SERVE:
        cfg = configs.get_config(arch)
        launches, summ = serve_model(
            torch, kernels, sup, dev, cfg, "serve 8c", profile,
            steps=RECURRENT_SERVE_STEPS, batch=batch, prompt_len=prompt,
            cache_len=prompt + RECURRENT_SERVE_STEPS)
        summ.update(layers=cfg.num_layers, of_layers=cfg.num_layers)
        log(f"[serve 8c] {cfg.name}: all {cfg.num_layers} layers "
            f"({cfg.pattern.count('local') * cfg.pattern_groups} local, "
            f"window {cfg.window}); {smi}")
        out[arch] = (launches, summ)
    return out


# 8d: the encoder-decoder and vision-language architectures at full width,
# all their layers, (arch, batch, prompt): whisper-large-v3's 256 decoder
# tokens over the 1 500 frames of its encoder; phi3-vision's 1 024, the
# first 576 of them image positions
ENCDEC_SERVE = (("whisper_large_v3", 4, 256), ("phi3_vision_4_2b", 4, 1024))
ENCDEC_SERVE_STEPS = 16


def frontend_extras(torch, dev, cfg, batch, seed):
    """The frontend stubs' embeddings an encoder-decoder or a
    vision-language model takes (``enc_feats`` [batch, enc_seq, d],
    ``img_embeds`` [batch, num_image_tokens, d]), float32 drawn on the
    card from ``seed``."""
    out = {}
    if cfg.enc_layers:
        out["enc_feats"], = card_normal(
            torch, dev, seed, (batch, cfg.enc_seq, cfg.d_model))
    if cfg.num_image_tokens:
        out["img_embeds"], = card_normal(
            torch, dev, seed + 1, (batch, cfg.num_image_tokens,
                                   cfg.d_model))
    return out


def phase_serve_encdec(torch, kernels, sup, dev, smi, profile=False):
    """8d: ``decode_loop`` for each of ``ENCDEC_SERVE`` at full width with
    its frontend's embeddings (see the module docstring), each model
    freed before the next loads; with ``profile``, each run a second time
    under ``torch.profiler``. Returns {arch: (launches, summary)}."""
    from repro_torch import configs
    out = {}
    for arch, batch, prompt in ENCDEC_SERVE:
        cfg = configs.get_config(arch)
        launches, summ = serve_model(
            torch, kernels, sup, dev, cfg, "serve 8d", profile,
            steps=ENCDEC_SERVE_STEPS, batch=batch, prompt_len=prompt,
            cache_len=prompt + ENCDEC_SERVE_STEPS,
            extras=frontend_extras(torch, dev, cfg, batch, 2))
        summ.update(layers=cfg.num_layers, of_layers=cfg.num_layers,
                    enc_layers=cfg.enc_layers)
        log(f"[serve 8d] {cfg.name}: all {cfg.num_layers} layers"
            f"{f' and {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}"
            f", head dim {cfg.head_dim}; {smi}")
        out[arch] = (launches, summ)
    return out


def serve_model(torch, kernels, sup, dev, cfg, tag, profile=False,
                steps=None, batch=None, prompt_len=None, cache_len=None,
                extras=None):
    """One model at ``cfg`` through ``decode_loop``: random params drawn
    on the card, ``batch`` prompts of ``prompt_len`` tokens (the serve
    run's by default), ``steps`` greedy tokens (its ``SERVE_STEPS`` by
    default) over a cache of ``cache_len`` (its ``SERVE_CACHE``), the
    prefill's other inputs ``extras`` ({name: tensor on the card}) where
    given, launches zeroed before and read after and held to
    ``serve_expected_launches``, every logit finite, every token below the
    true vocabulary; the memory freed before and after. Returns
    (launches, summary)."""
    from repro_torch import models, serve
    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    steps = steps or sup.SERVE_STEPS
    batch = batch or sup.SERVE_BATCH
    prompt_len = prompt_len or sup.SERVE_PROMPT
    cache_len = cache_len or sup.SERVE_CACHE
    specs = models.lm_specs(cfg)
    t0 = time.perf_counter()
    params = models.init_params(
        specs, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(1)
    tv = cfg.true_vocab or cfg.vocab_size
    prompt = torch.randint(0, tv, (batch, prompt_len), generator=gen,
                           device=dev)
    log(f"[{tag}] {cfg.name}: {models.num_params(specs)} params "
        f"({models.num_bytes(specs) / 1e9:.2f} GB {cfg.param_dtype}) drawn "
        f"on the card in {init_s:.2f} s; prompts {list(prompt.shape)}, "
        f"{steps} greedy tokens, cache {cache_len}"
        + "".join(f"; {k} {list(v.shape)}" for k, v in (extras or {}).items()))

    stamps, finite = [], []

    def on_logits(lg):
        finite.append(torch.isfinite(lg).all())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    def run():
        stamps.clear()
        finite.clear()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        toks = serve.decode_loop(params, cfg, prompt, steps,
                                 cache_len=cache_len, extras=extras,
                                 on_logits=on_logits)
        torch.cuda.synchronize()
        return toks

    kernels.reset_launches()
    toks = run()
    launches = dict(kernels.LAUNCHES)
    want = serve_expected_launches(cfg, steps)
    for name in set(launches) | set(want):
        if launches.get(name, 0) != want.get(name, 0):
            raise AssertionError(f"{tag} {cfg.name}: {name} launched "
                                 f"{launches.get(name, 0)} times, expected "
                                 f"{want.get(name, 0)}")
    if len(finite) != steps or not all(bool(f) for f in finite):
        raise AssertionError(f"{tag} {cfg.name}: non-finite logits")
    if tuple(toks.shape) != (batch, steps) or not bool(
            ((toks >= 0) & (toks < tv)).all()):
        raise AssertionError(f"{tag} {cfg.name}: tokens {toks.shape} "
                             f"outside [0, {tv})")
    gaps = np.diff(stamps)
    summ = dict(prefill_s=float(gaps[0]),
                decode_ms_per_step=float(gaps[1:].mean() * 1e3),
                decode_ms_min=float(gaps[1:].min() * 1e3),
                decode_ms_max=float(gaps[1:].max() * 1e3),
                total_s=float(stamps[-1] - stamps[0]),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches)
    summ["decode_tokens_per_s"] = batch / (summ["decode_ms_per_step"] / 1e3)
    summ["tokens_per_s"] = batch * steps / summ["total_s"]
    summ.update(batch=batch, prompt=prompt_len, steps=steps,
                cache_len=cache_len)
    summ["params"] = models.num_params(specs)
    log(f"[{tag}] {cfg.name}: prefill {summ['prefill_s']!r} s, decode "
        f"{summ['decode_ms_per_step']!r} ms/step (min "
        f"{summ['decode_ms_min']!r}, max {summ['decode_ms_max']!r}), "
        f"{summ['decode_tokens_per_s']!r} tokens/s in decode, "
        f"{summ['tokens_per_s']!r} tokens/s end to end, peak "
        f"{summ['peak_gb']!r} GB; launches {launches}; all logits finite; "
        f"first tokens {toks[:, :6].tolist()}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        # device activity alone: the host ops' trace (~10^5 events a
        # mamba2 step) costs minutes to take and reduce
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            run()
        avgs = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(_self_device_us(e) for e in avgs)
        share = {k: sum(_self_device_us(e) for e in avgs
                        if k in e.key) / max(total, 1e-9)
                 for k in ("flash_tiled_mma", "flash_split_mma",
                           "rmsnorm_kernel")}
        wall = stamps[-1] - stamps[0]
        who = f"({tag}) {cfg.name}"
        log(f"[profile] {who} serve: device {total / 1e3:.1f} ms of "
            f"{wall * 1e3:.1f} ms wall (busy share {total / 1e6 / wall!r}); "
            f"{sum(e.count for e in avgs)} device launches; "
            f"share of device time: K5 prefill {share['flash_tiled_mma']!r},"
            f" K5 decode {share['flash_split_mma']!r}, K6 "
            f"{share['rmsnorm_kernel']!r}")
        for e in sorted(avgs, key=_self_device_us, reverse=True)[:10]:
            log(f"[profile] {who}   {_self_device_us(e) / 1e3:9.3f} ms  "
                f"{e.count:6d} calls  {e.key[:90]}")
    del params, prompt, toks, extras
    free_memory(torch)
    return launches, summ


# -------------------------------------------------------------------------
# phase 9: the one-card trainer (K5's and K6's backward kernels, qwen3-14b
# at full width cut to TRAIN_LAYERS layers, the REDUCED crash/resume and
# golden)
# -------------------------------------------------------------------------

# 9b: qwen3-14b at full width, depth cut to TRAIN_LAYERS of 40 layers;
# train_preset's microbatching over DataConfig(batch=8, seq=1024)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_RUN_STEPS = 4, 8, 1024, 5
# 9b asserts its peak device memory stays under this (GB)
TRAIN_PEAK_GB = 75.0
# 9d: the other architectures' training at full width, depth cut to
# TRAIN_ARCH_LAYERS, TRAIN_ARCH_STEPS steps each
TRAIN_ARCHS = ("gemma_7b", "qwen3_moe_30b_a3b")
TRAIN_ARCH_LAYERS, TRAIN_ARCH_STEPS = 2, 3
# 9e: the recurrent and state-space architectures at full width, (arch,
# layers, batch, seq): recurrentgemma-2b cut to one pattern group (13 of
# 26 layers: 9 rec, 4 local) on sequences of 4 096, twice its window, so
# that K5's windowed backward runs at the model's own shapes; mamba2-130m
# whole on sequences of 1 024, four SSD chunks with the chunk recurrence
# between them
RECURRENT_TRAIN = (("recurrentgemma_2b", 13, 8, 4096),
                   ("mamba2_130m", 6, 8, 1024))
RECURRENT_TRAIN_STEPS = 3
# 9f: the encoder-decoder and vision-language architectures at full
# width, (arch, decoder layers, batch, seq): whisper-large-v3 whole (32
# encoder and 32 decoder layers) on 448 decoder tokens over its 1 500
# frames; phi3-vision cut to 8 of 32 layers on 1 024 tokens, the first
# 576 image positions, so that K5's backward runs at head dim 96 on the
# model's own shape
ENCDEC_TRAIN = (("whisper_large_v3", 32, 8, 448),
                ("phi3_vision_4_2b", 8, 8, 1024))
ENCDEC_TRAIN_STEPS = 3
# 9a holds K5 bwd and K6 bwd at the training shapes of these
# architectures (``train_kernel_shapes``): 9b's and 9d's, and
# stablelm-3b's head dim 80, which trains on the CPU only
BWD_ARCHS = ("qwen3_14b",) + TRAIN_ARCHS + ("stablelm_3b",)
# and at two edges, (B, H, KV, T, S, D, bf16), causal: float32, and the
# REDUCED models' head dim 16
FLASH_BWD_EDGE = ((1, 4, 2, 128, 128, 64, False),
                  (2, 4, 2, 32, 32, 16, True))


def flash_bwd_cost(B, H, KV, T, S, D, itemsize=2, window=0, causal=True):
    """K5's backward, causal with the queries at the last T of S, or
    unmasked: q, o, do and k, v read once, dq, dk, dv written once, the
    float32 LSE read; 10·D flops (five products, each a multiply and an
    add) per visible query-key pair (``visible_pairs``, inside the window
    where there is one, all T·S unmasked): S and dP recomputed, dV, dK
    and dQ."""
    return ((4 * B * H * T * D + 4 * B * KV * S * D) * itemsize
            + 4 * B * H * T), \
        10 * B * H * D * visible_pairs(T, S, window, causal)


def rmsnorm_bwd_cost(N, D, itemsize=2):
    """K6's backward: x and dy read and dx written once, the float32 scale
    read and its gradient written; ~12 flops an element (two sums, dx's
    four products and a difference, dscale's two products and add)."""
    return 3 * N * D * itemsize + 8 * D, 12 * N * D


def train_expected_launches(cfg, tcfg):
    """Per train step, from the code: per microbatch each attention
    block runs K5 once and each block K6 ``norms_per_layer`` times (ln1,
    ln2 where the norm is RMSNorm but in an ``"ssm"`` block, q_norm and
    k_norm with the qk-norm), twice under remat "full" (the forward and
    its recompute in the backward), and each of their backward kernels
    once; ``ln_f``, outside the groups, K6 and its backward once where it
    is RMSNorm; an encoder's blocks and ``ln_f`` likewise, once a
    microbatch (``encoder_launches``)."""
    k = max(tcfg.microbatch, 1)
    fwd = {"none": 1, "full": 2}[tcfg.remat]
    attn, n = layer_launches(cfg)
    ea, en, ef = encoder_launches(cfg)
    attn, n, f = attn + ea, n + en, int(cfg.norm == "rmsnorm") + ef
    return {"flash_attention": fwd * attn * k,
            "flash_attention_bwd": attn * k,
            "rmsnorm": (fwd * n + f) * k, "rmsnorm_bwd": (n + f) * k}


def window_bwd_shape():
    """K5 bwd's (B, H, KV, T, S, D, window, bf16) in a microbatch of 9e's
    recurrentgemma-2b (``RECURRENT_TRAIN``) under its ``train_preset``."""
    from repro_torch import configs
    from repro_torch.launch import train_preset
    arch, _, batch, seq = RECURRENT_TRAIN[0]
    cfg = configs.get_config(arch)
    B = batch // max(train_preset(arch).microbatch, 1)
    return (B, cfg.num_heads, cfg.num_kv_heads, seq, seq, cfg.head_dim,
            cfg.window, cfg.compute_dtype == "bfloat16")


def train_kernel_shapes(arch, cfg):
    """K5 bwd's (B, H, KV, T, S, D, bf16) and K6 bwd's {tag: (N, width)}
    in a microbatch of ``cfg`` under ``train_preset(arch)`` over
    DataConfig(TRAIN_BATCH, TRAIN_SEQ)."""
    from repro_torch.launch import train_preset
    B = TRAIN_BATCH // max(train_preset(arch).microbatch, 1)
    return ((B, cfg.num_heads, cfg.num_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
             cfg.head_dim, cfg.compute_dtype == "bfloat16"),
            norm_rows(cfg, B * TRAIN_SEQ))


def encdec_bwd_shapes():
    """{name: (B, H, KV, T, S, D, causal, bf16)}: K5 bwd's shapes in a
    microbatch of 9f (``ENCDEC_TRAIN`` under ``train_preset``): an
    encoder's self-attention over its frames and its decoder's
    cross-attention over them (unmasked); a decoder-only model's causal
    self-attention."""
    from repro_torch import configs
    from repro_torch.launch import train_preset
    out = {}
    for arch, _, batch, seq in ENCDEC_TRAIN:
        cfg = configs.get_config(arch)
        B = batch // max(train_preset(arch).microbatch, 1)
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        bf16 = cfg.compute_dtype == "bfloat16"
        if cfg.enc_layers:
            F = cfg.enc_seq
            out[f"{arch} encoder"] = (B, H, KV, F, F, D, False, bf16)
            out[f"{arch} cross"] = (B, H, KV, seq, F, D, False, bf16)
        else:
            out[arch] = (B, H, KV, seq, seq, D, True, bf16)
    return out


def phase_train_kernels(torch, sup, dev):
    """9a: K5's and K6's backward kernels against their plain versions at
    the training shapes of ``BWD_ARCHS`` and at ``FLASH_BWD_EDGE``, and
    bit for bit against a second launch, then timed beside the plain
    version and autograd of the PyTorch call. Returns {name: row} for the
    kernels line (qwen3-14b's shapes, the other architectures' K5 bwd
    under ``arch_shapes``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    err = {"flash_attention_bwd": 0.0, "rmsnorm_bwd": 0.0}
    rel = dict(err)
    archs = arch_cfgs(BWD_ARCHS)
    shapes = {arch: train_kernel_shapes(arch, cfg) for arch, cfg in archs}
    # (B, H, KV, T, S, D, causal, bf16) by name: the architectures'
    # (causal), the edges, 9f's (``encdec_bwd_shapes``) and head dim 96's
    # edges (``sup.FLASH_BWD_D96_SHAPES``)
    bwd = {a: sh[0][:6] + (True,) + sh[0][6:] for a, sh in shapes.items()}
    bwd.update(encdec_bwd_shapes())
    edges = ([c[:6] + (True,) + c[6:] for c in FLASH_BWD_EDGE]
             + list(sup.FLASH_BWD_D96_SHAPES))
    flash = {}
    for what, (B, H, KV, T, S, D, causal, bf16) in (
            list(bwd.items()) + [("edge", c) for c in edges]):
        dt = torch.bfloat16 if bf16 else torch.float32
        q, k, v, do = (a.to(dt) for a in card_normal(
            torch, dev, T + S + D, (B, H, T, D), (B, KV, S, D),
            (B, KV, S, D), (B, H, T, D)))
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal)
        torch.cuda.synchronize()
        bar = sup.BWD_BAR_BF16 if bf16 else sup.BWD_BAR_F32
        mask = "causal" if causal else "unmasked"
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            r = sup.rel_err(g, w)
            if not r <= bar:
                raise AssertionError(f"flash_attention_bwd {what} {name} "
                                     f"{list(q.shape)} {mask}: {r} of the "
                                     f"largest gradient (bar {bar})")
            torch.testing.assert_close(a, g, rtol=0, atol=0)
            e = float((g.float() - w.float()).abs().max())
            err["flash_attention_bwd"] = max(err["flash_attention_bwd"], e)
            rel["flash_attention_bwd"] = max(rel["flash_attention_bwd"], r)
            log(f"[train] flash_attention_bwd {what} {name} q "
                f"{list(q.shape)} k/v {list(k.shape)} {dt} {mask}: max abs "
                f"err {e!r}, {r!r} of the largest gradient (bar {bar}); "
                f"bitwise equal to a second launch")
        if what != "edge":                      # timed below
            flash[what] = (q, k, v, o, lse, do)
    # with a window: 9e's recurrentgemma-2b (``window_bwd_shape``) and the
    # tiles' edges (``sup.FLASH_BWD_WINDOW_SHAPES``), each gradient
    # relative to its largest value floored at 1e-3 of the three's
    # largest (``sup.bwd_errs``: a window of one makes dq and dk zero)
    win_shape = window_bwd_shape()
    for what, (B, H, KV, T, S, D, w, bf16) in (
            [("recurrentgemma_2b", win_shape)]
            + [("window edge", c) for c in sup.FLASH_BWD_WINDOW_SHAPES]):
        dt = torch.bfloat16 if bf16 else torch.float32
        q, k, v, do = (a.to(dt) for a in card_normal(
            torch, dev, T + D + w, (B, H, T, D), (B, KV, S, D),
            (B, KV, S, D), (B, H, T, D)))
        o, lse = flash_attention(q, k, v, causal=True, window=w,
                                 return_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=w)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                    window=w)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                           window=w)
        torch.cuda.synchronize()
        bar = sup.BWD_BAR_BF16 if bf16 else sup.BWD_BAR_F32
        for name, g, a, wt, r in zip(("dq", "dk", "dv"), got, again, want,
                                     sup.bwd_errs(got, want)):
            if not r <= bar:
                raise AssertionError(f"flash_attention_bwd {what} {name} "
                                     f"{list(q.shape)} window {w}: {r} of "
                                     f"its largest gradient (bar {bar})")
            torch.testing.assert_close(a, g, rtol=0, atol=0)
            e = float((g.float() - wt.float()).abs().max())
            err["flash_attention_bwd"] = max(err["flash_attention_bwd"], e)
            rel["flash_attention_bwd"] = max(rel["flash_attention_bwd"], r)
            log(f"[train] flash_attention_bwd {what} {name} q "
                f"{list(q.shape)} k/v {list(k.shape)} {dt} window {w}: max "
                f"abs err {e!r}, {r!r} of its largest gradient (bar {bar}); "
                f"bitwise equal to a second launch")
        if what != "window edge":               # timed below
            flash["window"] = (q, k, v, o, lse, do)
    norm, seen = {}, set()
    for arch, cfg in archs:
        for tag, (N, Dn) in shapes[arch][1].items():
            if (N, Dn) in seen:
                continue
            seen.add((N, Dn))
            x, s, dy = card_normal(torch, dev, N + Dn, (N, Dn), (Dn,),
                                   (N, Dn))
            x, s = x * 3.0, (1.0 + 0.1 * s).to(getattr(torch,
                                                        cfg.param_dtype))
            for dt in (torch.bfloat16, torch.float32):
                xd, dyd = x.to(dt), dy.to(dt)
                got = rmsnorm_bwd(xd, s, dyd)
                again = rmsnorm_bwd(xd, s, dyd)
                want = ref.rmsnorm_bwd_ref(xd, s, dyd)
                torch.cuda.synchronize()
                bar = sup.BWD_BAR_BF16 if dt == torch.bfloat16 else \
                    sup.BWD_BAR_F32
                for name, g, a, w in zip(("dx", "dscale"), got, again, want):
                    r = sup.rel_err(g, w)
                    if not r <= bar:
                        raise AssertionError(
                            f"rmsnorm_bwd {arch} {tag} {name} [{N}, {Dn}] "
                            f"{dt}: {r} (bar {bar})")
                    torch.testing.assert_close(a, g, rtol=0, atol=0)
                    e = float((g.float() - w.float()).abs().max())
                    err["rmsnorm_bwd"] = max(err["rmsnorm_bwd"], e)
                    rel["rmsnorm_bwd"] = max(rel["rmsnorm_bwd"], r)
                    log(f"[train] rmsnorm_bwd {arch} {tag} {name} [{N}, "
                        f"{Dn}] {dt}: max abs err {e!r}, {r!r} of the "
                        f"largest gradient (bar {bar}); bitwise equal to a "
                        f"second launch")
            if arch == "qwen3_14b" and tag in ("ln", "q"):     # timed below
                norm[tag] = (x.to(torch.bfloat16), s, dy.to(torch.bfloat16))

    def autograd_ms(fn, ins, grads, reps=20):
        """Device time of the backward alone of ``fn(*ins)`` (its graph kept
        between calls): the self device time of its kernels over ``reps``
        calls (``torch.profiler``), so that the autograd engine's host time
        between launches is not counted."""
        from torch.profiler import ProfilerActivity, profile
        leaves = [t.detach().requires_grad_() for t in ins]
        out = fn(*leaves)
        torch.autograd.grad(out, leaves, grads, retain_graph=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.autograd.grad(out, leaves, grads, retain_graph=True)
            torch.cuda.synchronize()
        return sum(_self_device_us(e) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   ) / reps / 1e3

    def flash_timed(what):
        B, H, KV, T, S, D, causal, _ = bwd[what]
        args = flash[what]
        nbytes, flops = flash_bwd_cost(B, H, KV, T, S, D, causal=causal)
        b, by = bound_ms(nbytes, flops, PEAK_BF16_S)
        return dict(
            shape=f"q [{B},{H},{T},{D}] k/v [{B},{KV},{S},{D}] bf16, "
                  f"{'causal' if causal else 'unmasked'}",
            ms=graph_ms(torch, lambda: flash_attention_bwd(
                *args, causal=causal)),
            plain_ms=graph_ms(torch, lambda: ref.flash_attention_bwd_ref(
                *args, causal=causal), reps=10, rounds=3),
            bound_ms=b, bound_by=by,
            library_ms=autograd_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal and T == S, enable_gqa=True),
                args[:3], args[5]))

    def backward_ms(fn, ins, grads):
        """The backward alone of ``fn(*ins)`` (its graph kept between
        calls) between CUDA events, host time included (a few launches
        against milliseconds of device time here): the profiler's capture
        of SDPA's masked backward read anything from 0 to 2.2 ms across
        runs."""
        leaves = [t.detach().requires_grad_() for t in ins]
        out = fn(*leaves)
        return eager_ms(torch, lambda: torch.autograd.grad(
            out, leaves, grads, retain_graph=True), reps=10)

    def window_timed():
        B, H, KV, T, S, D, w, _ = win_shape
        args = flash["window"]
        nbytes, flops = flash_bwd_cost(B, H, KV, T, S, D, window=w)
        b, by = bound_ms(nbytes, flops, PEAK_BF16_S)
        mask = torch.ones(T, S, dtype=torch.bool, device=dev).tril(
            S - T).triu(S - T - w + 1)
        return dict(
            window_shape=f"q [{B},{H},{T},{D}] k/v [{B},{KV},{S},{D}] bf16, "
                         f"causal, window {w}",
            window_ms=graph_ms(torch, lambda: flash_attention_bwd(
                *args, causal=True, window=w)),
            window_plain_ms=graph_ms(
                torch, lambda: ref.flash_attention_bwd_ref(
                    *args, causal=True, window=w), reps=3, rounds=3),
            window_bound_ms=b, window_bound_by=by,
            window_library_ms=backward_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True),
                args[:3], args[5]))

    k5 = dict(flash_timed("qwen3_14b"),
              max_abs_err=err["flash_attention_bwd"],
              max_rel_err=rel["flash_attention_bwd"],
              arch_shapes={a: flash_timed(a) for a in BWD_ARCHS[1:]},
              encdec_shapes={w: flash_timed(w) for w in encdec_bwd_shapes()})
    k5.update(window_timed())
    rows = {}
    for tag, key in (("", "ln"), ("qk_", "q")):
        x, s, dy = norm[key]
        N, Dn = x.shape
        nbytes, flops = rmsnorm_bwd_cost(N, Dn)
        b, by = bound_ms(nbytes, flops)
        rows[tag] = dict(
            shape=f"x [{N},{Dn}] bf16, scale f32",
            ms=graph_ms(torch, lambda: rmsnorm_bwd(x, s, dy)),
            plain_ms=eager_ms(torch, lambda: ref.rmsnorm_bwd_ref(x, s, dy),
                              reps=1, rounds=1),
            bound_ms=b, bound_by=by,
            library_ms=autograd_ms(
                lambda x_, s_: F.rms_norm(x_, (Dn,), s_, 1e-6),
                (x, s.to(torch.bfloat16)), dy))
    k6 = dict(rows[""], max_abs_err=err["rmsnorm_bwd"],
              max_rel_err=rel["rmsnorm_bwd"])
    for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        k6["qk_" + key] = rows["qk_"][key]
    out = {"flash_attention_bwd": k5, "rmsnorm_bwd": k6}
    for name, row in out.items():
        log(f"[train] time {name}: " + json.dumps(row))
    return out


def _train_shares(torch, prof):
    """The share of a profiled train step's device time that K5, K5 bwd,
    K6, K6 bwd, the dtype casts and cuBLAS take (by kernel name); with
    the total, the ten largest items and the device launches."""
    devs = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(_self_device_us(e) for e in devs)
    groups = {"K5": ("flash_tiled",), "K5_bwd": ("flash_bwd_",),
              "K6": ("rmsnorm_kernel",), "K6_bwd": ("rmsnorm_bwd_",),
              "casts": ("copy",), "cublas": ("gemm", "cutlass", "xmma",
                                             "nvjet", "cublas")}
    share = {g: sum(_self_device_us(e) for e in devs
                    if any(n in e.key for n in names)) / max(total, 1e-9)
             for g, names in groups.items()}
    top = [(e.key[:90], _self_device_us(e) / 1e3, e.count)
           for e in sorted(devs, key=_self_device_us, reverse=True)[:10]]
    return total, share, top, sum(e.count for e in devs)


def phase_train(torch, kernels, dev, profile=False):
    """9b: qwen3-14b at full width cut to TRAIN_LAYERS layers through
    ``train_driver`` (see the module docstring). Returns (launches of one
    step, summary)."""
    return train_model(torch, kernels, dev, "qwen3_14b", TRAIN_LAYERS,
                       TRAIN_RUN_STEPS, "9b", profile)


def phase_train_recurrent(torch, kernels, dev, smi, profile=False):
    """9e: ``RECURRENT_TRAIN`` through ``train_driver`` (see the module
    docstring); with ``profile``, one more step of each under
    ``torch.profiler``. Returns {arch: (launches of one step,
    summary)}."""
    out = {}
    for arch, layers, batch, seq in RECURRENT_TRAIN:
        out[arch] = train_model(torch, kernels, dev, arch, layers,
                                RECURRENT_TRAIN_STEPS, "9e", profile,
                                batch=batch, seq=seq)
        log(f"[train] (9e) {arch}: {smi}")
    return out


def phase_train_encdec(torch, kernels, dev, smi, profile=False):
    """9f: ``ENCDEC_TRAIN`` through ``train_driver`` (see the module
    docstring); with ``profile``, one more step of each under
    ``torch.profiler``. Returns {arch: (launches of one step,
    summary)}."""
    out = {}
    for arch, layers, batch, seq in ENCDEC_TRAIN:
        out[arch] = train_model(torch, kernels, dev, arch, layers,
                                ENCDEC_TRAIN_STEPS, "9f", profile,
                                batch=batch, seq=seq)
        log(f"[train] (9f) {arch}: {smi}")
    return out


def phase_train_archs(torch, kernels, dev, smi):
    """9d: ``TRAIN_ARCHS`` through ``train_driver`` (see the module
    docstring). Returns {arch: (launches of one step, summary)}."""
    out = {}
    for arch in TRAIN_ARCHS:
        out[arch] = train_model(torch, kernels, dev, arch, TRAIN_ARCH_LAYERS,
                                TRAIN_ARCH_STEPS, "9d")
        log(f"[train] (9d) {arch}: {smi}")
    return out


def encoder_params(specs):
    """Parameters an encoder frame runs through: the encoder's, but its
    position table (a lookup)."""
    from repro_torch import models
    enc = specs.get("encoder")
    return models.num_params(enc) - models.num_params(enc["pos"]) if enc \
        else 0


def active_params(cfg, specs):
    """Parameters a decoder token runs through: all of them but the
    encoder's and the learned position table (a lookup), and only k of E
    experts in a MoE block."""
    from repro_torch import models
    n = models.num_params(specs)
    if "encoder" in specs:
        n -= models.num_params(specs["encoder"])
    if "pos" in specs["embed"]:
        n -= models.num_params(specs["embed"]["pos"])
    if cfg.num_experts:
        experts = sum(models.num_params(v) for blk in specs["blocks"].values()
                      for k, v in blk["mlp"].items() if k != "router")
        n -= experts * (1 - cfg.experts_per_token / cfg.num_experts)
    return n


# the leaves 9b, 9d and 9e probe in the first block of each kind (and
# the MLP's, ``probed_leaves``)
PROBE_LEAVES = {"attn": (("attn", "wq"),), "moe": (("attn", "wq"),),
                "local": (("attn", "wq"),),
                "dec": (("attn", "wq"), ("xattn", "wq"), ("lnx", "scale")),
                "rec": (("rec", "w_a"), ("rec", "lam"), ("rec", "conv_w")),
                "ssm": (("ssm", "in_proj"), ("ssm", "a_log"),
                        ("ssm", "dt_bias"), ("ssm", "conv_w"))}


def probed_leaves(cfg):
    """[(name, path)] of the leaves a train run probes: ``ln_f``'s scale,
    the embedding (and its learned positions), an encoder's positions and
    its first block's ``wq``, and in the first block of each kind its
    ``PROBE_LEAVES`` and its MLP's (the router and the experts' ``wg``,
    ``wu``, ``wd`` for a MoE, ``wu`` otherwise; an ``"ssm"`` block has
    none)."""
    out = [("ln_f.scale", ("ln_f", "scale")),
           ("embed.embedding", ("embed", "embedding"))]
    if cfg.learned_pos:
        out.append(("embed.pos", ("embed", "pos")))
    if cfg.enc_layers:
        out += [("encoder.pos", ("encoder", "pos")),
                ("encoder.b0_enc.attn.wq",
                 ("encoder", "blocks", "b0_enc", "attn", "wq"))]
    seen = set()
    for j, kind in enumerate(cfg.pattern):
        if kind in seen:
            continue
        seen.add(kind)
        key = f"b{j}_{kind}"
        paths = list(PROBE_LEAVES[kind])
        if kind != "ssm":
            paths += [("mlp", n) for n in (("router", "wg", "wu", "wd")
                                           if kind == "moe" else ("wu",))]
        out += [(".".join((key,) + p), ("blocks", key) + p) for p in paths]
    return out


def train_model(torch, kernels, dev, arch, layers, run_steps, tag,
                profile=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """One architecture at full width cut to ``layers`` layers through
    ``train_driver`` with ``train_preset(arch)`` over
    DataConfig(batch, seq), ``run_steps`` steps: every loss finite, the
    parameters moved, each step's launches as derived, peak memory under
    TRAIN_PEAK_GB. Returns (launches of one step, summary)."""
    import dataclasses
    from repro_torch import configs, models
    from repro_torch.launch import train_preset
    from repro_torch.train import DataConfig, init_opt, train_driver
    free_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    tcfg = train_preset(arch)
    dcfg = DataConfig(batch=batch, seq=seq)
    specs = models.lm_specs(cfg)
    n_params = models.num_params(specs)
    n_active = active_params(cfg, specs)
    t0 = time.perf_counter()
    params = models.init_params(
        specs, torch.Generator(device=dev).manual_seed(tcfg.seed), dev)
    opt = init_opt(params, tcfg)

    # the leaves probed: a slice of each (moved), and their first moments
    # after the run (a gradient reached them; for a MoE, every expert's
    # slice of its weights and every router column)
    leaves = probed_leaves(cfg)
    names = [n for n, _ in leaves]

    def probed(tree):
        out = []
        for _, path in leaves:
            t = tree
            for k in path:
                t = t[k]
            out.append(t)
        return out

    def probe():
        return [t[0, :64].clone() if t.dim() > 2 else t[:64].clone()
                for t in probed(params)]
    before = probe()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    want = train_expected_launches(cfg, tcfg)
    stamps, per_step = [], []

    def hook(k, p, o, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(dict(kernels.LAUNCHES))
        kernels.reset_launches()

    kernels.reset_launches()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    out = train_driver(cfg, tcfg, dcfg, steps=run_steps, hooks=[hook],
                       params=params, opt=opt, device=dev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    for i, launched in enumerate(per_step):
        for name in set(launched) | set(want):
            if launched.get(name, 0) != want.get(name, 0):
                raise AssertionError(
                    f"train {cfg.name} step {i}: {name} launched "
                    f"{launched.get(name, 0)} times, expected "
                    f"{want.get(name, 0)}")
    if len(losses) != run_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train {cfg.name}: losses {losses}")
    moved = dict(zip(names, (bool((a != b).any())
                             for a, b in zip(before, probe()))))
    if not all(moved.values()):
        raise AssertionError(f"train {cfg.name}: parameters did not move "
                             f"({moved})")
    reached = {}
    for n, m in zip(names, probed(out["opt"].mu)):
        if cfg.num_experts and ".mlp." in n:      # each expert, dim 2
            ok = m.ne(0).movedim(2, 0).reshape(m.shape[2], -1).any(1).all()
        else:
            ok = m.ne(0).any()
        reached[n] = bool(ok)
    if not all(reached.values()):
        raise AssertionError(f"train {cfg.name}: no gradient reached "
                             f"{[n for n, r in reached.items() if not r]} "
                             f"(first moments all zero)")
    if peak > TRAIN_PEAK_GB:
        raise AssertionError(f"train {cfg.name}: peak {peak} GB over "
                             f"{TRAIN_PEAK_GB}")
    steps = np.diff(stamps)
    tokens = batch * seq
    frames = cfg.enc_seq if cfg.enc_layers else 0
    pairs = cfg.enc_layers * frames * frames    # the encoder's, unmasked
    for kind in cfg.pattern:            # each attention layer's pairs
        if kind in ATTN_KINDS:
            pairs += cfg.pattern_groups * visible_pairs(
                seq, seq, cfg.window * (kind == "local"))
        if kind == "dec":               # the cross-attention's, unmasked
            pairs += cfg.pattern_groups * seq * frames
    n_enc = encoder_params(specs)
    flops = (6 * n_active * tokens + 6 * n_enc * batch * frames
             + 12 * cfg.head_dim * cfg.num_heads * pairs * batch)
    steady = float(np.median(steps[1:]))
    summ = dict(layers=cfg.num_layers, of_layers=full.num_layers,
                params=n_params, active_params=n_active,
                encoder_params=n_enc, enc_layers=cfg.enc_layers,
                frames=frames,
                init_s=init_s, microbatch=tcfg.microbatch, remat=tcfg.remat,
                batch=batch, seq=seq, losses=losses,
                step_s=[float(x) for x in steps], steady_step_s=steady,
                tokens_per_s=tokens / steady,
                model_tflop_per_step=flops / 1e12,
                model_tflops=flops / steady / 1e12, peak_gb=peak,
                launches_per_step=per_step[0])
    log(f"[train] ({tag}) {cfg.name} at full width, {cfg.num_layers} of "
        f"{full.num_layers} layers ({n_params} params, {n_active!r} active a "
        f"token, drawn in {init_s:.2f} s), "
        + (f"{cfg.enc_layers} encoder layers ({n_enc} params a frame) over "
           f"{frames} frames, " if cfg.enc_layers else "")
        + f"train_preset (microbatch {tcfg.microbatch}, remat {tcfg.remat}), "
        f"batch {batch} x {seq}: losses {losses}; wall per step "
        f"{summ['step_s']} s (steady {steady!r} s: "
        f"{summ['tokens_per_s']!r} tokens/s, {summ['model_tflops']!r} "
        f"model TFLOP/s of {summ['model_tflop_per_step']!r} TFLOP a step); "
        f"peak {peak!r} GB; launches a step {per_step[0]} (as derived); "
        f"parameters moved and their first moments nonzero: {names}"
        f"{' (every expert, every router column)' if cfg.num_experts else ''}"
        )
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        # device activity alone: the host ops' trace (~10^5 events a
        # mamba2 step) costs minutes to take and reduce
        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            train_driver(cfg, tcfg, dcfg, steps=1, params=out["params"],
                         opt=out["opt"], device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        total, share, top, n_dev = _train_shares(torch, prof)
        summ.update(profile_device_ms=total / 1e3, profile_wall_s=wall,
                    device_share=share, profile_device_launches=n_dev)
        who = f"({tag}) {cfg.name}"
        log(f"[profile] {who} train step: device {total / 1e3:.1f} ms of "
            f"{wall * 1e3:.1f} ms wall (busy share {total / 1e6 / wall!r}); "
            f"{n_dev} device launches; share of device time: "
            f"{json.dumps(share)}")
        for key, ms, n in top:
            log(f"[profile] {who}   {ms:9.3f} ms  {n:6d} calls  {key}")
    del params, opt, out, before
    free_memory(torch)
    return per_step[0], summ


# 9c's crash/resume: (steps, checkpoint every, crash after step)
RESUME_STEPS, RESUME_EVERY, RESUME_CRASH = 6, 2, 3


def phase_train_reduced(torch, sup, dev):
    """9c: the REDUCED qwen3-14b, qwen3-moe, recurrentgemma and whisper on
    the card: crash and resume bit for bit under deterministic
    algorithms; and qwen3-14b's golden losses."""
    import dataclasses
    import tempfile
    from repro_torch import configs, models
    from repro_torch.configs import TrainConfig
    from repro_torch.models.spec import _leaves
    from repro_torch.train import (CrashInjected, DataConfig, init_opt,
                                   train_driver)
    tcfg = TrainConfig(**sup.TRAIN_TCFG)
    dcfg = DataConfig(**sup.TRAIN_DCFG)
    torch.use_deterministic_algorithms(True)
    try:
        for arch in ("qwen3-14b", "qwen3_moe_30b_a3b", "recurrentgemma_2b",
                     "whisper_large_v3"):
            cfg = configs.reduced_config(arch)
            with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as d:
                ref, res = sup.crash_restart(
                    train_driver, CrashInjected, cfg, tcfg, dcfg, d, dev,
                    steps=RESUME_STEPS, every=RESUME_EVERY,
                    crash_at=RESUME_CRASH)
            start = res["start_step"]
            if ref["losses"][start:] != res["losses"]:
                raise AssertionError(f"9c {cfg.name}: resumed losses "
                                     f"{res['losses']} against "
                                     f"{ref['losses'][start:]}")
            for a, b in zip(_leaves(ref["params"]) + _leaves(ref["opt"].mu)
                            + _leaves(ref["opt"].nu),
                            _leaves(res["params"]) + _leaves(res["opt"].mu)
                            + _leaves(res["opt"].nu)):
                torch.testing.assert_close(b, a, rtol=0, atol=0)
            log(f"[train] (9c) {cfg.name} ({cfg.compute_dtype} compute) "
                f"{RESUME_STEPS} steps, checkpoints every {RESUME_EVERY}, "
                f"crash after step {RESUME_CRASH}, resumed from step "
                f"{start}: losses "
                f"{res['losses']}, every parameter and moment bitwise the "
                f"uninterrupted run's, under "
                f"torch.use_deterministic_algorithms(True)")
        cfg = configs.reduced_config("qwen3-14b")
        gold = sup.train_golden()
        fcfg = dataclasses.replace(cfg, compute_dtype="float32")
        params = models.params_from_numpy(
            sup.numpy_params(models.lm_specs(fcfg), sup.TRAIN_PARAM_SEED),
            dev)
        out = train_driver(fcfg, tcfg, dcfg, steps=sup.TRAIN_STEPS,
                           params=params, opt=init_opt(params, tcfg),
                           device=dev)
    finally:
        torch.use_deterministic_algorithms(False)
    diff = float(np.max(np.abs(np.array(out["losses"])
                               - np.array(gold["losses"]))))
    if not diff <= sup.TRAIN_LOSS_BAR:
        raise AssertionError(f"9c: losses {out['losses']} against the "
                             f"golden's {gold['losses']} (max diff {diff})")
    log(f"[train] (9c) golden: {fcfg.name}, float32 compute, "
        f"{sup.TRAIN_STEPS} steps from numpy params (seed "
        f"{sup.TRAIN_PARAM_SEED}): losses {out['losses']}, max diff "
        f"{diff!r} from repro's (bar {sup.TRAIN_LOSS_BAR})")
    return dict(resume_start=start, golden_max_diff=diff)


def kernels_line(rows, launches):
    line = []
    for k in KERNELS:
        row = rows[k]
        entry = {"name": k, "route": "cuda", "source": SOURCES[k],
                 "replaces": REPLACES[k], "launches": launches[k]}
        entry.update({key: val for key, val in row.items()})
        if k + "@padded" in rows:
            entry.update(padded_ms=rows[k + "@padded"]["ms"],
                         padded_shape=rows[k + "@padded"]["shape"])
        for tag in ("batch", "batch_padded"):
            extra = rows.get(f"{k}@{tag}")
            if extra:
                entry.update({f"{tag}_{key}": extra[key] for key in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")})
        line.append(entry)
    return line


def main():
    arm_deadline()
    # cuBLAS's deterministic workspace (9c runs under
    # torch.use_deterministic_algorithms), set before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    name, smi = phase_probe(torch)
    sys.path[:0] = [SRC, os.path.join(ROOT, "tests")]
    import repro_torch.core as tc
    import test_torch_support as sup
    from repro_torch import kernels

    dev = "cuda"
    profile = "--profile" in sys.argv[1:]
    t0 = time.perf_counter()
    phase_build(kernels)
    rows = phase_kernels(torch, sup, dev)
    rows.update(phase_observe(torch, tc, sup, dev))
    mark(f"[time] build + kernels: {time.perf_counter() - t0:.1f} s")
    rows["fused_tick_block"] = phase_k4(torch, tc, sup, dev)
    mark(f"[time] + K4: {time.perf_counter() - t0:.1f} s")
    phase_goldens(tc, sup, dev)
    mark(f"[time] + goldens: {time.perf_counter() - t0:.1f} s")
    launches, summaries, finals = phase_main(torch, tc, kernels, sup, dev)
    mark(f"[time] + main path: {time.perf_counter() - t0:.1f} s")
    smoke_launches, smoke_summ, _, grid = phase_smoke_slots(
        torch, tc, kernels, sup, dev, smi)
    log("[smoke] " + json.dumps({"smoke_runs": smoke_summ}))
    for k, n in smoke_launches.items():
        launches[k] += n
    rows["fused_tick_block"].update(grid)
    mark(f"[time] + smoke_slots: {time.perf_counter() - t0:.1f} s")
    fig6_launches, law_rows, _ = phase_fig6(torch, tc, kernels, sup, dev,
                                            smi)
    for k, n in fig6_launches.items():
        launches[k] += n
    rows["fused_tick_block"]["laws"] = law_rows
    mark(f"[time] + fig6: {time.perf_counter() - t0:.1f} s")
    fig8_launches, fig8_rows, fig8_err = phase_fig8(torch, tc, kernels, sup,
                                                    dev, smi)
    for k, n in fig8_launches.items():
        launches[k] += n
    rows["fused_tick_block"]["fig8"] = fig8_rows
    rows["fused_tick_block"]["max_abs_err"] = max(
        rows["fused_tick_block"]["max_abs_err"], fig8_err)
    mark(f"[time] + fig8: {time.perf_counter() - t0:.1f} s")
    fb_launches, fb_rows, fb_err = phase_feedback(torch, tc, kernels, sup,
                                                  dev, smi)
    for k, n in fb_launches.items():
        launches[k] += n
    rows["fused_tick_block"]["feedback"] = fb_rows
    rows["fused_tick_block"]["max_abs_err"] = max(
        rows["fused_tick_block"]["max_abs_err"], fb_err)
    mark(f"[time] + feedback: {time.perf_counter() - t0:.1f} s")
    imp_launches, imp_rows, imp_fct, paper_fct = phase_impair(
        torch, tc, kernels, sup, dev, smi)
    for k, n in imp_launches.items():
        launches[k] += n
    rows["fused_tick_block"]["impair"] = imp_rows
    mark(f"[time] + impair: {time.perf_counter() - t0:.1f} s")
    fault_launches, fault_rows, sweep_fct = phase_fault(
        torch, tc, kernels, sup, dev, smi, finals["e"], imp_fct)
    for k, n in fault_launches.items():
        launches[k] += n
    rows["fused_tick_block"]["chunk"] = fault_rows
    mark(f"[time] + fault: {time.perf_counter() - t0:.1f} s")
    shard_launches, shard_rows, outer_two = phase_shard(
        torch, tc, kernels, sup, dev, smi, paper_fct, sweep_fct)
    for k, n in shard_launches.items():
        launches[k] += n
    rows["fused_tick_block"]["shard"] = shard_rows
    mark(f"[time] + shard: {time.perf_counter() - t0:.1f} s")
    incast_launches, incast_rows = phase_incast(torch, tc, kernels, sup, dev,
                                                smi, outer_two)
    for k, n in incast_launches.items():
        launches[k] += n
    # K4's runs (HOMA and the outer sync run no kernel: their rows are in
    # the [incast] line)
    rows["fused_tick_block"]["incast"] = {
        k: v for k, v in incast_rows.items() if "launches" in v}
    mark(f"[time] + incast: {time.perf_counter() - t0:.1f} s")
    if profile:
        phase_profile(torch, tc, sup, dev, summaries)
        phase_profile_smoke(torch, tc, sup, dev, smoke_summ)
        mark(f"[time] + profile: {time.perf_counter() - t0:.1f} s")
    rows.update(phase_lm_kernels(torch, sup, dev))
    mark(f"[time] + LM kernels: {time.perf_counter() - t0:.1f} s")
    serve_launches, serve_summ = phase_serve(torch, kernels, sup, dev,
                                             profile)
    log("[serve] " + json.dumps({"serve": serve_summ}))
    mark(f"[time] + serve: {time.perf_counter() - t0:.1f} s")
    for k in LM_KERNELS:
        launches[k] = serve_launches[k]
    t8b = time.perf_counter()
    archs = phase_serve_archs(torch, kernels, sup, dev, smi)
    log("[serve 8b] " + json.dumps({"serve_archs": {
        a: summ for a, (_, summ) in archs.items()}}))
    for k in LM_KERNELS:
        rows[k]["archs_launches"] = {a: n[k] for a, (n, _) in archs.items()}
    mark(f"[time] 8b other architectures' serve: "
         f"{time.perf_counter() - t8b:.1f} s")
    t8c = time.perf_counter()
    recurrent = phase_serve_recurrent(torch, kernels, sup, dev, smi,
                                      profile)
    log("[serve 8c] " + json.dumps({"serve_recurrent": {
        a: summ for a, (_, summ) in recurrent.items()}}))
    for k in LM_KERNELS:
        rows[k]["recurrent_launches"] = {a: n[k]
                                         for a, (n, _) in recurrent.items()}
    mark(f"[time] 8c recurrent architectures' serve: "
         f"{time.perf_counter() - t8c:.1f} s")
    t8d = time.perf_counter()
    encdec = phase_serve_encdec(torch, kernels, sup, dev, smi, profile)
    log("[serve 8d] " + json.dumps({"serve_encdec": {
        a: summ for a, (_, summ) in encdec.items()}}))
    for k in LM_KERNELS:
        rows[k]["encdec_launches"] = {a: n[k] for a, (n, _) in encdec.items()}
    mark(f"[time] 8d encoder-decoder and vision-language serve: "
         f"{time.perf_counter() - t8d:.1f} s")
    t9 = time.perf_counter()
    rows.update(phase_train_kernels(torch, sup, dev))
    mark(f"[time] 9a backward kernels: {time.perf_counter() - t9:.1f} s")
    t9b = time.perf_counter()
    train_launches, train_summ = phase_train(torch, kernels, dev, profile)
    log("[train] " + json.dumps({"train": train_summ}))
    mark(f"[time] 9b qwen3-14b train: {time.perf_counter() - t9b:.1f} s")
    t9d = time.perf_counter()
    train_archs = phase_train_archs(torch, kernels, dev, smi)
    log("[train] " + json.dumps({"train_archs": {
        a: summ for a, (_, summ) in train_archs.items()}}))
    mark(f"[time] 9d other architectures' train: "
         f"{time.perf_counter() - t9d:.1f} s")
    t9e = time.perf_counter()
    train_rec = phase_train_recurrent(torch, kernels, dev, smi, profile)
    log("[train] " + json.dumps({"train_recurrent": {
        a: summ for a, (_, summ) in train_rec.items()}}))
    mark(f"[time] 9e recurrent architectures' train: "
         f"{time.perf_counter() - t9e:.1f} s")
    t9f = time.perf_counter()
    train_ed = phase_train_encdec(torch, kernels, dev, smi, profile)
    log("[train] " + json.dumps({"train_encdec": {
        a: summ for a, (_, summ) in train_ed.items()}}))
    mark(f"[time] 9f encoder-decoder and vision-language train: "
         f"{time.perf_counter() - t9f:.1f} s")
    t9c = time.perf_counter()
    reduced = phase_train_reduced(torch, sup, dev)
    log("[train] " + json.dumps({"train_reduced": reduced}))
    mark(f"[time] 9c REDUCED crash/resume and golden: "
         f"{time.perf_counter() - t9c:.1f} s")
    mark(f"[time] + train: {time.perf_counter() - t0:.1f} s")
    for k in TRAIN_KERNELS:
        launches[k] = train_launches[k]
    for k in LM_KERNELS:
        rows[k]["train_launches_per_step"] = train_launches[k]
    for k in LM_KERNELS + TRAIN_KERNELS:
        rows[k]["archs_train_launches_per_step"] = {
            a: n[k] for a, (n, _) in train_archs.items()}
        rows[k]["recurrent_train_launches_per_step"] = {
            a: n.get(k, 0) for a, (n, _) in train_rec.items()}
        rows[k]["encdec_train_launches_per_step"] = {
            a: n.get(k, 0) for a, (n, _) in train_ed.items()}
    rows["flash_attention_bwd"]["window_launches_per_step"] = \
        train_rec["recurrentgemma_2b"][0]["flash_attention_bwd"]

    for k in PATH_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"the main path never launched {k}")
    line = kernels_line(rows, launches)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
