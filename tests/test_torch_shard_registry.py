"""Registry conformance of the port's sharded slot engine at one rank:
every one of the 13 laws through ``simulate_slots_sharded`` on the k = 4
fat tree's web-search anchor under the mixed impairment regime, streamed
with ``chunk=96``, bit for bit ``repro``'s impaired slot engine
(``tests/test_shard_scenario.py::test_registry_conformance_1device``'s
impaired leg; its clean leg is ``test_torch_shard.py``'s per-law check).

The anchor is ``repro``'s (seed 3, load 0.25 over 2 ms, 64 slots, the
CSR layout: S * H = 320), cut from 2 000 to ``STEPS`` ticks to keep the
file inside its time budget; the feedback channels, the hop clock and
the regime's capacity, loss and jitter draws all act within them.

``repro`` is imported only through ``test_torch_support.import_repro``.
"""
import functools

import pytest
import torch

import test_torch_support as sup
from test_torch_shard import assert_bitmatch_repro

S = 64
STEPS = 700


def _anchor(core, **dev):
    ft = core.fat_tree(4)
    sched = core.make_schedule(core.poisson_websearch(ft, 0.25, 0.002, 1e-6,
                                                      seed=3, **dev))
    cfg = core.SimConfig(dt=1e-6, steps=STEPS, hist=512,
                         update_period=2e-6)
    sp = core.CircuitSchedule(day=50 * core.US, night=10 * core.US,
                              matchings=4).params(*dev.values())
    lcfg = core.default_law_config(core.schedule_as_flows(sched),
                                   expected_flows=8.0, sched=sp)
    tor, host = core.fabric.TOR, core.fabric.HOST
    imp = core.fabric_impairments(
        ft, rules={(tor, host): core.LinkProcess(kind="oscillate",
                                                 bw_lo=2.5e9,
                                                 period=200e-6, seed=5)},
        default=core.netem(loss=0.01, jitter=1e-6, seed=9), **dev)
    return ft.topology(**dev), sched, cfg, lcfg, imp


@functools.lru_cache(maxsize=None)
def _repro_anchor():
    jcore, _ = sup.import_repro()
    return _anchor(jcore)


@functools.lru_cache(maxsize=None)
def _port_anchor():
    import repro_torch.core as tc
    return _anchor(tc, device="cpu")


@pytest.mark.parametrize("law", sorted(__import__(
    "repro_torch.core", fromlist=["LAWS"]).LAWS))
def test_registry_conformance_impaired_chunked_1rank(law):
    jcore, _ = sup.import_repro()
    import repro_torch.core as tc
    from repro_torch.core.shardslots import LAST_SHARDED
    jtopo, jsched, jcfg, jlcfg, jimp = _repro_anchor()
    topo, sched, cfg, lcfg, imp = _port_anchor()
    want = jcore.simulate_slots(jtopo, jsched, law, S, jlcfg, jcfg,
                                impair=jimp)
    got = tc.simulate_slots_sharded(topo, sched, law, S, lcfg, cfg,
                                    chunk=96, impair=imp, device="cpu")
    assert LAST_SHARDED["geometry"]["use_csr"]
    assert_bitmatch_repro(got, want, f"{law} impaired, chunk 96")
    assert torch.isfinite(got[0].fct).any()
