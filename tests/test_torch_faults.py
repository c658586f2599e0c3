"""The port's own copy of the fault injector (``repro_torch.faults``) against
the reference's ``repro.faults``: for the same ``FaultConfig`` and seed,
both give the same sequence of every decision and the same ``stats()``,
and their clocks agree.  Exact equality: both draw from
``random.Random(seed)`` in the same order.
"""
import dataclasses

import pytest

from repro import faults as ref_faults
from repro_torch import faults

CONFIGS = {
    "rates": dict(seed=7, evict_rate=0.3, nan_output_rate=0.2,
                  nan_input_rate=0.1, oversized_rate=0.15,
                  expired_rate=0.05, delay_ms_range=(1, 9)),
    "oom": dict(seed=3, oom_batch_limit=4, evict_rate=0.5),
    "campaign": dict(seed=11, nan_at_leg=(2, 4), corrupt_ckpt_at_leg=(3,),
                     crash_save_at_leg=(5,), device_loss_at_leg=(1, 3)),
    "persistent": dict(seed=0, nan_at_leg=(1, 2), nan_persistent=True),
    "default": dict(),
}


def decisions(mod, cfg: dict) -> tuple:
    """A fixed script of every hook, interleaved, and the stats after."""
    inj = mod.FaultInjector(mod.FaultConfig(**cfg))
    seq = []
    for i in range(60):
        seq.append(("evict", inj.should_evict()))
        seq.append(("oom", inj.should_oom(1 + i % 8)))
        seq.append(("delay", inj.dispatch_delay_ms()))
        seq.append(("row", inj.corrupt_output_row(1 + i % 5)))
        seq.append(("kind", inj.classify_request()))
    for leg in list(range(1, 7)) * 2:
        seq.append(("poison", leg, inj.poison_leg(leg)))
        seq.append(("lose", leg, inj.lose_device(leg)))
        seq.append(("sabotage", leg, inj.checkpoint_sabotage(leg)))
    return seq, inj.stats()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_same_decisions_and_stats(name):
    got = decisions(faults, CONFIGS[name])
    want = decisions(ref_faults, CONFIGS[name])
    assert got == want


def test_config_fields_and_kinds_match():
    assert ([f.name for f in dataclasses.fields(faults.FaultConfig)]
            == [f.name for f in dataclasses.fields(ref_faults.FaultConfig)])
    assert faults.FaultConfig() == faults.FaultConfig(
        **dataclasses.asdict(ref_faults.FaultConfig()))
    assert faults.HEALTHY == ref_faults.HEALTHY
    assert faults.TRAFFIC_KINDS == ref_faults.TRAFFIC_KINDS
    assert faults.CAMPAIGN_KINDS == ref_faults.CAMPAIGN_KINDS
    e, r = faults.TransientFault("oom", "x"), ref_faults.TransientFault(
        "oom", "x")
    assert (e.kind, str(e)) == (r.kind, str(r))


def test_clocks():
    a, b = faults.SimClock(5.0), ref_faults.SimClock(5.0)
    for ms in (0.0, -1.0, 2.5, 10.0):
        a.advance(ms)
        b.advance(ms)
        assert a.now_ms() == b.now_ms()
    m = faults.MonotonicClock()
    t0 = m.now_ms()
    m.advance(1.0)
    assert m.now_ms() - t0 >= 1.0
