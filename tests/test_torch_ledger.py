"""The port's pipeline ledger (scalable_agent_tpu_torch/obs/ledger.py)
held against the live JAX ledger.

One stamp sequence, every timestamp given (an injected clock) and the
interval fixed, gives the same ``ledger/*`` gauges and histograms to
1e-9; the port registers the JAX ledger's names less those of the actor
service's stages, which it has no subsystem for.  A rollback's
``discard`` counts the trajectory's frames into
``ledger/frames_discarded_total``, through the port's ``InflightWindow``
too; ``finalize`` closes what is left as abandoned; the live MFU gauge
follows the configured FLOPs and peak, and knows this card's peaks only.
"""

import json

import pytest

from scalable_agent_tpu import obs as jax_obs
from scalable_agent_tpu.obs import ledger as jax_ledger
from scalable_agent_tpu_torch import obs
from scalable_agent_tpu_torch.obs import ledger
from scalable_agent_tpu_torch.runtime.transport import InflightWindow

FRAMES = 12800.0
# Names the JAX ledger registers for a subsystem the port has not ported:
# the actor service's stages.
UNPORTED = {f"ledger/{kind}/{stage}{suffix}"
            for stage in jax_ledger.SERVICE_STAGES
            if stage not in ledger.PORTED_SERVICE_STAGES
            for kind, suffix in (("rate", "_per_s"), ("rho", ""))}

# (actor, birth, stamps after birth in us, fate): four trajectories.
RECORDS = [
    ("actor-0", 1_000, [("unroll_done", 401_000), ("queue_put", 401_500),
                        ("queue_get", 650_000),
                        ("transport_pack", 662_000),
                        ("transport_upload", 663_400),
                        ("transport_unpack", 663_900),
                        ("put_done", 664_000), ("dispatch", 900_000),
                        ("retire", 1_400_000)], "retired"),
    ("actor-1", 2_000, [("unroll_done", 390_000), ("queue_put", 395_000),
                        ("queue_get", 1_100_000), ("put_done", 1_112_000),
                        ("dispatch", 1_500_000), ("retire", 1_520_000)],
     "retired"),
    ("actor-0", 405_000, [("unroll_done", 800_000),
                          ("queue_put", 800_100), ("queue_get", 1_500_000),
                          ("put_done", 1_514_000),
                          ("dispatch", 1_600_000)], "discarded"),
    ("actor-1", 400_000, [("unroll_done", 790_000)], "open"),
]


def _drive(module, registry):
    led = module.PipelineLedger(registry=registry,
                                frames_per_trajectory=FRAMES)
    led.configure_mfu(1.75e11, 989.4e12)
    tids = []
    for actor, birth, stamps, fate in RECORDS:
        tid = led.open(actor, "fake_benchmark", birth_us=birth)
        for stage, ts in stamps:
            led.stamp(tid, stage, ts_us=ts)
        tids.append((tid, fate))
    for tid, fate in tids:
        if fate == "retired":
            led.close(tid, retired=True)
        elif fate == "discarded":
            led.close(tid, retired=False, fate="discarded")
    stats = led.publish(interval_s=2.0)
    led.stamp(99, "retire")  # a late stamp for no record
    return led, stats


def test_ledger_gauges_match_jax():
    ours_reg, jax_reg = obs.MetricsRegistry(), jax_obs.MetricsRegistry()
    ours, ours_stats = _drive(ledger, ours_reg)
    theirs, jax_stats = _drive(jax_ledger, jax_reg)
    got = {k: v for k, v in ours_reg.snapshot().items()
           if k.startswith("ledger/")}
    want = {k: v for k, v in jax_reg.snapshot().items()
            if k.startswith("ledger/")
            and not any(k.startswith(u) for u in UNPORTED)}
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-9 * max(1.0, abs(want[key])),\
            (key, got[key], want[key])
    assert got["ledger/trajectories_retired_total"] == 2.0
    assert got["ledger/frames_discarded_total"] == FRAMES
    assert got["ledger/open_records"] == 1.0
    assert got["ledger/late_stamps_total"] == 1.0
    assert got["ledger/mfu"] == pytest.approx(1.75e11 * 2 / 2.0 / 989.4e12)
    assert ours.dominant_segment() == theirs.dominant_segment()
    assert ours_stats["latency_shares"] == pytest.approx(
        jax_stats["latency_shares"], abs=1e-12)
    names = {i.name for i in ours_reg.instruments()}
    assert names == {i.name for i in jax_reg.instruments()} - UNPORTED


def test_finalize_abandons_and_dumps_the_artifact(tmp_path):
    registry = obs.MetricsRegistry()
    led = ledger.PipelineLedger(registry=registry,
                                frames_per_trajectory=FRAMES,
                                logdir=str(tmp_path))
    jax_led = jax_ledger.PipelineLedger(registry=jax_obs.MetricsRegistry(),
                                        frames_per_trajectory=FRAMES,
                                        logdir=str(tmp_path / "jax"))
    for one in (led, jax_led):
        one.stamp(one.open("actor-0", "g"), "unroll_done")
        one.finalize()
    snap = registry.snapshot()
    assert snap["ledger/trajectories_abandoned_total"] == 1.0
    assert snap["ledger/open_records"] == 0.0
    ours = json.load(open(tmp_path / "ledger.p0.json"))
    theirs = json.load(open(tmp_path / "jax" / "ledger.p0.json"))
    assert ours.keys() == theirs.keys()
    assert ours["open_records"] == [] and ours["counters"]["abandoned"] == 1


def test_window_discard_counts_frames_discarded(monkeypatch):
    """The rollback path: the window's pending updates close their
    records discarded, and retire closes them retired."""
    registry = obs.MetricsRegistry()
    led = ledger.PipelineLedger(registry=registry,
                                frames_per_trajectory=FRAMES)
    monkeypatch.setattr(ledger, "_ledger", led)
    window = InflightWindow(3, registry=registry)
    tids = [led.open("actor-0", "g") for _ in range(3)]
    for tid in tids:
        window.push({}, ledger_id=tid)
    assert registry.snapshot()["learner/inflight_depth"] == 3.0
    window.retire()
    assert window.discard() == 2
    snap = registry.snapshot()
    assert snap["ledger/trajectories_retired_total"] == 1.0
    assert snap["ledger/trajectories_discarded_total"] == 2.0
    assert snap["ledger/frames_discarded_total"] == 2 * FRAMES
    assert snap["learner/retire_s/count"] == 1.0
    assert snap["ledger/open_records"] == 0.0


@pytest.mark.parametrize("name,dtype,want", [
    ("NVIDIA H100 80GB HBM3", "bfloat16", 989.4e12),
    ("NVIDIA H100 80GB HBM3", "float32", 66.9e12),
    ("NVIDIA A100-SXM4-80GB", "bfloat16", None),
    ("cpu", "float32", None)])
def test_peak_flops_knows_this_card_only(name, dtype, want):
    assert ledger.peak_flops(name, dtype) == want


def test_every_timing_histogram_maps_to_a_ledger_stage():
    """The twin of JAX ``tests/test_ledger_lint.py``: every ``_s``
    histogram registered in the port's runtime and driver maps to a ledger
    stage (``TIMING_STAGE_MAP``), but the checkpoint's save time, which no
    frame's latency passes through; an f-string name (the batchers'
    ``f"{metrics_name}/request_latency_s"``) is matched by its constant
    suffix, as the JAX lint matches it; every mapped name is still
    registered somewhere, and maps to a segment or a service stage."""
    import ast
    from pathlib import Path

    package = Path(ledger.__file__).resolve().parents[1]
    files = sorted((package / "runtime").glob("*.py")) + sorted(
        (package / "driver").glob("*.py"))
    names, suffixes = set(), set()
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "histogram" and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and str(arg.value).endswith(
                    "_s"):
                names.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                tail = ""
                for part in reversed(arg.values):
                    if not (isinstance(part, ast.Constant)
                            and isinstance(part.value, str)):
                        break
                    tail = part.value + tail
                if tail.endswith("_s"):
                    suffixes.add(tail)
    for tail in suffixes:
        matched = {name for name in ledger.TIMING_STAGE_MAP
                   if name.endswith(tail)}
        assert matched, f"no TIMING_STAGE_MAP name ends in {tail!r}"
        names |= matched
    allowlist = {"checkpoint/save_s"}
    assert names - allowlist == set(ledger.TIMING_STAGE_MAP)
    stages = {name for name, _, _ in ledger.SEGMENTS} | set(
        ledger.PORTED_SERVICE_STAGES)
    assert set(ledger.TIMING_STAGE_MAP.values()) <= stages
    for name, stage in ledger.TIMING_STAGE_MAP.items():
        assert jax_ledger.TIMING_STAGE_MAP[name] == stage, name
