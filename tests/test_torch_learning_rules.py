"""The port's learning-dynamics rules (``obs/learning.py``) held against the
live JAX module.

Twins of ``tests/test_learning_dynamics.py``'s ``TestLearningRules`` and
``TestStalenessClipRelationship``: every snapshot, row list and
``metrics.jsonl`` goes through both packages, the JAX test's assertions
hold for the port's result, and the two results are equal exactly (both
do the same Python float arithmetic).  ``LAYER_GROUPS`` has one home in
the port.
"""

import json

import pytest

from scalable_agent_tpu.obs import learning as jax_learning
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.obs import learning

HEALTHY = {
    "entropy_frac": 0.7, "kl": 0.01, "ess_frac": 0.9,
    "explained_variance": 0.5, "rho_clip_fraction": 0.1,
    "dead_torso_frac": 0.05, "update_ratio_torso": 1e-3,
    "update_ratio_core": 1e-3, "update_ratio_heads": 1e-3,
}


def _verdicts(snapshot):
    """The port's verdicts, after checking them equal to the JAX ones."""
    ours = learning.derive_verdicts(snapshot)
    assert ours == jax_learning.derive_verdicts(snapshot)
    return ours


def test_constants_and_gauges_are_the_jax_ones():
    for name in ("ENTROPY_COLLAPSE_LIMIT", "VALUE_DIVERGENCE_LIMIT",
                 "RHO_CLIP_SATURATION_LIMIT", "MATERIAL_LOG_RHO",
                 "ESS_FLOOR", "UPDATE_RATIO_BAND", "DEAD_TORSO_LIMIT",
                 "LAYER_GROUPS", "LEARNING_GAUGES"):
        assert getattr(learning, name) == getattr(jax_learning, name), name
    # One home: convert.py (and the learner) take the list from here.
    assert convert.LAYER_GROUPS is learning.LAYER_GROUPS


class TestLearningRules:
    def test_healthy_snapshot_is_clean(self):
        assert _verdicts(HEALTHY) == []

    def test_empty_snapshot_is_clean_not_broken(self):
        assert _verdicts({}) == []

    def _fired(self, overrides):
        return [v["name"] for v in _verdicts({**HEALTHY, **overrides})]

    def test_entropy_collapse(self):
        assert self._fired({"entropy_frac": 0.01}) == ["entropy_collapse"]
        assert self._fired({"entropy_frac": 0.06}) == []

    def test_value_divergence_allows_warmup_negative_ev(self):
        assert self._fired({"explained_variance": -0.8}) == [
            "value_divergence"]
        assert self._fired({"explained_variance": -0.1}) == []

    def test_off_policy_saturated_via_clip_or_ess(self):
        verdicts = _verdicts({**HEALTHY, "rho_clip_fraction": 0.95})
        assert [v["name"] for v in verdicts] == ["off_policy_saturated"]
        assert "replay_ratio" in verdicts[0]["remedy"]
        assert "target_update_interval" in verdicts[0]["remedy"]
        assert self._fired({"ess_frac": 0.05}) == ["off_policy_saturated"]
        # Immaterial drift (every ratio a rounding above 1) cannot fire.
        assert self._fired({"rho_clip_fraction": 0.95,
                            "log_rho_p95": 0.01}) == []

    def test_update_ratio_fires_high_only(self):
        fired = _verdicts({**HEALTHY, "update_ratio_core": 0.5})
        assert [v["name"] for v in fired] == ["update_ratio_out_of_band"]
        assert fired[0]["evidence"]["group"] == "core"
        assert self._fired({"update_ratio_heads": 0.0}) == []

    def test_dead_torso(self):
        assert self._fired({"dead_torso_frac": 0.95}) == ["dead_torso"]
        assert self._fired({"dead_torso_frac": 0.6}) == []

    def test_extract_snapshot_filters_nonfinite(self):
        metrics = {"devtel/learn/entropy_frac": 0.5,
                   "devtel/learn/kl": float("nan"),
                   "devtel/learn/ess_frac": None,
                   "unrelated/metric": 1.0}
        snap = learning.extract_snapshot(metrics)
        assert snap == {"entropy_frac": 0.5}
        assert snap == jax_learning.extract_snapshot(metrics)


class TestStalenessClipRelationship:
    S_KEY = "ledger/staleness_replayed_s/p95"
    C_KEY = "devtel/learn/rho_clip_fraction"

    def _rows(self, pairs):
        return [{self.S_KEY: s, self.C_KEY: c} for s, c in pairs]

    @staticmethod
    def _relationship(rows, **kwargs):
        ours = learning.staleness_clip_relationship(rows, **kwargs)
        assert ours == jax_learning.staleness_clip_relationship(rows,
                                                                **kwargs)
        return ours

    def test_positive_correlation_measured(self):
        out = self._relationship(self._rows(
            [(0.1, 0.05), (0.5, 0.2), (1.0, 0.4), (2.0, 0.75)]))
        assert out["intervals"] == 4
        assert out["pearson_r"] > 0.95
        assert out["clip_per_staleness_s"] > 0.0
        assert "correlate" in out["statement"]

    def test_too_few_points_or_constant_series_is_none(self):
        assert self._relationship(
            self._rows([(0.1, 0.1), (0.2, 0.2)])) is None
        assert self._relationship(
            self._rows([(0.5, 0.1), (0.5, 0.2), (0.5, 0.3)])) is None

    def test_rows_missing_either_series_are_skipped(self):
        rows = self._rows([(0.1, 0.05), (0.5, 0.2), (1.0, 0.4)])
        rows.insert(1, {self.S_KEY: 0.3})  # no clip reading
        assert self._relationship(rows)["intervals"] == 3

    @pytest.mark.parametrize("min_points", [2, 5])
    def test_min_points_and_other_keys(self, min_points):
        rows = [{"a": float(i), "b": float(i * i)} for i in range(4)]
        out = self._relationship(rows, staleness_key="a", clip_key="b",
                                 min_points=min_points)
        assert (out is None) == (min_points > 4)

    def test_read_interval_rows_strips_prefix_and_skips_torn(
            self, tmp_path):
        rows = [
            {"step": 1, "obs/devtel/learn/rho_clip_fraction": 0.1,
             "obs/ledger/staleness_replayed_s/p95": 0.2,
             "total_loss": 3.0},
            {"step": 2, "obs/devtel/learn/rho_clip_fraction": 0.3},
        ]
        text = "\n".join(json.dumps(r) for r in rows)
        (tmp_path / "metrics.jsonl").write_text(
            text + '\n{"step": 3, "obs/trunc')  # torn tail
        parsed = learning.read_interval_rows(str(tmp_path))
        assert parsed == jax_learning.read_interval_rows(str(tmp_path))
        assert len(parsed) == 2
        assert parsed[0]["devtel/learn/rho_clip_fraction"] == 0.1
        assert parsed[0]["ledger/staleness_replayed_s/p95"] == 0.2
        assert parsed[0]["step"] == 1
        assert "total_loss" not in parsed[0]
        assert learning.read_interval_rows(str(tmp_path / "none")) == []
