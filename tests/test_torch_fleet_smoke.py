"""The port's fleet smoke end to end (tendermint_tpu_torch/chaos/fleet.py
run_fleet_soak, device="cpu"), with the reference's assertions
(tests/test_fleet_soak.py:166-241), then the port's and the reference's
tools held equal on its evidence both ways:

- the reference's chain_observatory.merge / fleet_referee.build_report (and
  their markdown) on the dumps the port's soak wrote equal the port's own;
- the port's tools on dumps the reference's code wrote equal the
  reference's own. Those dumps are of the same live fleet: each time the
  soak writes a node's dump, the reference's write_node_dump writes one of
  the same node beside it (its capture reads a node's surfaces by name, and
  the port's Node has the reference's). The reference's soak is not run.

The reference's check that the poisoner is still quarantined when the soak
ends is read here as: the scorer quarantined exactly the poisoner's tag at
some point of the soak (every quarantined set is recorded), it is still
quarantined or was paroled, and it was punished. The scorer paroles a
source after 64 clean rows, and the poisoner votes honestly besides its
flood, so the end-of-soak set depends on how many heights the soak ran.
Time fields are excluded from the equality: TIME_KEYS, the reports' own
stamp. No other tolerance applies.
"""

import asyncio
import json
import os
import shutil

os.environ.setdefault("TMTPU_CRYPTO_BACKEND", "cpu")

import pytest  # noqa: E402

from tendermint_tpu.tools import chain_observatory as R_obs  # noqa: E402
from tendermint_tpu.tools import fleet_referee as R_ref  # noqa: E402
from tendermint_tpu_torch.chaos.fleet import ROLE_VALIDATOR, ROLES, FleetSpec, run_fleet_soak  # noqa: E402
from tendermint_tpu_torch.crypto import batch as T_batch  # noqa: E402
from tendermint_tpu_torch.crypto import provenance as T_prov  # noqa: E402
from tendermint_tpu_torch.libs import metrics as T_metrics  # noqa: E402
from tendermint_tpu_torch.tools import chain_observatory as T_obs  # noqa: E402
from tendermint_tpu_torch.tools import fleet_referee as T_ref  # noqa: E402
from tendermint_tpu_torch.tools import release_gate as T_gate  # noqa: E402
from test_torch_fleet_spec import SEED, smoke_kw  # noqa: E402

# the keys that name a time: the merge's and the referee's own stamp
TIME_KEYS = ("generated_ts",)


def timeless(doc):
    if isinstance(doc, dict):
        return {k: timeless(v) for k, v in doc.items() if k not in TIME_KEYS}
    if isinstance(doc, list):
        return [timeless(v) for v in doc]
    return doc


@pytest.fixture(autouse=True)
def _port_memo_off():
    prev = T_batch._MEMO
    T_batch._MEMO = T_batch.VerifiedRowMemo(0)
    try:
        yield
    finally:
        T_batch._MEMO = prev


def tools_agree(dumps_dir: str) -> dict:
    """Both packages' merge and referee over one directory's dumps and
    manifest: equal JSON (less TIME_KEYS) and equal markdown. Returns the
    port's report."""
    r_dumps, t_dumps = R_obs.load_dumps(dumps_dir), T_obs.load_dumps(dumps_dir)
    assert t_dumps == r_dumps
    r_merge, t_merge = R_obs.merge(r_dumps), T_obs.merge(t_dumps)
    assert timeless(t_merge) == timeless(r_merge)
    assert T_obs.render_markdown(t_merge) == R_obs.render_markdown(r_merge)
    r_man, t_man = R_ref.load_manifest(dumps_dir), T_ref.load_manifest(dumps_dir)
    assert t_man == r_man
    r_rep = R_ref.build_report(r_dumps, manifest=r_man)
    t_rep = T_ref.build_report(t_dumps, manifest=t_man)
    assert timeless(t_rep) == timeless(r_rep)
    assert T_ref.render_markdown(t_rep) == R_ref.render_markdown(r_rep)
    return t_rep


def test_fleet_smoke_end_to_end(tmp_path, monkeypatch):
    spec = FleetSpec.generate(SEED, 7, **smoke_kw())
    assert len(spec.validators) == 4
    assert len(spec.joiners) == 1
    assert len(spec.light_edges) == 1
    poisoners = [ns for ns in spec.nodes if ns.poisoner]
    assert len(poisoners) == 1 and poisoners[0].role == ROLE_VALIDATOR
    assert any(ev.kind == "sig_poison" for ev in spec.schedule.events)
    assert all(ev.param_dict().get("target") != poisoners[0].index
               for ev in spec.schedule.events if ev.kind in ("crash", "restart"))

    # every dump the soak writes, the reference's capture writes of the same
    # live node into ref_dumps
    ref_dumps = str(tmp_path / "ref_dumps")
    real_write = T_obs.write_node_dump

    def write_both(node, directory):
        R_obs.write_node_dump(node, ref_dumps)
        return real_write(node, directory)

    monkeypatch.setattr(T_obs, "write_node_dump", write_both)
    scorer = T_prov.default_scorer()
    scorer.reset()  # process-global: this soak's adversary only
    # every source the scorer quarantined during the soak: a source paroled
    # after 64 clean rows (the poisoner also votes honestly) leaves the
    # end-of-soak snapshot, so the soak's length would decide the reference's
    # end-state check; the union decides it exactly
    ever = set()
    real_record = scorer.record_rows

    def record_rows(sources, mask):
        real_record(sources, mask)
        ever.update(scorer.quarantined_sources())

    monkeypatch.setattr(scorer, "record_rows", record_rows)
    checks0 = T_metrics.fleet_metrics().safety_checks._values.get((), 0.0)

    res = asyncio.run(run_fleet_soak(spec, str(tmp_path / "soak"), min_heights=6,
                                     deadline_s=240.0, device="cpu"))

    assert res["verdict"] == "pass"
    assert res["safety_violations"] == 0
    poisoner_id = res["poisoners"][poisoners[0].index]
    assert poisoner_id
    tag = f"peer:{poisoner_id}"
    assert ever == {tag}
    sus = res["suspicion"]
    assert tag in sus["quarantined"] or sus["paroles"] >= 1
    assert sus["punished"] >= 1
    assert res["heights"] >= 6
    assert res["live_nodes"] == 7
    assert res["chaos_applied"] >= len(spec.schedule)
    assert res["chaos_errors"] == []
    assert res["workload"]["tx_submitted"] > 0
    assert res["workload"]["light_ok"] > 0
    (joiner,) = res["joiners"].values()
    assert joiner["sync_mode"] == "blocksync"
    assert joiner["height"] >= res["heights"] - 2

    report = res["report"]
    assert report["coverage"]["partial"] is False
    assert report["waterfall"]["uncovered"] == []
    assert len(report["waterfall"]["per_node"]) == 7
    assert set(report["roles"].values()) == set(ROLES)
    assert report["manifest"]["fingerprint"] == spec.fingerprint()
    assert T_metrics.fleet_metrics().safety_checks._values.get((), 0.0) - checks0 == \
        report["safety"]["heights_checked"] > 0

    again = FleetSpec.generate(SEED, 7, **smoke_kw())
    assert again.fingerprint() == res["fingerprint"]
    assert again.schedule.fingerprint() == res["schedule_fingerprint"]

    dumps_dir = res["dumps_dir"]
    assert T_ref.main(["--dumps", dumps_dir, "--check"]) == 0
    with open(os.path.join(dumps_dir, "fleet_report.json")) as f:
        assert json.load(f)["verdict"] == "pass"
    result = T_gate.evaluate(fleet_dumps=dumps_dir, perf_root=str(tmp_path / "no_rounds"))
    assert result["exit_code"] == 0 and result["verdict"] == "pass"
    assert result["gates"]["perf"]["status"] == "no_rounds"

    # the reference's tools on the port's dumps, the port's on the
    # reference's dumps of the same nodes (the port's manifest beside them)
    assert timeless(tools_agree(dumps_dir)) == timeless(
        T_ref.build_report(T_obs.load_dumps(dumps_dir), manifest=T_ref.load_manifest(dumps_dir)))
    assert len(os.listdir(ref_dumps)) == 7
    shutil.copy(os.path.join(dumps_dir, T_ref.MANIFEST_NAME), ref_dumps)
    ref_report = tools_agree(ref_dumps)
    assert ref_report["verdict"] == "pass"
    assert ref_report["safety"] == report["safety"]
