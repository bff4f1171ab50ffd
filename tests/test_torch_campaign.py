"""The card campaign (``romtime_tpu_torch/scripts/campaign.py``) against
the JAX repository's ``scripts/tpu_campaign.sh``: its phases, each
phase's environment (tpu_campaign.sh:40-52) and the default phase list
(:27), read from the shell script itself; then the driver with a fake
runner (no subprocess): each phase's environment reaches the entry, its
log is named for the phase, and each phase appends one line, ``"bench":
null`` where the entry printed none."""

import json
import os
import re

import pytest

from romtime_tpu_torch.scripts import campaign

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shell_phases():
    """phase → environment, and the default phases, of tpu_campaign.sh."""
    with open(os.path.join(REPO, "scripts", "tpu_campaign.sh")) as f:
        text = f.read().replace("\\\n", " ")
    table = {}
    for name, body in re.findall(r"^\s*(\w+)\)\s+run \w+(.*?);;", text,
                                 flags=re.M):
        table[name] = dict(re.findall(r'(\w+)="?([^"\s]+)"?', body))
    default = re.search(r"&& phases=\(([^)]*)\)", text)
    return table, tuple(default.group(1).split())


def test_phase_table_is_the_shell_campaigns():
    table, default = _shell_phases()
    assert len(table) == 7
    assert campaign.PHASES == table
    assert campaign.DEFAULT_PHASES == default
    assert campaign.TIMEOUT_S == 3000


@pytest.mark.parametrize("phases", [[], ["default", "lu", "throughput"],
                                    ["uniform", "device"]])
def test_campaign_with_a_fake_runner(tmp_path, monkeypatch, phases):
    """Each phase's environment and log, one output line a phase."""
    seen = []

    def runner(env, log_path):
        name = os.path.basename(log_path)[len("bench_"):-len(".log")]
        seen.append((name, env, log_path))
        if name == "lu":
            return "Traceback (most recent call last):\n"
        return "progress\n" + json.dumps({"metric": "m", "value": len(seen),
                                          "phase_env": campaign.PHASES[name]})

    monkeypatch.setenv("BENCH_DEVICE", "cuda")
    out = tmp_path / "build" / "card_campaign.jsonl"
    records = campaign.main(phases + ["--out", str(out)], runner=runner)
    want = phases or list(campaign.DEFAULT_PHASES)
    assert [r["phase"] for r in records] == [n for n, *_x in seen] == want
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert lines == records
    for (name, env, log_path), rec in zip(seen, records):
        assert log_path == str(tmp_path / "build" / f"bench_{name}.log")
        for k, v in campaign.PHASES[name].items():
            assert env[k] == v
        assert env["BENCH_DEVICE"] == "cuda"
        if name == "lu":
            assert rec["bench"] is None
        else:
            assert rec["bench"]["phase_env"] == campaign.PHASES[name]


def test_unknown_phase_is_refused(tmp_path):
    with pytest.raises(SystemExit):
        campaign.main(["nosuch", "--out", str(tmp_path / "x.jsonl")],
                      runner=lambda env, log: "")
    assert not (tmp_path / "x.jsonl").exists()
