"""On the card, at the cells' own size: the program's rows of one fresh
seed come out correct, and each control's, the reference computed below
the configuration's precision in the program's place (the workload's
``check.controls``), come out not correct, each judged by the verdict
that decides a run's ``correct``.

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        benchmark/tests/test_harness_control.py
"""

import pytest

from benchmark import harness

SEED = 3_900_000_001


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fleet-onecell-b2048", "global-n15-b2048",
                                  "fleet-uniform-b2048"])
def test_program_passes_and_each_control_fails(card, name):
    from benchmark.checks import calibrate

    work, config, mix = harness.load_cell(name)
    calls = 12 if name == "fleet-uniform-b2048" else 48
    prog, *ctls = calibrate.readings(work, config, mix, [SEED], {SEED},
                                     calls, "cuda")
    assert prog["correct"] is True, prog
    assert len(ctls) == len(work["check"]["controls"])
    for ctl in ctls:
        assert ctl["correct"] is False, ctl
