"""The chaos CLI on the port (``resilience/__main__.py``) on the CPU: the
serving leg (a supervised generation server on the prefill ladder, every
stream re-served under a ``serving.decode_step`` fault bit for bit its
clean run, with the fault and the recovery on /metrics) and the training
leg (a ``--train-victim`` subprocess SIGKILLs itself mid-pass; the
resumed trainer ends bit for bit an uninterrupted one), called in this
process, and the CLI's argument handling."""

import pytest

from paddle_tpu_torch.resilience import __main__ as chaos
from paddle_tpu_torch.resilience import faults


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    faults.clear()


def test_serving_leg_recovers_bit_identical():
    errs = []
    out = chaos._chaos_serving(errs, "cpu")
    assert not errs, errs
    assert out["serving_ok"] and out["bit_identical"], out
    assert out["faults_fired"] == 1 and out["reprefills"] >= 1
    assert out["metrics_sane"]
    assert faults.fired_counts() == {}


def test_training_leg_kill9_resume_bit_identical():
    errs = []
    out = chaos._chaos_train(errs, "cpu")
    assert not errs, errs
    assert out["victim_killed"], out
    # the kill landed mid pass 2: passes 0 and 1 are complete
    assert out["complete_passes"] == ["pass-00000", "pass-00001"]
    assert out["resume_bit_identical"]


def test_cli_requires_a_mode(capsys):
    with pytest.raises(SystemExit):
        chaos.main([])
    assert "--smoke" in capsys.readouterr().err
