"""The port's comms audit catches planted faults: on 2 gloo ranks on the
CPU, the ``train_step`` program with an extra all-reduce exceeds the
committed budget (DLC510), and with an all-gather of the batch gathers a
shape no FSDP2 parameter group predicts (DLC511).
"""

from deeplearning_cfn_tpu_torch.analysis import comms_audit as cm


def test_planted_faults_give_dlc510_and_dlc511():
    planted = cm.run_comms_audit(device="cpu", journal=False, plant="extra_allreduce+batch_gather",
                                 programs=("train_step",))
    rules = sorted(v.rule for v in planted.violations)
    # The extra collectives also cut the step's slack below the committed
    # score: DLC512's regression form.
    assert rules == ["DLC510", "DLC511", "DLC512"]
    (gather,) = [v for v in planted.violations if v.rule == "DLC511"]
    assert "gathers a 32x8x8x1 array" in gather.message
    (p,) = planted.programs
    assert p.by_op["all-reduce"] == 3 and p.by_op["all-gather"] == 2
