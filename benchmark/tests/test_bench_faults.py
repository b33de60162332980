"""A run with the timed path broken underneath reads ``correct`` false:
each fault a cell can have, planted in the program, with the harness's look
for a card skipped (the runs are on the CPU at a tiny size)."""
import numpy as np
import pytest

from benchmark.tests.tiny import run_cell

TRAIN = ["sasrec_1m.train"]


def _state_unchanged(monkeypatch):
    """Every step returns its outputs and leaves the weights and moments as
    they were."""
    from rec_pangu_tpu_torch.train import fused_update

    def still(self, inputs, step):
        return self.model(inputs, train=True)

    monkeypatch.setattr(fused_update.SeqFusedStep, "__call__", still)


def _half_batch(monkeypatch):
    """Every uploaded batch keeps its first half: the step's mean is over
    the rest."""
    from rec_pangu_tpu_torch.models import base

    whole = base.SequenceModelBase.upload_batch

    def half(self, batch, device, train=False):
        return whole(self, {k: v[:len(v) // 2] for k, v in batch.items()}, device, train)

    monkeypatch.setattr(base.SequenceModelBase, "upload_batch", half)


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_training_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = run_cell(name)
    assert result["correct"] is False, result["numbers"]


def test_altered_answer_is_not_correct(monkeypatch):
    """One id of each answer replaced, where it is produced, by an item the
    answer does not hold."""
    from rec_pangu_tpu_torch.serving import scorer

    make = scorer.make_retrieval_scorer

    def altered(*args, **kwargs):
        retrieve = make(*args, **kwargs)

        def serve(batch):
            scores, ids = retrieve(batch)
            ids = ids.copy()
            ids[0, 0] = next(i for i in range(1, 3000) if i not in set(ids[0].tolist()))
            return scores, ids

        return serve

    monkeypatch.setattr(scorer, "make_retrieval_scorer", altered)
    result = run_cell("sasrec_1m.retrieve")
    assert result["correct"] is False, result["numbers"]
    assert np.isfinite(result["numbers"]["score_gap"]["value"])


@pytest.mark.parametrize("name", TRAIN + ["sasrec_1m.retrieve"])
def test_program_switch_refuses(monkeypatch, name):
    """A run with one of the program's switches set (bfloat16 moments here)
    reports nothing."""
    from benchmark.harness.cell import Refused

    monkeypatch.setenv("REC_PANGU_TPU_MOMENT_DTYPE", "bf16")
    with pytest.raises(Refused, match="switches"):
        run_cell(name)


@pytest.mark.parametrize("name", TRAIN)
def test_moments_below_precision_refuse(monkeypatch, name):
    """Moments held in bfloat16 by the program itself, with no switch set,
    refuse the run: the norms compared barely move under such rounding."""
    import torch

    from benchmark.harness.cell import Refused
    from rec_pangu_tpu_torch.train import fused_update

    monkeypatch.setattr(fused_update, "_moment_dtype", lambda: torch.bfloat16)
    with pytest.raises(Refused, match="below the configuration's float32"):
        run_cell(name)
