"""The port's training step on the MoE, MLA, SSD, RG-LRU and
encoder-decoder smoke configs as shipped (``dtype="bfloat16"``) against
the reference's: loss and grad_norm within rtol 2e-2
(``torch_train_parity.check_bf16_step``)."""
import pytest

from torch_train_parity import (  # noqa: F401 (few_threads: a fixture)
    MLA,
    MOE,
    RECURRENT_ENCDEC,
    check_bf16_step,
    few_threads,
)

FAMILIES = sorted([MLA, MOE] + RECURRENT_ENCDEC)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_step_matches_reference(name):
    check_bf16_step(name)
